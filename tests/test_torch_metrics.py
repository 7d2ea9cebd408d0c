"""``stats=True`` on the port's tables (``repro_torch.obs.metrics``) against
the JAX package's ``backend="pallas"`` tables (``repro.obs.metrics``).

The same seeded numpy batches go through both packages on the CPU, the
reference's ops jitted once each (module-scoped fixtures).  The port takes
the ``"pallas"`` backend's semantics: the op runs unchanged and a
read-only walk of the batch's distinct live keys measures the probe
lengths against the post-op store (``bolt_on_stats``).  Every field of
``TableStats`` must be equal, but ``fixpoint_iters`` after
``update_values`` and ``counting.insert``, which the reference runs in its
engine under that backend too: the port reports 0 there.  The
arithmetic is integer (the load factor an f32 quotient of two integers),
so the tolerance is zero.  Beside the reference: the port's outputs and
store planes are bit-exact with ``stats=False`` (stats only observe), and
the probe lengths equal a numpy re-walk of the store.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counting as jcnt
from repro.core import multi_value as jmv
from repro.core import single_value as jsv
from repro.obs import metrics as jmetrics
from repro_torch.core import counting as tcnt
from repro_torch.core import multi_value as tmv
from repro_torch.core import probing
from repro_torch.core import single_value as tsv
from repro_torch.core.common import (
    EMPTY_KEY,
    STATUS_FULL,
    to_numpy_u32,
)
from repro_torch.obs import metrics

FIELDS = ("status_hist", "probe_hist", "probe_sum", "probe_n",
          "fixpoint_iters", "live_slots", "tombstone_slots", "load_factor")
B = 600                  # every batch and query batch: one compile per op
CAPACITY = 1000          # W = 8: 1000 slots (p = 125); a FULL case at 64
OUT_CAPACITY = 1024
_OPT = {"xla_backend_optimization_level": 0,
        "xla_cpu_use_fusion_emitters": False}


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static), compiler_options=_OPT)


_J = {
    "insert": _jit(jsv.insert, stats=True),
    "retrieve": _jit(jsv.retrieve, stats=True),
    "erase": _jit(jsv.erase),
    "update": _jit(jsv.update_values,
                   update_fn=lambda old, key, new: old + new,
                   combine=lambda a, b: a + b, stats=True),
    "count": _jit(jcnt.insert, stats=True),
    "counts": _jit(jcnt.counts, stats=True),
    "mv_insert": _jit(jmv.insert, stats=True),
    "mv_count": _jit(jmv.count_values, stats=True),
    "mv_retrieve": _jit(jmv.retrieve_all, out_capacity=OUT_CAPACITY,
                        stats=True),
}


def _keys(rng, n):
    return rng.choice(2 ** 32 - 2, size=n, replace=False).astype(np.uint32)


def _as_kw(keys, key_words):
    """(n,) u32 keys, or (n, 2) planes whose plane 1 takes a second word
    (a quarter of the keys share plane-0 words in pairs)."""
    if key_words == 1:
        return keys
    lo = keys.copy()
    lo[1::8] = lo[::8][:lo[1::8].shape[0]]
    hi = (keys * np.uint32(2654435761)) ^ np.uint32(0x5BD1E995)
    return np.stack([lo, hi], axis=1)


def _u(x):
    """Numpy view of an output of either package."""
    if isinstance(x, torch.Tensor):
        return to_numpy_u32(x) if x.dtype == torch.int32 else x.numpy()
    return np.asarray(x)


def _same(j, t, what):
    np.testing.assert_array_equal(_u(j).astype(_u(t).dtype), _u(t), what)


def _same_stats(j, t, what, skip=()):
    for f in FIELDS:
        if f in skip:
            continue
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), f"{what} {f}")
    jd, td = j.as_dict(), t.as_dict()
    for f in skip:
        jd.pop(f), td.pop(f)
    assert jd == td, what


def _same_tables(jt, tt, what):
    _same(jt.store["keys"], tt.store["keys"], f"{what} key planes")
    _same(jt.store["values"], tt.store["values"], f"{what} value planes")
    assert int(jt.count) == tt.count, what


def _clone(tt):
    return dataclasses.replace(tt, store={k: v.clone()
                                          for k, v in tt.store.items()})


def _observer(call, tt, what):
    """Run ``call(table, stats)`` on a clone of ``tt`` without stats and on
    ``tt`` with them: every output and the store planes are bit-exact."""
    plain_t = _clone(tt)
    plain = call(plain_t, False)
    got = call(tt, True)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert len(got) == len(plain) + 1, what
    for a, b in zip(got, plain):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), what
        else:                                  # the table: its planes
            for k in a.store:
                assert torch.equal(a.store[k], b.store[k]), what
            assert a.count == b.count, what
    assert isinstance(got[-1], metrics.TableStats)
    return got


def _scenario(key_words):
    """Run every stats entry point on both packages; returns ``{step:
    (jax result, port result, fields to skip)}``."""
    rng = np.random.default_rng([26, key_words])
    out = {}
    pool = _keys(rng, 3 * B)
    keys = pool[:B].copy()
    keys[B - 100:] = keys[:100]                         # duplicates
    mask = rng.random(B) < 0.9
    vals = rng.integers(0, 2 ** 32, B, dtype=np.uint32)
    k1 = _as_kw(keys, key_words)
    jm = jnp.asarray(mask)

    jt = jsv.create(CAPACITY, window=8, backend="pallas",
                    key_words=key_words)
    tt = tsv.create(CAPACITY, window=8, device="cpu", key_words=key_words)
    jt, js, jst = _J["insert"](jt, k1, vals, jm)
    tt, ts, tst = _observer(
        lambda t, st: tsv.insert(t, k1, vals, mask=mask, stats=st), tt,
        "sv.insert")
    _same_tables(jt, tt, "sv.insert")
    out["sv.insert"] = ((js, jst), (ts, tst), ())

    queries = _as_kw(np.concatenate([keys[:B - 100], pool[B:B + 100]]),
                     key_words)
    jv, jf, jst = _J["retrieve"](jt, queries)
    tv, tf, tst = _observer(lambda t, st: tsv.retrieve(t, queries, stats=st),
                            tt, "sv.retrieve")
    out["sv.retrieve"] = ((jv, jf, jst), (tv, tf, tst), ())

    gone = k1[:150]
    jt, je = _J["erase"](jt, gone)
    tt, te = tsv.erase(tt, gone)
    _same_tables(jt, tt, "sv.erase")

    # half present keys (some erased: tombstones reused), half new
    k2 = _as_kw(np.concatenate([keys[100:400], pool[B + 100:B + 400]]),
                key_words)
    m2 = rng.random(B) < 0.95
    jt, js, jst = _J["insert"](jt, k2, vals, jnp.asarray(m2))
    tt, ts, tst = _observer(
        lambda t, st: tsv.insert(t, k2, vals, mask=m2, stats=st), tt,
        "sv.insert onto tombstones")
    _same_tables(jt, tt, "sv.insert onto tombstones")
    out["sv.insert_tombstones"] = ((js, jst), (ts, tst), ())

    jt, js, jst = _J["update"](jt, k1, init=jnp.uint32(1), mask=jm,
                               values=vals)
    tt, ts, tst = _observer(
        lambda t, st: tsv.update_values(t, k1, ("add",), 1, mask=mask,
                                        values=vals, combine=("add",),
                                        stats=st), tt, "sv.update_values")
    _same_tables(jt, tt, "sv.update_values")
    out["sv.update_values"] = ((js, jst), (ts, tst), ("fixpoint_iters",))

    rows = _as_kw(pool[rng.integers(0, 300, B)], key_words)
    jc = jcnt.create(CAPACITY, window=8, backend="pallas",
                     key_words=key_words)
    tc = tcnt.create(CAPACITY, window=8, device="cpu", key_words=key_words)
    jc, js, jst = _J["count"](jc, rows, jm)
    tc, ts, tst = _observer(lambda t, st: tcnt.insert(t, rows, mask,
                                                      stats=st),
                            tc, "counting.insert")
    _same_tables(jc, tc, "counting.insert")
    out["counting.insert"] = ((js, jst), (ts, tst), ("fixpoint_iters",))
    jn, jst = _J["counts"](jc, queries)
    tn, tst = _observer(lambda t, st: tcnt.counts(t, queries, stats=st), tc,
                        "counting.counts")
    out["counting.counts"] = ((jn, jst), (tn, tst), ())

    pairs = _as_kw(np.repeat(pool[:150], 4), key_words)
    jmt = jmv.create(CAPACITY, window=8, backend="pallas",
                     key_words=key_words)
    tmt = tmv.create(CAPACITY, window=8, device="cpu", key_words=key_words)
    jmt, js, jst = _J["mv_insert"](jmt, pairs, vals, jm)
    tmt, ts, tst = _observer(
        lambda t, st: tmv.insert(t, pairs, vals, mask=mask, stats=st), tmt,
        "mv.insert")
    _same_tables(jmt, tmt, "mv.insert")
    out["mv.insert"] = ((js, jst), (ts, tst), ())
    mq = _as_kw(np.concatenate([pool[:150], pool[:150], pool[B:B + 300]]),
                key_words)
    jn, jst = _J["mv_count"](jmt, mq, jm)
    tn, tst = _observer(lambda t, st: tmv.count_values(t, mq, mask=mask,
                                                       stats=st),
                        tmt, "mv.count_values")
    out["mv.count_values"] = ((jn, jst), (tn, tst), ())
    *jr, jst = _J["mv_retrieve"](jmt, mq, mask=jm)
    *tr, tst = _observer(lambda t, st: tmv.retrieve_all(
        t, mq, OUT_CAPACITY, mask=mask, stats=st), tmt, "mv.retrieve_all")
    out["mv.retrieve_all"] = ((*jr, jst), (*tr, tst), ())

    # FULL: a 64-slot table with a budget of 2 windows takes the batch
    jf = jsv.create(64, window=8, backend="pallas", key_words=key_words,
                    max_probes=2)
    tf = tsv.create(64, window=8, device="cpu", key_words=key_words,
                    max_probes=2)
    jf, js, jst = _J["insert"](jf, k1, vals, jm)
    tf, ts, tst = _observer(
        lambda t, st: tsv.insert(t, k1, vals, mask=mask, stats=st), tf,
        "sv.insert FULL")
    _same_tables(jf, tf, "sv.insert FULL")
    assert (_u(ts) == STATUS_FULL).any()
    out["sv.insert_full"] = ((js, jst), (ts, tst), ())
    return out, tt, queries


@pytest.fixture(scope="module", params=[1, 2], ids=["u32", "two-word"])
def scenario(request):
    return _scenario(request.param)


STEPS = ("sv.insert", "sv.retrieve", "sv.insert_tombstones",
         "sv.update_values", "counting.insert", "counting.counts",
         "mv.insert", "mv.count_values", "mv.retrieve_all", "sv.insert_full")


@pytest.mark.parametrize("step", STEPS)
def test_stats_equal_the_pallas_backend(scenario, step):
    """Outputs and every ``TableStats`` field equal the JAX ``"pallas"``
    table's (``fixpoint_iters`` apart after update_values / counting)."""
    (j, t, skip) = scenario[0][step]
    for a, b in zip(j[:-1], t[:-1]):
        _same(a, b, step)
    _same_stats(j[-1], t[-1], step, skip)
    if skip:
        assert int(t[-1].fixpoint_iters) == 0


def _recount(table, keys):
    """Probe lengths by a numpy re-walk of the store: windows until a
    window holding the key on every plane or an EMPTY on plane 0, at most
    the table's budget."""
    kp = to_numpy_u32(table.store["keys"])                   # (kw, p, W)
    k = to_numpy_u32(keys).reshape(keys.shape[0], -1)
    words = tsv.key_hash_word(keys)
    row0 = probing.initial_row(words, table.num_rows, table.seed).numpy()
    step = probing.row_step(table.scheme, words, table.num_rows,
                            table.seed).numpy()
    out = np.zeros(k.shape[0], np.int64)
    for i in range(k.shape[0]):
        row = int(row0[i])
        for attempt in range(table.max_probes):
            out[i] += 1
            win = kp[:, row, :]
            if (win == k[i][:, None]).all(axis=0).any():
                break
            if (win[0] == EMPTY_KEY).any():
                break
            row = (row + int(step[i])) % table.num_rows
    return out


def test_probe_hist_matches_a_numpy_recount(scenario):
    """The retrieve's probe histogram, sum and count against a numpy
    re-walk of the same store (the reference's ``TestProbeHistRecount``),
    and ``probe_quantile`` an upper bin edge of the recount's median."""
    _, tt, queries = scenario
    distinct = torch.unique(torch.as_tensor(queries.astype(np.int64)),
                            dim=0)
    q = torch.as_tensor(distinct.numpy().astype(np.uint32).view(np.int32))
    _, _, st = tsv.retrieve(tt, q, stats=True)
    ref = _recount(tt, q)
    assert int(st.probe_n) == q.shape[0]
    assert int(st.probe_sum) == int(ref.sum())
    edges = 2 ** np.arange(metrics.NUM_PROBE_BINS)
    b = np.clip(np.searchsorted(edges, ref, side="left"), 0,
                metrics.NUM_PROBE_BINS - 1)
    np.testing.assert_array_equal(
        st.probe_hist.numpy(),
        np.bincount(b, minlength=metrics.NUM_PROBE_BINS))
    assert st.probe_quantile(0.5) >= float(np.median(ref))
    assert ref.max() > 1                      # walks past the first window


def test_empty_batches():
    """An empty batch: no probe lengths, the slot census of the store (the
    reference's ``"pallas"`` sv ops cannot take one, so they run on
    ``"jax"``; its multi-value count can)."""
    keys = np.zeros(0, np.uint32)
    jt = jsv.create(64, window=8)
    tt = tsv.create(64, window=8, device="cpu")
    _, js, jst = jsv.insert(jt, keys, keys, stats=True)
    _, ts, tst = tsv.insert(tt, keys, keys, stats=True)
    _same(js, ts, "status")
    _same_stats(jst, tst, "sv.insert")
    _same_stats(jsv.retrieve(jt, keys, stats=True)[2],
                tsv.retrieve(tt, keys, stats=True)[2], "sv.retrieve")
    jm = jmv.create(64, window=8, backend="pallas")
    tm = tmv.create(64, window=8, device="cpu")
    _same_stats(jmv.count_values(jm, keys, stats=True)[1],
                tmv.count_values(tm, keys, stats=True)[1], "mv.count_values")
    assert tst.mean_probe_len() == 0.0 and tst.probe_quantile(0.99) == 0.0


def test_readers_and_merge():
    """``TableStats``' readers and ``merge`` on hand-made fields, against
    the reference's on the same numbers."""
    def pair(status, plen, active):
        j = jmetrics.table_stats(
            jsv.create(64, window=8).ops, jsv.create(64, window=8).store,
            status=jnp.asarray(status), plen=jnp.asarray(plen),
            active=jnp.asarray(active))
        t = tsv.create(64, window=8, device="cpu")
        return j, metrics.table_stats(
            t.ops, t.store, status=torch.as_tensor(status),
            plen=torch.as_tensor(plen), active=torch.as_tensor(active))

    rng = np.random.default_rng(3)
    a = pair(rng.integers(0, 5, 50).astype(np.int32),
             rng.integers(0, 70000, 50).astype(np.int32),
             rng.random(50) < 0.8)
    b = pair(np.array([7, -1], np.int32), np.array([1, 2], np.int32),
             np.array([True, True]))
    _same_stats(a[0], a[1], "a")
    _same_stats(b[0], b[1], "b")
    _same_stats(jmetrics.merge(a[0], b[0]), metrics.merge(a[1], b[1]),
                "merge")
    assert metrics.empty().as_dict() == jmetrics.empty().as_dict()
    for q in (0.0, 0.3, 0.5, 0.99, 1.0):
        assert a[0].probe_quantile(q) == a[1].probe_quantile(q)


def test_wide_probe_sum_does_not_wrap():
    """``probe_sum`` is int64: 2^28 keys at 8 windows each is 2^31."""
    plen = torch.full((4,), 2 ** 30, dtype=torch.int32)
    _, total, n = metrics.probe_hist(plen, torch.ones(4, dtype=torch.bool))
    assert int(total) == 2 ** 32 and int(n) == 4


def test_bucket_list_refuses_stats():
    from repro_torch.core import bucket_list as tbl
    t = tbl.create(64, 128, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5b"):
        tbl.insert(t, np.arange(1, 5, dtype=np.uint32),
                   np.arange(4, dtype=np.uint32), stats=True)


def test_no_jax_in_the_port_metrics():
    import subprocess
    import sys
    code = ("import sys; import repro_torch.obs.metrics, "
            "repro_torch.core.migrate; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "or m == 'repro' for m in sys.modules), 'imports jax'")
    subprocess.run([sys.executable, "-c", code], check=True)

