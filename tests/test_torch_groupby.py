"""The port's group-by and counting table against the JAX reference,
bit-exact.

``repro_torch.relational.groupby`` and ``repro_torch.core.counting`` (on
``single_value.update_values`` and the bulk engine's read-modify-write)
run on the CPU, where ``cops_update`` / ``cops_update64`` run their plain
version; ``repro.relational.groupby`` and ``repro.core.counting`` run with
``backend="jax"`` (the vectorized engine) and, for 1-word keys,
``backend="pallas"`` (the fused RMW tile ``_update_kernel`` in interpret
mode; two-word keys have no Pallas update tile and take the vectorized
engine there too).
The same seeded numpy batches go through both: statuses, the table's
planes and count, ``finalize`` over the full capacity and ``lookup`` must
be equal for every aggregate; the arithmetic is integer (``mean`` divides
two float32 values in both), so the tolerance is zero.

Each (backend, scheme, window, key width) compiles one jitted JAX round
(every aggregate: a masked batch, an empty batch, a streaming second
batch, finalize, lookup), without XLA's backend optimisation passes and
CPU fusion emitters; the cases differ only in their data.  The file runs
in about 35 s on one core.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counting as jcounting
from repro.relational import groupby as jgb
from repro_torch.core import convert
from repro_torch.core import counting as tcounting
from repro_torch.core.common import (
    STATUS_FULL,
    STATUS_INSERTED,
    STATUS_MASKED,
    STATUS_UPDATED,
    to_numpy_u32,
)
from repro_torch.kernels.cops import ops
from repro_torch.relational import groupby as tgb

CAPACITY = 256
N1, N2, NQ = 400, 160, 96
_FAST = {"xla_backend_optimization_level": 0,
         "xla_cpu_use_fusion_emitters": False}


def _np(x):
    """numpy of a JAX array or of a port tensor (int32 words as u32)."""
    if isinstance(x, torch.Tensor):
        return to_numpy_u32(x) if x.dtype == torch.int32 else x.numpy()
    return np.asarray(x)


def _eq(j, t, what):
    j, t = _np(j), _np(t)
    assert j.shape == t.shape, (what, j.shape, t.shape)
    np.testing.assert_array_equal(j.astype(t.dtype), t, err_msg=what)


@functools.cache
def _gb_round(backend, scheme, window, key_words):
    """One jitted JAX round over every aggregate (``mean`` reads the
    ``sum`` table: the two fold alike).  The empty batch runs with 1-word
    keys on ``"jax"`` only: the ``"pallas"`` update cannot take one (its
    tile size is the batch size, and ``repro/kernels/cops/ops.py:
    _tile_batch`` divides by it), and that round gives an empty status
    without a call."""
    def f(k1, v1, m1, k0, v0, k2, v2, q):
        out = {}
        for agg in ("sum", "min", "max", "count"):
            t = jgb.create(CAPACITY, key_words=key_words, window=window,
                           scheme=scheme, backend=backend)
            t, s1 = jgb.update(t, agg, k1, v1, mask=m1)
            if backend == "jax" and key_words == 1:
                t, s0 = jgb.update(t, agg, k0, v0)
            else:
                s0 = jnp.zeros((0,), jnp.int32)
            t, s2 = jgb.update(t, agg, k2, v2)
            for a in (agg, "mean") if agg == "sum" else (agg,):
                out[a] = (s1, s0, s2, jgb.finalize(t, a), jgb.lookup(t, a, q),
                          t.count, t.store)
        return out
    return jax.jit(f, compiler_options=_FAST)


def _group_keys(rng, count, key_words):
    """``count`` distinct keys: u32 words, or (count, 2) planes whose
    plane 0 comes from a small range (keys share it) and whose plane 1 is
    0xFFFFFFFF / 0xFFFFFFFE for some."""
    if key_words == 1:
        return rng.choice(2 ** 32 - 2, size=count, replace=False).astype(
            np.uint32)
    lo = rng.integers(1, 24, 4 * count).astype(np.uint64)
    hi = rng.integers(0, 2 ** 32, 4 * count, dtype=np.uint64)
    hi[: count // 8] = 0xFFFFFFFF
    hi[count // 8: count // 4] = 0xFFFFFFFE
    u = (hi << np.uint64(32)) | lo
    _, first = np.unique(u, return_index=True)
    u = u[np.sort(first)][:count]
    u = u[rng.permutation(count)]
    return np.stack([(u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (u >> np.uint64(32)).astype(np.uint32)], axis=1)


def _case(seed, groups, key_words, big):
    """Batches of one case: ``groups`` distinct keys (more than the
    table holds for a near-full case), values over the whole u32 range
    (sums wrap, accumulators pass 2^24) or, with ``big``, near 2^32."""
    rng = np.random.default_rng(seed)
    pool = _group_keys(rng, groups + 64, key_words)
    keys, absent = pool[:groups], pool[groups:]
    k1 = keys[rng.integers(0, groups, N1)]
    lo = 2 ** 32 - 2 ** 20 if big else 0
    v1 = rng.integers(lo, 2 ** 32, N1, dtype=np.uint32)
    m1 = rng.random(N1) < 0.9
    k2 = np.concatenate([keys[rng.integers(0, groups, N2 // 2)],
                         _group_keys(rng, N2 // 2 + 64, key_words)[64:]])
    v2 = rng.integers(lo, 2 ** 32, N2, dtype=np.uint32)
    q = np.concatenate([k1[: NQ - 32], absent[:32]])
    k0 = keys[:0]
    return k1, v1, m1, k0, v1[:0], k2, v2, q


#: data cases of each round: (seed, distinct groups, key width -> big values)
CASES = {"few_groups": (1, 40, False), "many_groups": (2, 180, False),
         "near_full": (3, 1000, False), "values_near_2^32": (4, 90, True)}


@pytest.mark.parametrize("backend, scheme, window, key_words", [
    ("jax", "cops", 32, 1), ("pallas", "linear", 1, 1),
    ("jax", "linear", 8, 2)])
def test_groupby_parity_with_jax(backend, scheme, window, key_words):
    jround = _gb_round(backend, scheme, window, key_words)
    for name, (seed, groups, big) in CASES.items():
        k1, v1, m1, k0, v0, k2, v2, q = _case(seed, groups, key_words, big)
        want = jround(k1, v1, jnp.asarray(m1), k0, v0, k2, v2, q)
        full = False
        for agg in tgb.AGGS:
            t = tgb.create(CAPACITY, key_words=key_words, window=window,
                           scheme=scheme, device="cpu")
            t, s1 = tgb.update(t, agg, k1, v1, mask=m1)
            t, s0 = tgb.update(t, agg, k0, v0)
            t, s2 = tgb.update(t, agg, k2, v2)
            js1, js0, js2, jfin, jlook, jcount, jstore = want[agg]
            what = f"{name} {agg}"
            _eq(js1, s1, f"{what} status 1")
            _eq(js0, s0, f"{what} empty batch")
            _eq(js2, s2, f"{what} status 2")
            for part, j, p in zip(("keys", "aggregates", "live"), jfin,
                                  tgb.finalize(t, agg)):
                _eq(j, p, f"{what} finalize {part}")
            for part, j, p in zip(("values", "found"), jlook,
                                  tgb.lookup(t, agg, q)):
                _eq(j, p, f"{what} lookup {part}")
            assert int(jcount) == t.count, what
            _eq(jstore["keys"], t.store["keys"], f"{what} key planes")
            _eq(jstore["values"], t.store["values"], f"{what} value planes")
            full |= bool((s1 == STATUS_FULL).any()
                         | (s2 == STATUS_FULL).any())
            assert bool((s1[torch.from_numpy(~m1)] == STATUS_MASKED).all())
        assert full == (name == "near_full"), name


def test_groupby_semantics_on_a_small_batch():
    """The aggregates of a hand-checked batch: sums wrap mod 2^32, min and
    max compare unsigned, count ignores the values, mean divides the
    float32 accumulator (rounded above 2^24) by the count."""
    keys = np.array([5, 7, 5, 5, 9, 7], np.uint32)
    vals = np.array([0xFFFFFFFF, 3, 2, 0x80000000, 2 ** 24 + 1, 1], np.uint32)
    got = {}
    for agg in tgb.AGGS:
        t = tgb.create(64, window=8, device="cpu")
        t, st = tgb.update(t, agg, keys, vals)
        assert st.tolist() == [STATUS_INSERTED, STATUS_INSERTED,
                               STATUS_UPDATED, STATUS_UPDATED,
                               STATUS_INSERTED, STATUS_UPDATED]
        got[agg] = tgb.lookup(t, agg, np.array([5, 7, 9, 11], np.uint32))
    u = lambda r: to_numpy_u32(r[0]).tolist()
    assert u(got["sum"]) == [(0xFFFFFFFF + 2 + 0x80000000) % 2 ** 32, 4,
                             2 ** 24 + 1, 0]
    assert u(got["min"]) == [2, 1, 2 ** 24 + 1, 0]
    assert u(got["max"]) == [0xFFFFFFFF, 3, 2 ** 24 + 1, 0]
    assert u(got["count"]) == [3, 2, 1, 0]
    mean = got["mean"][0].numpy()
    assert mean.dtype == np.float32
    assert mean[2] == np.float32(2 ** 24)        # 2^24 + 1 rounds to even
    assert got["mean"][1].tolist() == [True, True, True, False]
    t = tgb.create(64, device="cpu")
    t, _ = tgb.update(t, "count", keys)          # count takes no values
    assert u(tgb.lookup(t, "count", keys[:2])) == [3, 2]
    with pytest.raises(ValueError, match="values"):
        tgb.update(t, "sum", keys)
    with pytest.raises(ValueError, match="agg"):
        tgb.update(t, "median", keys, vals)


def test_aggregate_key_spellings_agree():
    """``aggregate`` infers the key width: a column tuple, (n, 2) planes
    and u64 keys give the same groups, and 16-bit columns the same
    aggregates as their single-word packing (the fig9 parity gate)."""
    rng = np.random.default_rng(7)
    hi = rng.integers(0, 16, 500).astype(np.uint32)
    lo = rng.integers(1, 40, 500).astype(np.uint32)
    vals = rng.integers(0, 2 ** 16, 500).astype(np.uint32)
    u64 = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    outs = [tgb.aggregate(k, vals, 2048, "sum", device="cpu") for k in
            ((hi, lo), np.stack([lo, hi], 1), u64)]
    for gk, out, live, table in outs[1:]:
        assert table.key_words == 2
        assert torch.equal(gk, outs[0][0]) and torch.equal(out, outs[0][1])
    packed = tgb.aggregate((hi << 16) | lo, vals, 2048, "sum", device="cpu")
    tc = outs[0][3]
    got, found = tgb.lookup(tc, "sum", (hi, lo))
    want, wfound = tgb.lookup(packed[3], "sum", (hi << 16) | lo)
    assert torch.equal(got, want) and bool(found.all() and wfound.all())
    assert tc.count == packed[3].count == len(np.unique(u64))


# ---------------------------------------------------------------------------
# the counting table
# ---------------------------------------------------------------------------

@functools.cache
def _count_round(backend, scheme, window):
    def f(table, k1, m1, k2, q):
        table, s1 = jcounting.insert(table, k1, m1)
        table, s2 = jcounting.insert(table, k2)
        return s1, s2, jcounting.counts(table, q), table.count, table.store
    return jax.jit(f, compiler_options=_FAST)


@pytest.mark.parametrize("backend, scheme, window", [
    ("jax", "cops", 32), ("pallas", "linear", 8)])
def test_counting_parity_and_saturation(backend, scheme, window):
    """Counts of a masked batch and a second batch, bit-exact, starting
    from a JAX counter bridged in with one key at 0xFFFFFFF0: 32 more
    occurrences saturate it at 0xFFFFFFFF in both packages."""
    rng = np.random.default_rng(window)
    keys = rng.choice(2 ** 32 - 2, 300, replace=False).astype(np.uint32)
    # a counter built by the port, one key set to 0xFFFFFFF0, and the same
    # state in both packages (the bridge both ways)
    tt = tcounting.create(CAPACITY, window=window, scheme=scheme,
                          device="cpu")
    tt, _ = tcounting.insert(tt, keys[:100])
    state = convert.table_to_numpy(tt)
    hot = keys[3]
    state["values"][state["keys"] == hot] = 0xFFFFFFF0
    jt = jcounting.create(CAPACITY, window=window, scheme=scheme,
                          backend=backend)
    jt = dataclasses.replace(jt, count=jnp.int32(state["count"]), store={
        "keys": jnp.asarray(state["keys"]),
        "values": jnp.asarray(state["values"])})
    tt = convert.table_from_numpy(
        state["keys"], state["values"], state["count"], num_rows=jt.num_rows,
        window=window, scheme=scheme, seed=jt.seed, max_probes=jt.max_probes,
        device="cpu")
    k1 = np.concatenate([np.full(20, hot, np.uint32),
                         keys[rng.integers(0, 250, 180)]])
    m1 = rng.random(200) < 0.9
    k2 = np.concatenate([np.full(40, hot, np.uint32), keys[150:310 - 40]])
    q = np.concatenate([keys[:200], keys[250:]])
    js1, js2, jc, jcount, jstore = _count_round(backend, scheme, window)(
        jt, k1, jnp.asarray(m1), k2, q)
    tt, s1 = tcounting.insert(tt, k1, m1)
    tt, s2 = tcounting.insert(tt, k2)
    _eq(js1, s1, "status 1")
    _eq(js2, s2, "status 2")
    _eq(jc, tcounting.counts(tt, q), "counts")
    assert int(jcount) == tt.count
    _eq(jstore["values"], tt.store["values"], "counters")
    _eq(jstore["keys"], tt.store["keys"], "key plane")
    assert to_numpy_u32(tcounting.counts(tt, keys[3:4]))[0] == 0xFFFFFFFF


def test_counting_refuses_what_is_not_ported():
    """``stats=True`` and ``insert_or_grow`` run on the counting table
    (``tests/test_torch_metrics.py`` and ``test_torch_growth.py`` hold them
    to the reference); the update specs it does not carry refuse."""
    t = tcounting.create(64, device="cpu")
    t, status, st = tcounting.insert(t, np.arange(1, 5, dtype=np.uint32),
                                     stats=True)
    assert (status == 0).all() and int(st.probe_n) == 4
    t, status = tcounting.insert_or_grow(t, np.arange(1, 5, dtype=np.uint32))
    assert to_numpy_u32(tcounting.counts(t, np.arange(1, 5, dtype=np.uint32))
                        ).tolist() == [2, 2, 2, 2]
    from repro_torch.core import single_value as sv
    with pytest.raises(NotImplementedError, match="item 1c"):
        sv.update_values(t, np.arange(1, 5, dtype=np.uint32), ("or",), 1,
                         combine=("or",))
    with pytest.raises(NotImplementedError, match="item 1b"):
        sv.update_values(t, np.arange(1, 5, dtype=np.uint32),
                         lambda a, b: a + b, 1, combine=("add",))
    with pytest.raises(NotImplementedError, match="item 1b"):
        sv.update_values(t, np.arange(1, 5, dtype=np.uint32), ("add",), 1)


def test_cpu_update_launches_no_kernel():
    ops.reset_launches()
    t = tgb.create(256, device="cpu")
    keys = np.arange(1, 101, dtype=np.uint32)
    tgb.update(t, "sum", keys, keys)
    c = tcounting.create(256, key_words=2, device="cpu")
    tcounting.insert(c, np.stack([keys, keys], 1))
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_tables_are_on_the_card_by_default():
    """The group-by, counting and set tables raise without a card unless
    the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: create() uses it")
    from repro_torch.core import hashset
    for create in (tgb.create, tcounting.create, hashset.create):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create(64)
        assert create(64, device="cpu").device.type == "cpu"


_FOLDS = {"add": lambda a, b: (a + b) & 0xFFFFFFFF, "min": min, "max": max,
          "sat_add": lambda a, b: min(a + b, 0xFFFFFFFF)}


@pytest.mark.parametrize("fold", sorted(_FOLDS))
def test_update_folds_every_row_in_batch_order(fold):
    """``update_values`` gives the sequential chain's result: a present
    key folds each live operand in turn, an absent key's first live
    element claims a slot holding its ``init`` and the later ones fold
    in (large operands, so sums wrap and the counter saturates).  The
    representative walks, then every other row folds into its slot."""
    from repro_torch.core import single_value as sv
    rng = np.random.default_rng(11)
    keys = rng.integers(1, 40, 300).astype(np.uint32)
    vals = rng.integers(0, 2 ** 32, 300, dtype=np.uint32)
    init = rng.integers(0, 2 ** 32, 300, dtype=np.uint32)
    mask = rng.random(300) < 0.85
    combine = "add" if fold == "sat_add" else fold
    t = sv.create(128, device="cpu")
    t, _ = sv.insert(t, np.arange(1, 20, dtype=np.uint32),
                     np.full(19, 0xFFFFFF00, dtype=np.uint32))
    want = {k: 0xFFFFFF00 for k in range(1, 20)}
    for k, v, i, m in zip(keys.tolist(), vals.tolist(), init.tolist(),
                          mask.tolist()):
        if m:
            want[k] = _FOLDS[fold](want[k], v) if k in want else i
    t, st = sv.update_values(t, keys, (fold,), init, mask, values=vals,
                             combine=(combine,))
    got, found = sv.retrieve(t, np.array(sorted(want), dtype=np.uint32))
    assert bool(found.all()) and t.count == len(want)
    assert to_numpy_u32(got).tolist() == [want[k] for k in sorted(want)]
    assert not bool((st == STATUS_FULL).any())


@pytest.mark.parametrize("fold", sorted(_FOLDS))
def test_combining_each_groups_rows_first_is_the_chain(fold):
    """The update combines each representative's other rows first
    (``bulk.fold_rest``, the kernel's launch 1) and its walk folds the
    result in once: ``fold(old, fold(operand, rest))`` on a match and
    ``fold(claimv, rest)`` on a claim equal the row-by-row chain, for
    operands anywhere in u32, near 0xFFFFFFFF (sums wrap mod 2^32, the
    counter saturates) and small."""
    from repro_torch.core import bulk
    rng = np.random.default_rng(23)
    m, n = 40, 900
    for lo, hi in ((0, 2 ** 32), (0xFFFFFF00, 2 ** 32), (0, 256)):
        old, operand, claimv = (rng.integers(lo, hi, m, dtype=np.uint64)
                                for _ in range(3))
        rest_rep = rng.integers(-1, m, n).astype(np.int32)
        rows = rng.integers(lo, hi, n, dtype=np.uint64)
        matched = [_FOLDS[fold](int(a), int(b)) for a, b in zip(old, operand)]
        claimed = [int(c) for c in claimv]
        for r, v in zip(rest_rep.tolist(), rows.tolist()):
            if r >= 0:
                matched[r] = _FOLDS[fold](matched[r], v)
                claimed[r] = _FOLDS[fold](claimed[r], v)

        def words(x):
            return torch.from_numpy(np.asarray(x, dtype=np.uint32)
                                    .view(np.int32).reshape(-1, 1).copy())

        spec = (fold,)
        rest = bulk.fold_rest(spec, torch.from_numpy(rest_rep), words(rows), m)
        got_m = bulk.fold_words(spec, words(old),
                                bulk.fold_words(spec, words(operand), rest))
        got_c = bulk.fold_words(spec, words(claimv), rest)
        assert to_numpy_u32(got_m[:, 0]).tolist() == matched, (fold, lo)
        assert to_numpy_u32(got_c[:, 0]).tolist() == claimed, (fold, lo)


def test_update_refuses_out_of_range_representatives():
    """The fold's representatives index the walk's slots: the wrapper
    refuses any outside [-1, m)."""
    from repro_torch.core import single_value as sv
    t = sv.create(64, value_words=2, device="cpu")
    k = torch.arange(1, 5, dtype=torch.int32)
    x = torch.ones((4, 2), dtype=torch.int32)
    kw = dict(ops=("add", "add"), seed=t.seed, scheme=t.scheme,
              max_probes=8, count=0)
    for bad in ([0, 4], [-2, 1]):
        with pytest.raises(ValueError, match="rest representatives"):
            ops.update(t.store["keys"][0], t.store["values"], k, x, x,
                       torch.tensor(bad, dtype=torch.int32), x[:2], **kw)
    with pytest.raises(ValueError, match="or neither"):
        ops.update(t.store["keys"][0], t.store["values"], k, x, x,
                   torch.tensor([0, 1], dtype=torch.int32), None, **kw)
