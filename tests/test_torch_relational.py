"""The port's hash set, DISTINCT, hash join and the table bridge against
the JAX reference, bit-exact.

``repro_torch.core.hashset`` and ``repro_torch.relational.{distinct,
join}`` run on the CPU (the kernels' plain versions); their JAX
counterparts run with ``backend="jax"``.  The same seeded numpy batches
go through both: insert statuses and masks, store planes and counts,
membership, erase masks, DISTINCT's unique keys, counts and masks in
every key spelling (flat u32 words, (n, 2) planes, a column tuple), and
every ``JoinResult`` field of the four join flavours (with a build mask,
tombstoned build rows, a probe mask and an output too small for the
matches), ``count_matches`` and ``gather_payload``, 1-word and two-column
keys.  The arithmetic is integer, so the tolerance is zero.  On the CPU
the port's build replays the JAX engine's placement, so even the order of
a probe row's matches agrees.

Each (scheme, window, key width) compiles one jitted JAX round, without
XLA's backend optimisation passes and CPU fusion emitters; the file runs
in about 30 s on one core.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashset as jhs
from repro.core import multi_value as jmv
from repro.relational import distinct as jdistinct
from repro.relational import groupby as jgb
from repro.relational import join as jjoin
from repro_torch.core import convert
from repro_torch.core import hashset as ths
from repro_torch.core import multi_value as tmv
from repro_torch.core.common import to_numpy_u32
from repro_torch.relational import distinct as tdistinct
from repro_torch.relational import groupby as tgb
from repro_torch.relational import join as tjoin
from repro_torch.relational import util as tutil

CAPACITY = 512
_FAST = {"xla_backend_optimization_level": 0,
         "xla_cpu_use_fusion_emitters": False}


def _np(x):
    if isinstance(x, torch.Tensor):
        return to_numpy_u32(x) if x.dtype == torch.int32 else x.numpy()
    return np.asarray(x)


def _eq(j, t, what):
    if isinstance(j, tuple):
        assert isinstance(t, tuple) and len(j) == len(t), what
        for i, (a, b) in enumerate(zip(j, t)):
            _eq(a, b, f"{what}[{i}]")
        return
    j, t = _np(j), _np(t)
    assert j.shape == t.shape, (what, j.shape, t.shape)
    np.testing.assert_array_equal(j.astype(t.dtype), t, err_msg=what)


def _keys(rng, count, key_words):
    """``count`` distinct keys: u32 words, or (count, 2) planes (lo, hi)
    whose plane 0 comes from a small range and whose plane 1 is
    0xFFFFFFFF / 0xFFFFFFFE for some."""
    if key_words == 1:
        return rng.choice(2 ** 32 - 2, count, replace=False).astype(np.uint32)
    lo = rng.integers(1, 40, 4 * count).astype(np.uint64)
    hi = rng.integers(0, 2 ** 32, 4 * count, dtype=np.uint64)
    hi[: count // 8] = 0xFFFFFFFF
    hi[count // 8: count // 4] = 0xFFFFFFFE
    u = (hi << np.uint64(32)) | lo
    _, first = np.unique(u, return_index=True)
    u = u[np.sort(first)][:count]
    u = u[rng.permutation(count)]
    return np.stack([(u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (u >> np.uint64(32)).astype(np.uint32)], axis=1)


def _draw(rng, pool, n):
    return pool[rng.integers(0, pool.shape[0], n)]


# ---------------------------------------------------------------------------
# the hash set
# ---------------------------------------------------------------------------

@functools.cache
def _set_round(scheme, window, key_words):
    def f(k1, m1, k2, gone, q):
        s = jhs.create(CAPACITY // 2, key_words=key_words, window=window,
                       scheme=scheme)
        s, a1 = jhs.add(s, k1, m1)
        s, a2 = jhs.add(s, k2)
        c1 = jhs.contains(s, q)
        s, erased = jhs.remove(s, gone)
        c2 = jhs.contains(s, q)
        s, a3 = jhs.add(s, k2)
        return a1, a2, c1, erased, c2, a3, s.count, s.store
    return jax.jit(f, compiler_options=_FAST)


@pytest.mark.parametrize("scheme, window, key_words", [
    ("cops", 32, 1), ("linear", 4, 2)])
def test_hashset_parity_with_jax(scheme, window, key_words):
    """add (duplicates, a mask, more keys than the set holds), contains,
    remove and re-add onto the tombstones."""
    rng = np.random.default_rng(window)
    pool = _keys(rng, 400, key_words)
    k1, k2 = _draw(rng, pool[:200], 300), _draw(rng, pool[100:], 300)
    m1 = rng.random(300) < 0.9
    gone, q = pool[50:150], pool
    want = _set_round(scheme, window, key_words)(k1, jnp.asarray(m1), k2,
                                                 gone, q)
    s = ths.create(CAPACITY // 2, key_words=key_words, window=window,
                   scheme=scheme, device="cpu")
    assert s.store["values"].shape[0] == 0
    s, a1 = ths.add(s, k1, m1)
    s, a2 = ths.add(s, k2)
    c1 = ths.contains(s, q)
    s, erased = ths.remove(s, gone)
    c2 = ths.contains(s, q)
    s, a3 = ths.add(s, k2)
    got = (a1, a2, c1, erased, c2, a3)
    for name, j, t in zip(("add 1", "add 2", "contains", "remove",
                           "contains after remove", "re-add"), want, got):
        _eq(j, t, name)
    assert int(want[6]) == ths.size(s)
    _eq(want[7]["keys"], s.store["keys"], "key planes")
    assert bool((~a2).any()) and not bool(a1[torch.from_numpy(~m1)].any())


def test_hashset_refuses_the_packed_layout():
    with pytest.raises(ValueError, match="packed"):
        ths.create(64, layout="packed", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ths.create(64, layout="aos", device="cpu")


# ---------------------------------------------------------------------------
# DISTINCT
# ---------------------------------------------------------------------------

SPELLINGS = ("flat", "planes", "columns")


def _spell(keys, spelling):
    if spelling == "columns":
        return (keys[:, 1].copy(), keys[:, 0].copy())
    return keys


@functools.cache
def _distinct_round(out_capacity):
    def f(flat, planes, hi, lo, mask):
        out = [jdistinct.distinct(flat, out_capacity, mask=mask),
               jdistinct.distinct(planes, out_capacity),
               jdistinct.distinct((hi, lo), out_capacity)]
        ds = jdistinct.create(CAPACITY)
        ds, f1 = jdistinct.first_occurrence(ds, flat[:200])
        ds, f2 = jdistinct.first_occurrence(ds, flat[100:])
        return out, f1, f2
    return jax.jit(f, compiler_options=_FAST)


@pytest.mark.parametrize("out_capacity", [200, 40])
def test_distinct_parity_with_jax(out_capacity):
    """One-shot DISTINCT of 1-word keys (with a mask), (n, 2) planes and
    a column tuple, with room for every unique key and without; the
    streaming first-occurrence mask across two batches."""
    rng = np.random.default_rng(out_capacity)
    flat = _draw(rng, _keys(rng, 120, 1), 400)
    planes = _draw(rng, _keys(rng, 120, 2), 400)
    mask = rng.random(400) < 0.8
    want, jf1, jf2 = _distinct_round(out_capacity)(
        flat, planes, planes[:, 1].copy(), planes[:, 0].copy(),
        jnp.asarray(mask))
    got = [tdistinct.distinct(flat, out_capacity, mask=mask, device="cpu"),
           tdistinct.distinct(planes, out_capacity, device="cpu"),
           tdistinct.distinct(_spell(planes, "columns"), out_capacity,
                              device="cpu")]
    for spelling, (ju, jn, jfresh), (tu, tn, tfresh) in zip(SPELLINGS, want,
                                                             got):
        _eq(ju, tu, f"{spelling} unique keys")
        assert int(jn) == int(tn), spelling
        _eq(jfresh, tfresh, f"{spelling} first-occurrence mask")
    assert isinstance(got[2][0], tuple) and int(got[0][1]) > 0
    ds = tdistinct.create(CAPACITY, device="cpu")
    ds, f1 = tdistinct.first_occurrence(ds, flat[:200])
    ds, f2 = tdistinct.first_occurrence(ds, flat[100:])
    _eq(jf1, f1, "streaming batch 1")
    _eq(jf2, f2, "streaming batch 2")


def test_compact_drops_what_does_not_fit():
    vals = torch.arange(10, dtype=torch.int32)
    sel = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    out, n = tutil.compact(vals, sel, 4, fill=-7)
    assert out.tolist() == [0, 2, 3, 5] and int(n) == 7
    out, n = tutil.compact(vals[:, None].repeat(1, 2), sel, 9, fill=-1)
    assert out[:, 0].tolist() == [0, 2, 3, 5, 6, 8, 9, -1, -1]
    assert tutil.capacity_for(100, 0.5) == 200 and tutil.capacity_for(0) == 32


# ---------------------------------------------------------------------------
# the hash join
# ---------------------------------------------------------------------------

@functools.cache
def _join_round(scheme, window, key_words, out_capacity):
    def f(b, bmask, gone, p, pmask, payload):
        t, bst = jjoin.build(b, capacity=CAPACITY, key_words=key_words,
                             window=window, scheme=scheme, mask=bmask)
        t, _ = jmv.erase(t, gone)                    # tombstoned build rows
        out = {"build": bst}
        for how in jjoin.HOW:
            out[f"count {how}"] = jjoin.count_matches(t, p, how, mask=pmask)
            r = jjoin.probe(t, p, out_capacity, how, mask=pmask)
            out[how] = dataclasses.astuple(r)
            out[f"payload {how}"] = jjoin.gather_payload(r, payload, payload,
                                                         fill=7)
        r = jjoin.hash_join(b, p, out_capacity, "inner", key_words=key_words,
                            window=window, scheme=scheme, capacity=CAPACITY,
                            build_mask=bmask)
        out["hash_join"] = dataclasses.astuple(r)
        return out
    return jax.jit(f, compiler_options=_FAST)


@pytest.mark.parametrize("scheme, window, key_words, out_capacity", [
    ("cops", 32, 1, 1024), ("linear", 8, 1, 200), ("cops", 16, 2, 200)])
def test_join_parity_with_jax(scheme, window, key_words, out_capacity):
    """The four flavours on an N:M build with a build mask, tombstoned
    build rows and a probe mask, at an output size that holds every row
    (1024) or one that overflows (200); count_matches and
    gather_payload."""
    rng = np.random.default_rng([window, key_words])
    pool = _keys(rng, 160, key_words)
    b = _draw(rng, pool[:100], 300)                   # N:M, ~3 rows a key
    bmask = rng.random(300) < 0.95
    gone = pool[:10]
    p = _draw(rng, pool, 240)                         # 3/8 miss
    pmask = rng.random(240) < 0.9
    payload = rng.integers(0, 2 ** 32, 300, dtype=np.uint32)
    want = _join_round(scheme, window, key_words, out_capacity)(
        b, jnp.asarray(bmask), gone, p, jnp.asarray(pmask), payload)
    t, bst = tjoin.build(b, capacity=CAPACITY, key_words=key_words,
                         window=window, scheme=scheme, mask=bmask,
                         device="cpu")
    _eq(want["build"], bst, "build status")
    t, _ = tmv.erase(t, gone)
    for how in tjoin.HOW:
        what = f"{how} out_capacity={out_capacity}"
        _eq(want[f"count {how}"], tjoin.count_matches(t, p, how,
                                                       mask=pmask),
            f"{what} count_matches")
        r = tjoin.probe(t, p, out_capacity, how, mask=pmask)
        for field, j in zip(("build_idx", "probe_idx", "valid",
                             "matched", "total"), want[how]):
            _eq(j, getattr(r, field), f"{what} {field}")
        jb, jp = want[f"payload {how}"]
        tb, tp = tjoin.gather_payload(r, payload, payload, fill=7)
        _eq(jb, tb, f"{what} build payload")
        _eq(jp, tp, f"{what} probe payload")
    r = tjoin.hash_join(b, p, out_capacity, "inner", key_words=key_words,
                        window=window, scheme=scheme, capacity=CAPACITY,
                        build_mask=bmask, device="cpu")
    for field, j in zip(("build_idx", "probe_idx", "valid", "matched",
                         "total"), want["hash_join"]):
        _eq(j, getattr(r, field), f"hash_join {field}")
    if out_capacity == 200:
        assert int(r.total) > out_capacity      # the tail was dropped


def test_two_column_join_matches_its_packed_join():
    """A two-column equi-join (column tuples) against the same columns
    packed into one u32 word (the fig9 parity gate): every field equal."""
    rng = np.random.default_rng(9)
    bh, bl = (rng.integers(0, 1 << 4, 300).astype(np.uint32),
              rng.integers(1, 1 << 6, 300).astype(np.uint32))
    ph, pl = (rng.integers(0, 1 << 4, 300).astype(np.uint32),
              rng.integers(1, 1 << 6, 300).astype(np.uint32))
    for how in tjoin.HOW:
        rc = tjoin.hash_join((bh, bl), (ph, pl), 4096, how, device="cpu")
        rp = tjoin.hash_join((bh << 16) | bl, (ph << 16) | pl, 4096, how,
                             device="cpu")
        for field in ("build_idx", "probe_idx", "valid", "matched", "total"):
            assert torch.equal(getattr(rc, field), getattr(rp, field)), (
                how, field)


# ---------------------------------------------------------------------------
# the bridge: JAX group-by, counter and set state into the port and back
# ---------------------------------------------------------------------------

def _bridge(jt, device="cpu"):
    return convert.table_from_numpy(
        np.asarray(jt.store["keys"]), np.asarray(jt.store["values"]),
        int(jt.count), num_rows=jt.num_rows, window=jt.window,
        scheme=jt.scheme, seed=jt.seed, max_probes=jt.max_probes,
        device=device)


def test_convert_bridges_groupby_and_set_state_both_ways():
    """A JAX group-by table (two value words) and a JAX set (none) restore
    into the port; both packages then take the same batch, and the port's
    state comes back equal to the JAX package's."""
    rng = np.random.default_rng(11)
    keys = _draw(rng, _keys(rng, 60, 1), 200)
    vals = rng.integers(0, 2 ** 32, 200, dtype=np.uint32)
    step = jax.jit(lambda t, k, v: jgb.update(t, "max", k, v),
                   compiler_options=_FAST)
    jt, _ = step(jgb.create(256, window=8), keys[:100], vals[:100])
    tt = _bridge(jt)
    assert (tt.key_words, tt.value_words) == (1, 2)
    jt, js = step(jt, keys[100:], vals[100:])
    tt, ts = tgb.update(tt, "max", keys[100:], vals[100:])
    _eq(js, ts, "group-by status")
    back = convert.table_to_numpy(tt)
    _eq(jt.store["keys"], back["keys"], "group-by keys")
    _eq(jt.store["values"], back["values"], "group-by values")
    assert back["count"] == int(jt.count)

    add = jax.jit(jhs.add, compiler_options=_FAST)
    js_, _ = add(jhs.create(256, window=8), keys[:100])
    ts_ = _bridge(js_)
    assert ts_.value_words == 0
    js_, ja = add(js_, keys[100:])
    ts_, ta = ths.add(ts_, keys[100:])
    _eq(ja, ta, "set add")
    back = convert.table_to_numpy(ts_)
    _eq(js_.store["keys"], back["keys"], "set keys")
    assert back["values"].shape == (0, *back["keys"].shape[1:])
    assert back["count"] == int(js_.count) == ths.size(ts_)
