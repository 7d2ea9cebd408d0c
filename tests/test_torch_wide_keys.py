"""Two-word keys in the port (``key_words=2``: u64 keys and two-column
composite keys) against the JAX reference, bit-exact.

The same seeded numpy batches go through both packages on the CPU:
``backend="jax"`` (the bulk engines' general lane) and ``backend="pallas"``
(the two-plane Pallas kernels ``_insert64_kernel``, ``_lookup64_kernel``
and ``_retrieve64_kernel`` in interpret mode) on the JAX side; the port's
CPU path (the kernels' plain versions) on the other, once for each key
spelling: numpy ``uint64``, (n, 2) u32 planes and a tuple of two u32
columns.  Statuses, store planes, live counts, values, found masks, erase
results, per-query counts, offsets and ``retrieve_all`` values must be
equal; the arithmetic is integer, so the tolerance is zero.

The batches hold in-batch duplicates, keys that differ only in the high
word, masks, erases followed by re-inserts onto the tombstones, and keys
whose plane 1 is 0xFFFFFFFF or 0xFFFFFFFE (the sentinels' bits).  Each
case's JAX side is one jitted function per (backend, scheme, window),
compiled without XLA's backend optimisation passes and CPU fusion
emitters (the same integer results, compiled several times faster).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import common as jcommon
from repro.core import hashing as jh
from repro.core import multi_value as jmv
from repro.core import single_value as jsv
from repro_torch.core import common as tcommon
from repro_torch.core import convert
from repro_torch.core import hashing as th
from repro_torch.core import multi_value as tmv
from repro_torch.core import single_value as tsv
from repro_torch.core.common import (
    STATUS_INSERTED,
    STATUS_MASKED,
    STATUS_UPDATED,
    to_numpy_u32,
)
from repro_torch.kernels.cops import contract, ops

MIN_CAPACITY = 256
_FAST = {"xla_backend_optimization_level": 0,
         "xla_cpu_use_fusion_emitters": False}
SPELLINGS = ("u64", "planes", "columns")


def _planes(rng, n):
    """``n`` distinct two-word keys as (n, 2) u32 planes (lo, hi): plane 0
    from a small range, so many keys share it, and some plane-1 words are
    0xFFFFFFFF / 0xFFFFFFFE."""
    lo = rng.integers(1, 40, 4 * n).astype(np.uint64)
    hi = rng.integers(0, 2 ** 32, 4 * n, dtype=np.uint64)
    hi[: n // 8] = 0xFFFFFFFF
    hi[n // 8: n // 4] = 0xFFFFFFFE
    u = (hi << np.uint64(32)) | lo
    _, first = np.unique(u, return_index=True)
    u = u[np.sort(first)][:n]
    assert u.shape == (n,)
    u = u[rng.permutation(n)]
    return np.stack([(u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (u >> np.uint64(32)).astype(np.uint32)], axis=1)


def _spell(planes, spelling):
    """The same keys as numpy uint64, (n, 2) planes or (hi, lo) columns."""
    if spelling == "u64":
        return jcommon.join_u64(planes[:, 1], planes[:, 0])
    if spelling == "columns":
        return (planes[:, 1].copy(), planes[:, 0].copy())
    return planes


def _high_word_twins(planes):
    """Keys that share plane 0 with ``planes`` but not plane 1."""
    return planes ^ np.array([0, 1], np.uint32)


def _same(j, t):
    t = to_numpy_u32(t) if t.dtype == torch.int32 else t.numpy()
    np.testing.assert_array_equal(np.asarray(j).astype(t.dtype), t)


def _same_table(jt, tt):
    _same(jt.store["keys"], tt.store["keys"])
    _same(jt.store["values"], tt.store["values"])
    assert int(jt.count) == tt.count


# ---------------------------------------------------------------------------
# the word helpers
# ---------------------------------------------------------------------------

def test_combine_planes_bit_exact():
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)
    lo = rng.integers(0, 2 ** 32, 4096, dtype=np.uint32)
    hi[:4] = lo[4:8] = [0, 0xFFFFFFFF, 0xFFFFFFFE, 2 ** 31]
    got = th.combine_planes(torch.from_numpy(hi.view(np.int32)),
                            torch.from_numpy(lo.astype(np.int64)))
    np.testing.assert_array_equal(
        np.asarray(jh.combine_planes(jnp.asarray(hi), jnp.asarray(lo))),
        got.numpy())
    keys = torch.from_numpy(np.stack([lo, hi], 1).view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(jsv.key_hash_word(jnp.asarray(np.stack([lo, hi], 1)))),
        tsv.key_hash_word(keys).numpy())


def test_pack_and_unpack_columns_bit_exact():
    rng = np.random.default_rng(1)
    for ncols in (1, 2, 3):
        cols = tuple(rng.integers(0, 2 ** 32, 64, dtype=np.uint32)
                     for _ in range(ncols))
        want = np.asarray(jh.pack_columns(tuple(map(jnp.asarray, cols))))
        got = th.pack_columns(cols)
        _same(want, got)
        _same(jh.pack_columns(cols),
              th.pack_columns(tuple(torch.from_numpy(c.view(np.int32))
                                    for c in cols)))
        for j, t in zip(jh.unpack_columns(jnp.asarray(want)),
                        th.unpack_columns(got)):
            _same(j, t)
    with pytest.raises(ValueError):
        th.pack_columns(())
    with pytest.raises(ValueError):
        th.pack_columns((cols[0], cols[1][:5]))


def test_split_and_join_u64_bit_exact():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2 ** 64, 512, dtype=np.uint64)
    x[:3] = [0, 2 ** 64 - 1, 2 ** 63]
    jhi, jlo = jcommon.split_u64(x)
    for spelling in (x, torch.from_numpy(x.view(np.int64)).view(torch.uint64)):
        hi, lo = tcommon.split_u64(spelling)
        _same(jhi, hi)
        _same(jlo, lo)
    back = tcommon.join_u64(hi, lo)
    np.testing.assert_array_equal(back, jcommon.join_u64(jhi, jlo))
    np.testing.assert_array_equal(back, x)
    for wrong in (x.view(np.int64), torch.from_numpy(x.view(np.int64)),
                  list(x[:3])):
        with pytest.raises(TypeError):
            tcommon.split_u64(wrong)


def test_key_spellings_normalize_alike():
    planes = _planes(np.random.default_rng(3), 100)
    want = torch.from_numpy(planes.view(np.int32))
    for spelling in SPELLINGS:
        got = tsv.normalize_key_batch(_spell(planes, spelling), 2, "cpu")
        assert torch.equal(got, want), spelling
    u64 = torch.from_numpy(_spell(planes, "u64").view(np.int64))
    assert torch.equal(tsv.normalize_key_batch(u64.view(torch.uint64), 2,
                                               "cpu"), want)
    with pytest.raises(ValueError):
        tsv.normalize_key_batch(planes[:, 0], 2, "cpu")
    with pytest.raises(ValueError):
        tsv.normalize_key_batch(_spell(planes, "u64"), 1, "cpu")


# ---------------------------------------------------------------------------
# the single-value table
# ---------------------------------------------------------------------------

def _sv_round(t, k1, v1, m1, queries, gone, k2, v2, m2):
    """insert -> retrieve -> erase -> insert onto the tombstones ->
    retrieve / contains: the reference's whole case, one jitted function."""
    t1, s1 = jsv.insert(t, k1, v1, m1)
    r1 = jsv.retrieve(t1, queries)
    t2, e = jsv.erase(t1, gone)
    t3, s2 = jsv.insert(t2, k2, v2, m2)
    r2 = jsv.retrieve(t3, queries)
    return t1, s1, r1, t2, e, t3, s2, r2, jsv.contains(t3, queries)


_sv_jit = jax.jit(_sv_round, compiler_options=_FAST)


def _sv_data(seed, cap):
    rng = np.random.default_rng(seed)
    b = int(0.9 * cap)
    pool = _planes(rng, 2 * b)
    k1 = pool[:b].copy()
    k1[b - b // 8:] = k1[: b // 8]                      # duplicates
    k1[b // 2: b // 2 + b // 16] = _high_word_twins(k1[: b // 16])
    m1 = rng.random(b) < 0.9
    k2 = np.concatenate([k1[b // 4: 3 * b // 4], pool[b: b + b - b // 2]])
    k2[b - b // 16:] = k2[: b // 16]                    # duplicates
    m2 = rng.random(b) < 0.9
    queries = np.concatenate([k1, _high_word_twins(k1[:32]), pool[-32:]])
    return dict(k1=k1, v1=rng.integers(0, 2 ** 32, b, dtype=np.uint32), m1=m1,
                queries=queries, gone=k1[: b // 3],
                k2=k2, v2=rng.integers(0, 2 ** 32, b, dtype=np.uint32), m2=m2)


@functools.cache
def _sv_reference(backend, scheme, window):
    """(the case's data, the reference's outputs), computed once."""
    jt = jsv.create(MIN_CAPACITY, window=window, scheme=scheme, key_words=2,
                    backend=backend)
    d = _sv_data(window, jt.capacity)
    return d, _sv_jit(jt, d["k1"], d["v1"], jnp.asarray(d["m1"]),
                      d["queries"], d["gone"], d["k2"], d["v2"],
                      jnp.asarray(d["m2"]))


@pytest.mark.parametrize("backend, scheme, window", [
    ("jax", "cops", 8), ("pallas", "linear", 32)])
def test_single_value_parity_with_jax(backend, scheme, window):
    d, (jt1, js1, jr1, jt2, je, jt3, js2, jr2, jc) = _sv_reference(
        backend, scheme, window)
    for spelling in SPELLINGS:
        def sp(x):
            return _spell(x, spelling)
        tt = tsv.create(MIN_CAPACITY, window=window, scheme=scheme,
                        key_words=2, device="cpu")
        tt, ts1 = tsv.insert(tt, sp(d["k1"]), d["v1"], mask=d["m1"])
        _same(js1, ts1)
        _same_table(jt1, tt)
        for j, t in zip(jr1, tsv.retrieve(tt, sp(d["queries"]))):
            _same(j, t)
        tt, te = tsv.erase(tt, sp(d["gone"]))
        _same(je, te)
        _same_table(jt2, tt)
        tt, ts2 = tsv.insert(tt, sp(d["k2"]), d["v2"], mask=d["m2"])
        _same(js2, ts2)
        _same_table(jt3, tt)
        for j, t in zip(jr2, tsv.retrieve(tt, sp(d["queries"]))):
            _same(j, t)
        _same(jc, tsv.contains(tt, sp(d["queries"])))
        assert bool((ts2 == STATUS_UPDATED).any()
                    and (ts2 == STATUS_INSERTED).any()
                    and (ts2 == STATUS_MASKED).any())


# ---------------------------------------------------------------------------
# the multi-value table
# ---------------------------------------------------------------------------

def _mv_round(t, k1, v1, m1, queries, qmask, gone, k2, v2, m2, cap):
    """append -> count / retrieve_all -> erase -> append onto the
    tombstones -> count / retrieve_all: one jitted function."""
    t1, s1 = jmv.insert(t, k1, v1, m1)
    c1 = jmv.count_values(t1, queries, qmask)
    r1 = jmv.retrieve_all(t1, queries, cap, qmask)
    t2, e = jmv.erase(t1, gone)
    t3, s2 = jmv.insert(t2, k2, v2, m2)
    c2 = jmv.count_values(t3, queries, qmask)
    r2 = jmv.retrieve_all(t3, queries, cap, qmask)
    return t1, s1, c1, r1, t2, e, t3, s2, c2, r2


_mv_jit = jax.jit(_mv_round, static_argnums=10, compiler_options=_FAST)


@functools.cache
def _mv_reference(backend, scheme, window):
    """(the case's data, the reference's outputs), computed once."""
    jt = jmv.create(MIN_CAPACITY, window=window, scheme=scheme, key_words=2,
                    backend=backend)
    cap = jt.capacity
    rng = np.random.default_rng([window, 7])
    b = int(0.6 * cap)
    pool = _planes(rng, b)
    base = pool[: (b + 2) // 3]
    k1 = np.repeat(base, 3, axis=0)[:b]
    k1[b - b // 8:] = _high_word_twins(k1[: b // 8])
    k2 = np.concatenate([k1[: b // 4], np.repeat(pool[b // 2:], 2, axis=0)])[:b]
    queries = np.concatenate([base, base[:16], _high_word_twins(base[:16]),
                              pool[-16:]])
    d = dict(k1=k1, v1=rng.integers(0, 2 ** 32, b, dtype=np.uint32),
             m1=rng.random(b) < 0.9, queries=queries,
             qmask=rng.random(queries.shape[0]) < 0.85,
             gone=np.concatenate([base[: b // 16], base[:2]]), k2=k2,
             v2=rng.integers(0, 2 ** 32, b, dtype=np.uint32),
             m2=rng.random(b) < 0.9, out_cap=cap // 2)
    return d, _mv_jit(jt, d["k1"], d["v1"], jnp.asarray(d["m1"]),
                      d["queries"], jnp.asarray(d["qmask"]), d["gone"],
                      d["k2"], d["v2"], jnp.asarray(d["m2"]), d["out_cap"])


@pytest.mark.parametrize("backend, scheme, window", [
    ("jax", "linear", 1), ("pallas", "cops", 8)])
def test_multi_value_parity_with_jax(backend, scheme, window):
    d, (jt1, js1, jc1, jr1, jt2, je, jt3, js2, jc2, jr2) = _mv_reference(
        backend, scheme, window)
    k1, v1, m1, k2, v2, m2 = (d[k] for k in ("k1", "v1", "m1", "k2", "v2",
                                             "m2"))
    queries, qmask, gone, out_cap = (d[k] for k in ("queries", "qmask",
                                                    "gone", "out_cap"))
    for spelling in SPELLINGS:
        def sp(x):
            return _spell(x, spelling)
        tt = tmv.create(MIN_CAPACITY, window=window, scheme=scheme,
                        key_words=2, device="cpu")
        tt, ts1 = tmv.insert(tt, sp(k1), v1, mask=m1)
        _same(js1, ts1)
        _same_table(jt1, tt)
        _same(jc1, tmv.count_values(tt, sp(queries), mask=qmask))
        for j, t in zip(jr1, tmv.retrieve_all(tt, sp(queries), out_cap,
                                              mask=qmask)):
            _same(j, t)
        tt, te = tmv.erase(tt, sp(gone))
        _same(je, te)
        _same_table(jt2, tt)
        tt, ts2 = tmv.insert(tt, sp(k2), v2, mask=m2)
        _same(js2, ts2)
        _same_table(jt3, tt)
        _same(jc2, tmv.count_values(tt, sp(queries), mask=qmask))
        for j, t in zip(jr2, tmv.retrieve_all(tt, sp(queries), out_cap,
                                              mask=qmask)):
            _same(j, t)
        assert int(te.sum()) > 0 and bool((ts2 == STATUS_INSERTED).any())


# ---------------------------------------------------------------------------
# the bridge, the wrappers, the contract and the refusals
# ---------------------------------------------------------------------------

def test_bridge_carries_two_key_planes():
    """A JAX-built two-plane store with tombstones crosses the numpy bridge
    and back, for both tables, and the port goes on from it as the
    reference does."""
    d, out = _sv_reference("jax", "cops", 8)
    md, mout = _mv_reference("jax", "linear", 1)
    for bridge, cls, (jt, jt3), data, go_on in (
            (convert.table_from_numpy, tsv.SingleValueHashTable,
             (out[3], out[5]), d, tsv.insert),
            (convert.multi_table_from_numpy, tmv.MultiValueHashTable,
             (mout[4], mout[6]), md, tmv.insert)):
        tt = bridge(np.asarray(jt.store["keys"]),
                    np.asarray(jt.store["values"]), int(jt.count),
                    num_rows=jt.num_rows, window=jt.window, scheme=jt.scheme,
                    seed=jt.seed, max_probes=jt.max_probes, device="cpu")
        assert isinstance(tt, cls) and tt.key_words == 2
        _same_table(jt, tt)
        back = convert.table_to_numpy(tt)
        np.testing.assert_array_equal(back["keys"],
                                      np.asarray(jt.store["keys"]))
        assert back["count"] == int(jt.count)
        tt, _ = go_on(tt, data["k2"], data["v2"], mask=data["m2"])
        _same_table(jt3, tt)


def _cpu_store(seed=5):
    t = tsv.create(MIN_CAPACITY, window=8, key_words=2, device="cpu")
    planes = _planes(np.random.default_rng(seed), 180)
    t, _ = tsv.insert(t, planes, planes[:, 1])
    t, _ = tsv.erase(t, planes[::4])
    kw = dict(seed=t.seed, scheme=t.scheme, max_probes=t.num_rows)
    return t, torch.from_numpy(planes.view(np.int32)), kw


def test_cpu_wrappers64_are_the_plain_versions():
    t, keys, kw = _cpu_store()
    kp, vp = contract.table_planes(t)
    ops.reset_launches()
    got = ops.lookup64(kp, vp, keys, slots=True, **kw)
    assert all(torch.equal(a, b) for a, b in
               zip(got, ops.lookup_plain(kp, vp, keys, slots=True, **kw)))
    every = torch.ones(keys.shape[0], dtype=torch.bool)
    got = ops.retrieve_walk64(kp, keys, every, collect=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ops.retrieve_walk_plain(
        kp, keys, every, collect=True, **kw)))
    for wrapper, plain, extra in ((ops.insert64, ops.insert_plain,
                                   {"count": t.count}),
                                  (ops.append64, ops.append_plain, {})):
        planes = [(kp.clone(), vp.clone()) for _ in range(2)]
        s1 = wrapper(*planes[0], keys, keys[:, 0], **extra, **kw)
        s2 = plain(*planes[1], keys, keys[:, 0], **extra, **kw)
        assert torch.equal(s1, s2)
        assert all(torch.equal(a, b) for a, b in zip(*planes))
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_wrappers64_refuse_other_shapes():
    t, keys, kw = _cpu_store()
    kp, vp = contract.table_planes(t)
    with pytest.raises(ValueError):
        ops.lookup64(kp[0], vp, keys, **kw)          # one plane
    with pytest.raises(ValueError):
        ops.lookup64(kp, vp, keys[:, 0], **kw)       # 1-word keys
    with pytest.raises(ValueError):
        ops.lookup(kp, vp, keys, **kw)               # the u32 wrapper
    with pytest.raises(ValueError):
        ops.insert64(kp, vp, keys, keys[:5, 0], count=0, **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.append64(kp.to("meta"), vp.to("meta"), keys.to("meta"),
                     keys[:, 0].to("meta"), **kw)


def test_contract64_catches_a_wrong_high_word():
    """A store whose one key has the wrong plane 1 fails the same-map /
    same-pairs part, and, as that key now lies off its own walk, the
    before-first-EMPTY part of the append."""
    t, keys, kw = _cpu_store()
    good = contract.table_planes(t)
    st = torch.zeros(4, dtype=torch.int32)
    assert all(contract.check_insert(good, good, st, st, **kw).values())
    bad = tuple(x.clone() for x in good)
    slot = contract.live_map(*bad)[2][0]
    bad[0].view(2, -1)[1, slot] ^= 1
    assert not contract.check_insert(bad, good, st, st, **kw)["same_map"]
    res = contract.check_append(bad, good, keys[:4], st, st, **kw)
    assert not res["same_pairs"] and not res["before_first_empty"], res
    assert all(contract.check_append(good, good, keys[:4], st, st,
                                     **kw).values())


@pytest.mark.parametrize("key_words", [1, 2])
def test_contract_cases64_run_on_cpu(key_words):
    """The card's kernel-vs-plain cases, run where both sides are the
    plain versions: every check holds, with shared plane-0 words."""
    single = contract.run_case(600, window=8, scheme="cops", device="cpu",
                               key_words=key_words)
    multi = contract.run_multi_case(600, window=4, scheme="linear",
                                    device="cpu", key_words=key_words)
    assert len(single) == 8 and all(single.values()), single
    assert len(multi) == 24 and all(multi.values()), multi


def test_distinct_keys64():
    keys = contract.distinct_keys64(0, 50000, "cpu", shared=True)
    words = contract.bulk.pack_keys(keys)
    assert keys.shape == (50000, 2)
    assert torch.unique(words).shape[0] == 50000
    lo, hi = tcommon.as_u32(keys[:, 0]), tcommon.as_u32(keys[:, 1])
    assert not bool((lo >= 0xFFFFFFFE).any())
    assert int((lo <= contract.SHARED_WORDS).sum()) >= 12000
    assert bool((hi == 0xFFFFFFFF).any() and (hi == 0xFFFFFFFE).any())
    more = contract.distinct_keys64(60000, 1000, "cpu", shared=True)
    both = torch.cat([words, contract.bulk.pack_keys(more)])
    assert torch.unique(both).shape[0] == 51000


@pytest.mark.parametrize("create", [tsv.create, tmv.create])
@pytest.mark.parametrize("kwargs", [{"key_words": 3}, {"value_words": 2},
                                    {"key_words": 2, "value_words": 2}])
def test_wider_configurations_refuse_naming_item_2b(create, kwargs):
    if create is tsv.create and "value_words" in kwargs:
        # the single-value table carries two value words (the group-by's)
        kwargs = {**kwargs, "value_words": 3}
    with pytest.raises(NotImplementedError, match="item 2b"):
        create(64, device="cpu", **kwargs)


def test_two_word_table_is_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: create() uses it")
    for create in (tsv.create, tmv.create):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create(64, key_words=2)


def test_empty_and_masked_two_word_batches():
    planes = _planes(np.random.default_rng(6), 8)
    tt = tsv.create(64, key_words=2, device="cpu")
    tt, st = tsv.insert(tt, planes, planes[:, 0], mask=np.zeros(8, bool))
    assert bool((st == STATUS_MASKED).all()) and tt.count == 0
    tt, st = tsv.insert(tt, planes[:0], planes[:0, 0])
    assert st.shape == (0,)
    mt = tmv.create(64, key_words=2, device="cpu")
    assert tmv.count_values(mt, planes[:0]).shape == (0,)
    mt, e = tmv.erase(mt, planes)
    assert not bool(e.any())
    mt, st = tmv.insert(mt, _spell(planes, "columns"), planes[:, 0])
    assert mt.count == 8
    assert mt.key_words == 2
