"""The port's bucket list (``repro_torch.core.bucket_list``) against the JAX
reference (``repro.core.bucket_list``), bit-exact.

The same seeded numpy batches go through both packages on the CPU: the
JAX side on ``backend="jax"`` (the batched build and fused retrieval),
``"pallas"`` (the bucket-walk tile in interpret mode) and ``"scan"`` (the
sequential reference); the port's CPU path (the kernels' plain versions)
on the other.  Key-store planes (keys and packed handles), the pool,
``alloc_top``, the key count, statuses, ``count_values``,
``retrieve_all`` and the storage density must be equal; the arithmetic is
integer, so the tolerance is zero.

Every scenario keeps one batch shape and one query shape, so that the
jitted reference compiles once per table configuration (backend, scheme,
window and the static growth schedule, pool and key capacity).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucket_list as jbl
from repro.kernels.minhash import ops as jmh
from repro_torch.core import bucket_list as tbl
from repro_torch.core import convert
from repro_torch.core.common import (
    STATUS_FULL,
    STATUS_INSERTED,
    STATUS_MASKED,
    STATUS_POOL_FULL,
    to_numpy_u32,
)
from repro_torch.kernels.cops import ops
from repro_torch.kernels.minhash import ops as tmh

BATCH = 256
CAPS = (1024, 37)           # a whole retrieval, and a truncated one
QUERIES = 60


def _ref_round(table, keys, values, mask, queries, caps):
    """The reference's insert of one batch, then its reads of the table
    it leaves: ``retrieve_all`` at each output capacity, and
    ``count_values``."""
    table, status = jbl.insert(table, keys, values, mask)
    found = [jbl.retrieve_all(table, queries, cap) for cap in caps]
    return table, status, found, jbl.count_values(table, queries)


#: jit without XLA's backend optimisation passes and its CPU fusion
#: emitters: integer results are the same, and it compiles 3-5x faster
_FAST = {"xla_backend_optimization_level": 0,
         "xla_cpu_use_fusion_emitters": False}
_round = jax.jit(_ref_round, static_argnums=5, compiler_options=_FAST)


def _u32(t):
    return to_numpy_u32(t) if t.dtype == torch.int32 else t.numpy()


def _assert_same(j, t):
    t = _u32(t)
    np.testing.assert_array_equal(np.asarray(j).astype(t.dtype), t)


def _assert_tables(jt, tt):
    """Key-store planes (keys + handles), pool, alloc_top, counts and the
    storage density, bit for bit."""
    for name in ("keys", "values"):
        np.testing.assert_array_equal(np.asarray(jt.key_store.store[name]),
                                      to_numpy_u32(tt.key_store.store[name]))
    np.testing.assert_array_equal(np.asarray(jt.pool), to_numpy_u32(tt.pool))
    assert int(jt.alloc_top) == tt.alloc_top
    assert int(jt.num_keys()) == tt.num_keys()
    assert np.float32(jt.storage_density()) == np.float32(tt.storage_density())


def _both_rounds(jt, tt, keys, values, mask, queries):
    """One round on both packages, compared after each operation; returns
    the two tables and the port's statuses."""
    jt, js, found, counts = _round(jt, keys, values, jnp.asarray(mask),
                                   queries, CAPS)
    tt, ts = tbl.insert(tt, keys, values, mask)
    _assert_same(js, ts)
    _assert_tables(jt, tt)
    for cap, jout in zip(CAPS, found):
        for j, t in zip(jout, tbl.retrieve_all(tt, queries, cap)):
            _assert_same(j, t)
    _assert_same(counts, tbl.count_values(tt, queries))
    return jt, tt, ts


def _pair(backend, scheme, window, growth, s0, key_capacity, pool_capacity):
    kw = dict(s0=s0, growth=growth, window=window, scheme=scheme)
    return (jbl.create(key_capacity, pool_capacity, backend=backend, **kw),
            tbl.create(key_capacity, pool_capacity, device="cpu", **kw))


#: (backend, scheme, window, growth, s0, key capacity, pool capacity,
#: key range of the batches, what the last batch must report)
SCENARIOS = [
    ("jax", "cops", 32, 1.1, 1, 2048, 1 << 14, 40, STATUS_INSERTED),
    ("scan", "cops", 32, 1.1, 1, 256, 4096, 40, STATUS_INSERTED),
    ("pallas", "cops", 32, 1.1, 1, 256, 4096, 40, STATUS_INSERTED),
    ("jax", "linear", 8, 1.0, 4, 256, 4096, 40, STATUS_INSERTED),
    ("jax", "cops", 8, 1.5, 2, 512, 40, 12, STATUS_POOL_FULL),
    ("scan", "linear", 8, 1.1, 1, 8, 4096, 200, STATUS_FULL),
]


@pytest.mark.parametrize(
    "backend, scheme, window, growth, s0, key_capacity, pool_capacity, "
    "key_range, expect", SCENARIOS)
def test_parity_with_jax(backend, scheme, window, growth, s0, key_capacity,
                         pool_capacity, key_range, expect):
    """Three batches: duplicates within and across batches, a mask, the
    growth schedule's buckets opening in and across batches; each followed
    by retrievals of present, absent and duplicate keys, whole and
    truncated.  The small pool runs out (POOL_FULL), the 8-slot key store
    fills (FULL)."""
    rng = np.random.default_rng([window, s0, pool_capacity])
    jt, tt = _pair(backend, scheme, window, growth, s0, key_capacity,
                   pool_capacity)
    queries = np.concatenate([np.arange(1, 41, dtype=np.uint32),
                              np.arange(1, 11, dtype=np.uint32),
                              np.arange(1000, 1010, dtype=np.uint32)])
    assert queries.shape == (QUERIES,)
    seen = []
    for b in range(3):
        keys = rng.integers(1, key_range, BATCH, dtype=np.uint32)
        vals = rng.integers(0, 2 ** 32, BATCH, dtype=np.uint32)
        mask = rng.random(BATCH) < 0.9
        jt, tt, ts = _both_rounds(jt, tt, keys, vals, mask, queries)
        seen.append(ts.numpy())
    seen = np.concatenate(seen)
    assert (seen == STATUS_MASKED).any() and (seen == expect).any()


def test_empty_batches():
    """An empty insert changes nothing; an empty query batch gives empty
    counts and offsets [0] — on both packages."""
    jt, tt = _pair(*SCENARIOS[0][:7])
    rng = np.random.default_rng(11)
    keys = rng.integers(1, 40, BATCH, dtype=np.uint32)
    jt, tt, _ = _both_rounds(jt, tt, keys, keys, np.ones(BATCH, bool),
                             keys[:QUERIES])
    none = np.zeros((0,), np.uint32)
    jt2, js = jbl.insert(jt, jnp.asarray(none), jnp.asarray(none))
    tt2, ts = tbl.insert(tt, none, none)
    assert ts.shape == (0,) and js.shape == (0,)
    _assert_tables(jt2, tt2)
    for j, t in zip(jbl.retrieve_all(jt, jnp.asarray(none), 16),
                    tbl.retrieve_all(tt, none, 16)):
        _assert_same(j, t)
    assert tbl.count_values(tt, none).shape == (0,)


def test_convert_both_ways():
    """A JAX-built table crosses to the port, a port-built one to JAX, and
    each pair goes on identically."""
    rng = np.random.default_rng(12)
    batches = [(rng.integers(1, 40, BATCH, dtype=np.uint32),
                rng.integers(0, 2 ** 32, BATCH, dtype=np.uint32))
               for _ in range(2)]
    queries = np.arange(1, QUERIES + 1, dtype=np.uint32)
    every = np.ones(BATCH, bool)
    jt, tt = _pair(*SCENARIOS[0][:7])
    jt = _round(jt, *batches[0], jnp.asarray(every), queries, CAPS)[0]
    tt, _ = tbl.insert(tt, *batches[0])
    # JAX -> port
    tj = convert.bucket_table_from_numpy(
        np.asarray(jt.key_store.store["keys"]),
        np.asarray(jt.key_store.store["values"]), int(jt.key_store.count),
        np.asarray(jt.pool), int(jt.alloc_top),
        num_rows=jt.key_store.num_rows, window=jt.key_store.window,
        scheme=jt.key_store.scheme, seed=jt.key_store.seed,
        max_probes=jt.key_store.max_probes, s0=jt.s0, growth=jt.growth,
        sizes=jt.sizes, cum=jt.cum, device="cpu")
    assert isinstance(tj, tbl.BucketListHashTable)
    _assert_tables(jt, tj)
    # port -> JAX
    back = convert.bucket_table_to_numpy(tt)
    ks = jt.key_store
    jback = dataclasses.replace(
        jt, key_store=dataclasses.replace(
            ks, store={"keys": jnp.asarray(back["keys"]),
                       "values": jnp.asarray(back["values"])},
            count=jnp.asarray(back["count"], jnp.int32)),
        pool=jnp.asarray(back["pool"]),
        alloc_top=jnp.asarray(back["alloc_top"], jnp.int32))
    _assert_tables(jback, tt)
    for j, t in ((jt, tj), (jback, tt)):
        _both_rounds(j, t, *batches[1], every, queries)
    with pytest.raises(ValueError, match="schedule"):
        convert.bucket_table_from_numpy(
            back["keys"], back["values"], back["count"], back["pool"],
            back["alloc_top"], num_rows=ks.num_rows, window=ks.window,
            scheme=ks.scheme, seed=ks.seed, max_probes=ks.max_probes, s0=2,
            growth=1.1, sizes=jt.sizes, cum=jt.cum, device="cpu")


def test_metagenomics_pipeline_classifies():
    """Mini Fig. 8, as ``tests/test_system.py`` runs it on the JAX package
    (with the table of ``examples/metagenomics.py``: s0 = 1, growth 1.1):
    genomes -> minhash sketches -> bucket list -> reads classified by
    k-mer votes.  Both packages build the same table and predict the same
    genome for every read."""
    rng = np.random.default_rng(42)
    k, s, n_genomes = 16, 24, 4
    genomes = [rng.integers(0, 4, 2000).astype(np.uint8)
               for _ in range(n_genomes)]
    jt, tt = _pair(*SCENARIOS[0][:7])   # room for 4 x BATCH keys
    nothing = np.zeros(QUERIES, np.uint32)
    for gid, g in enumerate(genomes):
        sk = np.asarray(jmh.sketch_reads(jnp.asarray(g[None]), k=k,
                                         s=BATCH))[0]
        np.testing.assert_array_equal(
            sk, to_numpy_u32(tmh.sketch_reads(g[None], k=k, s=BATCH,
                                              device="cpu"))[0])
        # the sketch's INVALID padding masked out (one batch shape)
        hashes = np.minimum(sk, 0xFFFFFFFD)
        live = sk != 0xFFFFFFFF
        gids = np.full(hashes.shape, gid, np.uint32)
        jt, js = _round(jt, hashes, gids, jnp.asarray(live), nothing,
                        CAPS)[:2]
        tt, ts = tbl.insert(tt, hashes, gids, live)
        assert (ts.numpy()[live] == STATUS_INSERTED).all()
        _assert_same(js, ts)
    _assert_tables(jt, tt)

    reads, truth = [], []
    for _ in range(12):
        gid = int(rng.integers(0, n_genomes))
        start = int(rng.integers(0, 1500))
        reads.append(genomes[gid][start:start + 400])
        truth.append(gid)
    reads = np.stack(reads)
    jsk = np.asarray(jmh.sketch_reads(jnp.asarray(reads), k=k, s=s))
    tsk = to_numpy_u32(tmh.sketch_reads(reads, k=k, s=s, device="cpu"))
    np.testing.assert_array_equal(jsk, tsk)
    valid = jsk != 0xFFFFFFFF
    q = np.minimum(jsk[valid], 0xFFFFFFFD)
    read_of = np.nonzero(valid)[0]
    cap = len(q) * 8
    jout = jax.jit(jbl.retrieve_all, static_argnums=2,
                   compiler_options=_FAST)(jt, jnp.asarray(q), cap)
    tout = tbl.retrieve_all(tt, q, cap)
    for j, t in zip(jout, tout):
        _assert_same(j, t)
    preds = []
    for out, off, cnt in (jout, tout):
        out, cnt = np.asarray(_u32(out) if isinstance(out, torch.Tensor)
                              else out), np.asarray(cnt)
        hits = out[:int(np.asarray(off)[-1])]
        votes = np.zeros((len(reads), n_genomes), np.int64)
        np.add.at(votes, (np.repeat(read_of, cnt), hits), 1)
        preds.append(votes.argmax(1))
    np.testing.assert_array_equal(preds[0], preds[1])
    assert (preds[1] == np.asarray(truth)).sum() >= 12 * 0.75


def test_sorted_domain_matches_reference():
    """``bulk._sort_batch`` and ``_group_structure`` of 1-word keys (the
    build's sorted domain: unsigned key order, masked elements last,
    batch order within a key) against the JAX engine's."""
    from repro.core import bulk as jbulk
    from repro_torch.core import bulk as tbulk
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 2 ** 32 - 2, 300, dtype=np.uint32)
    keys[100:200] = keys[:100]                  # duplicates, across halves
    keys[:10] = np.uint32(0x80000000) + np.arange(10, dtype=np.uint32)
    mask = rng.random(300) < 0.8
    vals = np.arange(300, dtype=np.uint32)
    def ref(k, m, v):
        flag, skeys, sidx, svals = jbulk._sort_batch(k[:, None], m, [v])
        return (flag, skeys[:, 0], sidx, svals[0]), jbulk._group_structure(
            flag, skeys)

    want, jgroups = jax.jit(ref, compiler_options=_FAST)(keys, mask, vals)
    tflag, tkeys, tidx, (tvals,) = tbulk._sort_batch(
        torch.from_numpy(keys.view(np.int32)), torch.from_numpy(mask),
        [torch.from_numpy(vals.view(np.int32))])
    for j, t in zip(want, (tflag, tkeys, tidx, tvals)):
        _assert_same(j, t)
    for j, t in zip(jgroups, tbulk._group_structure(tflag, tkeys)):
        _assert_same(j, t)


def test_handles_and_schedule():
    """The handle words and the growth schedule are the JAX package's; a
    count of 2^21 or more sets word 1's top bit and still unpacks."""
    count = np.array([0, 1, 5, 2 ** 21, jbl.MAX_COUNT], np.int32)
    bidx = np.array([0, 3, 63, 7, 255], np.int32)
    ptr = np.array([0, 17, 2 ** 31 - 1, 5, 9], np.uint32)
    state = np.full(5, jbl.STATE_READY, np.int32)
    jh = np.asarray(jbl.pack_handle(jnp.asarray(ptr), jnp.asarray(count),
                                    jnp.asarray(bidx), jnp.asarray(state)))
    th = tbl.pack_handle(torch.from_numpy(ptr.astype(np.int64)),
                         torch.from_numpy(count), torch.from_numpy(bidx),
                         tbl.STATE_READY)
    np.testing.assert_array_equal(jh, to_numpy_u32(th))
    for j, t in zip(jbl.unpack_handle(jnp.asarray(jh)), tbl.unpack_handle(th)):
        np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                      t.numpy())
    for s0, growth, pool in ((1, 1.1, 4096), (8, 1.0, 100), (2, 1.5, 40),
                             (1, 2.0, 1 << 30)):
        assert (tbl.growth_schedule(s0, growth, pool)
                == jbl.growth_schedule(s0, growth, pool))


def test_cpu_table_launches_no_kernel():
    ops.reset_launches()
    tt = tbl.create(256, 1024, device="cpu")
    keys = np.repeat(np.arange(1, 31, dtype=np.uint32), 3)
    tt, _ = tbl.insert(tt, keys, keys)
    tbl.count_values(tt, keys)
    tbl.retrieve_all(tt, keys, 300)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_unported_configurations_refuse():
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 5b"):
        tbl.create(64, 64, key_words=2, device="cpu")
    for kwargs in ({"key_words": 3}, {"scheme": "quadratic"},
                   {"scheme": "bucketed"}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tbl.create(64, 64, device="cpu", **kwargs)
    with pytest.raises(ValueError):
        tbl.create(64, 64, scheme="cuckoo", device="cpu")
    with pytest.raises(ValueError):
        tbl.insert(tbl.create(64, 64, device="cpu"), np.ones(4, np.uint32),
                   np.ones(3, np.uint32))


def test_key_store_refuses_single_value_calls():
    """The key store's values are two-word handles: the single-value
    insert, whose kernels store one value word, refuses it, whatever the
    values' width, as ``single_value.create`` refuses ``value_words=3``."""
    from repro_torch.core import single_value as tsv
    ks = tbl.create(64, 64, device="cpu").key_store
    keys = np.arange(1, 5, dtype=np.uint32)
    for call in (lambda: tsv.insert(ks, keys, keys),
                 lambda: tsv.insert(ks, keys, np.stack([keys, keys], 1)),
                 lambda: tsv.create(64, value_words=3, device="cpu")):
        with pytest.raises(NotImplementedError, match="item 2b"):
            call()


def test_create_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: create() uses it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbl.create(64, 64)
