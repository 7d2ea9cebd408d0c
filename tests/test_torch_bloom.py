"""The port's blocked bloom filter against the JAX reference, bit-exact.

``repro_torch.core.bloom`` keeps packed u32 words where
``repro.core.bloom`` keeps one u8 per bit, so states are compared through
the bit view (``bloom.bits``, the reference's ``unpack_words`` layout) and
the ``convert`` bridge.  The same seeded numpy keys go through:

- ``repro.core.bloom`` (insert, contains, ``contains_stack``,
  ``rebuild_from_table``, ``fill_fraction``), jitted once per filter
  geometry;
- ``repro.kernels.bloom.ops.insert_words`` / ``query_words``, the Pallas
  kernels #9 and #10 in interpret mode, on packed words;
- ``tests/test_hash_tables.py::TestBloom``'s false-positive bound and pack
  round trip.

On the CPU the port's wrappers run the kernels' plain versions.  Every
comparison is of integers and bits, so the tolerance is zero.  Keys cover
the whole u32 range (the default seed and the step constant wrap u32),
with duplicates, masks and empty batches.  About 10 s on one core.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bloom as jbloom
from repro.core import single_value as jsv
from repro.kernels.bloom import ops as jbloom_ops
from repro_torch.core import bloom as tbloom
from repro_torch.core import convert
from repro_torch.core import single_value as tsv
from repro_torch.core.common import to_numpy_u32
from repro_torch.kernels.bloom import ops, ref

_FAST = {"xla_backend_optimization_level": 0,
         "xla_cpu_use_fusion_emitters": False}
_jit = {name: jax.jit(getattr(jbloom, name), compiler_options=_FAST)
        for name in ("insert", "contains", "contains_stack")}

N = 3000                   # keys per batch: one compile per geometry

#: (num_bits, block_bits, k, seed): the default, small and wide blocks, one
#: hash, many hashes, a seed below 2^31
GEOMETRIES = [(1 << 15, 512, 4, 0x9E3779B9), (1 << 14, 256, 1, 0x9E3779B9),
              (1 << 16, 1024, 8, 12345), (1 << 13, 32, 3, 0x9E3779B9),
              (1 << 15, 512, 17, 0xDEADBEEF)]


def _keys(rng, n):
    """u32 keys over the whole range, some repeated."""
    k = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    k[n // 2: n // 2 + n // 8] = k[: n // 8]
    return k


def _bits_equal(jf, tf):
    np.testing.assert_array_equal(np.asarray(jf.bits), convert.bloom_to_numpy(tf))


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_filter_matches_reference(geometry):
    num_bits, block_bits, k, seed = geometry
    rng = np.random.default_rng([num_bits, k])
    jf = jbloom.create(num_bits, k=k, block_bits=block_bits, seed=seed)
    tf = tbloom.create(num_bits, k=k, block_bits=block_bits, seed=seed,
                       device="cpu")
    assert (tf.num_blocks, tf.block_bits) == (jf.num_blocks, jf.block_bits)
    keys = _keys(rng, N)
    jb, jp = jbloom._positions(jf, jnp.asarray(keys))
    tb, tp = tbloom._positions(tf, keys)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    for step in range(2):
        mask = rng.random(N) < (0.5 if step == 0 else 0.9)
        batch = keys if step == 0 else _keys(rng, N)
        jf = _jit["insert"](jf, batch, jnp.asarray(mask))
        tbloom.insert(tf, batch, mask=mask)
        _bits_equal(jf, tf)
        queries = np.concatenate([batch, _keys(rng, N)])[:N]
        np.testing.assert_array_equal(
            np.asarray(_jit["contains"](jf, queries)),
            tbloom.contains(tf, queries).numpy())
    # the set bits agree exactly; the reference's float32 mean sums in
    # float32, so its fraction may differ in the last bits (rel 1e-6)
    assert int(ref.popcount(tf.words).sum()) == int(jf.bits.sum())
    assert float(tbloom.fill_fraction(tf)) == pytest.approx(
        float(jbloom.fill_fraction(jf)), rel=1e-6)
    np.testing.assert_array_equal(np.asarray(jbloom.pack_words(jf)),
                                  to_numpy_u32(tbloom.pack_words(tf)))


@pytest.mark.parametrize("k,block_bits", [(4, 512), (8, 256)])
def test_kernel_ops_match_pallas_interpret(k, block_bits):
    """The port's kernel ops on packed words against the Pallas kernels in
    interpret mode: masked inserts into a filter holding bits, then
    queries of inserted, masked-out and new keys."""
    rng = np.random.default_rng(k)
    num_blocks, wpb = 97, block_bits // 32
    start = rng.integers(0, 2 ** 32, (num_blocks, wpb), dtype=np.uint32)
    start &= rng.integers(0, 2 ** 32, start.shape, dtype=np.uint32)
    keys = _keys(rng, 700)
    mask = rng.random(700) < 0.6
    jw = jbloom_ops.insert_words(jnp.asarray(start), jnp.asarray(keys),
                                 jnp.asarray(mask), k_hashes=k,
                                 seed=0x9E3779B9, interpret=True)
    tw = torch.from_numpy(start.view(np.int32).copy())
    out = ops.insert_words(tw, torch.from_numpy(keys.view(np.int32)),
                           torch.from_numpy(mask), k_hashes=k,
                           seed=0x9E3779B9)
    assert out is tw                                  # updated in place
    np.testing.assert_array_equal(np.asarray(jw), to_numpy_u32(tw))
    queries = np.concatenate([keys, _keys(rng, 300)])
    np.testing.assert_array_equal(
        np.asarray(jbloom_ops.query_words(jw, jnp.asarray(queries),
                                          k_hashes=k, seed=0x9E3779B9,
                                          interpret=True)),
        ops.query_words(tw, torch.from_numpy(queries.view(np.int32)),
                        k_hashes=k, seed=0x9E3779B9).numpy())


def test_no_false_negatives_and_fp_bound():
    """``TestBloom``'s cases on the port: no false negatives; under 2%
    false positives at 32 bits per key, k = 4; the same hits as the
    reference on the absent keys."""
    jf = jbloom.insert(jbloom.create(1 << 15, k=4),
                       jnp.arange(1, 1001, dtype=jnp.uint32))
    tf = tbloom.create(1 << 15, k=4, device="cpu")
    tbloom.insert(tf, np.arange(1, 1001, dtype=np.uint32))
    assert bool(tbloom.contains(tf, np.arange(1, 1001, dtype=np.uint32)).all())
    absent = np.arange(10 ** 6, 10 ** 6 + 10000, dtype=np.uint32)
    fp = tbloom.contains(tf, absent)
    assert float(fp.float().mean()) < 0.02
    np.testing.assert_array_equal(np.asarray(jbloom.contains(jf, absent)),
                                  fp.numpy())


def test_pack_round_trip_and_bridge():
    """``TestBloom.test_pack_roundtrip`` on the port, and the ``convert``
    bridge both ways: a JAX filter's bits into port words and back."""
    tf = tbloom.create(1 << 12, k=3, device="cpu")
    tbloom.insert(tf, np.arange(1, 301, dtype=np.uint32))
    w = tbloom.pack_words(tf)
    f2 = tbloom.unpack_words(to_numpy_u32(w), tf.block_bits, tf.k, tf.seed,
                             device="cpu")
    assert torch.equal(tbloom.bits(f2), tbloom.bits(tf))
    assert torch.equal(ref.pack_bits(tbloom.bits(tf)), tf.words)
    jf = jbloom.insert(jbloom.create(1 << 12, k=3),
                       jnp.arange(1, 301, dtype=jnp.uint32))
    tj = convert.bloom_from_numpy(np.asarray(jf.bits), k=jf.k, seed=jf.seed,
                                  device="cpu")
    assert torch.equal(tj.words, tf.words)
    jback = jbloom.unpack_words(jnp.asarray(to_numpy_u32(tj.words)),
                                jf.block_bits, jf.k, jf.seed)
    np.testing.assert_array_equal(np.asarray(jback.bits), np.asarray(jf.bits))


def test_contains_stack_matches_reference():
    """Each key tested against its owner's plane of a (P, blocks, words)
    stack — one query over the stack, the reference's u8 gather."""
    rng = np.random.default_rng(5)
    p = 3
    jfs = [jbloom.create(1 << 13) for _ in range(p)]
    tfs = [tbloom.create(1 << 13, device="cpu") for _ in range(p)]
    for i in range(p):
        keys = _keys(rng, 400)
        jfs[i] = jbloom.insert(jfs[i], keys)
        tbloom.insert(tfs[i], keys)
    queries = _keys(rng, 1200)
    owners = rng.integers(0, p, 1200).astype(np.uint32)
    stack = torch.stack([f.words for f in tfs])
    got = tbloom.contains_stack(tfs[0], stack, owners, queries)
    want = _jit["contains_stack"](jfs[0], jnp.stack([f.bits for f in jfs]),
                                  jnp.asarray(owners), queries)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # one insert over the stack with a plane per key == P masked inserts
    words = torch.zeros_like(stack)
    keys = _keys(rng, 900)
    mask = rng.random(900) < 0.7
    ops.insert_words(words, torch.from_numpy(keys.view(np.int32)),
                     torch.from_numpy(mask), k_hashes=4, seed=0x9E3779B9,
                     planes=torch.from_numpy(owners[:900].astype(np.int64)))
    for i in range(p):
        jf = jbloom.insert(jbloom.create(1 << 13), keys,
                           jnp.asarray(mask & (owners[:900] == i)))
        np.testing.assert_array_equal(np.asarray(jf.bits),
                                      ref.unpack_bits(words[i]).numpy())


def test_masks_empty_batches_and_planes_out_of_range():
    tf = tbloom.create(1 << 12, device="cpu")
    empty = np.zeros(0, np.uint32)
    tbloom.insert(tf, empty)
    tbloom.insert(tf, empty, mask=np.zeros(0, bool))
    assert tbloom.contains(tf, empty).shape == (0,)
    assert not bool(tf.words.any())
    keys = np.arange(1, 65, dtype=np.uint32)
    tbloom.insert(tf, keys, mask=np.zeros(64, bool))      # all masked
    assert not bool(tf.words.any())
    jf = jbloom.insert(jbloom.create(1 << 12), jnp.asarray(empty))
    assert not bool(jf.bits.any())
    # a plane outside the stack is masked out and queries False
    stack = torch.zeros((2, tf.num_blocks, 16), dtype=torch.int32)
    planes = torch.tensor([0, 1, 2, -1] * 16)
    kw = torch.from_numpy(keys.view(np.int32))
    ops.insert_words(stack, kw, k_hashes=4, seed=tf.seed, planes=planes)
    lone = tbloom.create(1 << 12, device="cpu")
    tbloom.insert(lone, keys, mask=planes.numpy() == 0)
    assert torch.equal(stack[0], lone.words)
    hit = ops.query_words(stack, kw, k_hashes=4, seed=tf.seed, planes=planes)
    assert torch.equal(hit, (planes >= 0) & (planes < 2))
    with pytest.raises(ValueError, match="multiple of 32"):
        tbloom.create(1 << 12, block_bits=48, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        ops.query_words(stack.float(), kw, k_hashes=4, seed=1)


def test_rebuild_from_table_matches_reference():
    """The live set of a table with tombstones, re-advertised: bit-exact
    against the reference, and a subset of the incremental filter
    (``test_properties.py``'s rebuild property)."""
    rng = np.random.default_rng(9)
    keys = rng.choice(2 ** 32 - 2, 300, replace=False).astype(np.uint32)
    jt, _ = jax.jit(jsv.insert, compiler_options=_FAST)(
        jsv.create(512, window=16), keys, keys)
    jt, _ = jax.jit(jsv.erase, compiler_options=_FAST)(jt, keys[:150])
    tt = convert.table_from_numpy(
        np.asarray(jt.store["keys"]), np.asarray(jt.store["values"]),
        int(jt.count), num_rows=jt.num_rows, window=jt.window,
        scheme=jt.scheme, seed=jt.seed, max_probes=jt.max_probes,
        device="cpu")
    f_inc = tbloom.create(1 << 12, device="cpu")
    tbloom.insert(f_inc, tsv.key_hash_word(torch.from_numpy(
        keys.view(np.int32))))
    inc = tbloom.bits(f_inc)
    tf = tbloom.rebuild_from_table(f_inc, tt)
    assert tf is f_inc                                 # rebuilt in place
    jf = jax.jit(jbloom.rebuild_from_table, compiler_options=_FAST)(
        jbloom.create(1 << 12), jt)
    _bits_equal(jf, tf)
    assert bool((inc >= tbloom.bits(tf)).all())
    assert bool(tbloom.contains(tf, keys[150:]).all())


def test_cpu_filter_launches_no_kernel():
    ops.reset_launches()
    tf = tbloom.create(1 << 12, device="cpu")
    tbloom.insert(tf, np.arange(1, 101, dtype=np.uint32))
    tbloom.contains(tf, np.arange(1, 101, dtype=np.uint32))
    assert ops.LAUNCHES == {"bloom_insert": 0, "bloom_query": 0}


def test_create_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: create() uses it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbloom.create(1 << 12)


def test_insert_plan_picks_the_path_by_keys_per_sector():
    """``insert_plan``: the partitioned insert for chip_smoke.py phase 21's
    shape (2^28 keys into 2^32 bits), fig12's preload batches (2^24 keys
    into 8 planes of 16 bits per slot of 2^25 slots) and a shard's rebuild
    (2^25 slots into its plane); the direct insert for the serve step's
    2^20 keys into the 8 planes, for a filter no larger than one range, for
    one of more than ``MAX_TILES`` tiles and for an empty batch.  A
    partitioned plan's tiles cover the filter's rows, each at most
    ``TILE_WORDS`` words, and its ranges the tiles, each at most
    ``RANGE_BYTES``, at most ``MAX_LOCAL`` ranges of at most ``MAX_LOCAL``
    tiles."""
    from repro_torch.core.common import table_geometry
    stack = 8 * tbloom.num_blocks_for(16 * table_geometry(2 ** 25, 32)[1])
    shapes = {"phase 21": (2 ** 28, tbloom.num_blocks_for(2 ** 32), True),
              "preload": (2 ** 24, stack, True),
              "rebuild": (2 ** 25, stack // 8, True),
              "serve step": (2 ** 20, stack, False),
              "one range": (2 ** 28, ops.RANGE_BYTES // 64, False),
              "too many tiles": (2 ** 30, 2 ** 26, False),
              "empty": (0, stack, False)}
    for name, (n, rows, partitioned) in shapes.items():
        plan = ops.insert_plan(n, rows, 16)
        assert plan.partitioned == partitioned, (name, plan)
        if not partitioned:
            continue
        assert plan.rows_per_tile * 16 <= ops.TILE_WORDS, (name, plan)
        assert (plan.tiles - 1) * plan.rows_per_tile < rows <= (
            plan.tiles * plan.rows_per_tile), (name, plan)
        assert 2 <= plan.ranges <= ops.MAX_LOCAL, (name, plan)
        assert plan.tiles_per_range <= ops.MAX_LOCAL, (name, plan)
        assert (plan.tiles_per_range * plan.rows_per_tile * 64
                <= ops.RANGE_BYTES), (name, plan)
        assert (plan.ranges - 1) * plan.tiles_per_range < plan.tiles <= (
            plan.ranges * plan.tiles_per_range), (name, plan)
    odd = ops.insert_plan(2 ** 24, 3 * 2 ** 20, 3)
    assert odd.partitioned and odd.rows_per_tile == ops.TILE_WORDS // 3


def test_query_plan_picks_the_path_by_its_own_threshold():
    """``query_plan``: the insert's cut, at ``QUERY_KEYS_PER_SECTOR``.  The
    partitioned query for chip_smoke.py phase 21's shape (2^28 keys into
    2^32 bits, 16 keys a sector); the direct query for the serve step's
    2^20 lookups into fig12's 8 planes (1/16 a sector), a filter of one
    range, more than ``MAX_TILES`` tiles, an empty batch and any batch with
    a plane per key; at the threshold partitioned, one key below it
    direct."""
    from repro_torch.core.common import table_geometry
    stack = 8 * tbloom.num_blocks_for(16 * table_geometry(2 ** 25, 32)[1])
    shapes = {"phase 21": (2 ** 28, tbloom.num_blocks_for(2 ** 32), True),
              "serve step": (2 ** 20, stack, False),
              "one range": (2 ** 28, ops.RANGE_BYTES // 64, False),
              "too many tiles": (2 ** 30, 2 ** 26, False),
              "empty": (0, stack, False)}
    for name, (n, rows, partitioned) in shapes.items():
        plan = ops.query_plan(n, rows, 16)
        assert plan.partitioned == partitioned, (name, plan)
        if partitioned:
            assert plan == ops.insert_plan(n, rows, 16), name
    at = math.ceil(ops.QUERY_KEYS_PER_SECTOR * stack * 16 * 4 / 32)
    assert ops.query_plan(at, stack, 16).partitioned
    assert not ops.query_plan(at - 1, stack, 16).partitioned
    assert not ops.query_plan(2 ** 28, stack, 16, planes=True).partitioned
    assert ops.query_plan(at, stack, 16)[1:] == ops.insert_plan(
        2 ** 24, stack, 16)[1:]
