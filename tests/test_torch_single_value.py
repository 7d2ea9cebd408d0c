"""The port's single-value table (``repro_torch.core.single_value``) against
the JAX reference (``repro.core.single_value``), bit-exact.

The same seeded numpy batches go through both packages on the CPU:
``backend="jax"`` (the bulk engines) and ``backend="pallas"`` (the COPS
kernels in interpret mode, as ``tests/test_kernels.py`` runs them) on
the JAX side; the port's CPU path (the kernels' plain versions) on the
other.  Store planes, statuses, counts, values, found and erased masks
must be equal; the arithmetic is integer, so the tolerance is zero.

Shapes are fixed per window so that the jitted JAX reference compiles
once per (backend, scheme, window) and serves every load factor.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import single_value as jsv
from repro_torch.core import convert
from repro_torch.core import single_value as tsv
from repro_torch.core.common import (
    STATUS_FULL,
    STATUS_INSERTED,
    STATUS_MASKED,
    STATUS_UPDATED,
    to_numpy_u32,
)
from repro_torch.kernels.cops import ops

MIN_CAPACITY = 512          # W=1: 521 slots ... W=128: 640 slots (<= 2^12)

#: the reference ops, jitted without XLA's backend optimisation passes and
#: its CPU fusion emitters: integer results are the same, and each
#: compiles several times faster
_jit = {name: jax.jit(getattr(jsv, name),
                      compiler_options={"xla_backend_optimization_level": 0,
                                        "xla_cpu_use_fusion_emitters": False})
        for name in ("insert", "retrieve", "contains", "erase")}


def _keys(rng, n):
    """Distinct u32 keys over the whole range (values >= 2^31 included),
    never a sentinel."""
    return rng.choice(2 ** 32 - 2, size=n, replace=False).astype(np.uint32)


def _vals(rng, n):
    return rng.integers(0, 2 ** 32, n, dtype=np.uint32)


def _assert_tables(jt, tt):
    np.testing.assert_array_equal(np.asarray(jt.store["keys"]),
                                  to_numpy_u32(tt.store["keys"]))
    np.testing.assert_array_equal(np.asarray(jt.store["values"]),
                                  to_numpy_u32(tt.store["values"]))
    assert int(jt.count) == tt.count


def _assert_same(j, t):
    t = to_numpy_u32(t) if t.dtype == torch.int32 else t.numpy()
    np.testing.assert_array_equal(np.asarray(j).astype(t.dtype), t)


def _bulk(jt):
    """The JAX table as the bulk engines see it: with ``backend="pallas"``
    erase and contains run ``repro.core.bulk_retrieve`` all the same, so
    they share the ``"jax"`` compilation."""
    return dataclasses.replace(jt, backend="jax")


def _scenario(backend, scheme, window, rho, seed=0):
    """insert (duplicates + mask) -> retrieve -> erase -> upsert onto
    tombstones -> retrieve / contains, compared after every step.  Every
    insert batch has the same (b,) shape and a mask, so each jitted
    reference op compiles once per (backend, scheme, window)."""
    rng = np.random.default_rng([seed, window, int(rho * 100)])
    jt = jsv.create(MIN_CAPACITY, window=window, scheme=scheme,
                    backend=backend)
    tt = tsv.create(MIN_CAPACITY, window=window, scheme=scheme, device="cpu")
    cap = jt.capacity
    b = int(1.1 * cap)
    pool = _keys(rng, 2 * b)
    keys, fresh = pool[:b].copy(), pool[b:]
    live = int(rho * cap)
    keys[live - live // 16: live] = keys[: live // 16]     # duplicates
    mask = np.arange(b) < live
    mask &= rng.random(b) < 0.95                            # masked holes
    vals = _vals(rng, b)

    jt, js = _jit["insert"](jt, keys, vals, jnp.asarray(mask))
    tt, ts = tsv.insert(tt, keys, vals, mask=mask)
    _assert_same(js, ts)
    _assert_tables(jt, tt)

    queries = np.concatenate([keys, fresh[:64]])
    jv, jf = _jit["retrieve"](jt, queries)
    tv, tf = tsv.retrieve(tt, queries)
    _assert_same(jv, tv)
    _assert_same(jf, tf)

    gone = keys[: b // 3]
    jt2, je = _jit["erase"](_bulk(jt), gone)
    jt = dataclasses.replace(jt2, backend=backend)
    tt, te = tsv.erase(tt, gone)
    _assert_same(je, te)
    _assert_tables(jt, tt)

    # half present keys (some erased, so tombstones get reused), half new
    half = b // 4
    k2 = np.concatenate([keys[half: 3 * half], fresh[64: 64 + b - 2 * half]])
    dups = b // 32
    k2[2 * half - dups: 2 * half] = k2[:dups]                 # duplicates
    m2 = np.arange(b) < 2 * half + b // 4
    v2 = _vals(rng, b)
    jt, js = _jit["insert"](jt, k2, v2, jnp.asarray(m2))
    tt, ts = tsv.insert(tt, k2, v2, mask=m2)
    _assert_same(js, ts)
    _assert_tables(jt, tt)

    jv, jf = _jit["retrieve"](jt, queries)
    tv, tf = tsv.retrieve(tt, queries)
    _assert_same(jv, tv)
    _assert_same(jf, tf)
    _assert_same(_jit["contains"](_bulk(jt), queries),
                 tsv.contains(tt, queries))
    return np.asarray(js)


@pytest.mark.parametrize("rho", [0.5, 0.9])
@pytest.mark.parametrize("window", [1, 8, 32, 128])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_parity_with_jax(backend, scheme, window, rho):
    status = _scenario(backend, scheme, window, rho)
    assert (status == STATUS_INSERTED).any() and (status == STATUS_UPDATED).any()


@pytest.mark.parametrize("window", [1, 8, 32, 128])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
def test_parity_near_full(scheme, window):
    """More live keys than slots: FULL statuses and the store they leave
    must match the reference too."""
    rng = np.random.default_rng(window)
    jt = jsv.create(MIN_CAPACITY, window=window, scheme=scheme,
                    backend="jax")
    tt = tsv.create(MIN_CAPACITY, window=window, scheme=scheme, device="cpu")
    b = int(1.1 * jt.capacity)
    keys, vals = _keys(rng, b), _vals(rng, b)
    every = np.ones(b, bool)            # the scenario's compiled signature
    jt, js = _jit["insert"](jt, keys, vals, jnp.asarray(every))
    tt, ts = tsv.insert(tt, keys, vals, mask=every)
    _assert_same(js, ts)
    _assert_tables(jt, tt)
    assert (ts == STATUS_FULL).sum() == b - tt.capacity
    assert tt.load_factor() == 1.0


def test_masked_and_empty_batches():
    rng = np.random.default_rng(1)
    tt = tsv.create(256, device="cpu")
    keys, vals = _keys(rng, 8), _vals(rng, 8)
    tt, st = tsv.insert(tt, keys, vals, mask=np.zeros(8, bool))
    assert bool((st == STATUS_MASKED).all()) and tt.count == 0
    tt, st = tsv.insert(tt, keys[:0], vals[:0])
    assert st.shape == (0,) and tt.count == 0
    v, f = tsv.retrieve(tt, keys[:0])
    assert v.shape == f.shape == (0,)
    tt, e = tsv.erase(tt, keys[:0])
    assert e.shape == (0,)


def test_start_from_jax_state():
    """A JAX-built store with tombstones crosses the numpy bridge and both
    packages go on from it identically."""
    rng = np.random.default_rng(5)
    jt = jsv.create(1024, window=16, backend="jax")
    keys, vals = _keys(rng, 900), _vals(rng, 900)
    jt, _ = _jit["insert"](jt, keys, vals)
    jt, _ = _jit["erase"](jt, keys[::3])
    tt = convert.table_from_numpy(
        np.asarray(jt.store["keys"]), np.asarray(jt.store["values"]),
        int(jt.count), num_rows=jt.num_rows, window=jt.window,
        scheme=jt.scheme, seed=jt.seed, max_probes=jt.max_probes,
        device="cpu")
    _assert_tables(jt, tt)
    back = convert.table_to_numpy(tt)
    np.testing.assert_array_equal(back["keys"], np.asarray(jt.store["keys"]))
    assert back["count"] == int(jt.count)
    more = np.concatenate([keys[::3][:100], _keys(rng, 100)])
    mv = _vals(rng, 200)
    jt, js = _jit["insert"](jt, more, mv)
    tt, ts = tsv.insert(tt, more, mv)
    _assert_same(js, ts)
    _assert_tables(jt, tt)
    jv, jf = _jit["retrieve"](jt, keys)
    tv, tf = tsv.retrieve(tt, keys)
    _assert_same(jv, tv)
    _assert_same(jf, tf)


def test_torch_key_spellings_agree():
    """numpy u32, torch int32 / uint32 and (n, 1) keys give the same table."""
    rng = np.random.default_rng(2)
    keys, vals = _keys(rng, 300), _vals(rng, 300)
    spellings = [keys, torch.from_numpy(keys.view(np.int32)),
                 torch.from_numpy(keys.view(np.int32)).view(torch.uint32),
                 keys[:, None]]
    planes = []
    for k in spellings:
        tt = tsv.create(512, window=8, device="cpu")
        tt, _ = tsv.insert(tt, k, vals)
        planes.append(to_numpy_u32(tt.store["keys"]))
    for p in planes[1:]:
        np.testing.assert_array_equal(planes[0], p)


@pytest.mark.parametrize("kwargs", [
    {"key_words": 3}, {"value_words": 3}, {"scheme": "quadratic"},
    {"scheme": "bucketed"}, {"layout": "aos"}, {"layout": "packed"},
    {"layout": "bucketedq"},
])
def test_unported_configurations_refuse(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tsv.create(64, device="cpu", **kwargs)


def _stats_calls():
    """Every table entry point that takes the reference's ``stats``."""
    from repro_torch.core import bucket_list as tbl
    from repro_torch.core import multi_value as tmv
    k = np.arange(1, 9, dtype=np.uint32)
    sv_t = lambda: tsv.create(64, device="cpu")              # noqa: E731
    mv_t = lambda: tmv.create(64, device="cpu")              # noqa: E731
    bl_t = lambda: tbl.create(64, 128, device="cpu")         # noqa: E731
    return {
        "sv.insert": lambda st: tsv.insert(sv_t(), k, k, stats=st),
        "sv.retrieve": lambda st: tsv.retrieve(sv_t(), k, stats=st),
        "sv.update_values": lambda st: tsv.update_values(
            sv_t(), k, ("add",), 1, combine=("add",), stats=st),
        "mv.insert": lambda st: tmv.insert(mv_t(), k, k, stats=st),
        "mv.count_values": lambda st: tmv.count_values(mv_t(), k, stats=st),
        "mv.retrieve_all": lambda st: tmv.retrieve_all(mv_t(), k, 16,
                                                       stats=st),
        "bl.insert": lambda st: tbl.insert(bl_t(), k, k, stats=st),
        "bl.count_values": lambda st: tbl.count_values(bl_t(), k, stats=st),
        "bl.retrieve_all": lambda st: tbl.retrieve_all(bl_t(), k, 16,
                                                       stats=st),
    }


@pytest.mark.parametrize("entry", sorted(_stats_calls()))
def test_stats_keyword(entry):
    """The reference's ``stats`` keyword: on the single- and multi-value
    tables ``True`` runs and returns the ``stats=False`` outputs with a
    ``TableStats`` beside them (``tests/test_torch_metrics.py`` holds the
    stats to the reference); the bucket list refuses it naming ROADMAP.md
    item 5b."""
    from repro_torch.obs.metrics import TableStats
    call = _stats_calls()[entry]
    plain = call(False)
    if entry.startswith("bl."):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue 1 item 5b"):
            call(True)
        return
    got = call(True)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert len(got) == len(plain) + 1
    assert isinstance(got[-1], TableStats)
    for a, b in zip(got, plain):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            for k in a.store:
                assert torch.equal(a.store[k], b.store[k])


def test_unknown_configurations_raise():
    with pytest.raises(ValueError):
        tsv.create(64, scheme="cuckoo", device="cpu")
    with pytest.raises(ValueError):
        tsv.create(64, window=3, device="cpu")
    with pytest.raises(ValueError, match="words"):
        tsv.insert(tsv.create(64, device="cpu"),
                   np.zeros((4, 2), np.uint32), np.zeros(4, np.uint32))


def test_create_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: create() uses it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsv.create(64)


def test_cpu_table_launches_no_kernel():
    ops.reset_launches()
    tt = tsv.create(256, device="cpu")
    keys = np.arange(1, 101, dtype=np.uint32)
    tt, _ = tsv.insert(tt, keys, keys)
    tsv.retrieve(tt, keys)
    tsv.erase(tt, keys[:10])
    tt, _ = tsv.update_values(tt, keys, ("add",), 1, combine=("add",))
    assert set(ops.LAUNCHES) >= {"cops_insert", "cops_lookup", "cops_update"}
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_package_imports_neither_jax_nor_repro():
    """Every module of repro_torch imports, both tables run their u32 and
    two-word key paths (every key spelling), and the bucket list, the
    minhash sketches, the counting table, the hash set, the relational
    operators (group-by, DISTINCT, the four joins), a bloom filter and a
    small elastic service (insert, lookup, erase, compaction, reshard, a
    grown shard's snapshot) and flash attention (grouped heads and
    panels) run, on the CPU, without pulling in JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import numpy as np\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.core import convert, multi_value as mv, "
        "single_value as sv\n"
        "k64 = np.arange(1, 41, dtype=np.uint64) * np.uint64(2 ** 33 + 3)\n"
        "cols = (np.arange(40, dtype=np.uint32), np.arange(1, 41, "
        "dtype=np.uint32))\n"
        "for kw, keys in ((1, cols[1]), (2, k64), (2, cols)):\n"
        "    t = sv.create(128, key_words=kw, device='cpu')\n"
        "    t, _ = sv.insert(t, keys, cols[0])\n"
        "    sv.retrieve(t, keys); sv.contains(t, keys)\n"
        "    t, _ = sv.erase(t, keys)\n"
        "    convert.table_to_numpy(t)\n"
        "    m = mv.create(128, key_words=kw, device='cpu')\n"
        "    m, _ = mv.insert(m, keys, cols[0])\n"
        "    mv.count_values(m, keys); mv.retrieve_all(m, keys, 64)\n"
        "    mv.erase(m, keys)\n"
        "from repro_torch.core import bucket_list as bl\n"
        "from repro_torch.kernels.minhash import ops as mh\n"
        "reads = np.arange(120, dtype=np.uint8).reshape(3, 40) % 5\n"
        "sk = mh.sketch_reads(reads, k=16, s=8, device='cpu')\n"
        "b = bl.create(128, 256, device='cpu')\n"
        "b, _ = bl.insert(b, cols[1], cols[0])\n"
        "bl.count_values(b, cols[1]); bl.retrieve_all(b, cols[1], 64)\n"
        "convert.bucket_table_to_numpy(b)\n"
        "from repro_torch.core import counting, hashset\n"
        "from repro_torch.relational import distinct, groupby, join\n"
        "for kw, keys in ((1, cols[1]), (2, k64), (2, cols)):\n"
        "    c = counting.create(128, key_words=kw, device='cpu')\n"
        "    c, _ = counting.insert(c, keys); counting.counts(c, keys)\n"
        "    s = hashset.create(128, key_words=kw, device='cpu')\n"
        "    s, _ = hashset.add(s, keys); hashset.contains(s, keys)\n"
        "    s, _ = hashset.remove(s, keys)\n"
        "    for agg in groupby.AGGS:\n"
        "        g = groupby.create(128, key_words=kw, device='cpu')\n"
        "        g, _ = groupby.update(g, agg, keys, cols[0])\n"
        "        groupby.lookup(g, agg, keys); groupby.finalize(g, agg)\n"
        "    convert.table_to_numpy(g)\n"
        "    distinct.distinct(keys, 64, device='cpu')\n"
        "    for how in join.HOW:\n"
        "        r = join.hash_join(keys, keys, 64, how, device='cpu')\n"
        "        join.gather_payload(r, cols[0], cols[0])\n"
        "from repro_torch.core import bloom, migrate, snapshot\n"
        "from repro_torch.serving import elastic\n"
        "f = bloom.create(1 << 12, device='cpu')\n"
        "bloom.insert(f, cols[1]); bloom.contains(f, cols[0])\n"
        "convert.bloom_from_numpy(convert.bloom_to_numpy(f), k=4, seed=1, "
        "device='cpu')\n"
        "st = elastic.create(3, 256, device='cpu')\n"
        "st, _ = elastic.insert(st, cols[1], cols[0])\n"
        "elastic.lookup(st, cols[0]); st, _ = elastic.erase(st, cols[1][:9])\n"
        "st = elastic.reshard(elastic.compact_all(st), 2)\n"
        "elastic.check_ownership(st)\n"
        "snapshot.restore_bytes(snapshot.snapshot_bytes(migrate.grow("
        "st.shards[0], 512)), device='cpu')\n"
        "import torch\n"
        "from repro_torch.kernels.flash import ops as fl\n"
        "x = torch.ones(1, 64, 4, 16)\n"
        "fl.flash_attention(x, x[:, :, :2], x[:, :, :2])\n"
        "fl.flash_call(x[0], x[0], x[0], causal=False)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith"
        "('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[-1]) >= 39
