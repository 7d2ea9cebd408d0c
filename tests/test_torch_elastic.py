"""The port's elastic service and its substrate against the JAX reference,
bit-exact.

``repro_torch.serving.elastic`` (4 shards x 2048 slots, slack 2.5) and
``repro.serving.elastic`` take the same seeded mixed traffic: each step
upserts a batch (new keys, re-inserts, in-batch duplicates), looks up a
batch (present, erased and absent keys) through the bloom admission test,
and erases a batch (live, absent and repeated keys).  After every step the
statuses, values, found and erased flags, the ``stats`` dicts, every
shard's planes and count and every filter's bits (the port's packed words
unpacked) must be equal; then again after ``compact_all``, ``reshard``
4 -> 7 and 8 -> 3, and across ``save`` / ``load`` in both directions.
The substrate too: ``exchange.make_plan`` with and without a mask (and
overflow), ``multisplit``, ``owner_of``, ``migrate.live_entries`` /
``grow`` / ``compact`` on single- and multi-value tables, and snapshots
written by either package restored by the other (with torn and corrupted
files raising ``SnapshotError`` and the async writer's latest-wins).

On the CPU the port runs the kernels' plain versions and its bulk
engines, which replay the JAX engine's placement, so the planes agree bit
for bit; the tolerance is zero.  The reference runs jitted without XLA's
backend optimisation passes and CPU fusion emitters (the same integers,
compiled several times faster); its ``reshard`` runs as it is, with its
module's ``insert`` jitted the same way.  About 35 s on one core.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exchange as jex
from repro.core import hashset as jhs
from repro.core import migrate as jmig
from repro.core import multi_value as jmv
from repro.core import single_value as jsv
from repro.core import snapshot as jsnap
from repro.serving import elastic as jel
from repro_torch.core import bloom as tbloom
from repro_torch.core import exchange as tex
from repro_torch.core import hashset as ths
from repro_torch.core import migrate as tmig
from repro_torch.core import multi_value as tmv
from repro_torch.core import single_value as tsv
from repro_torch.core import snapshot as tsnap
from repro_torch.core.common import to_numpy_u32
from repro_torch.kernels.bloom import ops as bloom_ops
from repro_torch.kernels.bloom import ref as bloom_ref
from repro_torch.obs.registry import REGISTRY
from repro_torch.serving import elastic as tel

_FAST = {"xla_backend_optimization_level": 0,
         "xla_cpu_use_fusion_emitters": False}

P, CAP, SLACK = 4, 2048, 2.5
B = 512                    # upserts and lookups per step; B // 4 erases


def _np(x):
    if isinstance(x, torch.Tensor):
        return to_numpy_u32(x) if x.dtype == torch.int32 else x.numpy()
    return np.asarray(x)


def _eq(j, t, what):
    np.testing.assert_array_equal(np.asarray(j).astype(_np(t).dtype), _np(t),
                                  err_msg=what)


def _assert_table(jt, tt, what):
    _eq(jt.store["keys"], tt.store["keys"], f"{what} keys")
    _eq(jt.store["values"], tt.store["values"], f"{what} values")
    assert int(jt.count) == tt.count, what


def _assert_service(jst, tst, what):
    assert jst.num_shards == tst.num_shards and jst.slack == tst.slack
    for i, (js, ts) in enumerate(zip(jst.shards, tst.shards)):
        _assert_table(js, ts, f"{what} shard {i}")
        jf, tf = jst.filters[i], tst.filters[i]
        assert (jf.num_blocks, jf.block_bits, jf.k, jf.seed) == \
            (tf.num_blocks, tf.block_bits, tf.k, tf.seed), what
        np.testing.assert_array_equal(np.asarray(jf.bits),
                                      tbloom.bits(tf).numpy(),
                                      err_msg=f"{what} filter {i}")
    assert int(jel.count(jst)) == tel.count(tst)


def _jax_twin(tt, module, **kw):
    """The JAX table holding the port table's state (no JAX op runs)."""
    jt = module.create(tt.capacity, key_words=tt.key_words,
                       value_words=tt.value_words, window=tt.window,
                       scheme=tt.scheme, seed=tt.seed,
                       max_probes=tt.max_probes, **kw)
    return dataclasses.replace(
        jt, store={"keys": jnp.asarray(to_numpy_u32(tt.store["keys"])),
                   "values": jnp.asarray(to_numpy_u32(tt.store["values"]))},
        count=jnp.asarray(tt.count, jnp.int32))


def _traffic(rng, steps):
    """``steps`` batches (ins_keys, ins_vals, get_keys, del_keys) over
    distinct non-sentinel keys; absent lookups come from a disjoint range."""
    pool = rng.choice(2 ** 31, steps * B, replace=False).astype(np.uint32)
    absent = (rng.choice(2 ** 31 - 2, steps * B, replace=False)
              + 2 ** 31).astype(np.uint32)
    seen = np.zeros(0, np.uint32)
    for s in range(steps):
        fresh = pool[s * B:(s + 1) * B]
        again = seen[rng.integers(0, max(len(seen), 1), B // 4)] \
            if len(seen) else fresh[: B // 4]
        ins = np.concatenate([fresh[: B - B // 4], again])
        ins[B // 2: B // 2 + B // 16] = ins[: B // 16]          # duplicates
        seen = np.concatenate([seen, fresh[: B - B // 4]])
        vals = rng.integers(0, 2 ** 32, B, dtype=np.uint32)
        get = np.concatenate([seen[rng.integers(0, len(seen), B // 2)],
                              absent[s * B: s * B + B // 2]])
        dele = np.concatenate([seen[rng.integers(0, len(seen), B // 8)],
                               absent[s * B + B // 2: s * B + B // 2 + B // 16],
                               ins[: B // 16]])
        yield ins, vals, get, dele


def test_service_matches_reference(monkeypatch, tmp_path):
    rng = np.random.default_rng(16)
    jst = jel.create(P, CAP, bloom_bits_per_key=16, slack=SLACK)
    tst = tel.create(P, CAP, bloom_bits_per_key=16, slack=SLACK,
                     device="cpu")
    _assert_service(jst, tst, "fresh")
    jstep = jax.jit(jel.make_serve_step().__wrapped__, compiler_options=_FAST)
    for s, batch in enumerate(_traffic(rng, 4)):
        jst, jout = jstep(jst, *batch)
        tst, tout = tel.serve_step(tst, *batch)
        for name, j, t in zip(("status", "values", "found", "erased"),
                              jout[:4], tout[:4]):
            _eq(j, t, f"step {s} {name}")
        assert {k: int(v) for k, v in jout[4].items()} == \
            {k: int(v) for k, v in tout[4].items()}, f"step {s} stats"
        _assert_service(jst, tst, f"step {s}")
    assert int(tout[4]["false_positives"]) > 0    # erased keys advertise

    jst = jax.jit(jel.compact_all, compiler_options=_FAST)(jst)
    tst = tel.compact_all(tst)
    _assert_service(jst, tst, "compact_all")
    tel.check_ownership(tst)

    # the reference's reshard as it is, its inserts jitted
    monkeypatch.setattr(jel, "insert",
                        jax.jit(jel.insert, compiler_options=_FAST))
    for src, dst in ((P, 7), (8, 3)):
        if src != P:
            jst, tst = jel.reshard(jst, src), tel.reshard(tst, src)
        j2, t2 = jel.reshard(jst, dst), tel.reshard(tst, dst)
        _assert_service(j2, t2, f"reshard {src}->{dst}")
        tel.check_ownership(t2)

    # save / load across packages, both ways
    jel.save(j2, str(tmp_path / "jax"))
    t3 = tel.load(str(tmp_path / "jax"), device="cpu")
    _assert_service(j2, t3, "jax save -> port load")
    tel.save(t3, str(tmp_path / "port"))
    _assert_service(jel.load(str(tmp_path / "port")), t3,
                    "port save -> jax load")


def test_service_save_load_and_torn_state(tmp_path):
    """Within the port: save / load (sync and through the writer) is
    bit-exact, load onto another shard count reshards, and a torn or
    corrupted checkpoint raises ``SnapshotError``."""
    rng = np.random.default_rng(3)
    st = tel.create(3, 1024, slack=SLACK, device="cpu")
    keys = rng.choice(2 ** 32 - 2, 600, replace=False).astype(np.uint32)
    st, status = tel.insert(st, keys, keys)
    assert bool((status == 0).all())
    st, erased = tel.erase(st, keys[:100])
    assert bool(erased.all())
    path = str(tmp_path / "svc")
    with tsnap.SnapshotWriter() as w:
        tel.save(st, path, writer=w)
        w.flush()
    back = tel.load(path, device="cpu")
    for a, b in zip(st.shards, back.shards):
        assert torch.equal(a.store["keys"], b.store["keys"])
        assert torch.equal(a.store["values"], b.store["values"])
    vals, found, stats = tel.lookup(back, keys)
    assert torch.equal(found, torch.arange(600) >= 100)
    assert int(stats["skips"]) >= 1 and int(stats["overflow"]) == 0
    five = tel.load(path, num_shards=5, device="cpu")
    tel.check_ownership(five)
    assert tel.count(five) == 500
    os.remove(os.path.join(path, "shard_1.snap"))
    with pytest.raises(tsnap.SnapshotError, match="missing snapshot"):
        tel.load(path, device="cpu")
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        fh.write('{"version": ')
    with pytest.raises(tsnap.SnapshotError, match="corrupted"):
        tel.load(path, device="cpu")
    with pytest.raises(tsnap.SnapshotError, match="manifest"):
        tel.load(str(tmp_path / "nothing"), device="cpu")


def test_service_empty_and_masked_batches():
    """Empty batches route nothing; a fully masked insert stores nothing,
    reports STATUS_MASKED and leaves the filters empty, so every lookup is
    skipped."""
    st = tel.create(2, 256, device="cpu")
    empty = np.zeros(0, np.uint32)
    st, status = tel.insert(st, empty, empty)
    vals, found, stats = tel.lookup(st, empty)
    st, erased = tel.erase(st, empty)
    assert status.shape == vals.shape == found.shape == erased.shape == (0,)
    assert int(stats["probes"]) == 0
    keys = np.arange(1, 65, dtype=np.uint32)
    st, status = tel.insert(st, keys, keys, mask=np.zeros(64, bool))
    assert bool((status == 3).all()) and tel.count(st) == 0
    assert not bool(st.filter_words.any())
    vals, found, stats = tel.lookup(st, keys)
    assert not bool(found.any()) and not bool(vals.any())
    assert int(stats["skips"]) == 64 and int(stats["false_positives"]) == 0


def test_serve_traffic_counts_and_spans():
    rng = np.random.default_rng(4)
    st = tel.create(2, 1024, slack=SLACK, device="cpu")
    REGISTRY.reset()
    st, tracer, steps, totals = tel.serve_traffic(st, _traffic(rng, 3))
    assert steps == 3 and totals["probes"] == 3 * B
    assert totals["overflow"] == 0 and totals["skips"] >= B
    assert tracer.percentiles("elastic.serve_step")["count"] == 3
    snap = REGISTRY.snapshot()
    assert snap["elastic.bloom_probes"] == 3 * B
    assert snap["elastic.hits"] == totals["hits"]


@pytest.mark.parametrize("num_parts,cap,masked", [
    (4, 96, False), (4, 96, True), (5, 40, False), (3, 40, True),
    (1, 300, False), (6, 10, True)])
def test_exchange_plan_matches_reference(num_parts, cap, masked):
    """``make_plan`` (slot, valid_send, overflow — a small cap overflows),
    ``scatter_to_buffer`` / ``gather_from_buffer``, ``multisplit`` and
    ``owner_of`` for 1- and 2-word keys."""
    rng = np.random.default_rng([num_parts, cap])
    keys = rng.integers(0, 2 ** 32 - 2, 300, dtype=np.uint32)
    owners = np.asarray(jex.owner_of(jnp.asarray(keys), num_parts, 1))
    _eq(owners, tex.owner_of(keys, num_parts, 1), "owner_of")
    k2 = rng.integers(0, 2 ** 32 - 2, (300, 2), dtype=np.uint32)
    _eq(jex.owner_of(jnp.asarray(k2), num_parts, 2),
        tex.owner_of(k2, num_parts, 2), "owner_of kw=2")
    mask = rng.random(300) < 0.6 if masked else None
    jp = jex.make_plan(jnp.asarray(owners), num_parts, cap,
                       mask=None if mask is None else jnp.asarray(mask))
    to = torch.from_numpy(owners.astype(np.int64))
    tp = tex.make_plan(to, num_parts, cap,
                       mask=None if mask is None else torch.from_numpy(mask))
    _eq(jp.slot, tp.slot, "slot")
    _eq(jp.valid_send, tp.valid_send, "valid_send")
    assert int(jp.overflow) == int(tp.overflow) and jp.cap == tp.cap
    tk = torch.from_numpy(keys.view(np.int32))
    jbuf = jex.scatter_to_buffer(jp, jnp.asarray(keys), num_parts,
                                 fill=0xFFFFFFFF)
    tbuf = tex.scatter_to_buffer(tp, tk, num_parts, fill=-1)
    _eq(jbuf, tbuf, "scatter")
    _eq(jex.gather_from_buffer(jp, jbuf, fill=7),
        tex.gather_from_buffer(tp, tbuf, fill=7), "gather")
    js = jex.multisplit(jnp.asarray(owners), num_parts, jnp.asarray(keys))
    ts = tex.multisplit(to, num_parts, tk)
    for i, (a, b) in enumerate(zip(js, ts)):
        _eq(a, b, f"multisplit[{i}]")


#: (kind, key_words, window, scheme)
MIGRATIONS = [("sv", 1, 16, "cops"), ("sv", 2, 8, "linear"),
              ("mv", 1, 16, "cops")]


@pytest.mark.parametrize("kind,kw,window,scheme", MIGRATIONS)
def test_migration_matches_reference(kind, kw, window, scheme):
    """``live_entries``, ``grow`` (up and down) and ``compact`` of a table
    holding tombstones, against the JAX engine (jitted, capacity static)."""
    rng = np.random.default_rng([kw, window])
    tmod, jmod = (tsv, jsv) if kind == "sv" else (tmv, jmv)
    tt = tmod.create(512, key_words=kw, window=window, scheme=scheme,
                     device="cpu")
    keys = rng.integers(0, 2 ** 31, (300, kw), dtype=np.uint32)
    if kind == "mv":
        keys[150:] = keys[:150]                       # two values per key
    tt, _ = tmod.insert(tt, keys, rng.integers(0, 2 ** 32, 300,
                                               dtype=np.uint32))
    tt, _ = tmod.erase(tt, keys[:60])
    jt = _jax_twin(tt, jmod)
    jk, jv, jl = jmig.live_entries(jt)
    tk, tv, tl = tmig.live_entries(tt)
    for what, a, b in (("keys", jk, tk), ("values", jv, tv), ("live", jl, tl)):
        _eq(a, b, f"live_entries {what}")
    for new_cap in (1024, 400):
        jg = jax.jit(jmig.grow, static_argnums=1,
                     compiler_options=_FAST)(jt, new_cap)
        _assert_table(jg, tmig.grow(tt, new_cap), f"grow({new_cap})")
    _assert_table(jax.jit(jmig.compact, compiler_options=_FAST)(jt),
                  tmig.compact(tt), "compact")
    with pytest.raises(ValueError, match="too small"):
        tmig.grow(tt, 64)


def test_migration_refuses_bucket_lists():
    from repro_torch.core import bucket_list as tbl
    b = tbl.create(64, 128, device="cpu")
    for fn in (tmig.live_entries, tmig.compact):
        with pytest.raises(NotImplementedError, match="item 5b"):
            fn(b)
    with pytest.raises(NotImplementedError, match="item 8"):
        tsnap.snapshot_bytes(b)


def _snapshot_cases(rng):
    """(port table, reference module, JAX create kwargs) with tombstones."""
    keys = rng.choice(2 ** 32 - 2, 200, replace=False).astype(np.uint32)
    vals = rng.integers(0, 2 ** 32, 200, dtype=np.uint32)
    sv1 = tsv.create(256, device="cpu")
    sv1, _ = tsv.insert(sv1, keys, vals)
    sv1, _ = tsv.erase(sv1, keys[:40])
    sv2 = tsv.create(256, key_words=2, window=8, device="cpu")
    sv2, _ = tsv.insert(sv2, np.stack([keys, vals], 1), vals)
    hs = ths.create(256, device="cpu")
    hs, _ = ths.add(hs, keys)
    mv = tmv.create(256, window=16, scheme="linear", device="cpu")
    mv, _ = tmv.insert(mv, np.concatenate([keys[:60], keys[:60]]),
                       vals[:120])
    return [(sv1, jsv, {}), (sv2, jsv, {}), (hs, jsv, {}), (mv, jmv, {}),
            (sv1, jsv, {"backend": "pallas"})]


def test_snapshots_cross_packages(tmp_path):
    """A file from either package restores bit-exact in the other, and a
    JAX ``"jax"`` table and its port twin serialize to the same bytes."""
    for i, (tt, jmod, kw) in enumerate(_snapshot_cases(
            np.random.default_rng(7))):
        jt = _jax_twin(tt, jmod, **kw)
        if not kw:
            assert tsnap.snapshot_bytes(tt) == jsnap.snapshot_bytes(jt)
        p = str(tmp_path / f"j{i}.snap")
        jsnap.save(jt, p)
        back = tsnap.load(p, device="cpu")
        assert type(back) is type(tt)
        _assert_table(jt, back, f"case {i} jax -> port")
        assert (back.num_rows, back.window, back.key_words, back.value_words,
                back.scheme, back.seed, back.max_probes) == \
            (tt.num_rows, tt.window, tt.key_words, tt.value_words, tt.scheme,
             tt.seed, tt.max_probes)
        p = str(tmp_path / f"t{i}.snap")
        assert tsnap.save(tt, p) == os.path.getsize(p)
        jback = jsnap.load(p)
        assert type(jback) is type(jt) and jback.backend == "jax"
        _assert_table(jback, tt, f"case {i} port -> jax")


def test_snapshot_damage_raises(tmp_path):
    tt = _snapshot_cases(np.random.default_rng(8))[0][0]
    blob = tsnap.snapshot_bytes(tt)
    nl = blob.find(b"\n", len(tsnap.MAGIC))
    flipped = bytearray(blob)
    flipped[-40] ^= 0xFF
    header = json.loads(blob[len(tsnap.MAGIC):nl])
    del header["config"]["static"]["seed"]
    damaged = [(b"NOTASNAP" + blob[8:], "magic"), (blob[:20], "header"),
               (blob[:-100], "torn snapshot: payload"),
               (blob + b"\x00", "torn snapshot: payload"),
               (bytes(flipped), "sha256"),
               (blob[:len(tsnap.MAGIC)] + b'{"version": ' + blob[nl:],
                "header"),
               (blob.replace(b'"version": 1', b'"version": 99', 1), "version"),
               (tsnap.MAGIC + json.dumps(header).encode() + blob[nl:],
                "missing static field 'seed'")]
    for data, match in damaged:
        with pytest.raises(tsnap.SnapshotError, match=match):
            tsnap.restore_bytes(data, device="cpu")
    p = tmp_path / "x.snap"
    for data in (b"", b"\x00" * 256):
        p.write_bytes(data)
        with pytest.raises(tsnap.SnapshotError):
            tsnap.load(str(p), device="cpu")
    with pytest.raises(tsnap.SnapshotError, match="missing snapshot"):
        tsnap.load(str(tmp_path / "none.snap"), device="cpu")


def test_snapshot_writer_latest_wins(tmp_path):
    """Saves queued faster than the disk: the file ends with the freshest
    table; the host copy is taken at ``save``, so updating the table in
    place afterwards does not reach the queued snapshot; a failed write
    surfaces on ``flush``."""
    rng = np.random.default_rng(9)
    t = tsv.create(256, device="cpu")
    p = str(tmp_path / "w.snap")
    want = []
    with tsnap.SnapshotWriter() as w:
        for i in range(5):
            k = rng.choice(2 ** 32 - 2, 20, replace=False).astype(np.uint32)
            t, _ = tsv.insert(t, k, k)
            want.append(tsnap.snapshot_bytes(t))
            w.save(t, p)
            w.save(t, str(tmp_path / f"each{i}.snap"))
        w.flush()
        t, _ = tsv.insert(t, np.array([5, 6], np.uint32),
                          np.array([5, 6], np.uint32))
    with open(p, "rb") as fh:
        assert fh.read() == want[-1]
    for i in range(5):
        with open(tmp_path / f"each{i}.snap", "rb") as fh:
            assert fh.read() == want[i]
    w = tsnap.SnapshotWriter()
    w.save(t, str(tmp_path / "no" / "such" / "dir" / "x.snap"))
    with pytest.raises(OSError):
        w.flush()
    w.close()


def test_cpu_service_launches_no_kernel():
    bloom_ops.reset_launches()
    st = tel.create(2, 256, device="cpu")
    keys = np.arange(1, 101, dtype=np.uint32)
    st, _ = tel.insert(st, keys, keys)
    tel.lookup(st, keys)
    assert bloom_ops.LAUNCHES == {"bloom_insert": 0, "bloom_query": 0}
    # the stack is one tensor; each filter is a view of one plane
    assert st.filters[1].words.data_ptr() == st.filter_words[1].data_ptr()
    assert bool(bloom_ref.popcount(st.filter_words).sum() > 0)
