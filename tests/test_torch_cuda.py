"""The port's CUDA kernels held against their plain versions on the card.

Needs a CUDA card and nvcc; every test here skips without a card.  On a
machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bucket_list as bl
from repro_torch.core import bulk
from repro_torch.core import multi_value as mv
from repro_torch.core import single_value as sv
from repro_torch.core.common import (
    STATUS_FULL,
    STATUS_INSERTED,
    STATUS_MASKED,
    STATUS_UPDATED,
    SUPPORTED_WINDOWS,
    TOMBSTONE_WORD,
    to_numpy_u32,
)
from repro_torch.kernels.cops import contract, ops
from repro_torch.kernels.minhash import ops as mh
from repro_torch.kernels.minhash.ref import INVALID_WORD

#: every launch counter at zero
_NONE = dict.fromkeys(ops.LAUNCHES, 0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", SUPPORTED_WINDOWS)
def test_kernels_hold_to_plain(window, scheme):
    """Insert under the four-part contract, lookup bit-exact, at rho 0.9
    with tombstones and in-batch duplicates."""
    _need_card()
    checks = contract.run_case(1 << 14, window=window, scheme=scheme,
                               device="cuda")
    torch.cuda.synchronize()
    assert all(checks.values()), checks


@pytest.mark.cuda
def test_table_on_card_goes_through_kernels():
    """The public entry points on a CUDA table launch both kernels and
    agree with the same operations on a CPU table: in-batch duplicates,
    a mask, upserts, erases and re-inserts into tombstones."""
    _need_card()
    rng = np.random.default_rng(0)
    keys = rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), 3000,
                      replace=False)
    vals = rng.integers(0, 2 ** 32, 3000, dtype=np.uint32)
    dup_keys = np.concatenate([keys[:1000], keys[:200]])
    mask = rng.random(dup_keys.shape[0]) < 0.9
    ops.reset_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        t = sv.create(4096, window=32, device=dev)
        t, st1 = sv.insert(t, keys, vals)
        t, st2 = sv.insert(t, dup_keys, dup_keys ^ 1, mask=mask)
        t, erased = sv.erase(t, keys[:500])
        t, st3 = sv.insert(t, keys[:600], vals[:600])
        v, f = sv.retrieve(t, keys)
        out[dev] = (st1.cpu(), st2.cpu(), erased.cpu(), st3.cpu(),
                    to_numpy_u32(v), f.cpu(), sv.contains(t, keys).cpu(),
                    t.count)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {**_NONE, "cops_insert": 3, "cops_lookup": 3}
    gpu, cpu = out["cuda"], out["cpu"]
    assert bool((gpu[0] == STATUS_INSERTED).all())
    assert bool(((gpu[1] == STATUS_UPDATED) | (gpu[1] == STATUS_MASKED)).all())
    for a, b in zip(gpu, cpu):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8, 32])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", SUPPORTED_WINDOWS)
def test_multi_value_kernels_hold_to_plain(window, scheme, r):
    """The append under the multi-value contract, the retrieve walk
    bit-exact, at load 0.8 with r consecutive duplicates, tombstones,
    duplicate and masked queries."""
    _need_card()
    checks = contract.run_multi_case(1 << 14, window=window, scheme=scheme,
                                     device="cuda", r=r)
    torch.cuda.synchronize()
    assert all(checks.values()), checks


def _segments(values, offsets, counts):
    """Each query's values as a sorted tuple (placement sets the order)."""
    v, o = to_numpy_u32(values), offsets.cpu().numpy()
    return [tuple(sorted(v[o[i]:o[i] + c])) for i, c in
            enumerate(counts.cpu().numpy())]


@pytest.mark.cuda
def test_multi_value_table_on_card_goes_through_kernels():
    """The multi-value entry points on a CUDA table launch the append and
    retrieve kernels and agree with a CPU table, per-key multisets."""
    _need_card()
    rng = np.random.default_rng(1)
    base = rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), 400,
                      replace=False)
    keys = np.repeat(base, 5)
    vals = np.arange(keys.shape[0], dtype=np.uint32)
    mask = rng.random(keys.shape[0]) < 0.9
    queries = np.concatenate([base, base[:50], base[:20] + (1 << 20)])
    qmask = rng.random(queries.shape[0]) < 0.8
    ops.reset_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        t = mv.create(4096, window=32, device=dev)
        t, st1 = mv.insert(t, keys, vals, mask=mask)
        c = mv.count_values(t, queries, mask=qmask)
        # sized by the counting pass: no segment is cut, so each holds the
        # same multiset whatever the slot placement
        seg1 = _segments(*mv.retrieve_all(t, queries, int(c.sum()),
                                          mask=qmask))
        t, erased = mv.erase(t, base[:100])
        t, st2 = mv.insert(t, keys[:300], vals[:300] + 5000)
        seg2 = _segments(*mv.retrieve_all(t, queries, 3000, mask=qmask))
        out[dev] = {"status1": st1.cpu(), "counts": c.cpu(), "seg1": seg1,
                    "erased": erased.cpu(), "status2": st2.cpu(),
                    "seg2": seg2, "count": t.count}
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {**_NONE, "cops_append": 2, "cops_retrieve": 4}
    gpu, cpu = out["cuda"], out["cpu"]
    assert bool(((gpu["status1"] == STATUS_INSERTED)
                 | (gpu["status1"] == STATUS_MASKED)).all())
    for name, a in gpu.items():
        b = cpu[name]
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), name


# ---------------------------------------------------------------------------
# two-word keys: cops_insert64, cops_append64, cops_lookup64, cops_retrieve64
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", SUPPORTED_WINDOWS)
def test_kernels64_hold_to_plain(window, scheme):
    """The two-plane kernels against their plain versions: the insert and
    the append under their contracts, the lookup and the retrieve walk
    bit-exact; a quarter of the keys share 2^10 plane-0 words, some with
    plane 1 at 0xFFFFFFFF / 0xFFFFFFFE."""
    _need_card()
    single = contract.run_case(1 << 14, window=window, scheme=scheme,
                               device="cuda", key_words=2)
    multi = contract.run_multi_case(1 << 14, window=window, scheme=scheme,
                                    device="cuda", key_words=2)
    torch.cuda.synchronize()
    assert all(single.values()), single
    assert all(multi.values()), multi


def _u64(lo, hi):
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


@pytest.mark.cuda
def test_wide_key_tables_on_card_go_through_kernels():
    """The public entry points of both tables on CUDA ``key_words=2``
    tables launch the 64-bit kernels and agree with CPU tables, whatever
    the key spelling (numpy uint64, (n, 2) planes, a column tuple)."""
    _need_card()
    rng = np.random.default_rng(2)
    lo = rng.integers(1, 64, 3000).astype(np.uint32)
    hi = rng.integers(0, 2 ** 32, 3000, dtype=np.uint32)
    hi[:40], hi[40:80] = 0xFFFFFFFF, 0xFFFFFFFE
    u64 = np.unique(_u64(lo, hi))[:2000]
    rng.shuffle(u64)
    planes = np.stack([(u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                       (u64 >> np.uint64(32)).astype(np.uint32)], axis=1)
    cols = (planes[:, 1], planes[:, 0])
    vals = rng.integers(0, 2 ** 32, 2000, dtype=np.uint32)
    mask = rng.random(1200) < 0.9
    dup = np.concatenate([planes[:1000], planes[:200]])
    out = {}
    ops.reset_launches()
    for dev in ("cuda", "cpu"):
        t = sv.create(4096, window=32, device=dev, key_words=2)
        t, st1 = sv.insert(t, u64, vals)
        t, st2 = sv.insert(t, dup, vals[:1200] ^ 1, mask=mask)
        t, erased = sv.erase(t, (cols[0][:500], cols[1][:500]))
        t, st3 = sv.insert(t, planes[:600], vals[:600])
        v, f = sv.retrieve(t, cols)
        m = mv.create(4096, window=32, device=dev, key_words=2)
        m, st4 = mv.insert(m, np.repeat(u64[:500], 3), np.arange(1500,
                                                               dtype=np.uint32))
        c = mv.count_values(m, planes[:600])
        seg = _segments(*mv.retrieve_all(m, planes[:600], int(c.sum())))
        m, me = mv.erase(m, u64[:100])
        out[dev] = (st1.cpu(), st2.cpu(), erased.cpu(), st3.cpu(),
                    to_numpy_u32(v), f.cpu(), sv.contains(t, u64).cpu(),
                    t.count, st4.cpu(), c.cpu(), seg, me.cpu(), m.count)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {**_NONE, "cops_insert64": 3, "cops_lookup64": 3,
                            "cops_append64": 1, "cops_retrieve64": 3}
    gpu, cpu = out["cuda"], out["cpu"]
    assert bool((gpu[0] == STATUS_INSERTED).all())
    for a, b in zip(gpu, cpu):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 4, 32])
def test_insert64_never_matches_a_half_published_key(window):
    """The race of a key published only on plane 0: many keys share four
    plane-0 words, with plane-1 words 0xFFFFFFFF (EMPTY's bits, held by a
    fresh slot's plane 1) and 0xFFFFFFFE (TOMBSTONE's, held by an erased
    one), in a table of a few rows.  120 rounds, on an empty store and on
    one holding tombstones; the insert and append contracts must hold
    every time."""
    _need_card()
    rng = np.random.default_rng(window)
    lo = np.repeat(np.arange(1, 5, dtype=np.uint32), 40)
    hi = np.tile(np.concatenate([[0xFFFFFFFF, 0xFFFFFFFE],
                                 np.arange(38)]).astype(np.uint32), 4)
    every = torch.from_numpy(np.stack([lo, hi], 1).view(np.int32)).cuda()
    for rnd in range(120):
        t = sv.create(140, window=window, device="cuda", key_words=2)
        kw = dict(seed=t.seed, scheme=t.scheme,
                  max_probes=bulk._tstatic(t)[3])
        order = torch.from_numpy(rng.permutation(160)).cuda()
        keys = every[order]
        vals = contract.values_for(keys, rnd)
        first, second = keys[:100], keys[60:]
        kernel = contract.table_planes(t)
        plain = tuple(x.clone() for x in kernel)
        count = 0
        for step, batch in enumerate((first, second)):
            v = vals[:batch.shape[0]] ^ step
            ks = ops.insert64(*kernel, batch, v, count=count, **kw)
            ps = ops.insert_plain(*plain, batch, v, count=count, **kw)
            parts = contract.check_insert(kernel, plain, ks, ps, **kw)
            assert all(parts.values()), (rnd, step, parts)
            count += int((ks == STATUS_INSERTED).sum())
            if step == 0:
                # erase every other key: the second batch meets tombstones
                gone = first[::2]
                for planes in (kernel, plain):
                    _, f, slot = ops.lookup_plain(*planes, gone, slots=True,
                                                  **kw)
                    planes[0].view(2, -1)[:, slot[f]] = TOMBSTONE_WORD
                count -= gone.shape[0]
        m = mv.create(140, window=window, device="cuda", key_words=2)
        kernel = contract.table_planes(m)
        plain = tuple(x.clone() for x in kernel)
        pairs = keys[torch.arange(140, device="cuda") % 40]
        pv = torch.arange(140, dtype=torch.int32, device="cuda")
        ks = ops.append64(*kernel, pairs, pv, **kw)
        ps = ops.append_plain(*plain, pairs, pv, **kw)
        parts = contract.check_append(kernel, plain, pairs, ks, ps, **kw)
        assert all(parts.values()), (rnd, parts)
        assert not bool((ks == STATUS_FULL).any())
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the bucket list (cops_bucket_walk) and the k-mer front end (kmer_hash)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("r, growth, s0", [(1, 1.1, 1), (8, 1.1, 1),
                                           (32, 1.1, 1), (8, 1.0, 8),
                                           (32, 1.0, 32)])
@pytest.mark.parametrize("window", [8, 32])
def test_bucket_walk_holds_to_plain(window, r, growth, s0):
    """The chain walk bit-exact against its plain version on tables of
    Fig. 7's wc-bl cells (wc-bl-1: growth 1.1, s0 1; wc-bl-2: growth 1.0,
    s0 r), with chains grown across two batches, duplicate and absent
    queries."""
    _need_card()
    checks = contract.run_bucket_case(1 << 14, r=r, growth=growth, s0=s0,
                                      device="cuda", window=window)
    torch.cuda.synchronize()
    assert all(checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 16, 20, 31, 64])
@pytest.mark.parametrize("rows, length", [(1, 1337), (300, 150), (7, 300),
                                          (2, 1000)])
def test_kmer_hash_holds_to_plain(rows, length, k):
    """``kmer_hash`` bit-exact against ``ref.kmer_hashes`` with N bases
    (codes 4 and 255), over rows of one tile, of several tiles and of a
    ragged last tile."""
    _need_card()
    rng = np.random.default_rng([rows, length, k])
    bases = rng.integers(0, 4, (rows, length)).astype(np.uint8)
    bases[rng.random((rows, length)) < 0.002] = 4
    bases[rng.random((rows, length)) < 0.002] = 255
    mh.reset_launches()
    got = mh.kmer_hash(torch.from_numpy(bases).cuda(), k)
    torch.cuda.synchronize()
    assert mh.LAUNCHES == {"kmer_hash": 1}
    want = mh.kmer_hash(torch.from_numpy(bases), k)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_bucket_list_and_sketches_on_card_go_through_kernels():
    """The metagenomics front end and the bucket list on the card launch
    ``kmer_hash``, ``cops_lookup`` and ``cops_bucket_walk`` and give the
    same sketches, statuses and tables (the build is deterministic), counts
    and retrievals as the same calls on the CPU."""
    _need_card()
    rng = np.random.default_rng(3)
    genomes = rng.integers(0, 4, (6, 3000)).astype(np.uint8)
    reads = genomes[rng.integers(0, 6, 40), :][:, 500:650].copy()
    reads[rng.random(reads.shape) < 0.01] = 4
    out = {}
    ops.reset_launches()
    mh.reset_launches()
    for dev in ("cuda", "cpu"):
        sk = mh.sketch_reads(genomes, k=16, s=200, device=dev)
        keys = torch.clamp(sk.long() & 0xFFFFFFFF, max=0xFFFFFFFD)
        keys = torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).int()
        gids = torch.arange(6, dtype=torch.int32, device=dev).repeat_interleave(200)
        live = (sk != INVALID_WORD).reshape(-1)
        t = bl.create(4096, 1 << 13, s0=1, growth=1.1, window=32, device=dev)
        t, st1 = bl.insert(t, keys.reshape(-1)[:600], gids[:600], live[:600])
        t, st2 = bl.insert(t, keys.reshape(-1)[600:], gids[600:], live[600:])
        t, st3 = bl.insert(t, keys.reshape(-1)[:300], gids[:300])
        q = mh.sketch_reads(reads, k=16, s=16, device=dev).reshape(-1)
        q = torch.cat([q, keys.reshape(-1)[:100]])
        c = bl.count_values(t, q)
        got = bl.retrieve_all(t, q, int(c.sum()))
        out[dev] = (sk.cpu(), st1.cpu(), st2.cpu(), st3.cpu(), c.cpu(),
                    *(x.cpu() for x in got),
                    *(x.cpu() for x in t.key_store.store.values()),
                    t.pool.cpu(), t.alloc_top, t.num_keys(),
                    t.storage_density())
    torch.cuda.synchronize()
    assert mh.LAUNCHES == {"kmer_hash": 2}
    assert ops.LAUNCHES == {**_NONE, "cops_lookup": 4, "cops_bucket_walk": 1}
    gpu, cpu = out["cuda"], out["cpu"]
    assert bool((gpu[1][live[:600].cpu()] == STATUS_INSERTED).all())
    for a, b in zip(gpu, cpu):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
