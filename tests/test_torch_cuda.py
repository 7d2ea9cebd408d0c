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
from repro_torch.kernels.bloom import ops as bloom_ops
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref

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


#: (r, layout) of the multi-value cases: runs of every length (100: longer
#: than any window, split across the kernel's chunks), and at r = 8 and 32
#: the other layouts (``contract.LAYOUTS``)
_MULTI_LAYOUTS = ([(r, "runs") for r in (1, 8, 32, 100)]
                  + [(8, layout) for layout in contract.LAYOUTS[1:]]
                  + [(32, "offset")])


@pytest.mark.cuda
@pytest.mark.parametrize("r, layout", _MULTI_LAYOUTS)
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", SUPPORTED_WINDOWS)
def test_multi_value_kernels_hold_to_plain(window, scheme, r, layout):
    """The append under the multi-value contract, the retrieve walk
    bit-exact, at load 0.8 with r duplicates of each key laid out as
    ``layout`` says, tombstones, duplicate and masked queries."""
    _need_card()
    checks = contract.run_multi_case(1 << 14, window=window, scheme=scheme,
                                     device="cuda", r=r, layout=layout)
    torch.cuda.synchronize()
    assert all(checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", [w for w in SUPPORTED_WINDOWS if w > 1])
def test_append_goes_full_partway_as_plain(window, scheme, key_words):
    """Runs that meet no other key and go FULL partway: the append kernel
    builds exactly the plain version's store and statuses."""
    _need_card()
    checks = contract.run_full_case(1 << 14, window=window, scheme=scheme,
                                    device="cuda", key_words=key_words)
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
    the append (in every layout; keys sharing their plane-0 word side by
    side) under their contracts, the lookup and the retrieve walk
    bit-exact; a quarter of the keys share 2^10 plane-0 words, some with
    plane 1 at 0xFFFFFFFF / 0xFFFFFFFE."""
    _need_card()
    single = contract.run_case(1 << 14, window=window, scheme=scheme,
                               device="cuda", key_words=2)
    multi = {f"{layout} {k}": ok for layout in contract.LAYOUTS
             for k, ok in contract.run_multi_case(
                 1 << 14, window=window, scheme=scheme, device="cuda",
                 key_words=2, layout=layout).items()}
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
@pytest.mark.parametrize("growth, s0", [(1.1, 1), (2.0, 4)])
@pytest.mark.parametrize("window", [32, 128])
def test_bucket_walk_holds_to_plain_on_scattered_chains(window, growth, s0):
    """The K-chain walk bit-exact against its plain version on chains
    grown by 24 insert batches (buckets scattered over the pool, up to 18
    a chain at growth 1.1, 128-value buckets at growth 2), on batches of 1,
    K - 1, K, K + 1 and 33 queries and the whole batch, with whole warps
    inactive, each query given exactly its key's values in insertion
    order (``contract.run_chain_case``): 12 walks, 12 launches."""
    _need_card()
    ops.reset_launches()
    checks = contract.run_chain_case(growth=growth, s0=s0, device="cuda",
                                     window=window,
                                     warp_keys=ops.bucket_keys())
    torch.cuda.synchronize()
    assert len(checks) == 29 and all(checks.values()), checks
    assert ops.LAUNCHES["cops_bucket_walk"] == 12


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
@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 31, 32, 33, 64, 1000])
def test_kmer_hash_rolls_across_rows(k):
    """``kmer_hash``, whose threads roll a run of outputs over a flat span
    of bases, bit-exact against ``ref.kmer_hashes`` on rows of k, k + 1,
    127, 150, 300 and 1337 bases (those at least k long): one row, 3 rows,
    and as many rows as put row boundaries inside threads' runs and across
    several blocks' spans; N codes 4 and 255 at row starts, row ends and
    inside windows; the bases also at an odd address."""
    _need_card()
    mh.reset_launches()
    launches = 0
    for length in (k, k + 1, 127, 150, 300, 1337):
        if length < k:
            continue
        n_out = length - k + 1
        for rows in sorted({1, 3, 4099 // n_out + 1, 3 * 4096 // n_out + 5}):
            rng = np.random.default_rng([k, length, rows])
            bases = rng.integers(0, 4, (rows, length)).astype(np.uint8)
            bases[rng.random(bases.shape) < 0.003] = 4
            bases[rng.random(bases.shape) < 0.003] = 255
            bases[::2, 0], bases[1::3, -1] = 4, 255
            bases[::5, length // 2] = 4
            want = mh.kmer_hash(torch.from_numpy(bases), k)
            flat = torch.zeros((bases.size + 1,), dtype=torch.uint8,
                               device="cuda")
            flat[1:] = torch.from_numpy(bases.reshape(-1)).cuda()
            for card in (torch.from_numpy(bases).cuda(),
                         flat[1:].view(rows, length)):
                got = mh.kmer_hash(card, k)
                torch.cuda.synchronize()
                launches += 1
                assert torch.equal(got.cpu(), want), (length, rows)
    assert mh.LAUNCHES == {"kmer_hash": launches}


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


# ---------------------------------------------------------------------------
# the read-modify-write (cops_update, cops_update64) and the relational layer
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", SUPPORTED_WINDOWS)
def test_update_kernels_hold_to_plain(window, scheme, key_words):
    """``cops_update`` / ``cops_update64`` under the update contract for
    every aggregate of the group-by and the counting table's saturating
    count at rho 0.9, and for sum on a table too small for the groups
    (FULL), with tombstones and in-batch duplicates; two-word keys share
    plane-0 words (some with plane 1 at 0xFFFFFFFF / 0xFFFFFFFE)."""
    _need_card()
    for what, rho in [(w, 0.9) for w in contract.UPDATES] + [("sum", 1.2)]:
        checks = contract.run_update_case(
            1 << 14, window=window, scheme=scheme, device="cuda", what=what,
            rho=rho, key_words=key_words)
        torch.cuda.synchronize()
        assert all(checks.values()), (what, rho, checks)


@pytest.mark.cuda
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("window", [8, 32, 64])
@pytest.mark.parametrize("groups", ["R - 1", "R", "R + 1", "one key"])
def test_update_combines_on_both_sides_of_shared_memory(groups, window,
                                                        key_words):
    """The update's combine keeps a block's groups in shared memory up to R
    (``ops.shared_groups``) representatives and goes to device memory
    above: R - 1, R and R + 1 groups, every one in batch 1, and a batch
    whose rows all share one key, under the update contract for each fold
    op (add, min, max, the saturating add, the last also saturating a new
    key through its other rows only), into an empty table and then into
    the filled one; and a table too small for its groups (FULL)."""
    _need_card()
    n_groups = {"R - 1": -1, "R": 0, "R + 1": 1}
    if groups == "one key":
        g, rho = 1, 1 / 256
    else:
        g, rho = ops.shared_groups() + n_groups[groups], 0.9
    n = max(1 << 14, 2 * g)
    for what, r in [(w, rho) for w in ("sum", "min", "max", "counting",
                                       "saturating")] + [("sum", 1.2)]:
        checks = contract.run_update_case(
            n, window=window, scheme="cops", device="cuda", what=what,
            groups=g, rho=r, key_words=key_words, cover=True)
        torch.cuda.synchronize()
        assert all(checks.values()), (what, g, r, checks)


@pytest.mark.cuda
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("window", [1, 4, 32])
def test_update_claims_race_beside_a_present_key(window, key_words):
    """Every key of the batch starts its walk on one row: the claims of
    new keys race for its lanes (and the rows after it) while the
    representatives of present keys fold into slots of the same row.  60
    rounds, each on a fresh store and on one holding tombstones; the
    update contract must hold every time."""
    _need_card()
    p = 13
    t = sv.create(p * window, window=window, device="cuda",
                  key_words=key_words, value_words=2)
    pool = contract.case_keys(key_words, 1 << 16, "cuda")
    from repro_torch.core.single_value import key_hash_word
    from repro_torch.core import probing
    rows = probing.initial_row(key_hash_word(pool), t.num_rows, t.seed)
    same = pool[rows == 0][: p * window // 2]
    kw = dict(seed=t.seed, scheme=t.scheme, max_probes=bulk._tstatic(t)[3])
    fold = ("add", "add")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(window)
    for rnd in range(60):
        t = sv.create(p * window, window=window, device="cuda",
                      key_words=key_words, value_words=2)
        kernel = (contract.table_planes(t)[0], t.store["values"])
        plain = tuple(x.clone() for x in kernel)
        update = contract.twin(ops.update, kernel[0])
        order = torch.randperm(same.shape[0], generator=gen, device="cuda")
        keys = same[order]
        count = 0
        for step, batch in enumerate((keys[: keys.shape[0] // 2],
                                      keys[keys.shape[0] // 4:])):
            batch = torch.cat([batch, batch[:8]])          # duplicates
            vals = contract.update_batch(batch, rnd + step, "sum")
            rk, x, claim, rest, _ = bulk.update_front(batch, vals, vals)
            ks = update(*kernel, rk, x, claim, rest, vals, ops=fold,
                        count=count, **kw)
            ps = ops.update_plain(*plain, rk, x, claim, rest, vals, ops=fold,
                                  count=count, **kw)
            claim = bulk.fold_words(fold, claim, bulk.fold_rest(
                fold, rest, vals, rk.shape[0]))
            parts = contract.check_update(kernel, plain, rk, claim, ks, ps,
                                          **kw)
            assert all(parts.values()), (rnd, step, parts)
            count += int((ks == STATUS_INSERTED).sum())
            if step == 0 and rnd % 2:
                gone = batch[: batch.shape[0] // 4]        # tombstones
                for planes in (kernel, plain):
                    _, f, slot = ops.lookup_plain(planes[0], None, gone,
                                                  slots=True, **kw)
                    kps = ops._planes(planes[0])
                    kps.view(kps.shape[0], -1)[:, slot[f]] = TOMBSTONE_WORD
                count = contract._live_slots(kernel[0]).shape[0]
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("values", [True, False], ids=["values", "hash-set"])
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("window", [1, 4, 32, 64, 128])
def test_insert_claims_race_on_one_row(window, key_words, values):
    """``cops_insert`` / ``cops_insert64`` where every key of the batch
    starts its walk on one row: the claims of new keys race for its lanes
    (and the rows after it) while present keys match in the same row; a
    value plane and none (the hash set); 60 rounds, on alternate ones
    onto tombstones; the insert contract and the lookup must hold every
    time (``contract.run_insert_race_case``)."""
    _need_card()
    checks = contract.run_insert_race_case(window=window, device="cuda",
                                           key_words=key_words,
                                           values=values)
    torch.cuda.synchronize()
    assert all(checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("batch", [1, 7, 8, 9, 33])
def test_insert_batch_sizes_around_the_walks_keys(batch, key_words):
    """At W = 32 a warp walks 8 keys: batches of 1, 7, 8, 9 and 33 keys
    (partial warps, a warp with one key) race on one row as in
    ``test_insert_claims_race_on_one_row``, with a value plane and
    without."""
    _need_card()
    for values in (True, False):
        checks = contract.run_insert_race_case(
            window=32, device="cuda", key_words=key_words, values=values,
            batch=batch)
        torch.cuda.synchronize()
        assert all(checks.values()), (values, checks)


@pytest.mark.cuda
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", [4, 32, 128])
def test_lookup_holds_to_plain_on_long_and_cut_walks(window, scheme,
                                                     key_words):
    """``cops_lookup`` / ``cops_lookup64`` bit-exact against
    ``lookup_plain`` (values, found, slots) on a table near full with
    TOMBSTONE-only windows, at the table's budget and at budgets of 1 and
    2 windows, with sentinel words as queries, on a value plane and on
    none (``contract.run_lookup_case``); all 12 lookups launch the
    kernel."""
    _need_card()
    ops.reset_launches()
    checks = contract.run_lookup_case(window=window, scheme=scheme,
                                      device="cuda", key_words=key_words)
    torch.cuda.synchronize()
    assert all(checks.values()), checks
    name = "cops_lookup" if key_words == 1 else "cops_lookup64"
    assert ops.LAUNCHES[name] == 12, ops.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("window", [32, 64, 128])
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("batch", [1, 7, 8, 9, 33])
def test_lookup_batch_sizes_around_the_walks_keys(batch, key_words, window):
    """At W >= 32 a warp walks 8 keys: lookups of 1, 7, 8, 9 and 33 keys
    (partial warps, a warp with one key), a present key and an absent one
    in turn, bit-exact against ``lookup_plain`` with and without a value
    plane and slots, at three budgets (``contract.run_lookup_case``)."""
    _need_card()
    ops.reset_launches()
    checks = contract.run_lookup_case(window=window, device="cuda",
                                      key_words=key_words, batch=batch)
    torch.cuda.synchronize()
    assert all(checks.values()), checks
    name = "cops_lookup" if key_words == 1 else "cops_lookup64"
    assert ops.LAUNCHES[name] == 12, ops.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", [4, 32, 128])
def test_retrieve_holds_to_plain_on_long_and_cut_walks(window, scheme,
                                                       key_words):
    """``cops_retrieve`` / ``cops_retrieve64`` bit-exact against
    ``retrieve_walk_plain`` (counts, and both arenas slot for slot) on a
    store near full of runs of 1, 8 and 40 equal keys with TOMBSTONE-only
    windows and erased pairs, under masks that leave whole groups of 8
    queries inactive, at the table's budget, at budgets of 1 and 2 windows
    and past num_rows on a store with no EMPTY window, with sentinel
    queries (``contract.run_retrieve_case``); all 16 walks launch the
    kernel."""
    _need_card()
    ops.reset_launches()
    checks = contract.run_retrieve_case(window=window, scheme=scheme,
                                        device="cuda", key_words=key_words)
    torch.cuda.synchronize()
    assert all(checks.values()), checks
    name = "cops_retrieve" if key_words == 1 else "cops_retrieve64"
    assert ops.LAUNCHES[name] == 16, ops.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("window", [32, 64, 128])
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("batch", [1, 7, 8, 9, 33])
def test_retrieve_batch_sizes_around_the_walks_keys(batch, key_words,
                                                    window):
    """At W >= 32 a warp walks 4 queries (``kRetrieveKeys``): retrieves of
    1, 7, 8, 9 and 33 queries (partial warps, a warp with one query), a
    present key and an absent one in turn, bit-exact against ``retrieve_walk_plain`` under
    both masks, counts only and collecting, at four budgets
    (``contract.run_retrieve_case``)."""
    _need_card()
    ops.reset_launches()
    checks = contract.run_retrieve_case(window=window, device="cuda",
                                        key_words=key_words, batch=batch)
    torch.cuda.synchronize()
    assert all(checks.values()), checks
    name = "cops_retrieve" if key_words == 1 else "cops_retrieve64"
    assert ops.LAUNCHES[name] == 16, ops.LAUNCHES


def _same_rows(a, b):
    """A join's output rows as (probe_idx, build_idx) pairs, sorted: the
    card's append may place a key's pairs in another order."""
    def pairs(r):
        v = r.valid.cpu()
        p, q = r.probe_idx.cpu()[v].long(), r.build_idx.cpu()[v].long()
        return torch.sort(p * (1 << 32) + q).values
    return torch.equal(pairs(a), pairs(b))


@pytest.mark.cuda
def test_relational_layer_on_card_goes_through_kernels():
    """The group-by (every aggregate, 1- and two-word keys), the counting
    table, the hash set, DISTINCT and the four joins on CUDA tables launch
    ``cops_update`` / ``cops_update64`` (and the walks they rest on) and
    agree with the same calls on CPU tables: group-by and counts as maps,
    DISTINCT exactly, joins per probe row as multisets."""
    _need_card()
    from repro_torch.core import counting, hashset
    from repro_torch.relational import distinct, groupby, join
    rng = np.random.default_rng(4)
    keys = rng.integers(1, 700, 5000).astype(np.uint32)
    cols = (rng.integers(0, 3, 5000).astype(np.uint32), keys)
    vals = rng.integers(0, 2 ** 32, 5000, dtype=np.uint32)
    mask = rng.random(5000) < 0.9
    probe = rng.integers(1, 1400, 3000).astype(np.uint32)
    ops.reset_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        res = {}
        for kw, k in ((1, keys), (2, cols)):
            for agg in groupby.AGGS:
                t = groupby.create(4096, key_words=kw, device=dev)
                t, st = groupby.update(t, agg, k, vals, mask=mask)
                t, st2 = groupby.update(t, agg, k[:1000] if kw == 1 else
                                        (cols[0][:1000], keys[:1000]),
                                        vals[:1000])
                gk, got, live = groupby.finalize(t, agg)
                order = torch.argsort(contract.bulk.pack_keys(gk[live]))
                res[f"gb {kw} {agg}"] = (st.cpu(), st2.cpu(),
                                         gk[live][order].cpu(),
                                         got[live][order].cpu(), t.count)
        c = counting.create(2048, device=dev)
        c, st = counting.insert(c, keys, mask)
        res["counting"] = (st.cpu(), counting.counts(c, probe).cpu())
        s = hashset.create(2048, device=dev)
        s, added = hashset.add(s, keys)
        s, removed = hashset.remove(s, probe[:500])
        res["set"] = (added.cpu(), removed.cpu(),
                      hashset.contains(s, probe).cpu(), hashset.size(s))
        u, n_u, fresh = distinct.distinct(cols, 1000, device=dev)
        res["distinct"] = (tuple(x.cpu() for x in u), int(n_u), fresh.cpu())
        for how in join.HOW:
            r = join.hash_join(keys, probe, 20000, how, device=dev)
            res[f"join {how}"] = r
        out[dev] = res
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cops_update"] == 11 and ops.LAUNCHES["cops_update64"] == 10
    # each update counts its batch's rows: 5 aggregates x (5000 + 1000),
    # and the counting table's 5000
    assert ops.ELEMENTS["cops_update"] == 5 * 6000 + 5000
    assert ops.ELEMENTS["cops_update64"] == 5 * 6000
    assert ops.LAUNCHES["cops_append"] == 4 and ops.LAUNCHES["cops_insert"] == 1
    assert ops.LAUNCHES["cops_insert64"] == 1
    gpu, cpu = out["cuda"], out["cpu"]
    for name, a in gpu.items():
        b = cpu[name]
        if name.startswith("join"):
            assert _same_rows(a, b), name
            for field in ("matched", "total"):
                assert torch.equal(getattr(a, field).cpu(),
                                   getattr(b, field)), (name, field)
            continue
        for x, y in zip(a, b):
            if isinstance(x, tuple):
                assert all(torch.equal(p, q) for p, q in zip(x, y)), name
            elif isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name
            else:
                assert x == y, name


def _bloom_case(gen, n, planes, num_blocks, wpb, dev="cuda"):
    """Keys over the whole u32 range with repeats, half masked, a plane
    per key (some out of range), and a filter already holding bits."""
    keys = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int32,
                         generator=gen).to(dev)
    keys[n // 2: n // 2 + n // 4] = keys[: n // 4]
    mask = (torch.rand((n,), generator=gen) < 0.5).to(dev)
    plane = torch.randint(-1, planes + 1, (n,), generator=gen).to(dev)
    words = torch.randint(-2 ** 31, 2 ** 31, (planes, num_blocks, wpb),
                          dtype=torch.int32, generator=gen)
    words &= torch.randint(-2 ** 31, 2 ** 31, words.shape, dtype=torch.int32,
                           generator=gen)
    words &= torch.randint(-2 ** 31, 2 ** 31, words.shape, dtype=torch.int32,
                           generator=gen)
    return keys, mask, plane, words.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 5])
@pytest.mark.parametrize("k", [1, 4, 8, 17])
@pytest.mark.parametrize("block_bits", [32, 96, 256, 512, 1024])
def test_bloom_kernels_hold_to_plain(block_bits, k, planes):
    """bloom_insert / bloom_query against their plain versions on the same
    card tensors, bit-exact: 512-bit and non-power-of-two blocks, the
    merged (k <= 16) and per-bit (k = 17) inserts, masks, repeated keys,
    planes out of range, and an empty batch."""
    _need_card()
    gen = torch.Generator().manual_seed(block_bits * 100 + k * 10 + planes)
    wpb = block_bits // 32
    keys, mask, plane, words = _bloom_case(gen, 1 << 16, planes, 1021, wpb)
    seed = 0x9E3779B9
    bloom_ops.reset_launches()
    got = words.clone()
    bloom_ops.insert_words(got, keys, mask, k_hashes=k, seed=seed,
                           planes=plane)
    want = bloom_ops.insert_plain(words.clone(), keys, mask, k_hashes=k,
                                  seed=seed, planes=plane)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    queries = torch.cat([keys, keys.flip(0) ^ 0x5A5A5A5A])
    qplane = torch.cat([plane, plane])
    hit = bloom_ops.query_words(got, queries, k_hashes=k, seed=seed,
                                planes=qplane)
    assert torch.equal(hit, bloom_ops.query_plain(
        want, queries, k_hashes=k, seed=seed, planes=qplane))
    assert bool(hit[: 1 << 16][mask & (plane >= 0) & (plane < planes)].all())
    empty = torch.zeros((0,), dtype=torch.int32, device="cuda")
    bloom_ops.insert_words(got, empty, k_hashes=k, seed=seed)
    assert bloom_ops.query_words(got, empty, k_hashes=k,
                                 seed=seed).shape == (0,)
    assert torch.equal(got, want)
    assert bloom_ops.LAUNCHES == {"bloom_insert": 1, "bloom_query": 1}


#: the insert's path cases: name -> (keys, planes, blocks, words a block,
#: k, (tile words, range bytes) or None for ``TILE_WORDS`` and
#: ``RANGE_BYTES``, the path ``insert_plan`` picks)
_SMALL_CUT = (1024, 1 << 14)    # 64 rows a tile, 4 tiles a range
_BLOOM_PATHS = {
    "wide filter": (1 << 25, 1, 2097143, 16, 4, None, "partitioned"),
    "3 words a block, wide": (1 << 24, 1, (1 << 22) + 15, 3, 4, None,
                              "partitioned"),
    "many ranges": ((1 << 20) + 77, 1, 65537, 16, 4, _SMALL_CUT,
                    "partitioned"),
    "most ranges": (1 << 20, 1, 65537, 16, 4, (256, 1024), "partitioned"),
    "below the threshold": (1 << 14, 1, 65537, 16, 4, _SMALL_CUT, "direct"),
    "planes and a mask": (1 << 20, 5, 16411, 16, 4, _SMALL_CUT,
                          "partitioned"),
    "k 17": (1 << 20, 1, 65537, 16, 17, _SMALL_CUT, "partitioned"),
    "3 words a block": (1 << 20, 1, 65537, 3, 8, _SMALL_CUT, "partitioned"),
    "one row": (1 << 20, 1, 65537, 16, 4, _SMALL_CUT, "partitioned"),
    "one tile": (1 << 20, 1, 65537, 16, 4, _SMALL_CUT, "partitioned"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_BLOOM_PATHS))
def test_bloom_insert_paths_hold_to_plain(case, monkeypatch):
    """``bloom_insert`` word for word against ``insert_plain`` on each
    path ``insert_plan`` picks: batches above the threshold on filters of
    128 MiB and of 48 MiB in 96-bit blocks at the kernel's own cut (64 KiB
    tiles, 16 MiB ranges), and on filters cut into small tiles and many
    ranges (up to ``MAX_LOCAL``) with n not a multiple of the kernels'
    tiles of keys; one below it (the direct path); a stack of 5 planes,
    some keys' planes out of range, half the keys masked; k = 17 (one
    atomic a bit); 96-bit blocks; every key in one row; every key in one
    tile.  One launch a call, through the path expected."""
    _need_card()
    n, planes, nb, wpb, k, cut, path = _BLOOM_PATHS[case]
    if cut:
        monkeypatch.setattr(bloom_ops, "TILE_WORDS", cut[0])
        monkeypatch.setattr(bloom_ops, "RANGE_BYTES", cut[1])
    gen = torch.Generator().manual_seed(len(case) * 1000 + n % 997)
    keys, mask, plane, words = _bloom_case(gen, n, planes, nb, wpb)
    if case != "planes and a mask":
        mask = plane = None
        words = words[0]
    if case == "one row":
        keys = keys[:1].repeat(n)
    elif case == "one tile":
        block = bloom_ops.ref.positions(keys, nb, 32 * wpb, k, 7)[0]
        plan = bloom_ops.insert_plan(n, nb, wpb)
        keys = keys[block < plan.rows_per_tile]
        keys = keys[torch.arange(n, device="cuda") % keys.shape[0]]
    assert bloom_ops.insert_plan(n, planes * nb, wpb).partitioned == (
        path == "partitioned")
    bloom_ops.reset_launches()
    got = words.clone()
    bloom_ops.insert_words(got, keys, mask, k_hashes=k, seed=7, planes=plane)
    want = bloom_ops.insert_plain(words.clone(), keys, mask, k_hashes=k,
                                  seed=7, planes=plane)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bloom_ops.LAUNCHES == {"bloom_insert": 1, "bloom_query": 0}
    assert bloom_ops.PATHS[path] == 1 and sum(bloom_ops.PATHS.values()) == 1
    assert bloom_ops.ELEMENTS["bloom_insert"] == n


#: the query's path cases: name -> (queries, planes, blocks, words a
#: block, k, (tile words, range bytes) or None for ``TILE_WORDS`` and
#: ``RANGE_BYTES``, the path ``query_plan`` picks)
_QUERY_PATHS = {
    "wide filter": (1 << 23, 1, 2097143, 16, 4, None, "query_partitioned"),
    "many ranges": ((1 << 20) + 77, 1, 65537, 16, 4, _SMALL_CUT,
                    "query_partitioned"),
    "most ranges": (1 << 20, 1, 65537, 16, 4, (256, 1024),
                    "query_partitioned"),
    "planes out of range": (1 << 20, 5, 16411, 16, 4, _SMALL_CUT,
                            "query_direct"),
    "k 17": (1 << 20, 1, 65537, 16, 17, _SMALL_CUT, "query_partitioned"),
    "3 words a block": (1 << 20, 1, 65537, 3, 8, _SMALL_CUT,
                        "query_partitioned"),
    "one row": (1 << 20, 1, 65537, 16, 4, _SMALL_CUT, "query_partitioned"),
    "one key": (1, 3, 16411, 16, 4, _SMALL_CUT, "query_direct"),
    "2049 keys": (2049, 5, 16411, 16, 4, _SMALL_CUT, "query_direct"),
    "below the threshold": (1 << 14, 1, 65537, 16, 4, _SMALL_CUT,
                            "query_direct"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_QUERY_PATHS))
def test_bloom_query_paths_hold_to_plain(case, monkeypatch):
    """``bloom_query`` against ``query_plain`` on the path ``query_plan``
    picks and on both paths forced through ``query_launch``, on the same
    batch: half of it keys inserted (repeats among them), half absent; a
    filter of 128 MiB at the kernels' own cut and filters cut into small
    tiles and many ranges (up to ``MAX_LOCAL``); a stack of planes with
    some queries' planes out of range (answer 0; a batch with planes is
    planned direct); k = 17 (bits tested one at a time); 96-bit blocks;
    every query in one row; one query, 2049 queries (not a multiple of a
    scatter block's 2048 keys), and an empty batch, which launches
    nothing.  ``PATHS`` counts each launch's path."""
    _need_card()
    n, planes, nb, wpb, k, cut, path = _QUERY_PATHS[case]
    if cut:
        monkeypatch.setattr(bloom_ops, "TILE_WORDS", cut[0])
        monkeypatch.setattr(bloom_ops, "RANGE_BYTES", cut[1])
    gen = torch.Generator().manual_seed(len(case) * 1000 + n % 997)
    keys, _, plane, words = _bloom_case(gen, max(n, 2), planes, nb, wpb)
    if planes == 1:
        plane, words = None, words[0]
    half = max(n, 2) // 2
    bloom_ops.insert_plain(words, keys[:half], k_hashes=k, seed=7,
                           planes=None if plane is None else plane[:half])
    queries = torch.cat([keys[:half], keys[half:] ^ 0x5A5A5A5A])[:n]
    if case == "one row":
        queries = queries[:1].repeat(n)
    qplane = None if plane is None else plane[:n]
    want = bloom_ops.query_plain(words, queries, k_hashes=k, seed=7,
                                 planes=qplane)
    rows = planes * nb
    assert bloom_ops.query_plan(n, rows, wpb, qplane is not None).partitioned \
        == (path == "query_partitioned")
    threshold = bloom_ops.QUERY_KEYS_PER_SECTOR
    monkeypatch.setattr(bloom_ops, "QUERY_KEYS_PER_SECTOR", 0.0)
    forced = bloom_ops.query_plan(n, rows, wpb)
    monkeypatch.setattr(bloom_ops, "QUERY_KEYS_PER_SECTOR", threshold)
    assert forced.partitioned
    bloom_ops.reset_launches()
    got = bloom_ops.query_words(words, queries, k_hashes=k, seed=7,
                                planes=qplane)
    part = bloom_ops.query_launch(words, queries, qplane, k, 7, forced)
    direct = bloom_ops.query_launch(words, queries, qplane, k, 7,
                                    bloom_ops.Plan(False))
    empty = bloom_ops.query_launch(words, queries[:0], None, k, 7, forced)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(part, want) and torch.equal(direct, want)
    assert empty.shape == (0,)
    live = torch.arange(n, device="cuda") < half
    if qplane is not None:
        out_of_range = (qplane < 0) | (qplane >= planes)
        assert not bool(want[out_of_range].any())
        live &= ~out_of_range
    assert bool(want[live].all())
    assert bloom_ops.LAUNCHES == {"bloom_insert": 0, "bloom_query": 3}
    other = ({"query_direct", "query_partitioned"} - {path}).pop()
    assert bloom_ops.PATHS == {"direct": 0, "partitioned": 0, path: 2,
                               other: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 20])
def test_bloom_insert_atomics_race(k):
    """One key repeated 2^16 times, and 2^16 keys into a filter of two
    blocks: every thread ORs into the same few words at once.  The filter
    is bit-exact against the plain version."""
    _need_card()
    gen = torch.Generator().manual_seed(k)
    one = torch.full((1 << 16,), 123456789, dtype=torch.int32,
                     device="cuda")
    many = torch.randint(-2 ** 31, 2 ** 31, (1 << 16,), dtype=torch.int32,
                         generator=gen).cuda()
    for keys, num_blocks in ((one, 1021), (many, 2)):
        words = torch.zeros((num_blocks, 16), dtype=torch.int32,
                            device="cuda")
        bloom_ops.insert_words(words, keys, k_hashes=k, seed=7)
        want = bloom_ops.insert_plain(torch.zeros_like(words), keys,
                                      k_hashes=k, seed=7)
        torch.cuda.synchronize()
        assert torch.equal(words, want)
        assert bool(bloom_ops.query_words(words, keys, k_hashes=k,
                                          seed=7).all())


@pytest.mark.cuda
def test_elastic_service_on_card_goes_through_kernels(tmp_path):
    """The elastic service on the card and on the CPU take the same
    traffic: statuses, values, found and erased flags and stats agree, the
    filter stacks are bit-exact (OR is order-free), and so do they after
    compact_all, a reshard and a snapshot round trip (bit-exact within the
    card)."""
    _need_card()
    from repro_torch.core import snapshot
    from repro_torch.serving import elastic
    rng = np.random.default_rng(12)
    pool = rng.choice(2 ** 31, 1 << 15, replace=False).astype(np.uint32)
    absent = pool[1 << 14:]
    bloom_ops.reset_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        st = elastic.create(4, 1 << 13, slack=2.5, device=dev)
        res = []
        for s in range(4):
            ins = pool[s * 2048:(s + 1) * 2048].copy()
            ins[1024:1100] = ins[:76]
            get = np.concatenate([pool[: (s + 1) * 1024], absent[:1024]])
            st, outs = elastic.serve_step(st, ins, ins * 3, get, ins[::8])
            res.append(tuple(x.cpu() for x in outs[:4])
                       + tuple(int(v) for v in outs[4].values()))
        res.append(st.filter_words.clone().cpu())   # a copy on either device
        st = elastic.compact_all(st)
        res.append(st.filter_words.clone().cpu())
        st = elastic.reshard(st, 3)
        elastic.check_ownership(st)
        res.append(elastic.lookup(st, pool)[:2])
        out[dev] = res
        if dev == "cuda":
            elastic.save(st, str(tmp_path / "svc"))
            back = elastic.load(str(tmp_path / "svc"), device="cuda")
            for a, b in zip(st.shards, back.shards):
                assert torch.equal(a.store["keys"], b.store["keys"])
                assert torch.equal(a.store["values"], b.store["values"])
            assert torch.equal(back.filter_words, st.filter_words)
            blob = snapshot.snapshot_bytes(st.shards[0])
            assert snapshot.snapshot_bytes(snapshot.restore_bytes(
                blob, device="cuda")) == blob
    torch.cuda.synchronize()
    assert bloom_ops.LAUNCHES["bloom_insert"] > 0
    assert bloom_ops.LAUNCHES["bloom_query"] > 0
    for a, b in zip(out["cuda"], out["cpu"]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            for x, y in zip(a, b):
                assert (torch.equal(x.cpu(), y) if isinstance(x, torch.Tensor)
                        else x == y)


#: the reference's tolerances (tests/test_kernels.py::TestFlashKernel)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_inputs(seed, b, s, sk, h, hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to("cuda", dtype)
            for shape in ((b, s, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_holds_to_plain(causal, hd, dtype):
    """``flash_fwd`` against the plain f32 attention on the card, one
    launch per call: grouped heads (starcoder2-3b's 24 / 2), sequences that
    are not multiples of the kernel's tiles (one row, one row past a
    128-row tile), Sk != S both ways, and the panels of ``flash_call``."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = FLASH_TOL[dtype]
    # the last shape, one KV head, also gives flash_call's panels
    for b, s, sk, h, hkv in [(2, 256, 256, 4, 2), (1, 200, 200, 24, 2),
                             (1, 1, 1, 4, 2), (1, 130, 130, 24, 2),
                             (1, 96, 320, 3, 3), (2, 320, 96, 2, 1)]:
        q, k, v = _flash_inputs(s + h + hd, b, s, sk, h, hkv, hd, dtype)
        flash_ops.reset_launches()
        got = flash_ops.flash_attention(q, k, v, causal=causal, tq=s, tk=sk)
        assert flash_ops.LAUNCHES["flash_fwd"] == 1
        want = flash_ref.gqa_attention(q, k, v, causal=causal)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    panels = [x[0].transpose(0, 1).expand(h, -1, -1).contiguous()
              for x in (q, k, v)]
    got = flash_ops.flash_call(*panels, causal=causal, tq=s, tk=sk)
    want = flash_ref.attention(*panels, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_tensors_and_refuses(dtype):
    """Views are read where they lie (a (B, H, S, hd) tensor transposed,
    a slice of fused QKV; in bf16 through TMA maps of those strides) or
    copied when misaligned or expanded (stride 0); an empty batch launches
    nothing; other head dims and dtypes raise on the card instead of
    running the plain version."""
    _need_card()
    tol = FLASH_TOL[dtype]
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, 256, 8, 64))
                           .astype(np.float32)).to("cuda", dtype)
    q = qkv[:, :, :4]
    k = qkv[:, :, 4:6]
    v = torch.from_numpy(rng.normal(size=(2, 2, 256, 64))
                         .astype(np.float32)).to("cuda", dtype).transpose(1,
                                                                          2)
    want = flash_ref.gqa_attention(q, k, v).float()
    torch.testing.assert_close(flash_ops.flash_attention(q, k, v).float(),
                               want, rtol=tol, atol=tol)
    odd = torch.zeros(2 * 256 * 4 * 64 + 1, device="cuda", dtype=dtype)[1:]
    odd = odd.view(2, 256, 4, 64).copy_(q)        # element-aligned only
    torch.testing.assert_close(flash_ops.flash_attention(odd, k, v).float(),
                               want, rtol=tol, atol=tol)
    one = k[:, :, :1]                                # stride 0 over heads
    torch.testing.assert_close(
        flash_ops.flash_attention(q, one.expand(-1, -1, 2, -1), v).float(),
        flash_ref.gqa_attention(q, one.expand(-1, -1, 2, -1), v).float(),
        rtol=tol, atol=tol)
    flash_ops.reset_launches()
    empty = torch.zeros(0, 64, 2, 64, device="cuda")
    assert flash_ops.flash_attention(empty, empty, empty).shape == (0, 64, 2,
                                                                    64)
    assert flash_ops.LAUNCHES["flash_fwd"] == 0     # nothing to launch
    for bad in (torch.zeros(1, 64, 2, 48, device="cuda"),
                torch.zeros(1, 64, 2, 64, device="cuda", dtype=torch.half)):
        flash_ops.reset_launches()
        with pytest.raises(NotImplementedError, match="item 12b"):
            flash_ops.flash_attention(bad, bad, bad)
        assert flash_ops.LAUNCHES["flash_fwd"] == 0


# ---------------------------------------------------------------------------
# the lookups' probe lengths (PLEN), stats=True and kmer_hash's largest k
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", [1, 4, 32, 128])
def test_lookup_plen_holds_to_plain(window, scheme, key_words):
    """The ``PLEN`` instantiations of ``cops_lookup`` / ``cops_lookup64``:
    probe lengths bit-exact against ``lookup_plain``'s, and values, found
    and slots equal to the lookup's without them, on a table near full with
    TOMBSTONE-only windows, at the table's budget, at 1 and 2 windows, and
    at num_rows + 3 on a store with no EMPTY slot, where the kernel stops
    reading at num_rows (``contract.run_plen_case``); all 16 lookups
    launch the kernel."""
    _need_card()
    ops.reset_launches()
    checks = contract.run_plen_case(window=window, scheme=scheme,
                                    device="cuda", key_words=key_words)
    torch.cuda.synchronize()
    assert all(checks.values()), checks
    name = "cops_lookup" if key_words == 1 else "cops_lookup64"
    assert ops.LAUNCHES[name] == 16, ops.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("window", [2, 32, 128])
@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("batch", [1, 7, 8, 9, 33])
def test_lookup_plen_batch_sizes(batch, key_words, window):
    """Probe lengths of batches of 1, 7, 8, 9 and 33 keys around the walk's
    8 keys a warp (and 16 groups a warp at W = 2), a present key and an
    absent one in turn (``contract.run_plen_case``)."""
    _need_card()
    checks = contract.run_plen_case(window=window, device="cuda",
                                    key_words=key_words, batch=batch)
    torch.cuda.synchronize()
    assert all(checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("key_words", [1, 2])
def test_stats_on_card_walk_through_the_plen_kernel(key_words):
    """``stats=True`` on CUDA tables (sv insert / retrieve / update_values,
    counting insert / counts, mv insert / count_values / retrieve_all):
    each ``TableStats`` equals, field for field, ``bolt_on_stats`` of a CPU
    copy of the same post-op store (the plain walk), the outputs equal the
    same call's with ``stats=False`` on a copy of the table, and each
    call's bolt-on walk is one more lookup launch; nothing else walks."""
    import dataclasses
    from repro_torch.core import counting
    from repro_torch.obs import metrics
    _need_card()
    keys = contract.case_keys(key_words, 3000, "cuda")
    vals = contract.values_for(keys, 3)
    b = torch.cat([keys, keys[:500]])
    v = torch.cat([vals, vals[:500]])
    mask = torch.arange(b.shape[0], device="cuda") % 7 != 3
    name = "cops_lookup" if key_words == 1 else "cops_lookup64"

    def copy(t, dev):
        return dataclasses.replace(t, store={k: x.to(dev, copy=True)
                                             for k, x in t.store.items()})

    def held(call, table, status=None, m=None, result_table=None):
        """Run ``call(table, stats)`` with and without stats on copies of
        ``table``; returns the stats run's outputs."""
        l0 = ops.LAUNCHES[name]
        plain = call(copy(table, "cuda"), False)
        l1 = ops.LAUNCHES[name]
        got = call(table, True)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name] - l1 == l1 - l0 + 1, ops.LAUNCHES
        *out, st = got
        plain = plain if isinstance(plain, tuple) else (plain,)
        for a, c in zip(out, plain):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, c)
        after = out[0] if result_table else table
        s = out[1] if status else None
        want = metrics.bolt_on_stats(
            copy(after, "cpu"), b.cpu(), status=None if s is None else s.cpu(),
            mask=None if m is None else m.cpu())
        for f in dataclasses.fields(st):
            assert torch.equal(getattr(st, f.name).cpu(),
                               getattr(want, f.name)), f.name
        return out

    ops.reset_launches()
    t = sv.create(4096, device="cuda", key_words=key_words)
    t = held(lambda x, st: sv.insert(x, b, v, mask=mask, stats=st), t,
             status=True, m=mask, result_table=True)[0]
    held(lambda x, st: sv.retrieve(x, b, stats=st), t)
    t = held(lambda x, st: sv.update_values(x, b, ("add",), 1, mask=mask,
                                            combine=("add",), stats=st),
             t, status=True, m=mask, result_table=True)[0]
    c = counting.create(4096, device="cuda", key_words=key_words)
    c = held(lambda x, st: counting.insert(x, b, mask, stats=st), c,
             status=True, m=mask, result_table=True)[0]
    held(lambda x, st: counting.counts(x, b, stats=st), c)
    m = mv.create(4096, device="cuda", key_words=key_words)
    m = held(lambda x, st: mv.insert(x, b, v, mask=mask, stats=st), m,
             status=True, m=mask, result_table=True)[0]
    held(lambda x, st: mv.count_values(x, b, mask=mask, stats=st), m,
         m=mask)
    held(lambda x, st: mv.retrieve_all(x, b, 4096, mask=mask, stats=st), m,
         m=mask)


def _wide_kmer_hashes(bases: np.ndarray, k: int) -> np.ndarray:
    """Canonical k-mer hashes of one row for k > 16, computed apart from
    ``ref.kmer_hashes``: the forward word is the window's last 16 bases,
    the reverse word its first 16, and a window with an N is INVALID."""
    from repro_torch.core.hashing import mix_murmur3
    n = bases.shape[0] - k + 1
    b = bases.astype(np.int64)
    code = b & 3
    fwd = np.zeros(n, np.int64)
    rev = np.zeros(n, np.int64)
    for j in range(16):
        fwd = (fwd << 2) | code[k - 16 + j:k - 16 + j + n]
        rev |= (3 - code[j:j + n]) << (2 * j)
    bad = np.concatenate([[0], np.cumsum(b > 3)])
    bad = (bad[k:k + n] - bad[:n]) > 0
    h = mix_murmur3(torch.from_numpy(np.minimum(fwd, rev))).numpy()
    return np.where(bad, 0xFFFFFFFF, h).astype(np.uint32)


@pytest.mark.cuda
def test_kmer_hash_at_large_k_and_its_limit():
    """``kmer_hash`` at k = 48898 (above the first kernel's tile) against
    ``ref.kmer_hashes``, and at the kernel's largest k (``max_k()``,
    1,048,064) against ``_wide_kmer_hashes`` on rows one k-mer and a few
    k-mers long (a block spanning ~2048 rows, its span offsets near 2^31);
    above it the wrapper raises NotImplementedError naming its item and
    launches nothing."""
    _need_card()
    assert mh.max_k() == 1048064
    rng = np.random.default_rng(48898)
    one = rng.integers(0, 4, (1, 50000)).astype(np.uint8)
    one[0, 49500] = 4
    got = mh.kmer_hash(torch.from_numpy(one).cuda(), 48898)
    want = mh.kmer_hash(torch.from_numpy(one), 48898)
    assert torch.equal(got.cpu(), want)
    assert (want == INVALID_WORD).any() and (want != INVALID_WORD).any()
    k = mh.max_k()
    gen = torch.Generator(device="cuda").manual_seed(7)
    for length in (k, k + 5):
        rows = 2100 if length == k else 3          # 2.2 GB, then 3 MB
        bases = torch.randint(0, 4, (rows, length), dtype=torch.uint8,
                              device="cuda", generator=gen)
        bases[1, length // 2] = 4
        mh.reset_launches()
        got = mh.kmer_hash(bases, k).cpu().numpy()
        assert mh.LAUNCHES == {"kmer_hash": 1}
        for r in (0, 1, rows - 1):
            assert (got[r].view(np.uint32) == _wide_kmer_hashes(
                bases[r].cpu().numpy(), k)).all(), (length, r)
        del bases
    mh.reset_launches()
    with pytest.raises(NotImplementedError, match="item 7b"):
        mh.kmer_hash(torch.zeros((1, k + 1), dtype=torch.uint8,
                                 device="cuda"), k + 1)
    assert mh.LAUNCHES == {"kmer_hash": 0}
