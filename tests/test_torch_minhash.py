"""The port's k-mer hashing and minhash sketches
(``repro_torch.kernels.minhash``) against the JAX package's
(``repro.kernels.minhash``: the Pallas kernel in interpret mode through
``ops`` and the plain oracle ``ref``), bit-exact.

The same seeded numpy bases go through both packages on the CPU, where
the port runs its plain versions.  Hashes are u32 words and the tolerance
is zero.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minhash import ops as jmh
from repro.kernels.minhash import ref as jref
from repro_torch.core.common import to_numpy_u32
from repro_torch.kernels.minhash import ops as tmh
from repro_torch.kernels.minhash import ref as tref

_FAST = {"xla_backend_optimization_level": 0,
         "xla_cpu_use_fusion_emitters": False}

def _bases(rng, shape, n_rate=0.01):
    """Random base codes, with N (codes 4 and 255) at ``n_rate``, and
    one of each at least when ``n_rate`` > 0."""
    b = rng.integers(0, 4, shape).astype(np.uint8)
    b[rng.random(shape) < n_rate / 2] = 4
    b[rng.random(shape) < n_rate / 2] = 255
    if n_rate:
        b.flat[rng.choice(b.size, 2, replace=False)] = (4, 255)
    return b


@pytest.mark.parametrize("length", [100, 1337])
@pytest.mark.parametrize("k", [8, 16, 20])
def test_kmer_hashes_match_jax(k, length):
    """Every window, N windows included, against the Pallas kernel (the
    oracle ``ref`` in the tests below); k = 20 shifts reverse-complement
    bases out of 32 bits."""
    rng = np.random.default_rng([k, length])
    bases = _bases(rng, length)
    want = np.asarray(jmh.kmer_hashes(jnp.asarray(bases), k=k))
    got = tmh.kmer_hashes(bases, k=k, device="cpu")
    assert got.shape == (length - k + 1,) and got.dtype == torch.int32
    np.testing.assert_array_equal(want, to_numpy_u32(got))
    assert (want == 0xFFFFFFFF).any() and (want != 0xFFFFFFFF).any()


@pytest.mark.parametrize("k", [8, 16, 20])
def test_reverse_complement_symmetry(k):
    """A sequence and its reverse complement hash to the same canonical
    k-mers, in reverse order, on both packages."""
    rng = np.random.default_rng(k)
    bases = _bases(rng, 300, n_rate=0.0)
    rc = (3 - bases[::-1]).copy()
    fwd = to_numpy_u32(tmh.kmer_hashes(bases, k=k, device="cpu"))
    np.testing.assert_array_equal(
        fwd, to_numpy_u32(tmh.kmer_hashes(rc, k=k, device="cpu"))[::-1])
    np.testing.assert_array_equal(
        fwd, np.asarray(jref.kmer_hashes(jnp.asarray(rc), k))[::-1])


@pytest.mark.parametrize("k, s", [(8, 24), (16, 16), (20, 64)])
def test_sketch_reads_match_jax(k, s):
    """(R, L) batches of reads with N bases: the sketches (against the
    Pallas path, and one row's against the oracle), the hashes of a row
    and the 1-D call on one row agree with the JAX package."""
    rng = np.random.default_rng([k, s])
    reads = _bases(rng, (6, 150))
    want = np.asarray(jmh.sketch_reads(jnp.asarray(reads), k=k, s=s))
    got = tmh.sketch_reads(reads, k=k, s=s, device="cpu")
    assert got.shape == (6, s)
    np.testing.assert_array_equal(want, to_numpy_u32(got))
    rows = tmh.kmer_hashes(reads, k=k, device="cpu")
    np.testing.assert_array_equal(
        to_numpy_u32(rows[2]), to_numpy_u32(tmh.kmer_hashes(reads[2], k=k, device="cpu")))
    hashes = jref.kmer_hashes(jnp.asarray(reads[5]), k)
    np.testing.assert_array_equal(to_numpy_u32(rows[5]), np.asarray(hashes))
    np.testing.assert_array_equal(
        want[5], np.asarray(jref.minhash_sketch(hashes, s)))


def test_sketch_pads_with_invalid():
    """Fewer distinct valid hashes than s: the sketch is padded with
    INVALID; duplicates count once; a row of Ns sketches to INVALID."""
    base = np.array([0, 1, 2, 3] * 8, np.uint8)        # 4 distinct 8-mers
    reads = np.stack([base, np.full(32, 4, np.uint8)])
    want = np.asarray(jmh.sketch_reads(jnp.asarray(reads), k=8, s=10))
    got = to_numpy_u32(tmh.sketch_reads(reads, k=8, s=10, device="cpu"))
    np.testing.assert_array_equal(want, got)
    assert (got[0, :2] != tref.INVALID).all() and (got[0, 4:] == tref.INVALID).all()
    assert (got[1] == tref.INVALID).all()
    assert (np.diff(got[0][got[0] != tref.INVALID].astype(np.int64)) > 0).all()


def _rolling_kmer_hashes(bases, k, per_thread):
    """The card kernel's recurrence (``csrc/minhash.cu``: ``hash_run``)
    written in torch: the flat outputs of (R, L) bases cut into runs of
    ``per_thread``; a run builds its first k-mer in k steps and rolls each
    later one in by one base (fwd takes the new last base, masked to 2k
    bits below k = 16; rev drops its first base and takes base min(k, 16)
    - 1 of the new window at the top; the N test compares the window's
    start with the last N's position), and where a row ends it skips the
    k - 1 bases that start no k-mer and builds anew."""
    from repro_torch.core.common import MASK32, as_word
    from repro_torch.core.hashing import mix_murmur3
    rows, length = bases.shape
    n_out = length - k + 1
    flat = bases.reshape(-1).to(torch.int64)
    total = rows * n_out
    f = torch.arange(0, total, per_thread)
    row = f // n_out
    p = f + row * (k - 1)
    left = n_out - (f - row * n_out)
    fmask = MASK32 if k >= 16 else (1 << 2 * k) - 1
    top = 2 * (min(k, 16) - 1)
    fwd = torch.zeros_like(f)
    rev = torch.zeros_like(f)
    last_n = p - 1
    fresh = torch.ones_like(f, dtype=torch.bool)

    def base(at):
        return flat[at.clamp(max=flat.numel() - 1)]

    out = []
    for _ in range(per_thread):
        bf, br, bl = torch.zeros_like(f), torch.zeros_like(f), p - 1
        for i in range(k):
            b = base(p + i)
            bl = torch.where(b > 3, p + i, bl)
            bf = ((bf << 2) | (b & 3)) & MASK32
            if i < 16:
                br |= (3 - (b & 3)) << (2 * i)
        b = base(p + k - 1)
        rl = torch.where(b > 3, p + k - 1, last_n)
        rf = ((fwd << 2) | (b & 3)) & fmask
        c = base(p + 15) if k > 16 else b
        rr = (rev >> 2) | ((3 - (c & 3)) << top)
        fwd, rev = torch.where(fresh, bf, rf), torch.where(fresh, br, rr)
        last_n = torch.where(fresh, bl, rl)
        out.append(torch.where(last_n >= p, tref.INVALID_WORD,
                               as_word(mix_murmur3(torch.minimum(fwd, rev)))))
        p, left = p + 1, left - 1
        fresh = left == 0
        p = torch.where(fresh, p + k - 1, p)
        left = torch.where(fresh, n_out, left)
    return torch.stack(out, 1).reshape(-1)[:total].reshape(rows, n_out)


@functools.cache
def _rolling_case(k):
    """Seeded bases for k: 5 rows of each length k, k + 3 (4 k-mers a row,
    so row boundaries fall inside a thread's run) and 61, with N codes 4
    and 255 at row starts, row ends and inside windows; and the JAX
    oracle's hashes of each row (one jitted call on the rows padded to 61
    bases: the first L - k + 1 windows of a padded row are the row's)."""
    rng = np.random.default_rng(k)
    layouts = []
    for length in (k, k + 3, 61):
        bases = _bases(rng, (5, length), n_rate=0.03)
        bases[0, 0], bases[1, -1], bases[2, length // 2] = 4, 255, 4
        layouts.append(bases)
    padded = np.concatenate([np.pad(b, ((0, 0), (0, 61 - b.shape[1])))
                             for b in layouts])
    oracle = jax.jit(jax.vmap(lambda r: jref.kmer_hashes(r, k)),
                     compiler_options=_FAST)
    want = np.asarray(oracle(jnp.asarray(padded)))
    return [(b, want[5 * i:5 * i + 5, :b.shape[1] - k + 1])
            for i, b in enumerate(layouts)]


@pytest.mark.parametrize("per_thread", [8, 16])
def test_rolling_recurrence_matches_for_every_k(per_thread):
    """The kernel's rolling recurrence, for every k from 1 to 40, across
    row restarts inside and between runs (``_rolling_case``): equal to
    ``ref.kmer_hashes`` and to the JAX package's oracle.  The kernel's
    outputs a thread (``kOut``) is one of the runs tested."""
    source = (Path(tmh.__file__).parent / "csrc" / "minhash.cu").read_text()
    assert int(re.search(r"kOut = (\d+);", source)[1]) in (8, 16)
    for k in range(1, 41):
        for bases, want in _rolling_case(k):
            tb = torch.from_numpy(bases)
            got = _rolling_kmer_hashes(tb, k, per_thread)
            assert torch.equal(got, tref.kmer_hashes(tb, k)), k
            np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_cpu_launches_no_kernel():
    tmh.reset_launches()
    reads = np.zeros((3, 40), np.uint8)
    tmh.sketch_reads(reads, k=16, s=4, device="cpu")
    tmh.kmer_hashes(reads[0], k=16, device="cpu")
    assert tmh.LAUNCHES == {"kmer_hash": 0}


def test_bad_inputs_raise():
    with pytest.raises(TypeError, match="uint8"):
        tmh.kmer_hashes(np.zeros(40, np.int32), k=8, device="cpu")
    with pytest.raises(ValueError, match="k=41"):
        tmh.kmer_hashes(np.zeros(40, np.uint8), k=41, device="cpu")
    with pytest.raises(ValueError, match=r"\(R, L\)"):
        tmh.sketch_reads(np.zeros(40, np.uint8), k=8, s=4, device="cpu")


def test_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the ops use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmh.kmer_hashes(np.zeros(40, np.uint8), k=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmh.sketch_reads(np.zeros((2, 40), np.uint8), k=8, s=4)


def test_kmer_hashes_at_a_large_k_match_jax():
    """k = 48898, above the limit the port once refused (the first card
    kernel's shared-memory tile): one read of 50,000 bases against the
    JAX oracle, an N late in the read so that the first 603 windows are
    valid and the rest INVALID.  On the CPU every k in [1, L] runs, as in
    the reference."""
    rng = np.random.default_rng(48898)
    bases = rng.integers(0, 4, 50000).astype(np.uint8)
    bases[49500] = 4
    want = np.asarray(jref.kmer_hashes(jnp.asarray(bases), 48898))
    got = to_numpy_u32(tmh.kmer_hashes(bases, k=48898, device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert (want[:603] != tref.INVALID).all()
    assert (want[603:] == tref.INVALID).all()
