"""The port's k-mer hashing and minhash sketches
(``repro_torch.kernels.minhash``) against the JAX package's
(``repro.kernels.minhash``: the Pallas kernel in interpret mode through
``ops`` and the plain oracle ``ref``), bit-exact.

The same seeded numpy bases go through both packages on the CPU, where
the port runs its plain versions.  Hashes are u32 words and the tolerance
is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minhash import ops as jmh
from repro.kernels.minhash import ref as jref
from repro_torch.core.common import to_numpy_u32
from repro_torch.kernels.minhash import ops as tmh
from repro_torch.kernels.minhash import ref as tref


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
