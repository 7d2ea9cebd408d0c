"""The k-mer hashing kernel's wrappers, launch counter and the sketch.

``kmer_hashes`` replaces ``repro.kernels.minhash.ops.kmer_hashes``: on a
CUDA tensor it launches ``kmer_hash`` (``csrc/minhash.cu``, built by
``kernels.build``) on the current stream, adds one to ``LAUNCHES`` and
its k-mers to ``ELEMENTS``, and raises if the launch reports a CUDA error;
on a CPU tensor it runs the plain version, ``ref.kmer_hashes``; on any
other device it raises.  ``sketch_reads`` is the front half of the
metagenomics pipeline (paper §V-C): reads -> canonical k-mer hashes ->
each read's minhash sketch (``ref.minhash_sketch``, the s smallest
distinct hashes), whose hashes a bucket list then takes as keys.  Both
run on the CUDA card unless the caller passes ``device="cpu"``, and raise
without a card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.single_value import resolve_device
from repro_torch.kernels.minhash import ref

#: launches of each kernel since the last ``reset_launches``
LAUNCHES = {"kmer_hash": 0}
#: the k-mers those launches hashed
ELEMENTS = dict.fromkeys(LAUNCHES, 0)

def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = ELEMENTS[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.library("minhash")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.kmer_hash.argtypes = [vp, vp, ll, ll, ctypes.c_int, vp]
    lib.kmer_hash.restype = ctypes.c_int
    lib.kmer_hash_max_k.argtypes = []
    lib.kmer_hash_max_k.restype = ctypes.c_int
    return lib


def max_k() -> int:
    """The largest k the kernel takes (``kmer_hash_max_k``: 1,048,064, where
    a block's span of bases still has 32-bit offsets); loads the library."""
    return _lib().kmer_hash_max_k()


def _bases(bases, device) -> torch.Tensor:
    """uint8 base codes as a contiguous tensor on ``device`` (None: the
    CUDA card)."""
    if isinstance(bases, np.ndarray):
        bases = torch.from_numpy(np.ascontiguousarray(bases))
    if not isinstance(bases, torch.Tensor) or bases.dtype != torch.uint8:
        raise TypeError(f"expected uint8 base codes, got "
                        f"{getattr(bases, 'dtype', type(bases))}")
    return bases.to(resolve_device(device)).contiguous()


def kmer_hash(bases: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's wrapper: (R, L) uint8 bases on one device -> (R, L -
    k + 1) int32 hash words, for every k in [1, L] as the reference; on
    the card k above ``max_k()`` raises NotImplementedError."""
    if bases.ndim != 2 or bases.dtype != torch.uint8:
        raise ValueError(f"expected (R, L) uint8 bases, got "
                         f"{tuple(bases.shape)} {bases.dtype}")
    rows, length = bases.shape
    if not 1 <= k <= length:
        raise ValueError(f"k={k} must be in [1, L={length}]")
    if bases.device.type == "cpu":
        return ref.kmer_hashes(bases, k)
    if bases.device.type != "cuda":
        raise ValueError(f"kmer_hash runs on CUDA or CPU tensors, not "
                         f"{bases.device}")
    if k > max_k():
        raise NotImplementedError(
            f"kmer_hash at k={k} > {max_k()} on the card is not ported to "
            "repro_torch yet: see ROADMAP.md queue 1 item 7b (k-mer hashing "
            "above the kernel's 32-bit span offsets)")
    bases = bases.contiguous()
    out = torch.empty((rows, length - k + 1), dtype=torch.int32,
                      device=bases.device)
    if rows:
        with torch.cuda.device(bases.device):
            rc = _lib().kmer_hash(bases.data_ptr(), out.data_ptr(), rows,
                                  length, k,
                                  torch.cuda.current_stream().cuda_stream)
        LAUNCHES["kmer_hash"] += 1
        ELEMENTS["kmer_hash"] += out.numel()
        if rc != 0:
            raise RuntimeError(f"kmer_hash launch failed with CUDA error {rc}")
    return out


def kmer_hashes(bases, *, k: int, device=None) -> torch.Tensor:
    """(L,) or (R, L) uint8 base codes -> (L - k + 1,) or (R, L - k + 1)
    canonical k-mer hashes (int32 words, INVALID where a window holds an
    N).  ``bases`` (numpy or torch) moves to ``device`` first."""
    bases = _bases(bases, device)
    if bases.ndim == 1:
        return kmer_hash(bases[None], k)[0]
    return kmer_hash(bases, k)


def sketch_reads(reads, *, k: int, s: int, device=None) -> torch.Tensor:
    """(R, L) base-code reads -> (R, s) minhash sketches: each read's s
    smallest distinct valid hashes in ascending u32 order, INVALID-padded
    (int32 words)."""
    reads = _bases(reads, device)
    if reads.ndim != 2:
        raise ValueError(f"expected (R, L) reads, got {tuple(reads.shape)}")
    return ref.minhash_sketch(kmer_hash(reads, k), s)
