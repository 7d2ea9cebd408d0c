"""Plain tensor versions of the k-mer / minhash front end, bit-exact
against ``repro.kernels.minhash.ref``.

Bases are uint8 codes (0..3 for A, C, G, T; anything above 3 marks an N);
hashes are int32 words holding u32 bits, INVALID = 0xFFFFFFFF (int32 -1)
where a window holds an N.  A k-mer's forward word takes 2 bits per base,
first base highest, and keeps its low 32 bits (the last 16 bases); its
reverse complement puts base j's complement at bits 2j, and bases past
the 16th shift out of 32 bits (the JAX package's shifts by 32 or more
give 0).  The canonical k-mer is the smaller word; its hash is murmur3's
fmix32.
"""

from __future__ import annotations

import torch

from repro_torch.core.common import MASK32, as_word
from repro_torch.core.hashing import mix_murmur3

INVALID = 0xFFFFFFFF
INVALID_WORD = -1
_SIGN = -2 ** 31       # flips int32 order to u32 order


def kmer_hashes(bases: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mer hash per window start: (..., L) uint8 bases ->
    (..., L - k + 1) int32 words."""
    b = bases.to(torch.int64)
    n = b.shape[-1] - k + 1
    fwd = torch.zeros((*b.shape[:-1], n), dtype=torch.int64, device=b.device)
    rev = torch.zeros_like(fwd)
    bad = torch.zeros(fwd.shape, dtype=torch.bool, device=b.device)
    for j in range(k):
        bj = b[..., j:j + n]
        bad |= bj > 3
        code = bj & 3
        fwd = ((fwd << 2) | code) & MASK32
        if 2 * j < 32:
            rev |= (3 - code) << (2 * j)
    h = as_word(mix_murmur3(torch.minimum(fwd, rev)))
    return torch.where(bad, INVALID_WORD, h)


def minhash_sketch(hashes: torch.Tensor, s: int) -> torch.Tensor:
    """The s smallest *distinct* valid hashes of each row, in ascending u32
    order, INVALID-padded (MetaCache): (..., n) -> (..., min(s, n)) int32
    words."""
    n = hashes.shape[-1]
    h = torch.sort(hashes.reshape(-1, n) ^ _SIGN, dim=1).values ^ _SIGN
    keep = h != INVALID_WORD
    keep[:, 1:] &= h[:, 1:] != h[:, :-1]
    rank = torch.cumsum(keep, dim=1) - 1
    width = min(s, n)
    out = torch.full((h.shape[0], width), INVALID_WORD, dtype=torch.int32,
                     device=h.device)
    rows, cols = torch.nonzero(keep & (rank < width), as_tuple=True)
    out[rows, rank[rows, cols]] = h[rows, cols]
    return out.reshape(*hashes.shape[:-1], width)
