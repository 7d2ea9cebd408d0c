"""Probing schemes over the (p, W) row layout — COPS and the linear baseline.

One *probe window* is one row of W lanes; the outer scheme walks rows and
the inner scheme is linear over the lanes, resolved by a vote (the
warp-cooperative window of §IV-B.2: ``__ballot_sync`` + ``__ffs`` in the
CUDA kernels, ``vote_*`` below in tensor code).

- ``"cops"``   — double hashing over rows: row_{l+1} = (row_l + g(k)) mod p.
                 With W = 1 it is scalar double hashing.
- ``"linear"`` — row_{l+1} = (row_l + 1) mod p.  With W = 1 it is
                 one-thread-per-key linear probing.

``quadratic`` and ``bucketed`` are schemes of the JAX package that this
port does not carry yet (``single_value.create`` refuses them).

Each walk starts at ``h1(k) mod p`` and runs at most
``effective_probes(scheme, max_probes, p)`` windows: the budget clamped to
the rows the scheme can reach, so no walk revisits a row.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashing

SCHEMES = ("cops", "linear", "quadratic", "bucketed")


def scheme_coverage(scheme: str, num_rows: int) -> int:
    """Number of DISTINCT rows a scheme's walk can ever reach."""
    if scheme == "quadratic":
        return (num_rows + 1) // 2
    if scheme == "bucketed":
        return min(2, num_rows)
    if scheme in ("cops", "linear"):
        return num_rows
    raise ValueError(f"unknown scheme {scheme!r}")


def effective_probes(scheme: str, max_probes: int, num_rows: int) -> int:
    """Per-walk probe budget clamped to the scheme's distinct-row coverage."""
    return max(1, min(int(max_probes), scheme_coverage(scheme, num_rows)))


def initial_row(key_word: torch.Tensor, num_rows: int, seed: int) -> torch.Tensor:
    """First probe row (int64)."""
    return hashing.hash_rows(key_word, num_rows, seed)


def row_step(scheme: str, key_word: torch.Tensor, num_rows: int,
             seed: int) -> torch.Tensor:
    """Per-key row increment, constant across attempts (int64)."""
    if scheme == "cops":
        return hashing.hash_step(key_word, num_rows, seed)
    if scheme == "linear":
        return torch.ones(key_word.shape, dtype=torch.int64,
                          device=key_word.device)
    raise NotImplementedError(f"scheme {scheme!r} is not ported yet")


def advance_row(row: torch.Tensor, step: torch.Tensor,
                num_rows: int) -> torch.Tensor:
    """Next row of a cops / linear walk."""
    return (row + step) % num_rows


def vote_lowest(mask: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set lane, or W if none.  mask: (..., W) bool."""
    w = mask.shape[-1]
    lanes = torch.arange(w, dtype=torch.int64, device=mask.device)
    return torch.where(mask, lanes, w).amin(dim=-1)


def vote_any(mask: torch.Tensor) -> torch.Tensor:
    """Group-any over the window lanes."""
    return mask.any(dim=-1)
