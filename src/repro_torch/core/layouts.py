"""Store protocol: the SOA layout of ``repro.core.layouts``.

:class:`SoaOps` binds the table geometry once and renders the access
patterns the engines need: the key planes, batched slot writes and
tombstones by flat slot id (``row * window + lane``), and the gather of
value vectors by slot id that the multi-value compaction reads through.  Stores are dicts
of int32 tensors ``{"keys": (key_words, p, W), "values": (value_words, p,
W)}`` holding u32 bits (see ``common``).

Unlike the JAX package, whose arrays are immutable, the writes here update
the planes **in place**: a table-sized store is never copied per batch.
The AOS, packed and bucketed layouts are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.common import EMPTY_WORD, TOMBSTONE_WORD

LAYOUTS = ("soa", "aos", "packed", "bucketed", "bucketedq")


@dataclasses.dataclass(frozen=True)
class SoaOps:
    num_rows: int
    window: int
    key_words: int
    value_words: int

    kind = "soa"

    @property
    def arena_capacity(self) -> int:
        """Number of flat slot ids: ``num_rows * window``."""
        return self.num_rows * self.window

    def create(self, device) -> dict:
        shape = (self.num_rows, self.window)
        return {
            "keys": torch.full((self.key_words, *shape), EMPTY_WORD,
                               dtype=torch.int32, device=device),
            "values": torch.zeros((self.value_words, *shape),
                                  dtype=torch.int32, device=device),
        }

    def key_planes(self, store: dict) -> torch.Tensor:
        """All key words as a (key_words, p, W) tensor."""
        return store["keys"]

    def scatter_batch(self, store: dict, slots: torch.Tensor,
                      keys: torch.Tensor, vals: torch.Tensor,
                      key_mask: torch.Tensor) -> None:
        """Write ``vals`` (n, vw) at flat ``slots`` and ``keys`` (n, kw)
        where ``key_mask``, in place.  Slots must be distinct and in range."""
        flat_k = store["keys"].view(self.key_words, self.arena_capacity)
        flat_v = store["values"].view(self.value_words, self.arena_capacity)
        flat_v[:, slots] = vals.T
        flat_k[:, slots[key_mask]] = keys[key_mask].T

    def arena_values(self, store: dict, slots: torch.Tensor) -> torch.Tensor:
        """Value vectors (n, value_words) at flat slot ids (in range)."""
        return store["values"].view(self.value_words,
                                    self.arena_capacity)[:, slots].T

    def tombstone_slots(self, store: dict, slots: torch.Tensor) -> None:
        """Write TOMBSTONE into every key word of the flat ``slots``, in place."""
        flat_k = store["keys"].view(self.key_words, self.arena_capacity)
        flat_k[:, slots] = TOMBSTONE_WORD
