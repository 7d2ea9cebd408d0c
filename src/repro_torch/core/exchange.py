"""Owner routing: multisplit -> padded send buffers -> results back.

The port of the local half of ``repro.core.exchange``: every key is owned
by exactly one shard (``hashing.hash_owner`` of its folded probe word), and
a batch is routed to its owners through a padded buffer of ``P * cap``
slots, ``cap`` per owner (MoE-capacity-factor style), and the per-slot
results are gathered back into batch order.  Overflow (elements past
``cap`` in their owner's segment) is counted; callers size ``cap`` so it
is zero.  The elastic service (``serving.elastic``) runs P shards in one
process, where the buffer already *is* the post-all-to-all layout.

Not ported: ``exchange``, ``ownership_exchange`` and ``ownership_return``,
the collectives over a mesh (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hashing


def multisplit(owners: torch.Tensor, num_parts: int, *arrays: torch.Tensor):
    """Partition arrays by ``owners`` (values in [0, num_parts)).

    Returns (sorted_owners, counts, order, *sorted_arrays) where ``order``
    is the stable permutation (argsort by owner).
    """
    order = torch.argsort(owners, stable=True)
    counts = torch.bincount(owners, minlength=num_parts)
    return owners[order], counts, order, *[a[order] for a in arrays]


def owner_of(keys, num_owners: int, key_words: int):
    """Shard owner per key (int64, on the keys' device; numpy keys on the
    CPU): ``hash_owner`` of the fold of ALL ``key_words`` planes
    (``single_value.key_hash_word``), so keys that differ only in a high
    plane land on independent owners."""
    from repro_torch.core import single_value as sv
    device = keys.device if isinstance(keys, torch.Tensor) else "cpu"
    word = sv.key_hash_word(sv.normalize_key_batch(keys, key_words, device))
    return hashing.hash_owner(word, num_owners)


@dataclasses.dataclass
class ExchangePlan:
    """Bookkeeping to route a batch to owners and the results back."""
    slot: torch.Tensor        # (n,) int64 send-buffer slot, P * cap if none
    valid_send: torch.Tensor  # (P * cap,) bool: which slots are populated
    overflow: torch.Tensor    # 0-d int32: elements past their segment's cap
    cap: int


def make_plan(owners: torch.Tensor, num_parts: int, cap: int,
              mask: torch.Tensor | None = None) -> ExchangePlan:
    """Slot assignment for the padded exchange.

    ``mask`` ((n,) bool) drops elements from the exchange entirely: a
    masked-out element ranks in a virtual segment ``num_parts`` that gets
    no slots, so it consumes NO slot of a real segment (a bloom-filtered
    lookup admitting 10% of a batch sends 10% of the traffic), its slot
    is out of range (the scatter drops it, the return gather fills), and
    it never counts as overflow.
    """
    n, dev = owners.shape[0], owners.device
    owners = owners.to(torch.int64)
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    owners_eff = torch.where(mask, owners, num_parts)
    counts = torch.bincount(owners_eff, minlength=num_parts + 1)
    start = torch.cumsum(counts, 0) - counts
    # stable rank of each element within its segment
    order = torch.argsort(owners_eff, stable=True)
    rank = torch.empty((n,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev) - start[owners_eff[order]]
    ok = mask & (rank < cap)
    slot = torch.where(ok, owners * cap + rank, num_parts * cap)
    valid = torch.zeros((num_parts * cap + 1,), dtype=torch.bool, device=dev)
    valid[slot] = True
    return ExchangePlan(slot=slot, valid_send=valid[:-1],
                        overflow=(mask & (rank >= cap)).sum().to(torch.int32),
                        cap=cap)


def scatter_to_buffer(plan: ExchangePlan, x: torch.Tensor, num_parts: int,
                      fill=0) -> torch.Tensor:
    """The (P * cap, ...) send buffer: ``x``'s rows at their slots,
    ``fill`` (in ``x``'s dtype: an int32 word such as ``EMPTY_WORD``)
    elsewhere."""
    buf = torch.full((num_parts * plan.cap + 1,) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    buf[plan.slot] = x
    return buf[:-1]


def gather_from_buffer(plan: ExchangePlan, buf: torch.Tensor,
                       fill=0) -> torch.Tensor:
    """Per-slot results back in batch order; ``fill`` for elements that
    held no slot (masked out or overflowed)."""
    ok = plan.slot < buf.shape[0]
    out = buf[plan.slot.clamp(max=max(buf.shape[0] - 1, 0))]
    return torch.where(ok.reshape((-1,) + (1,) * (out.ndim - 1)), out,
                       torch.as_tensor(fill, dtype=buf.dtype,
                                       device=buf.device))
