"""CountingHashTable — counts key occurrences (paper §IV), ``repro.core.counting``.

A ``SingleValueHashTable`` whose value is a saturating u32 counter:
inserting a key adds one to its counter, and an absent key starts at 1.
Built on ``single_value.update_values`` with the fold ``("sat_add",)`` and
the combiner ``("add",)``: the kernel (``cops_update``) adds each
occurrence to its key's counter, stopping at 0xFFFFFFFF.  The JAX engine
sums a batch's occurrences first (n operands of 1 cannot wrap u32) and
adds the sum; stepwise and combined increments agree.

Tables live on the CUDA card unless ``device="cpu"`` (see
``single_value``).  Not ported: ``insert_or_grow`` and the ``stats=True``
telemetry (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

from repro_torch.core import single_value as sv
from repro_torch.core.common import DEFAULT_SEED, DEFAULT_WINDOW

CountingHashTable = sv.SingleValueHashTable

_ITEM_8 = ("is not ported to repro_torch yet: see ROADMAP.md queue 1 item 8 "
           "(growth, snapshots and telemetry)")


def create(min_capacity: int, *, key_words: int = 1,
           window: int = DEFAULT_WINDOW, scheme: str = "cops",
           layout: str = "soa", seed: int = DEFAULT_SEED,
           max_probes: int | None = None, device=None) -> CountingHashTable:
    return sv.create(min_capacity, key_words=key_words, value_words=1,
                     window=window, scheme=scheme, layout=layout, seed=seed,
                     max_probes=max_probes, device=device)


def insert(table: CountingHashTable, keys, mask=None, stats: bool = False):
    """Count each key occurrence (saturating at 2^32 - 1).  Returns
    (table, status (n,) int32); the store is updated in place."""
    return sv.update_values(table, keys, ("sat_add",), 1, mask,
                            combine=("add",), stats=stats)


def insert_or_grow(table: CountingHashTable, keys, mask=None, *,
                   policy=None, max_attempts: int = 4):
    raise NotImplementedError(f"insert_or_grow {_ITEM_8}")


def counts(table: CountingHashTable, keys, stats: bool = False):
    """Occurrence count per key, int32 holding u32 bits (0 when absent)."""
    return sv.retrieve(table, keys, stats=stats)[0]
