"""CountingHashTable — counts key occurrences (paper §IV), ``repro.core.counting``.

A ``SingleValueHashTable`` whose value is a saturating u32 counter:
inserting a key adds one to its counter, and an absent key starts at 1.
Built on ``single_value.update_values`` with the fold ``("sat_add",)`` and
the combiner ``("add",)``: the kernel (``cops_update``) adds each
occurrence to its key's counter, stopping at 0xFFFFFFFF.  The JAX engine
sums a batch's occurrences first (n operands of 1 cannot wrap u32) and
adds the sum; stepwise and combined increments agree.

Tables live on the CUDA card unless ``device="cpu"`` (see
``single_value``).  ``stats=True`` returns an ``obs.metrics.TableStats``
beside the results, and ``insert_or_grow`` counts under the growth policy
of ``core.migrate``.
"""

from __future__ import annotations

from repro_torch.core import single_value as sv
from repro_torch.core.common import DEFAULT_SEED, DEFAULT_WINDOW

CountingHashTable = sv.SingleValueHashTable


def create(min_capacity: int, *, key_words: int = 1,
           window: int = DEFAULT_WINDOW, scheme: str = "cops",
           layout: str = "soa", seed: int = DEFAULT_SEED,
           max_probes: int | None = None, device=None) -> CountingHashTable:
    return sv.create(min_capacity, key_words=key_words, value_words=1,
                     window=window, scheme=scheme, layout=layout, seed=seed,
                     max_probes=max_probes, device=device)


def insert(table: CountingHashTable, keys, mask=None, stats: bool = False):
    """Count each key occurrence (saturating at 2^32 - 1).  Returns
    (table, status (n,) int32), and with ``stats=True`` a ``TableStats``;
    the store is updated in place."""
    return sv.update_values(table, keys, ("sat_add",), 1, mask,
                            combine=("add",), stats=stats)


def insert_or_grow(table: CountingHashTable, keys, mask=None, *,
                   policy=None, max_attempts: int = 4):
    """``insert`` under the auto-growth policy (see ``core.migrate``),
    through its ``insert_fn`` adapter: a grow / compact sweep carries each
    key's running count into the fresh store untouched."""
    from repro_torch.core import migrate
    return migrate.insert_or_grow(
        table, keys, None, mask,
        policy=migrate.DEFAULT_POLICY if policy is None else policy,
        insert_fn=lambda t, k, v, m: insert(t, k, m),
        max_attempts=max_attempts)


def counts(table: CountingHashTable, keys, stats: bool = False):
    """Occurrence count per key, int32 holding u32 bits (0 when absent);
    with ``stats=True`` the tuple ``(counts, TableStats)``."""
    res = sv.retrieve(table, keys, stats=stats)
    return (res[0], res[2]) if stats else res[0]
