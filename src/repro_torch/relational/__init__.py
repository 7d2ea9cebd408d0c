"""repro_torch.relational — the relational operators of ``repro.relational``.

The operators whose cuDF counterparts the paper's headline comparison
stands in for, on the port's tables:

- ``join.hash_join`` — inner / left / semi / anti hash join on a
  ``MultiValueHashTable`` (``cops_append`` build, ``cops_retrieve`` probe);
- ``groupby.aggregate`` — sum / min / max / count / mean on a
  ``SingleValueHashTable`` with two value words, one read-modify-write per
  group (``cops_update``, ``cops_update64``);
- ``distinct.distinct`` — drop-duplicates on a hash set's insert status.

Keys may be composite (a tuple of u32 columns, ``key_words`` inferred).
The sharded join (``shard_join``) waits for ROADMAP.md queue 1 item 9.
"""

from repro_torch.relational import distinct, groupby, join, util
from repro_torch.relational.groupby import AGGS, aggregate
from repro_torch.relational.join import HOW, NO_MATCH, JoinResult, hash_join

__all__ = ["AGGS", "HOW", "NO_MATCH", "JoinResult", "aggregate", "distinct",
           "groupby", "hash_join", "join", "util"]
