"""repro_torch.core — the hash-table data structures of ``repro.core``.

Ported so far, on the SOA store with the cops and linear schemes: the
single-value table (``single_value``), the counting table
(``counting``), the hash set (``hashset``), the multi-value table
(``multi_value``) and the bucket list (``bucket_list``, paper §IV-C),
their bulk engines (``bulk``, ``bulk_retrieve``) and their substrate
(``common``, ``hashing``, ``probing``, ``layouts``), plus ``convert``, a
numpy bridge from and to the JAX package's table state.  The elastic
service's substrate: the blocked bloom filter (``bloom``), the owner
exchange plan (``exchange``), migration (``migrate``: the live-set
sweep, ``grow``, ``compact``) and snapshots in the JAX package's format
(``snapshot``).
"""

from repro_torch.core import (
    bloom,
    bucket_list,
    bulk,
    bulk_retrieve,
    common,
    convert,
    counting,
    exchange,
    hashing,
    hashset,
    layouts,
    migrate,
    multi_value,
    probing,
    single_value,
    snapshot,
)
from repro_torch.core.bucket_list import BucketListHashTable
from repro_torch.core.multi_value import MultiValueHashTable
from repro_torch.core.single_value import SingleValueHashTable

__all__ = ["BucketListHashTable", "MultiValueHashTable",
           "SingleValueHashTable", "bloom", "bucket_list", "bulk",
           "bulk_retrieve", "common", "convert", "counting", "exchange",
           "hashing", "hashset", "layouts", "migrate", "multi_value",
           "probing", "single_value", "snapshot"]
