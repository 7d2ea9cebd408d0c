"""repro_torch.core — the hash-table data structures of ``repro.core``.

Ported so far, on the SOA store with the cops and linear schemes: the
single-value table (``single_value``), the counting table
(``counting``), the hash set (``hashset``), the multi-value table
(``multi_value``) and the bucket list (``bucket_list``, paper §IV-C),
their bulk engines (``bulk``, ``bulk_retrieve``) and their substrate
(``common``, ``hashing``, ``probing``, ``layouts``), plus ``convert``, a
numpy bridge from and to the JAX package's table state.
"""

from repro_torch.core import (
    bucket_list,
    bulk,
    bulk_retrieve,
    common,
    convert,
    counting,
    hashing,
    hashset,
    layouts,
    multi_value,
    probing,
    single_value,
)
from repro_torch.core.bucket_list import BucketListHashTable
from repro_torch.core.multi_value import MultiValueHashTable
from repro_torch.core.single_value import SingleValueHashTable

__all__ = ["BucketListHashTable", "MultiValueHashTable",
           "SingleValueHashTable", "bucket_list", "bulk",
           "bulk_retrieve", "common", "convert", "counting", "hashing",
           "hashset", "layouts", "multi_value", "probing", "single_value"]
