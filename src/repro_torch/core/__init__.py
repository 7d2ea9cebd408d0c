"""repro_torch.core — the hash-table data structures of ``repro.core``.

Ported so far: the single-value table (``single_value``) on the SOA store
with the cops and linear schemes, its bulk engines (``bulk``,
``bulk_retrieve``) and their substrate (``common``, ``hashing``,
``probing``, ``layouts``), plus ``convert``, a numpy bridge from and to
the JAX package's table state.
"""

from repro_torch.core import (
    bulk,
    bulk_retrieve,
    common,
    convert,
    hashing,
    layouts,
    probing,
    single_value,
)
from repro_torch.core.single_value import SingleValueHashTable

__all__ = ["SingleValueHashTable", "bulk", "bulk_retrieve", "common",
           "convert", "hashing", "layouts", "probing", "single_value"]
