"""Hand-written Hopper (sm_90a) kernels of the port.

- ``cops`` — COPS probing in CUDA C++ (``cops/csrc/cops.cu``):
  ``cops_insert`` (single-value upsert), ``cops_lookup``, ``cops_append``
  (multi-value append) and ``cops_retrieve`` (the multi-value walk), and
  their two-plane twins for two-word keys (``cops_insert64``,
  ``cops_lookup64``, ``cops_append64``, ``cops_retrieve64``), and
  ``cops_bucket_walk`` (the bucket list's chain walk over its value pool),
  and ``cops_update`` / ``cops_update64`` (the group-by's and the counting
  table's read-modify-write upsert), with their wrappers, plain tensor versions and launch counters in
  ``cops/ops.py`` and the contracts that hold them to the plain versions
  in ``cops/contract.py``.
- ``minhash`` — canonical k-mer hashing in CUDA C++
  (``minhash/csrc/minhash.cu``: ``kmer_hash``), with its wrappers, launch
  counter and the minhash sketch in ``minhash/ops.py`` and the plain
  versions in ``minhash/ref.py``.
- ``bloom`` — the blocked bloom filter's insert and query in CUDA C++
  (``bloom/csrc/bloom.cu``: ``bloom_insert``, one ``atomicOr`` per touched
  word, and ``bloom_query``), over one filter or a stack of filters with a
  plane per key, with their wrappers, plain versions and launch counters
  in ``bloom/ops.py`` and the bit-view arithmetic in ``bloom/ref.py``.
- ``flash`` — flash attention's forward in CUDA C++
  (``flash/csrc/flash.cu``: ``flash_fwd``, an f32 online softmax over K/V
  tiles streamed past a query tile, grouped KV heads read in place, f32 or
  bf16 at head dims 16, 32, 64 and 128), with its wrappers and launch
  counter in ``flash/ops.py`` and the plain attention in ``flash/ref.py``.

``build`` compiles the CUDA sources with nvcc at first use.
"""
