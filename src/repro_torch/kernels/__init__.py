"""Hand-written Hopper (sm_90a) kernels of the port.

- ``cops`` — COPS probing in CUDA C++ (``cops/csrc/cops.cu``):
  ``cops_insert`` (single-value upsert), ``cops_lookup``, ``cops_append``
  (multi-value append) and ``cops_retrieve`` (the multi-value walk), and
  their two-plane twins for two-word keys (``cops_insert64``,
  ``cops_lookup64``, ``cops_append64``, ``cops_retrieve64``), with their
  wrappers, plain tensor versions and launch counters in ``cops/ops.py``
  and the contracts that hold them to the plain versions in
  ``cops/contract.py``.

``build`` compiles the CUDA sources with nvcc at first use.
"""
