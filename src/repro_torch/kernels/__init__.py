"""Hand-written Hopper (sm_90a) kernels of the port.

- ``cops`` — COPS probing: ``cops_insert`` (single-value upsert) and
  ``cops_lookup`` in CUDA C++ (``cops/csrc/cops.cu``), with their wrappers,
  plain tensor versions and launch counters in ``cops/ops.py``.

``build`` compiles the CUDA sources with nvcc at first use.
"""
