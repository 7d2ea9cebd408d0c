"""repro_torch — the PyTorch + CUDA port of ``repro`` (WarpCore hash tables).

A package of its own beside the JAX reference ``repro``, with the same
module layout (``core``, ``kernels``, ``relational``, ``serving``,
``obs``).  It imports torch, numpy and the standard library only.
Tables live on the CUDA card unless the caller asks for the CPU
(``device="cpu"``), where each kernel's plain tensor version runs.
"""
