#!/usr/bin/env python3
"""Time ``bloom_insert`` at the shape of fig12's serve step on a CUDA card.

    PYTHONPATH=src python3 tools/probe_bloom_step.py            # "step"
    PYTHONPATH=src python3 tools/probe_bloom_step.py phase20 [direct]

Run it from the root of the tree to measure, with that tree's ``src`` on
``PYTHONPATH`` (another tree's, to time its wrapper with this script).

- "step": ``ops.insert_words`` of 2^20 keys into an 8 x 1048583 x 16
  stack of filter words with a plane per key and a mask (the serve step's
  insert, ``chip_smoke.py`` phase 20): its device time (queued behind a
  sleep kernel, so the host's enqueue is hidden), its time with the host's
  enqueue (the card idle before the call), the wrapper's host time, and
  the C entry ``bloom_insert`` called alone (device time, host time of
  the call); medians of 100 after 10.
- "phase20": ``chip_smoke.py``'s phase 20 from the current directory;
  with "direct", every bloom insert takes the direct path
  (``PARTITION_KEYS_PER_SECTOR`` set to infinity).

Prints the card's name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

N, SHARDS, BLOCKS, WPB = 1 << 20, 8, 1048583, 16
REPS, WARMUP = 100, 10


def median(xs) -> str:
    return f"{statistics.median(xs):.4f} (min {min(xs):.4f})"


def step(torch) -> None:
    from repro_torch.kernels.bloom import ops
    words = torch.zeros((SHARDS, BLOCKS, WPB), dtype=torch.int32,
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    keys = torch.randint(-2 ** 31, 2 ** 31, (N,), dtype=torch.int32,
                         device="cuda", generator=gen)
    owners = torch.randint(0, SHARDS, (N,), device="cuda", generator=gen)
    mask = torch.ones((N,), dtype=torch.bool, device="cuda")
    kw = dict(k_hashes=4, seed=0x9E3779B9)
    planes32 = owners.to(torch.int32)
    stream = torch.cuda.current_stream().cuda_stream

    def wrapper():
        ops.insert_words(words, keys, mask, planes=owners, **kw)

    def entry():
        ops._lib().bloom_insert(words.data_ptr(), keys.data_ptr(),
                                mask.data_ptr(), planes32.data_ptr(), N,
                                SHARDS, BLOCKS, WPB, 4, 0x9E3779B9, stream)

    for name, fn in (("insert_words", wrapper), ("C entry", entry)):
        device, idle, host = [], [], []
        for rep in range(WARMUP + REPS):
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            a2 = torch.cuda.Event(enable_timing=True)
            b2 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a2.record()
            fn()
            b2.record()
            t1 = time.perf_counter()
            b2.synchronize()
            if rep >= WARMUP:
                device.append(a.elapsed_time(b))
                idle.append(a2.elapsed_time(b2))
                host.append((t1 - t0) * 1e3)
        print(f"{name}: device {median(device)} ms, with the host's "
              f"enqueue {median(idle)} ms, host {median(host)} ms",
              flush=True)


def phase20(torch, direct: bool) -> None:
    sys.path.insert(0, ".")
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.bloom import ops
    build.build_all()
    if direct:
        ops.PARTITION_KEYS_PER_SECTOR = float("inf")
    check = chip_smoke.Checks()
    chip_smoke.elastic_path(torch, "card", check, 20)
    print(f"phase 20 alone{' (every insert direct)' if direct else ''}: "
          f"failed checks {check.failed}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_bloom_step: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["phase20"]:
        phase20(torch, sys.argv[2:3] == ["direct"])
    else:
        step(torch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
