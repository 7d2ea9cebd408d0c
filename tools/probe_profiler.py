#!/usr/bin/env python3
"""Probe when ``torch.profiler`` sees the card's kernels.

    python3 tools/probe_profiler.py

Builds 2^24 u64 keys into a single-value table on the card, then profiles
one upsert of every key (``ops.insert64``: the match pass and the claim
pass, two kernels) in sessions of its own: twice in a row, after a 30 GB
allocation is freed, after 20 s idle, after 20 s of upserts, and with
other profiler settings.  Prints, per session, the events the profiler
returned and the kernels it timed on the device, then the card's name and
power limit.  Needs one card and nvcc; imports no JAX.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 2 ** 24


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_profiler: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import bulk, single_value
    from repro_torch.kernels.cops import contract, ops

    def session(tag, fn, activities=(ProfilerActivity.CUDA,), **kw):
        torch.cuda.synchronize()
        with profile(activities=list(activities), **kw) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        timed = [e for e in events if e.device_time_total > 0]
        print(f"{tag}: {len(events)} events, {len(timed)} timed on the "
              f"device: " + "; ".join(f"{e.name[:48]} "
                                      f"{e.device_time_total / 1e3:.3f} ms"
                                      for e in timed), flush=True)

    keys = contract.distinct_keys64(0, N, "cuda")
    vals = contract.values_for(keys, 1)
    table = single_value.create(int(N / 0.9), window=32, device="cuda",
                                key_words=2)
    kw = dict(seed=table.seed, scheme=table.scheme,
              max_probes=bulk._tstatic(table)[3])
    planes = contract.table_planes(table)
    ops.insert64(*planes, keys, vals, count=0, **kw)

    def upsert():
        ops.insert64(*planes, keys, vals, count=N, **kw)

    session("first session", upsert)
    session("second session", upsert)
    block = torch.empty(30 * 2 ** 30, dtype=torch.uint8, device="cuda")
    del block
    torch.cuda.empty_cache()
    session("after a 30 GB allocation is freed", upsert)
    time.sleep(20)
    session("after 20 s idle", upsert)
    start = time.time()
    while time.time() - start < 20:
        upsert()
    torch.cuda.synchronize()
    session("after 20 s of upserts", upsert)
    session("CPU and CUDA activities", upsert,
            activities=(ProfilerActivity.CPU, ProfilerActivity.CUDA))
    session("acc_events=True", upsert, acc_events=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
