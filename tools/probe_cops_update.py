#!/usr/bin/env python3
"""Probe the constants of ``cops_update`` on a CUDA card.

    python3 tools/probe_cops_update.py

Builds variants of ``src/repro_torch/kernels/cops/csrc/cops.cu`` that
differ from the source in one choice each, into ``build/probe/``:

- ``kUpdateKeys`` (K, the keys a warp walks at W >= 32) at 1, 2, 4, 8, 16;
- ``kSharedGroups`` (R) at 0, so every combine goes to device memory;
- the combine's per-warp step: "match" folds the rows of each group that
  a warp holds first (``__match_any_sync``, then a warp reduction), "plain"
  never folds in the warp; the source folds only a warp whose rows all
  belong to one group.

Then it times ``ops.update`` (a sum of two value words, as the group-by's
``aggregate`` runs it) of 2^27 rows with keys uniform in [1, g] for each
g of ``GROUPS`` into an empty table, under each variant that differs from
the source where that g reaches (K only at the largest g, the combine at
all), and names the kernels of one call with their times
(``torch.profiler``).  Prints one line per (g, variant) and the card's
name and power limit.  Needs one card and nvcc; imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 2 ** 27                    # fig9's rows (phase 17 of chip_smoke.py)
GROUPS = (1, 64, 1024, 2 ** 14, 2 ** 16, 2 ** 25)
KEYS = (1, 2, 4, 8, 16)
# the per-warp step of the combine in the source, and the two it replaced
STEP = re.compile(r"      // a warp whose rows all belong to one group.*?"
                  r"\n      }\n", re.S)
STEPS = {
    "plain": """#pragma unroll
      for (int p = 0; p < V; ++p)
        if (r[u] >= 0)
          atomic_fold((ops >> (4 * p)) & 15, into + (size_t)r[u] * V + p,
                      x[u][p]);
""",
    "match": """const unsigned peers = __match_any_sync(0xFFFFFFFFu, r[u]);
      const bool leader = __ffs(peers) - 1 == lane;
#pragma unroll
      for (int p = 0; p < V; ++p) {
        const int op = (ops >> (4 * p)) & 15;
        const uint32_t v = warp_fold(op, peers, x[u][p]);
        if (leader && r[u] >= 0)
          atomic_fold(op, into + (size_t)r[u] * V + p, v);
      }
""",
}


def variants(text):
    """{name: source} of the variants, the source itself as "source"."""
    keys = int(re.search(r"kUpdateKeys = (\d+);", text)[1])
    out = {"source": text}
    for k in KEYS:
        if k != keys:
            out[f"K={k}"] = re.sub(r"kUpdateKeys = \d+;",
                                   f"kUpdateKeys = {k};", text)
    out["R=0"] = re.sub(r"kSharedGroups = \d+;", "kSharedGroups = 0;", text)
    assert STEP.search(text), "the combine's per-warp step moved"
    for name, step in STEPS.items():
        out[name] = STEP.sub(lambda _: "      " + step, text)
        out[f"{name}, R=0"] = STEP.sub(lambda _: "      " + step,
                                       out["R=0"])
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_cops_update: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import bulk
    from repro_torch.kernels import build
    from repro_torch.kernels.cops import contract, ops
    from repro_torch.relational import groupby

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)

    def compile_one(item):
        name, text = item
        tag = re.sub(r"[^A-Za-z0-9]+", "_", name)
        src, lib = out_dir / f"cops_{tag}.cu", out_dir / f"libcops_{tag}.so"
        src.write_text(text)
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, capture_output=True)
        return name, lib

    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = dict(pool.map(compile_one,
                             variants(build.sources()["cops"].read_text())
                             .items()))

    def use(lib):
        ops._lib.cache_clear()
        real = build.library
        build.library = lambda name: ctypes.CDLL(str(lib))
        try:
            ops._lib()
        finally:
            build.library = real

    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    fold = ("add", "add")
    for g in GROUPS:
        keys = torch.randint(1, g + 1, (N,), dtype=torch.int32,
                             generator=gen, device="cuda")
        vals = torch.randint(0, 2 ** 16, (N,), dtype=torch.int32,
                             generator=gen, device="cuda")
        payload = torch.stack([vals, torch.ones_like(vals)], dim=1)
        rkeys, x, claim, rest, _ = bulk.update_front(keys, payload, payload)
        table = groupby.create(groupby.capacity_for(g), device="cuda")
        kw = dict(seed=table.seed, scheme=table.scheme,
                  max_probes=bulk._tstatic(table)[3], count=0)
        empty = (contract.table_planes(table)[0], table.store["values"])
        for name, lib in libs.items():
            if name.startswith("K=") and g != GROUPS[-1]:
                continue
            use(lib)
            times = []
            for rep in range(6):
                planes = tuple(p.clone() for p in empty)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                ops.update(*planes, rkeys, x, claim, rest, payload, ops=fold,
                           **kw)
                end.record()
                end.synchronize()
                if rep:
                    times.append(start.elapsed_time(end))
            planes = tuple(p.clone() for p in empty)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                ops.update(*planes, rkeys, x, claim, rest, payload, ops=fold,
                           **kw)
                torch.cuda.synchronize()
            kernels = {re.search(r"(\w+_kernel<[^>]*>)", e.key)[1]:
                       e.device_time_total / 1e3
                       for e in prof.key_averages()
                       if "combine" in e.key or "walk" in e.key}
            print(f"g={g} reps={rkeys.shape[0]} {name}: ops.update "
                  f"{statistics.median(times):.3f} ms (median of 5; min "
                  f"{min(times):.3f}, max {max(times):.3f}); "
                  + "; ".join(f"{k} {v:.3f} ms"
                              for k, v in sorted(kernels.items())),
                  flush=True)
            del planes
        del keys, vals, payload, rkeys, x, claim, rest, table, empty
        torch.cuda.empty_cache()
    ops._lib.cache_clear()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
