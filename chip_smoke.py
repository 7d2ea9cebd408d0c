#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path — bulk build and bulk retrieval on the
single-value COPS table, the paper's headline (§IV-B, Fig. 5) — at the
paper's scale, and holds every kernel of that path against its plain
PyTorch version.  Phases, one status line each:

1. the card (``nvidia-smi`` name and power limit) and the kernels' build
   from ``src/repro_torch/kernels/*/csrc``;
2. kernel vs plain at 2^20 distinct keys, rho = 0.9, for W = 32 cops,
   W = 1 cops and W = 1 linear: a fresh build, then a batch of present,
   new and duplicate keys onto a store holding tombstones; the lookup
   bit-exact, the insert under the four-part contract
   (``repro_torch/kernels/cops/contract.py``);
3. the main path through the public entry points: 2^28 distinct u32 keys
   (``configs/warpcore.py: paper_n_pairs``) into ``create(n / 0.9)``,
   W = 32, cops — insert, upsert, retrieve, absent retrieve, erase and
   re-insert, every result checked; insert and retrieve timed with CUDA
   events (median of 5 after a warm-up).  The kernels' launch counters are
   zeroed just before this phase and read just after it;
4. each kernel's wrapper and its plain version on the main path's inputs
   (2^28 keys), compared and timed, with the least time the card could
   take for the same bytes (3.35 TB/s).

The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": ...}``, printed only when every phase passed.
Exits non-zero without a card, or when the repository's sources are not
beside this script.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_MAIN = 2 ** 28          # configs/warpcore.py: paper_n_pairs
N_SIDE = 2 ** 24          # absent lookups, erases and re-inserts
N_CHECK = 2 ** 20
RHO = 0.9
WINDOW = 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
SOURCE = "src/repro_torch/kernels/cops/csrc/cops.cu"
REPLACES = {"cops_insert": "src/repro/kernels/cops/kernel.py:75",
            "cops_lookup": "src/repro/kernels/cops/kernel.py:789"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(torch, fn, setup=lambda: (), reps=5, warmup=1):
    """(ms of each of ``reps`` runs after ``warmup`` runs, last result);
    the time runs between CUDA events around ``fn(*setup())``."""
    times, out = [], None
    for r in range(warmup + reps):
        args = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        if r >= warmup:
            times.append(start.elapsed_time(end))
    return times, out


def spread(times) -> str:
    return (f"{statistics.median(times):.3f} ms (median; min {min(times):.3f}"
            f", max {max(times):.3f})")


def walk_windows(torch, planes, keys, seed, scheme, budget):
    """Windows each walk reads up to its match or first EMPTY window, summed
    over ``keys`` (the data-dependent part of the kernels' bytes)."""
    from repro_torch.core import probing
    from repro_torch.core.common import EMPTY_WORD, as_u32
    kp = planes[0]
    p = kp.shape[0]
    total = 0
    for s in range(0, keys.shape[0], 1 << 22):
        k = keys[s:s + (1 << 22)]
        words = as_u32(k)
        row = probing.initial_row(words, p, seed)
        step = probing.row_step(scheme, words, p, seed)
        for _ in range(budget):
            if k.numel() == 0:
                break
            total += k.numel()
            win = kp[row]
            go = ~((win == k[:, None]).any(1) | (win == EMPTY_WORD).any(1))
            k, step = k[go], step[go]
            row = probing.advance_row(row[go], step, p)
    return total


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.core import bulk, single_value as sv
    from repro_torch.core.common import STATUS_INSERTED, STATUS_UPDATED
    from repro_torch.kernels import build
    from repro_torch.kernels.cops import contract, ops

    failures = []

    def check(name, ok):
        if not ok:
            failures.append(name)
        return ok

    # -- phase 1: the card and the build ------------------------------------
    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"phase 1 build: {sorted(built)} in "
          f"{time.perf_counter() - t0:.2f} s (concurrent nvcc)", flush=True)

    # -- phase 2: kernel vs plain at 2^20 keys ------------------------------
    for window, scheme in ((32, "cops"), (1, "cops"), (1, "linear")):
        t0 = time.perf_counter()
        checks = contract.run_case(N_CHECK, window=window, scheme=scheme,
                                   device="cuda", rho=RHO)
        torch.cuda.synchronize()
        bad = [k for k, ok in checks.items() if not check(
            f"phase2 W={window} {scheme} {k}", ok)]
        print(f"phase 2 kernel vs plain W={window} {scheme} n={N_CHECK} "
              f"rho={RHO}: {'ok' if not bad else 'FAILED ' + str(bad)} "
              f"({len(checks)} checks, {time.perf_counter() - t0:.1f} s)",
              flush=True)

    # -- phase 3: the main path at the paper's scale ------------------------
    dev = "cuda"
    keys = contract.distinct_keys(0, N_MAIN, dev)
    vals = contract.values_for(keys, 1)
    absent = contract.distinct_keys(N_MAIN + 2, N_SIDE, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    def fresh():
        return (sv.create(int(N_MAIN / RHO), window=WINDOW, device=dev),)

    ins_t, (table, st) = timed(torch, lambda t: sv.insert(t, keys, vals),
                               fresh)
    print(f"phase 3 table: p={table.num_rows} W={WINDOW} capacity="
          f"{table.capacity} ({table.capacity * 8 / 1e9:.2f} GB)", flush=True)
    check("insert all INSERTED", bool((st == STATUS_INSERTED).all()))
    check("insert count == n", table.count == N_MAIN)
    vals2 = contract.values_for(keys, 2)
    table, st = sv.insert(table, keys, vals2)
    check("upsert all UPDATED", bool((st == STATUS_UPDATED).all()))
    check("upsert count unchanged", table.count == N_MAIN)
    ret_t, (got, found) = timed(torch, lambda: sv.retrieve(table, keys))
    check("retrieve all found", bool(found.all()))
    check("retrieve values", bool(torch.equal(got, vals2)))
    del got, found
    got, found = sv.retrieve(table, absent)
    check("absent none found", not bool(found.any()))
    check("absent values 0", not bool(got.any()))
    gone = keys[:N_SIDE]
    table, erased = sv.erase(table, gone)
    check("erase all erased", bool(erased.all()))
    check("erase count", table.count == N_MAIN - N_SIDE)
    check("erased not contained", not bool(sv.contains(table, gone).any()))
    check("others contained",
          bool(sv.contains(table, keys[N_SIDE:2 * N_SIDE]).all()))
    vals3 = contract.values_for(gone, 3)
    table, st = sv.insert(table, gone, vals3)
    check("re-insert all INSERTED", bool((st == STATUS_INSERTED).all()))
    check("re-insert count", table.count == N_MAIN)
    got, found = sv.retrieve(table, gone)
    check("re-inserted values", bool(found.all() and torch.equal(got, vals3)))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    for name, count in launches.items():
        check(f"{name} launched on the main path", count > 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 3 main path n={N_MAIN} rho={RHO} W={WINDOW} cops: "
          f"{'ok' if not failures else 'FAILED ' + str(failures)}; "
          f"insert {spread(ins_t)} = "
          f"{N_MAIN / statistics.median(ins_t) / 1e6:.3f} G ops/s, "
          f"retrieve {spread(ret_t)} = "
          f"{N_MAIN / statistics.median(ret_t) / 1e6:.3f} G ops/s "
          f"(5 runs each, CUDA events, end to end through sv.insert / "
          f"sv.retrieve); peak {peak:.1f} GB; launches {launches}; "
          f"card {card}", flush=True)
    kw = dict(seed=table.seed, scheme=table.scheme,
              max_probes=bulk._tstatic(table)[3])
    del table, st, got, found, erased, vals2, vals3, absent

    # -- phase 4: each kernel vs its plain version at the main path's shapes
    def planes(t):
        return t.store["keys"][0], t.store["values"][0]

    def kernel_build(t):
        return t, ops.insert(*planes(t), keys, vals, count=0, **kw)

    def plain_build(t):
        return t, ops.insert_plain(*planes(t), keys, vals, count=0, **kw)

    kernel_ins_t, (built_k, kst) = timed(torch, kernel_build, fresh)
    plain_ins_t, (built_p, pst) = timed(torch, plain_build, fresh, reps=1,
                                         warmup=0)
    parts = contract.check_insert(planes(built_k), planes(built_p), kst, pst,
                                  **kw)
    for part, ok in parts.items():
        check(f"phase4 insert {part}", ok)
    _, pv, _ = contract.live_map(*planes(built_p))
    _, kv, _ = contract.live_map(*planes(built_k))
    ins_err = (int((kv - pv).abs().max()) if kv.shape == pv.shape
               else float("inf"))
    del built_p, pst, pv, kv
    look_t, kout = timed(torch, lambda: ops.lookup(*planes(built_k), keys,
                                                    **kw))
    plain_look_t, pout = timed(torch, lambda: ops.lookup_plain(
        *planes(built_k), keys, **kw), reps=1, warmup=0)
    look_err = int((kout[0].long() - pout[0].long()).abs().max())
    check("phase4 lookup bit-exact",
          torch.equal(kout[0], pout[0]) and torch.equal(kout[1], pout[1]))
    del kout, pout
    windows = walk_windows(torch, planes(built_k), keys, kw["seed"],
                           kw["scheme"], kw["max_probes"])
    mean_windows = windows / N_MAIN
    win_bytes = max(32, 4 * WINDOW)
    # each walk's windows + the value's 32-byte sector + the streams:
    # insert reads key, value and writes status; lookup reads key, writes
    # value and found
    ins_bytes = N_MAIN * (mean_windows * win_bytes + 32 + 12)
    look_bytes = N_MAIN * (mean_windows * win_bytes + 32 + 9)
    print(f"phase 4 kernels at n={N_MAIN}: "
          f"{'ok' if not failures else 'FAILED'}; "
          f"mean windows per walk {mean_windows:.4f}; cops_insert "
          f"{spread(kernel_ins_t)}, plain {plain_ins_t[0]:.3f} ms; "
          f"cops_lookup {spread(look_t)}, plain {plain_look_t[0]:.3f} ms; "
          f"card {card}",
          flush=True)

    record = {"kernels": [
        {"name": "cops_insert", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["cops_insert"],
         "launches": launches["cops_insert"], "max_abs_err": ins_err,
         "ms": statistics.median(kernel_ins_t), "plain_ms": plain_ins_t[0],
         "bound_ms": ins_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
        {"name": "cops_lookup", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["cops_lookup"],
         "launches": launches["cops_lookup"], "max_abs_err": look_err,
         "ms": statistics.median(look_t), "plain_ms": plain_look_t[0],
         "bound_ms": look_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
    ]}
    print(card, flush=True)
    print(json.dumps(record), flush=True)
    if failures:
        print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
