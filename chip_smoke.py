#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's two paths — bulk build and bulk retrieval on the
single-value COPS table, the paper's headline (§IV-B, Fig. 5), and on the
multi-value table (§IV-B.4, Fig. 7) — at the paper's scale, and holds
every kernel of each path against its plain PyTorch version.  Phases, one
status line each:

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
   take for the same bytes (3.35 TB/s);
5. multi-value kernels vs plain at 2^20 pairs, for wc-oa (W = 32 cops,
   r = 1, 8, 32) and lp-oa (W = 1 linear, max_probes 8192, r = 8)
   (``benchmarks/fig7_multi_value.py``): a build, an erase of 1/8 of the
   keys through ``multi_value.erase``, and a second batch onto the
   tombstones; after each batch the append under the multi-value contract
   and the retrieve walk bit-exact (``contract.run_multi_case``);
6. the multi-value main path, Fig. 7's wc-oa cell at r = 8: 2^28 pairs
   (2^25 distinct keys, 8 in a row, values 0 .. n-1) into
   ``multi_value.create(n / 0.8)``, W = 32, cops — insert, count_values,
   retrieve_all (present, absent and duplicate queries), erase and
   re-insert, every result checked; insert, count and retrieve_all timed
   (median of 5 after a warm-up), and retrieve_all split into dedup,
   kernel and compaction.  The counters are zeroed just before it and read
   just after it;
7. ``cops_append`` and ``cops_retrieve`` alone and their plain versions
   at phase 6's shapes, compared and timed, with their byte bounds; and
   the append of 2^28 distinct keys (r = 1) at the same shape, timed.

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
N_MV = 2 ** 28            # configs/warpcore.py: paper_n_pairs
R_MV = 8                  # fig7: keys repeated r times in a row
N_MV_SIDE = 2 ** 22       # duplicate queries, erases and re-inserts
N_MV_ABSENT = 2 ** 24
MV_CASES = (("wc-oa", 32, "cops", 1, None), ("wc-oa", 32, "cops", 8, None),
            ("wc-oa", 32, "cops", 32, None),
            ("lp-oa", 1, "linear", 8, 8192))  # fig7_multi_value.py:83-85
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
SOURCE = "src/repro_torch/kernels/cops/csrc/cops.cu"
REPLACES = {"cops_insert": "src/repro/kernels/cops/kernel.py:75",
            "cops_lookup": "src/repro/kernels/cops/kernel.py:789",
            "cops_append": "src/repro/kernels/cops/kernel.py:103",
            "cops_retrieve": "src/repro/kernels/cops/kernel.py:334"}


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


def probe_walks(torch, table_keys, keys, seed, scheme, budget, stop):
    """Yield ``(attempt, index, keys, windows)`` for every step of the probe
    walks of ``keys`` over the (p, W) key plane, 2^22 keys at a time:
    ``index`` is each walking key's position in ``keys``, ``windows`` its
    (W,) row.  A walk ends after the window where ``stop(windows, keys)``
    holds, or at ``budget``."""
    from repro_torch.core import probing
    from repro_torch.core.common import as_u32
    p = table_keys.shape[0]
    for s in range(0, keys.shape[0], 1 << 22):
        k = keys[s:s + (1 << 22)]
        idx = torch.arange(s, s + k.numel(), device=keys.device)
        words = as_u32(k)
        row = probing.initial_row(words, p, seed)
        step = probing.row_step(scheme, words, p, seed)
        for attempt in range(budget):
            if k.numel() == 0:
                break
            win = table_keys[row]
            yield attempt, idx, k, win
            go = ~stop(win, k)
            k, idx, step = k[go], idx[go], step[go]
            row = probing.advance_row(row[go], step, p)


def multi_walk_windows(torch, table_keys, keys, seed, scheme, budget):
    """For the distinct ``keys`` of a multi-value store: (the windows their
    walks read up to and including the first EMPTY window; the windows up to
    the last one holding a pair of the key — what an append of the key's
    pairs into an empty store must read), each summed over the keys."""
    from repro_torch.core.common import EMPTY_WORD
    walked = 0
    last = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    for attempt, idx, k, win in probe_walks(
            torch, table_keys, keys, seed, scheme, budget,
            lambda w, k: (w == EMPTY_WORD).any(1)):
        walked += k.numel()
        last[idx[(win == k[:, None]).any(1)]] = attempt + 1
    return walked, int(last.sum())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.core import bulk, bulk_retrieve, single_value as sv
    from repro_torch.core import multi_value as mv
    from repro_torch.core.common import (EMPTY_WORD, STATUS_INSERTED,
                                         STATUS_UPDATED)
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
    for name in ("cops_insert", "cops_lookup"):
        check(f"{name} launched on the main path", launches[name] > 0)
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
    windows = sum(k.numel() for _, _, k, _ in probe_walks(
        torch, planes(built_k)[0], keys, kw["seed"], kw["scheme"],
        kw["max_probes"],
        lambda w, k: ((w == k[:, None]) | (w == EMPTY_WORD)).any(1)))
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

    del built_k, kst

    # -- phase 5: multi-value kernels vs plain at 2^20 pairs ----------------
    for name, window, scheme, r, max_probes in MV_CASES:
        t0 = time.perf_counter()
        checks = contract.run_multi_case(N_CHECK, window=window,
                                         scheme=scheme, device="cuda", r=r,
                                         max_probes=max_probes)
        torch.cuda.synchronize()
        tag = f"phase5 {name} r={r}"
        bad = [k for k, ok in checks.items() if not check(f"{tag} {k}", ok)]
        print(f"phase 5 multi-value kernel vs plain {name} W={window} "
              f"{scheme} r={r} n={N_CHECK} load={contract.LOAD}: "
              f"{'ok' if not bad else 'FAILED ' + str(bad)} "
              f"({len(checks)} checks, {time.perf_counter() - t0:.1f} s)",
              flush=True)

    # -- phase 6: the multi-value main path (fig7 wc-oa, r = 8) -------------
    n_keys = N_MV // R_MV
    pool = contract.distinct_keys(0, n_keys + N_MV_ABSENT, dev)
    base, absent = pool[:n_keys], pool[n_keys:]
    del pool
    keys = base.repeat_interleave(R_MV)
    vals = torch.arange(N_MV, dtype=torch.int32, device=dev)
    want = vals.view(n_keys, R_MV)           # key i holds 8i .. 8i+7
    side = N_MV_SIDE
    failed_before = len(failures)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    def fresh_mv():
        return (mv.create(int(N_MV / contract.LOAD), window=WINDOW,
                          device=dev),)

    def sorted_segments(values, n):
        return values[:n * R_MV].view(n, R_MV).sort(dim=1).values

    mins_t, (mtab, st) = timed(torch, lambda t: mv.insert(t, keys, vals),
                               fresh_mv)
    print(f"phase 6 table: p={mtab.num_rows} W={WINDOW} capacity="
          f"{mtab.capacity} ({mtab.capacity * 8 / 1e9:.2f} GB store, "
          f"{mtab.capacity * 8 / 1e9:.2f} GB of collect arenas)", flush=True)
    check("mv insert all INSERTED", bool((st == STATUS_INSERTED).all()))
    check("mv insert count == n", mtab.count == N_MV)
    del st
    mcnt_t, cnt = timed(torch, lambda: mv.count_values(mtab, base))
    check("mv count_values all r", bool((cnt == R_MV).all()))
    mret_t, (got, offs, cnt) = timed(
        torch, lambda: mv.retrieve_all(mtab, base, N_MV))
    check("mv retrieve_all counts", bool((cnt == R_MV).all()))
    check("mv retrieve_all offsets", torch.equal(
        offs.long(), torch.arange(n_keys + 1, device=dev) * R_MV))
    check("mv retrieve_all segments",
          torch.equal(sorted_segments(got, n_keys), want))
    del got, offs, cnt
    got, offs, cnt = mv.retrieve_all(mtab, absent, N_MV_ABSENT)
    check("mv absent counts 0", not bool(cnt.any()))
    check("mv absent output zeros", not bool(got.any()) and
          not bool(offs.any()))
    q = base[:side]
    got, offs, cnt = mv.retrieve_all(mtab, torch.cat([q, q]),
                                     2 * side * R_MV)
    check("mv duplicate queries counts", bool((cnt == R_MV).all()))
    check("mv duplicate queries equal halves",
          torch.equal(got[:side * R_MV], got[side * R_MV:]))
    mtab, erased = mv.erase(mtab, q)
    check("mv erase counts", bool((erased == R_MV).all()))
    check("mv erase count", mtab.count == N_MV - side * R_MV)
    check("mv erased count 0", not bool(mv.count_values(mtab, q).any()))
    check("mv others count r", bool(
        (mv.count_values(mtab, base[side:2 * side]) == R_MV).all()))
    mtab, st = mv.insert(mtab, keys[:side * R_MV], vals[:side * R_MV])
    check("mv re-insert all INSERTED", bool((st == STATUS_INSERTED).all()))
    check("mv re-insert count", mtab.count == N_MV)
    got, offs, cnt = mv.retrieve_all(mtab, q, side * R_MV)
    check("mv re-inserted segments", bool((cnt == R_MV).all()) and
          torch.equal(sorted_segments(got, side), want[:side]))
    del got, offs, cnt, erased, st
    torch.cuda.synchronize()
    mv_launches = dict(ops.LAUNCHES)
    for name in ("cops_append", "cops_retrieve"):
        check(f"{name} launched on the multi-value path",
              mv_launches[name] > 0)
    mv_peak = torch.cuda.max_memory_allocated() / 1e9
    # the split of retrieve_all, by difference (outside the counted run)
    every = torch.ones((n_keys,), dtype=torch.bool, device=dev)
    mkw = dict(seed=mtab.seed, scheme=mtab.scheme,
               max_probes=bulk._tstatic(mtab)[3])
    mkp = mtab.store["keys"][0]
    dedup_t, _ = timed(torch, lambda: bulk_retrieve.group_queries(base,
                                                                  every))
    walk_t, _ = timed(torch, lambda: ops.retrieve_walk(mkp, base, every,
                                                       collect=True, **mkw))
    ret_ms, dedup_ms, walk_ms = (statistics.median(mret_t),
                                 statistics.median(dedup_t),
                                 statistics.median(walk_t))
    ok6 = len(failures) == failed_before
    print(f"phase 6 multi-value main path n={N_MV} r={R_MV} "
          f"load={contract.LOAD} W={WINDOW} cops: "
          f"{'ok' if ok6 else 'FAILED'}; insert {spread(mins_t)} ={N_MV / statistics.median(mins_t) / 1e6:.3f}"
          f" G pairs/s, count_values {spread(mcnt_t)} = "
          f"{N_MV / statistics.median(mcnt_t) / 1e6:.3f} G values/s, "
          f"retrieve_all {spread(mret_t)} = {N_MV / ret_ms / 1e6:.3f} G "
          f"values/s (5 runs each, CUDA events, through mv.insert / "
          f"mv.count_values / mv.retrieve_all); retrieve_all split: dedup "
          f"{dedup_ms:.3f} ms, walk kernel (arena fill included) "
          f"{walk_ms:.3f} ms, compaction {ret_ms - dedup_ms - walk_ms:.3f} "
          f"ms (by difference); peak {mv_peak:.1f} GB; launches "
          f"{mv_launches}; card {card}", flush=True)
    del mtab, mkp

    # -- phase 7: cops_append and cops_retrieve alone at phase 6's shapes ---
    def append_kernel(t):
        return t, ops.append(*planes(t), keys, vals, **mkw)

    def append_plain(t):
        return t, ops.append_plain(*planes(t), keys, vals, **mkw)

    def append_bytes(table_keys, landed):
        """What an append into an empty store, now ``table_keys``, must
        move: per distinct key the windows up to the last one its pairs
        landed in (``landed``, summed), each 128-byte line read once however
        many of the key's pairs walk it; each 32-byte key and value sector
        that holds a pair written once; the key, value and status streams,
        12 B per pair."""
        sectors = int((table_keys.reshape(-1, 8) != EMPTY_WORD).any(1).sum())
        return landed * win_bytes + 2 * 32 * sectors + N_MV * 12

    # the same append with 2^28 distinct keys (r = 1): what the r = 8
    # duplicates' CAS races on one row cost
    keys_r1 = contract.distinct_keys(0, N_MV, dev)
    app_r1_t, (r1_t, st_r1) = timed(torch, lambda t: (t, ops.append(
        *planes(t), keys_r1, vals, **mkw)), fresh_mv)
    check("phase7 append r=1 all INSERTED",
          bool((st_r1 == STATUS_INSERTED).all()))
    r1_kp = r1_t.store["keys"][0]
    _, landed_r1 = multi_walk_windows(torch, r1_kp, keys_r1, mkw["seed"],
                                      mkw["scheme"], mkw["max_probes"])
    app_r1_bytes = append_bytes(r1_kp, landed_r1)
    del keys_r1, st_r1, r1_t, r1_kp
    app_t, (mk_t, kst) = timed(torch, append_kernel, fresh_mv)
    app_plain_t, (mp_t, pst) = timed(torch, append_plain, fresh_mv, reps=1,
                                     warmup=0)
    for part, ok in contract.check_append(planes(mk_t), planes(mp_t), keys,
                                          kst, pst, **mkw).items():
        check(f"phase7 append {part}", ok)
    kpairs = contract.live_pairs(*planes(mk_t))
    ppairs = contract.live_pairs(*planes(mp_t))
    app_err = (int(((kpairs & 0xFFFFFFFF) - (ppairs & 0xFFFFFFFF)).abs()
                   .max()) if kpairs.shape == ppairs.shape else float("inf"))
    del mp_t, pst, kpairs, ppairs
    mkp = mk_t.store["keys"][0]
    cnt_only_t, _ = timed(torch, lambda: ops.retrieve_walk(
        mkp, base, every, collect=False, **mkw))
    rw_t, kout = timed(torch, lambda: ops.retrieve_walk(
        mkp, base, every, collect=True, **mkw))
    rw_plain_t, pout = timed(torch, lambda: ops.retrieve_walk_plain(
        mkp, base, every, collect=True, **mkw), reps=1, warmup=0)
    rw_err = max(int((a.long() - b.long()).abs().max())
                 for a, b in zip(kout, pout))
    check("phase7 retrieve bit-exact",
          all(torch.equal(a, b) for a, b in zip(kout, pout)))
    del kout, pout
    walked, landed = multi_walk_windows(torch, mkp, base, mkw["seed"],
                                        mkw["scheme"], mkw["max_probes"])
    cap = mkp.numel()
    app_bytes = append_bytes(mkp, landed)
    # retrieve: each query's windows up to its first EMPTY window + the key,
    # active and count streams (9 B) + both (p * W,) int32 arenas written
    # once in full (the wrapper's fill, the kernel's stamps)
    cnt_bytes = walked * win_bytes + n_keys * 9
    rw_bytes = cnt_bytes + cap * 8
    print(f"phase 7 multi-value kernels at n={N_MV} pairs, {n_keys} "
          f"queries: {'ok' if not failures else 'FAILED'}; append windows "
          f"per key {landed / n_keys:.4f} (r=1: {landed_r1 / N_MV:.4f}), "
          f"walk windows per query "
          f"{walked / n_keys:.4f}; cops_append {spread(app_t)}, plain "
          f"{app_plain_t[0]:.3f} ms, bound "
          f"{app_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, with r=1 (distinct "
          f"keys) {spread(app_r1_t)}, bound "
          f"{app_r1_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; cops_retrieve "
          f"collect {spread(rw_t)}, plain {rw_plain_t[0]:.3f} ms, bound "
          f"{rw_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; counts only "
          f"{spread(cnt_only_t)}, bound "
          f"{cnt_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; card {card}",
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
        {"name": "cops_append", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["cops_append"],
         "launches": mv_launches["cops_append"], "max_abs_err": app_err,
         "ms": statistics.median(app_t), "plain_ms": app_plain_t[0],
         "bound_ms": app_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
        {"name": "cops_retrieve", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["cops_retrieve"],
         "launches": mv_launches["cops_retrieve"], "max_abs_err": rw_err,
         "ms": statistics.median(rw_t), "plain_ms": rw_plain_t[0],
         "bound_ms": rw_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
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
