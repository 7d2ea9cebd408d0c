#!/usr/bin/env python3
"""Probe the constants of the COPS walks and of ``cops_update`` on a CUDA
card.

    python3 tools/probe_cops_update.py [insert] [retrieve] [update] [walk]
                                       [bloom] [kmer]

(the sections named; the first three by default).  Builds variants of
``src/repro_torch/kernels/cops/csrc/cops.cu`` that differ from the source
in one choice each, into ``build/probe/``:

- K, the keys a warp walks at W >= 32, at 1, 2, 4, 8, 16: ``kWalkKeys``
  (the upsert, the update, the two-plane passes, the lookup) and
  ``kRetrieveKeys`` (the retrieve) both set to K; a section does not time
  the variant whose K is its kernels' own in the source;
- "bounds": the walks (``walk_kernel``, ``upsert_kernel``,
  ``lookup_walk_kernel``, ``retrieve_walk_kernel``) under
  ``__launch_bounds__(kThreads)``, which the source leaves out;
- "retrieve 8 blocks": ``retrieve_walk_kernel`` alone under
  ``__launch_bounds__(kThreads, 8)``, so that 8 blocks (64 warps, at most
  32 registers a thread) fit an SM;
- ``kSharedGroups`` (R) at 0, so every combine goes to device memory;
- the combine's per-warp step: "match" folds the rows of each group that
  a warp holds first (``__match_any_sync``, then a warp reduction), "plain"
  never folds in the warp; the source folds only a warp whose rows all
  belong to one group.

- for the bucket walk alone ("walk"), its chains a warp
  (``kBucketKeys``) at 4, 8, 16, 32.

It prints ptxas's registers and spill bytes of every walk, lookup and
retrieve kernel of each variant.  Then ("insert") it times, under the
source, each K and "bounds", ``ops.insert`` and ``ops.insert64`` at
fig5's shape
(``INSERT_KEYS`` distinct keys into ``create(n / 0.9)``, W = 32, cops):
the build into an empty table and the upsert of every key into the table
it built, the two-plane upsert's two launches named with their times
(``torch.profiler``); and ``ops.lookup`` / ``ops.lookup64`` on the table
it built, of every key and of ``ABSENT_KEYS`` absent ones (as
``chip_smoke.py`` phases 4 and 11 time them).
Then ("retrieve") it times, under the same variants, ``ops.retrieve_walk``
and ``ops.retrieve_walk64`` at fig7's wc-oa shape (``MV_KEYS`` distinct
keys, each ``MV_R`` times in a row, appended into
``multi_value.create(pairs / 0.8)``, W = 32, cops), counts only and
collecting, every key a query, each variant's output held equal to the
source's (as ``chip_smoke.py`` phases 7 and 11 time them).
Then ("update") it times ``ops.update`` (a sum of two value words, as
the group-by's ``aggregate`` runs it) of 2^27 rows with keys uniform in
[1, g] for each g of ``GROUPS`` into an empty table, under each variant
that differs from the source where that g reaches (K only at the largest
g, the combine at all; "bounds" as K), and names the kernels of one call
with their times (``torch.profiler``).  Prints one line per (g, variant)
and the card's name and power limit.
Then ("walk") it times ``ops.bucket_walk`` under the source and each
bucket-walk variant, the arenas' fill included, every variant's arenas
held equal to the source's, on two tables: Fig. 7's wc-bl-1 at r = 8
(``MV_KEYS`` keys x ``MV_R`` into ``bucket_list.create(MV_KEYS / 0.8,
2 MV_KEYS MV_R + 64)``, growth 1.1, s0 1: chains of 4 buckets laid out
by one batch) and ``chip_smoke.py``'s Fig. 8 reference (256 genomes
indexed genome by genome: chains of up to ~20 buckets scattered over the
pool) queried with its 2^20 reads' sketches, as phases 13 and 14 there
walk them; and the two arena fills alone.
Then ("bloom") it times ``bloom_insert`` (``kernels/bloom/ops.py``) by
each path: at ``chip_smoke.py`` phase 21's shape (2^28 keys into 2^32
bits, 512-bit blocks, k = 4) the direct path and the partitioned one at
each tile size of ``TILE_WORDS`` and range size of ``RANGE_MIB``, and the
source's partitioned kernels named with their times (``torch.profiler``);
and at fig12's filter stack (8 planes
of 16 bits per slot of 2^25 slots, a plane per key) the two paths at
each batch of ``BLOOM_BATCHES`` keys (keys per filter sector 1/64 .. 1),
and a shard's rebuild (2^25 slots, half live, into one plane); each
partitioned filter held equal to the direct one.  Then the query, under
the source and each variant of
``src/repro_torch/kernels/bloom/csrc/bloom.cu`` ("bit by bit": the direct
query loading and testing each bit in turn to the first clear one; "tile
words first": the tile query loading every word of a key first): both
paths at phase 21's shape, present and absent keys, the direct path at
the serve step's (2^20 keys, half absent, into the 8-plane stack after
2^27 keys preloaded), and the kernels of both named with their device
times (``torch.profiler``); then, under the source, both paths at each
batch of ``QUERY_BATCHES`` keys, half absent, into the stack with a plane
per key and into phase 21's filter (the threshold), every answer held
equal to the plain version's or the other path's.
Then ("kmer") it times ``kmer_hash`` under each variant of
``src/repro_torch/kernels/minhash/csrc/minhash.cu`` (``kThreads`` at each
of ``KMER_THREADS``, ``kOut`` outputs a thread at each of ``KMER_OUTS``)
on ``chip_smoke.py`` phase 14's reads (2^20 x 150 bases, k = 16 and 31)
and one genome's windows (k = 16), by CUDA events and by the profiler's
device time, each held equal to the plain version.  Both print ptxas's
registers and spills of every kernel of each variant.
Needs one card and nvcc; imports no JAX.
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
INSERT_KEYS = 2 ** 28          # fig5's keys (phases 3 and 9 of chip_smoke.py)
ABSENT_KEYS = 2 ** 24          # their absent lookups (N_SIDE there)
MV_KEYS, MV_R = 2 ** 25, 8     # fig7 wc-oa r = 8 (phases 6 and 10 there)
GROUPS = (1, 64, 1024, 2 ** 14, 2 ** 16, 2 ** 25)
KEYS = (1, 2, 4, 8, 16)
BUCKET_KEYS = (4, 8, 16, 32)          # the bucket walk's K variants
RANGE_MIB = (2, 4, 16)                # the partitioned insert's range sizes
TILE_WORDS = (8192, 16384)            # ... and its tile sizes
BLOOM_BATCHES = tuple(2 ** e for e in range(18, 25))
QUERY_BATCHES = tuple(2 ** e for e in range(18, 29))
KMER_OUTS = (4, 8, 16)                # kmer_hash's outputs a thread
KMER_THREADS = (128, 256, 512)        # ... and threads a block
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


def own_keys(text):
    """(kWalkKeys, kRetrieveKeys) of a source text."""
    return tuple(int(re.search(rf"{name} = (\d+);", text)[1])
                 for name in ("kWalkKeys", "kRetrieveKeys"))


def variants(text):
    """{name: source} of the variants, the source itself as "source"."""
    out = {"source": text}
    for k in KEYS:
        if own_keys(text) != (k, k):
            out[f"K={k}"] = re.sub(r"(kWalkKeys|kRetrieveKeys) = \d+;",
                                   rf"\1 = {k};", text)
    walks = re.compile(r"(\n__global__ void )"
                       r"((?:walk|upsert|lookup_walk|retrieve_walk)_kernel\()")
    assert len(walks.findall(text)) == 4, "the walks' declarations moved"
    out["bounds"] = walks.sub(r"\1__launch_bounds__(kThreads)\n\2", text)
    out["retrieve 8 blocks"] = text.replace(
        "\n__global__ void retrieve_walk_kernel(",
        "\n__global__ void __launch_bounds__(kThreads, 8)\n"
        "retrieve_walk_kernel(")
    out["R=0"] = re.sub(r"kSharedGroups = \d+;", "kSharedGroups = 0;", text)
    assert STEP.search(text), "the combine's per-warp step moved"
    for name, step in STEPS.items():
        out[name] = STEP.sub(lambda _: "      " + step, text)
        out[f"{name}, R=0"] = STEP.sub(lambda _: "      " + step,
                                       out["R=0"])
    return out


def bucket_variants(text):
    """{name: source} of the bucket walk's variants (K)."""
    own = int(re.search(r"kBucketKeys = (\d+);", text)[1])
    return {f"bucket K={k}": re.sub(r"kBucketKeys = \d+;",
                                    f"kBucketKeys = {k};", text)
            for k in BUCKET_KEYS if k != own}


def kmer_variants(text):
    """{name: source} of ``kmer_hash``'s variants: each block of
    ``KMER_THREADS`` threads and outputs a thread of ``KMER_OUTS``; the one
    equal to the source as "source"."""
    out = {}
    for threads in KMER_THREADS:
        for m in KMER_OUTS:
            v = re.sub(r"kThreads = \d+;", f"kThreads = {threads};", text)
            v = re.sub(r"kOut = \d+;", f"kOut = {m};", v)
            out["source" if v == text else f"{threads} threads, kOut={m}"] = v
    assert "source" in out, "kmer_hash's constants moved"
    return out


def query_variants(text):
    """{name: source} of the queries' variants: "bit by bit", the direct
    query with each bit loaded and tested in turn, stopping at the first
    clear one (the first design's loop), where the source loads every word
    of a key first; "tile words first", the tile query loading every word
    first, where the source goes bit by bit; the source as "source"."""
    direct = "holds_bits(geo, words + row, h, g, kLoadBits)"
    tile = "mix_murmur3(key[u] + kStepAdd), 0);"
    assert direct in text and tile in text, "the queries' bit tests moved"
    return {"source": text,
            "bit by bit": text.replace(direct, direct.replace("kLoadBits",
                                                              "0")),
            "tile words first": text.replace(tile, tile.replace(
                ", 0);", ", kLoadBits);"))}


def kernel_registers(log):
    """``kernel<args> R registers, S B spilled`` for every kernel in
    ptxas's ``-v`` report ``log``."""
    out = []
    for name, spill, regs in re.findall(
            r"Compiling entry function '(\S+)'.*?\n.*?\n\s+\d+ bytes stack "
            r"frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
            log):
        m = re.search(r"\d+([a-z_]+_kernel)(I.*?E)?E", name)
        if m:
            args = ", ".join(v for _, v in re.findall(r"L(i|b)(\d+)E",
                                                      m[2] or ""))
            out.append(f"{m[1]}<{args}> {regs} registers, {spill} B spilled")
    return out


def walk_registers(log):
    """``kernel<args> R registers, S bytes of spill stores`` for every walk,
    lookup and retrieve kernel in ptxas's ``-v`` report ``log``."""
    out = []
    for name, spill, regs in re.findall(
            r"Compiling entry function '(\S+)'.*?\n.*?\n\s+\d+ bytes stack "
            r"frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
            log):
        m = re.search(r"\d+((?:lookup_walk|retrieve_walk|bucket_walk|walk"
                      r"|upsert|match|claim|lookup|retrieve)_kernel)I(.*?)"
                      r"EEvP", name)
        if m:
            args = ", ".join(v for _, v in re.findall(r"L(i|b)(\d+)E",
                                                      m[2]))
            out.append(f"{m[1]}<{args}> {regs} registers, {spill} B spilled")
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

    def compile_one(item, stem="cops"):
        name, text = item
        tag = re.sub(r"[^A-Za-z0-9]+", "_", name)
        src, lib = out_dir / f"{stem}_{tag}.cu", out_dir / f"lib{stem}_{tag}.so"
        src.write_text(text)
        res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas",
                              "-v", "-o", str(lib), str(src)], check=True,
                             capture_output=True, text=True)
        return name, lib, res.stdout + res.stderr

    sections = set(sys.argv[1:]) or {"insert", "retrieve", "update"}
    text = build.sources()["cops"].read_text()
    todo = (variants(text) if sections & {"insert", "retrieve", "update"}
            else {"source": text} if "walk" in sections else {})
    if "walk" in sections:
        todo.update(bucket_variants(text))
    others = {}   # {stem: {name: source}} of the minhash and bloom variants
    if "kmer" in sections:
        others["minhash"] = kmer_variants(
            build.sources()["minhash"].read_text())
    if "bloom" in sections:
        others["bloom"] = query_variants(build.sources()["bloom"].read_text())
    jobs = [(item, "cops") for item in todo.items()] + [
        (item, stem) for stem, v in others.items() for item in v.items()]
    with concurrent.futures.ThreadPoolExecutor() as pool:
        done = list(pool.map(lambda job: (job[1], *compile_one(*job)), jobs))
    built = [(name, lib, log) for stem, name, lib, log in done
             if stem == "cops"]
    libs = {name: lib for name, lib, _ in built}
    other_libs = {stem: {name: lib for st, name, lib, _ in done if st == stem}
                  for stem in others}
    for stem, name, _, log in done:
        if stem != "cops":
            print(f"ptxas {stem} {name}: " + "; ".join(
                kernel_registers(log)), flush=True)
    walk_k, retrieve_k = own_keys(build.sources()["cops"].read_text())

    def timed_here(name, own, retrieve=False):
        """Does a section whose kernels walk ``own`` keys a warp in the
        source (the retrieve's: ``retrieve``) time variant ``name``?"""
        return (name in ("source", "bounds")
                or name.startswith("K=") and name != f"K={own}"
                or name == "retrieve 8 blocks" and retrieve)
    for name, _, log in built:
        print(f"ptxas {name}: " + "; ".join(walk_registers(log)), flush=True)

    def use(lib, module=ops):
        """Load ``lib`` as the library of wrapper ``module``."""
        module._lib.cache_clear()
        real = build.library
        build.library = lambda name: ctypes.CDLL(str(lib))
        try:
            module._lib()
        finally:
            build.library = real

    from torch.profiler import ProfilerActivity, profile

    def median_ms(fn, setup=lambda: ()):
        """(median ms of 5 runs of ``fn(*setup())`` after one, the runs)"""
        times = []
        for rep in range(6):
            args = setup()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            if rep:
                times.append(start.elapsed_time(end))
        return statistics.median(times), times

    def kernels_of(fn):
        """{kernel: ms} of one call of ``fn``, by the profiler"""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {re.search(r"(\w+_kernel<[^>]*>)", e.key)[1]:
                e.device_time_total / 1e3
                for e in prof.key_averages() if "_kernel<" in e.key}

    from repro_torch.core import multi_value, single_value
    for key_words in (1, 2) if "insert" in sections else ():
        if key_words == 1:
            keys = contract.distinct_keys(0, INSERT_KEYS, "cuda")
            absent = contract.distinct_keys(INSERT_KEYS + 2, ABSENT_KEYS,
                                            "cuda")
        else:
            keys = contract.distinct_keys64(0, INSERT_KEYS, "cuda")
            absent = contract.distinct_keys64(2 * INSERT_KEYS, ABSENT_KEYS,
                                              "cuda")
        vals = contract.values_for(keys, 1)
        table = single_value.create(int(INSERT_KEYS / 0.9), window=32,
                                    device="cuda", key_words=key_words)
        kw = dict(seed=table.seed, scheme=table.scheme,
                  max_probes=bulk._tstatic(table)[3])
        empty = contract.table_planes(table)
        insert = ops.insert if key_words == 1 else ops.insert64
        lookup = ops.lookup if key_words == 1 else ops.lookup64
        for name, lib in libs.items():
            if not timed_here(name, walk_k):
                continue
            use(lib)
            built = []

            def build_one(planes):
                insert(*planes, keys, vals, count=0, **kw)
                built[:] = [planes]

            build_ms, bt = median_ms(
                build_one, lambda: (tuple(p.clone() for p in empty),))
            planes = built[0]
            upsert_ms, ut = median_ms(lambda: insert(
                *planes, keys, vals, count=INSERT_KEYS, **kw))
            split = kernels_of(lambda: insert(*planes, keys, vals,
                                              count=INSERT_KEYS, **kw))
            look_ms, lt = median_ms(lambda: lookup(*planes, keys, **kw))
            gone_ms, gt = median_ms(lambda: lookup(*planes, absent, **kw))
            found = lookup(*planes, keys, **kw)[1].all()
            none = not lookup(*planes, absent, **kw)[1].any()
            print(f"insert fig5 u{32 * key_words} n={INSERT_KEYS} W=32 "
                  f"{name}: build {build_ms:.3f} ms (median of 5; min "
                  f"{min(bt):.3f}, max {max(bt):.3f}); upsert of every key "
                  f"{upsert_ms:.3f} ms (min {min(ut):.3f}, max {max(ut):.3f});"
                  f" the upsert's kernels: "
                  + "; ".join(f"{k} {v:.3f} ms"
                              for k, v in sorted(split.items()))
                  + f"; lookup of every key {look_ms:.3f} ms (min "
                  f"{min(lt):.3f}, max {max(lt):.3f}; all found: "
                  f"{bool(found)}), of {ABSENT_KEYS} absent keys "
                  f"{gone_ms:.3f} ms (min {min(gt):.3f}, max {max(gt):.3f};"
                  f" none found: {none})",
                  flush=True)
            del planes, built
        del keys, absent, vals, table, empty
        torch.cuda.empty_cache()

    for key_words in (1, 2) if "retrieve" in sections else ():
        use(libs["source"])
        if key_words == 1:
            base = contract.distinct_keys(0, MV_KEYS, "cuda")
        else:
            base = contract.distinct_keys64(0, MV_KEYS, "cuda")
        table = multi_value.create(int(MV_KEYS * MV_R / 0.8), window=32,
                                   device="cuda", key_words=key_words)
        kw = dict(seed=table.seed, scheme=table.scheme,
                  max_probes=bulk._tstatic(table)[3])
        planes = contract.table_planes(table)
        (ops.append if key_words == 1 else ops.append64)(
            *planes, base.repeat_interleave(MV_R, dim=0),
            torch.arange(MV_KEYS * MV_R, dtype=torch.int32, device="cuda"),
            **kw)
        walk = ops.retrieve_walk if key_words == 1 else ops.retrieve_walk64
        every = torch.ones((MV_KEYS,), dtype=torch.bool, device="cuda")
        want = {}
        for name, lib in libs.items():
            if not timed_here(name, retrieve_k, retrieve=True):
                continue
            use(lib)
            line = []
            for collect in (False, True):
                ms, ts = median_ms(lambda: walk(planes[0], base, every,
                                                collect=collect, **kw))
                got = walk(planes[0], base, every, collect=collect, **kw)
                want.setdefault(collect, got)
                same = all(torch.equal(a, b) for a, b in
                           zip(got, want[collect]) if a is not None)
                line.append(f"{'collecting' if collect else 'counts only'} "
                            f"{ms:.3f} ms (min {min(ts):.3f}, max "
                            f"{max(ts):.3f}; as the source: {same})")
                del got
            print(f"retrieve fig7 wc-oa u{32 * key_words} {MV_KEYS} keys x "
                  f"{MV_R} W=32 {name}: " + "; ".join(line), flush=True)
        del base, table, planes, every, want
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    fold = ("add", "add")
    for g in GROUPS if "update" in sections else ():
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
            # the walk's variants at the largest g alone, the combine's
            # at every g
            walk_only = name.startswith("K=") or name in (
                "bounds", "retrieve 8 blocks")
            if walk_only and (g != GROUPS[-1] or not timed_here(name, walk_k)):
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
    if "walk" in sections:
        probe_bucket_walk(torch, libs, use, median_ms)
    if "kmer" in sections:
        probe_kmer(torch, other_libs["minhash"], use, median_ms)
    if "bloom" in sections:
        probe_bloom(torch, median_ms, other_libs["bloom"], use)
    ops._lib.cache_clear()
    print(card, flush=True)
    return 0


def probe_bucket_walk(torch, libs, use, median_ms):
    """The "walk" section (see the module's docstring)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.core import bucket_list as bl
    from repro_torch.kernels.cops import contract, ops
    from repro_torch.kernels.minhash import ops as mh

    def walks(tag, table, queries):
        found, ptr, rcnt, bidx = bl._handle_probe(table, queries)[2:6]
        args = (table.pool, ptr, rcnt, bidx, found, *bl._schedule(table))
        links = int(bidx[found].sum())
        want = None
        for name, lib in libs.items():
            if name != "source" and not name.startswith("bucket K="):
                continue
            use(lib)
            ms, ts = median_ms(lambda: ops.bucket_walk(*args))
            got = ops.bucket_walk(*args)
            want = want or got
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            del got
            print(f"bucket walk {tag}: {queries.shape[0]} queries "
                  f"({int(found.sum())} found, {int(rcnt[found].sum())} "
                  f"values, {links} links), pool {table.pool_capacity} "
                  f"{name}: {ms:.3f} ms (median of 5; min {min(ts):.3f}, "
                  f"max {max(ts):.3f}; as the source: {same})", flush=True)
        pool = table.pool
        fill_ms, ts = median_ms(lambda: (
            torch.full(pool.shape, queries.shape[0], dtype=torch.int32,
                       device="cuda"),
            torch.zeros(pool.shape, dtype=torch.int32, device="cuda")))
        print(f"bucket walk {tag}: the two (P,) arena fills alone "
              f"{fill_ms:.3f} ms (min {min(ts):.3f}, max {max(ts):.3f})",
              flush=True)

    base = contract.distinct_keys(0, MV_KEYS, "cuda")
    table = bl.create(int(MV_KEYS / contract.LOAD), 2 * MV_KEYS * MV_R + 64,
                      s0=1, growth=1.1, window=32, device="cuda")
    table, _ = bl.insert(table, base.repeat_interleave(MV_R),
                         torch.arange(MV_KEYS * MV_R, dtype=torch.int32,
                                      device="cuda"))
    walks("wc-bl-1 r=8", table, base)
    del base, table
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    genomes = smoke.make_reference(torch, gen)
    sketches = [smoke.sketch_keys(torch, mh.sketch_reads(
        smoke.genome_windows(torch, g), k=smoke.K_MER, s=smoke.SKETCH,
        device="cuda")) for g in genomes]
    est = genomes.shape[0] * smoke.genome_windows(
        torch, genomes[0]).shape[0] * smoke.SKETCH
    table = bl.create(2 * est, 4 * est, s0=1, growth=1.1, window=32,
                      device="cuda")
    for g, sk in enumerate(sketches):
        table, _ = bl.insert(table, sk, torch.full(sk.shape, g,
                                                   dtype=torch.int32,
                                                   device="cuda"))
    del sketches
    gid = torch.randint(0, genomes.shape[0], (smoke.N_READS,),
                        device="cuda", generator=gen)
    pos = torch.randint(0, smoke.GENOME_LEN - smoke.READ_LEN + 1,
                        (smoke.N_READS,), device="cuda", generator=gen)
    reads = genomes[gid[:, None], pos[:, None]
                    + torch.arange(smoke.READ_LEN, device="cuda")]
    del genomes, gid, pos
    sk = mh.sketch_reads(reads, k=smoke.K_MER, s=smoke.SKETCH, device="cuda")
    q = sk[sk != -1]
    walks("fig8 classify", table, torch.where(q == -2, -3, q))
    del table, reads, sk, q
    torch.cuda.empty_cache()


def probe_kmer(torch, libs, use, median_ms):
    """The "kmer" section (see the module's docstring)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels.minhash import ops as mh
    from repro_torch.kernels.minhash import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    reads = smoke.random_bases(torch, gen, (smoke.N_READS, smoke.READ_LEN),
                               0.001)
    genome = smoke.random_bases(torch, gen, (smoke.GENOME_LEN,), 0.0)
    windows = smoke.genome_windows(torch, genome).contiguous()
    cases = {f"reads {tuple(reads.shape)} k=16": (reads, 16),
             f"reads {tuple(reads.shape)} k=31": (reads, 31),
             f"one genome's windows {tuple(windows.shape)} k=16":
                 (windows, 16)}
    want = {tag: ref.kmer_hashes(x, k) for tag, (x, k) in cases.items()}
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn, reps=5):
        """The kernel's mean device time over ``reps`` calls (the
        profiler), or None where the profiler saw no device time."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if "kmer_kernel" in e.key]
        total = sum(e.device_time_total for e in ev)
        return total / reps / 1e3 if total else None

    for name, lib in libs.items():
        use(lib, mh)
        line = []
        for tag, (x, k) in cases.items():
            ms, ts = median_ms(lambda: mh.kmer_hash(x, k))
            dev = device_ms(lambda: mh.kmer_hash(x, k))
            same = torch.equal(mh.kmer_hash(x, k), want[tag])
            line.append(f"{tag} {ms:.4f} ms (min {min(ts):.4f}, max "
                        f"{max(ts):.4f}; device "
                        f"{'not measured' if dev is None else f'{dev:.4f}'}"
                        f"; as plain: {same})")
        print(f"kmer_hash {name}: " + "; ".join(line), flush=True)
    mh._lib.cache_clear()
    del reads, genome, windows, want
    torch.cuda.empty_cache()


def probe_query(torch, median_ms, libs, use):
    """The query's part of the "bloom" section: the direct path under each
    variant at phase 21's shape and at the serve step's, the partitioned
    path at phase 21's shape with its kernels, and the threshold."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import bloom
    from repro_torch.kernels.bloom import ops
    from repro_torch.kernels.cops import contract

    def forced(n, rows, wpb):
        saved = ops.QUERY_KEYS_PER_SECTOR
        ops.QUERY_KEYS_PER_SECTOR = 0
        try:
            return ops.query_plan(n, rows, wpb)
        finally:
            ops.QUERY_KEYS_PER_SECTOR = saved

    f = bloom.create(2 ** 32, device="cuda")
    keys = contract.distinct_keys(0, 2 ** 28, "cuda")
    ops.insert_words(f.words, keys, k_hashes=f.k, seed=f.seed)
    absent = contract.distinct_keys(2 ** 31, 2 ** 28, "cuda")
    shards, slots = 8, 2 ** 25
    nb = bloom.num_blocks_for(16 * slots)
    stack = torch.zeros((shards, nb, 16), dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    live = contract.distinct_keys(0, 2 ** 27, "cuda")
    owners = torch.randint(0, shards, live.shape, generator=gen,
                           device="cuda")
    ops.insert_words(stack, live, k_hashes=4, seed=0x9E3779B9, planes=owners)
    half = 2 ** 19
    serve = torch.cat([live[:half], contract.distinct_keys(2 ** 31, half,
                                                           "cuda")])
    serve_planes = torch.cat([owners[:half], owners[half:2 * half]])
    shapes = {"phase 21 present": (f.words, keys, None, f.k, f.seed),
              "phase 21 absent": (f.words, absent, None, f.k, f.seed),
              "serve step (2^20 into 8 planes, half absent)":
                  (stack, serve, serve_planes, 4, 0x9E3779B9)}
    want = {tag: ops.query_plain(w, q, k_hashes=k, seed=sd, planes=p)
            for tag, (w, q, p, k, sd) in shapes.items()}
    direct = ops.Plan(False)
    part = forced(2 ** 28, f.num_blocks, 16)
    for name, lib in libs.items():
        use(lib, ops)
        line = []
        for tag, (w, q, p, k, sd) in shapes.items():
            for path, plan in (("direct", direct), ("partitioned", part)):
                if path == "partitioned" and p is not None:
                    continue
                ms, ts = median_ms(lambda: ops.query_launch(w, q, p, k, sd,
                                                            plan))
                same = torch.equal(ops.query_launch(w, q, p, k, sd, plan),
                                   want[tag])
                line.append(f"{tag} {path} {ms:.3f} ms (min {min(ts):.3f}, "
                            f"max {max(ts):.3f}; as plain: {same})")
        # one profile: the serve step's direct query thrice, then phase
        # 21's partitioned query once
        w, q, p, k, sd = shapes["serve step (2^20 into 8 planes, half absent)"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                ops.query_launch(w, q, p, k, sd, direct)
            ops.query_launch(f.words, keys, None, f.k, f.seed, part)
            torch.cuda.synchronize()
        split = "; ".join(
            f"{re.search(r'(\w+_kernel)', e.key)[1]} "
            f"{e.device_time_total / 1e3:.3f} ms / {e.count}"
            for e in prof.key_averages()
            if e.device_time_total > 0 and "_kernel" in e.key
            and "elementwise" not in e.key)
        print(f"bloom query {name}: " + "; ".join(line) + "; the profile "
              f"(the serve step's direct query x3, phase 21's partitioned "
              f"one, {part.tiles} tiles in {part.ranges} ranges): "
              f"{split or 'not measured'}", flush=True)
    use(libs["source"], ops)
    del want, shapes
    torch.cuda.empty_cache()
    filters = {f"fig12 stack {shards} x {nb} blocks, a plane per key":
                   (stack, live, owners, 4, 0x9E3779B9),
               f"phase 21's filter, {f.num_blocks} blocks":
                   (f.words, keys, None, f.k, f.seed)}
    for tag, (w, present, own, k, sd) in filters.items():
        rows = w.shape[0] * w.shape[1] if w.ndim == 3 else w.shape[0]
        for n in QUERY_BATCHES:
            if own is None and n < 2 ** 24:
                continue
            q = torch.cat([present[:n // 2], contract.distinct_keys(
                2 ** 31, n - n // 2, "cuda")])
            p = None if own is None else torch.cat([
                own[:n // 2], torch.randint(0, shards, (n - n // 2,),
                                            generator=gen, device="cuda")])
            plan = forced(n, rows, 16)
            d_ms, dt = median_ms(lambda: ops.query_launch(w, q, p, k, sd,
                                                          direct))
            p_ms, pt = median_ms(lambda: ops.query_launch(w, q, p, k, sd,
                                                          plan))
            same = torch.equal(ops.query_launch(w, q, p, k, sd, direct),
                               ops.query_launch(w, q, p, k, sd, plan))
            picks = ops.query_plan(n, rows, 16).partitioned
            print(f"bloom query {tag}: {n} keys (half absent), "
                  f"{n / (rows * 2):.4f} a filter sector; direct {d_ms:.3f} "
                  f"ms (min {min(dt):.3f}, max {max(dt):.3f}); partitioned "
                  f"{p_ms:.3f} ms (min {min(pt):.3f}, max {max(pt):.3f}; as "
                  f"direct: {same}); query_plan: "
                  f"{'partitioned' if picks else 'direct'}", flush=True)
            del q, p
    ops._lib.cache_clear()
    del f, keys, absent, stack, live, owners, filters
    torch.cuda.empty_cache()


def probe_bloom(torch, median_ms, libs, use):
    """The "bloom" section (see the module's docstring)."""
    from repro_torch.core import bloom
    from repro_torch.kernels.bloom import ops
    from repro_torch.kernels.cops import contract

    def forced(n, rows, wpb, tile_words, range_bytes):
        """``insert_plan``'s partitioned cut at these sizes, whatever the
        threshold says."""
        saved = ops.TILE_WORDS, ops.RANGE_BYTES, ops.PARTITION_KEYS_PER_SECTOR
        ops.TILE_WORDS, ops.RANGE_BYTES = tile_words, range_bytes
        ops.PARTITION_KEYS_PER_SECTOR = 0
        try:
            return ops.insert_plan(n, rows, wpb)
        finally:
            (ops.TILE_WORDS, ops.RANGE_BYTES,
             ops.PARTITION_KEYS_PER_SECTOR) = saved

    def paths(tag, words, keys, mask=None, planes=None, cuts=None, **kw):
        stack = words if words.ndim == 3 else words[None]
        rows, wpb = stack.shape[0] * stack.shape[1], stack.shape[2]
        n = keys.shape[0]

        def run(plan):
            ms, ts = median_ms(
                lambda w: ops.insert_launch(w, keys, mask, planes,
                                            plan=plan, **kw),
                lambda: (words.zero_(),))
            return ms, ts, words.clone()

        d_ms, d_ts, want = run(ops.Plan(False))
        line = [f"direct {d_ms:.3f} ms (min {min(d_ts):.3f}, max "
                f"{max(d_ts):.3f})"]
        for tile_words, range_bytes in cuts or [(ops.TILE_WORDS,
                                                 ops.RANGE_BYTES)]:
            plan = forced(n, rows, wpb, tile_words, range_bytes)
            if not plan.partitioned:
                continue
            ms, ts, got = run(plan)
            line.append(
                f"partitioned, {plan.tiles} tiles of {tile_words * 4 >> 10}"
                f" KiB in {plan.ranges} ranges of {range_bytes >> 20} MiB, "
                f"{ms:.3f} ms (min {min(ts):.3f}, max {max(ts):.3f}; as "
                f"direct: {torch.equal(got, want)})")
            del got
        plan = ops.insert_plan(n, rows, wpb)
        if cuts and plan.partitioned:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                ops.insert_launch(words.zero_(), keys, mask, planes,
                                  plan=plan, **kw)
                torch.cuda.synchronize()
            line.append("the source's kernels: " + "; ".join(
                f"{e.key[:48]} {e.device_time_total / 1e3:.3f} ms"
                for e in prof.key_averages() if e.device_time_total > 0))
        print(f"bloom insert {tag}: {n} keys, {n / (rows * wpb / 8):.4f} a "
              f"filter sector; " + "; ".join(line) + f"; insert_plan: "
              f"{'partitioned' if plan.partitioned else 'direct'}",
              flush=True)
        del want

    f = bloom.create(2 ** 32, device="cuda")
    keys = contract.distinct_keys(0, 2 ** 28, "cuda")
    paths("phase 21 (2^32 bits)", f.words, keys, k_hashes=f.k, seed=f.seed,
          cuts=[(w, mib << 20) for w in TILE_WORDS for mib in RANGE_MIB])
    del f, keys
    torch.cuda.empty_cache()

    shards, slots = 8, 2 ** 25
    nb = bloom.num_blocks_for(16 * slots)
    words = torch.zeros((shards, nb, 16), dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    for n in BLOOM_BATCHES:
        keys = contract.distinct_keys(n, n, "cuda")
        owners = torch.randint(0, shards, (n,), generator=gen, device="cuda")
        paths(f"fig12 stack {shards} x {nb} blocks", words, keys,
              planes=owners, k_hashes=4, seed=0x9E3779B9)
    keys = contract.distinct_keys(0, slots, "cuda")
    live = torch.rand((slots,), generator=gen, device="cuda") < 0.5
    paths(f"fig12 rebuild, one plane of {nb} blocks", words[0], keys, live,
          k_hashes=4, seed=0x9E3779B9)
    del words, keys, live
    torch.cuda.empty_cache()
    probe_query(torch, median_ms, libs, use)


if __name__ == "__main__":
    sys.exit(main())
