#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths — bulk build and bulk retrieval on the
single-value COPS table, the paper's headline (§IV-B, Fig. 5), on the
multi-value table and the bucket list (§IV-B.4, §IV-C, Fig. 7), the
metagenomics pipeline (§V-C, Fig. 8), the relational layer (fig9) and the
bloom-filtered elastic service (fig12) — at the paper's scale, flash
attention at starcoder2-3b's attention widths, and the tables' telemetry
(``stats=True``) and growth (``insert_or_grow``), and holds every kernel
of each path against its plain PyTorch version.  Phases, one status line
each:

1. the card (``nvidia-smi`` name and power limit) and the kernels' build
   from ``src/repro_torch/kernels/*/csrc``;
2. kernel vs plain at 2^20 distinct keys, rho = 0.9, for W = 32 cops,
   W = 1 cops, W = 1 linear and W = 128 linear (the 8-key walk's 32-lane
   chunks and the linear step): a fresh build, then a batch of present,
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
   take for the same bytes (3.35 TB/s); ``cops_insert`` both as the build
   and as the upsert of every key into the table it built (all UPDATED,
   under the four-part contract); ``cops_lookup`` of every key and of
   phase 3's 2^24 absent keys, each bit-exact (values, found, slots) and
   timed with its bound; and the kernels of one build, one upsert and
   both lookups named with their times by ``torch.profiler`` in a child
   process (``--upsert-launches``);
5. multi-value kernels vs plain at 2^20 pairs, for wc-oa (W = 32 cops,
   r = 1, 8, 32 and 100 in a row; at r = 8 also the runs rolled by 3
   pairs, two keys interleaved and the pairs shuffled,
   ``contract.LAYOUTS``) and lp-oa (W = 1 linear, max_probes 8192, r = 8)
   (``benchmarks/fig7_multi_value.py``): a build, an erase of 1/8 of the
   keys through ``multi_value.erase``, and a second batch onto the
   tombstones; after each batch the append under the multi-value contract
   and the retrieve walk bit-exact (``contract.run_multi_case``); and runs
   that meet no other key and go FULL partway in a near-full store with a
   budget of 2 windows, at W = 32 cops, W = 2 linear and W = 128 cops,
   where the append must build the plain version's store exactly
   (``contract.run_full_case``); and the retrieve walk bit-exact on long
   and cut walks at W = 32, 64 and 128, cops and linear: runs of 1, 8 and
   40 equal keys in a store near full of 2^14 slots, TOMBSTONE-only
   windows, erased pairs, masks that leave whole groups of 8 queries
   inactive, budgets of 1 and 2 windows, the table's, and num_rows + 3 on
   a store with no EMPTY window, where walks revisit rows
   (``contract.run_retrieve_case``);
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
   at the same shape the append of 2^28 distinct keys (r = 1), of 2^23
   keys 32 times in a row (r = 32) and of phase 6's pairs shuffled (a
   permutation seeded through ``torch.Generator``), each timed with its
   byte bound, all INSERTED and its live pairs the batch's; the retrieve
   also counts only, and the kernels of one collecting and one counting
   retrieve named with their times by ``torch.profiler`` in a child
   process (``--upsert-launches 1 retrieve``);
8. the two-plane kernels vs plain at 2^20 two-word keys, a quarter of
   them sharing 2^10 plane-0 words, some with plane 1 at 0xFFFFFFFF /
   0xFFFFFFFE: phase 2's single-value cases with ``cops_insert64`` /
   ``cops_lookup64``, and phase 5's wc-oa r = 8 cases (every layout, the
   keys sharing a plane-0 word side by side), near-full cases and long and
   cut retrieve walks with ``cops_append64`` / ``cops_retrieve64``;
9. the u64 single-value main path: 2^28 distinct u64 keys (a bijective
   64-bit mix of ``arange``, ``contract.distinct_keys64``) into
   ``create(n / 0.9, key_words=2)``, W = 32, cops — insert, upsert,
   retrieve, absent retrieve, erase and re-insert, every result checked;
   insert and retrieve timed.  The counters are zeroed just before it and
   read just after it;
10. the u64 multi-value main path, Fig. 7's wc-oa at r = 8: 2^25 distinct
    u64 keys, 8 in a row, into ``multi_value.create(n / 0.8,
    key_words=2)`` — insert, count_values, retrieve_all, erase and
    re-insert, every result checked; insert, count and retrieve_all timed.
    The counters are zeroed just before it and read just after it;
11. each two-plane kernel alone and its plain version at the shapes of
    phases 9 and 10 (``cops_insert64`` both as the build and as the
    upsert of every key, the upsert's match and claim passes split by
    ``torch.profiler`` as in phase 4; ``cops_lookup64`` of every key and
    of phase 9's absent keys, as in phase 4), compared and timed, with
    their byte bounds;
    ``cops_append64`` also at r = 1, r = 32 and shuffled, and
    ``cops_retrieve64`` counts only and named by the profiler, as in
    phase 7;
12. ``cops_bucket_walk`` vs plain (identical arenas) on chains grown by
    24 insert batches, scattered over the pool and long (up to 18 buckets
    at growth 1.1, 128-value buckets at growth 2), on batches of 1, K - 1,
    K, K + 1 and 33 queries and with whole warps inactive, each query
    given exactly its key's values (``contract.run_chain_case``), and on
    bucket lists of 2^20 pairs for Fig. 7's wc-bl-1 (growth 1.1, s0 1) and
    wc-bl-2 (growth 1.0, s0 r) at r = 1, 8, 32, with chains grown across
    two batches, duplicate and absent queries
    (``contract.run_bucket_case``); and ``kmer_hash`` vs plain on 2^24
    bases with 0.1% N, as one row and as 150-base reads, for k = 8, 16,
    20, 31;
13. the bucket list's main path, Fig. 7's wc-bl-1 cell at r = 8: phase
    6's 2^28 pairs into ``bucket_list.create(2^25 / 0.8, 2^29 + 64)``,
    W = 32, cops — insert, count_values and retrieve_all of the 2^25 keys
    and of absent keys, each exact against a stable sort of the inserted
    pairs; timed, the insert split into its sort, its claim placement and
    the rest, and the storage density printed beside wc-oa's.  The
    counters are zeroed just before it and read just after it;
14. the Fig. 8 pipeline: a reference of 256 genomes of 2^22 bases (32
    ancestors x 8 strains at 1% substitutions) made on the card from a
    seed, sketched in windows of 127 bases at stride 112 (k = 16, 16
    hashes each) and indexed in a bucket list genome by genome; then 2^20
    reads of 150 bases (1% substitutions, 0.1% N) classified by k-mer
    votes, every retrieval exact against a sort of the inserted pairs and
    the species-level accuracy at least 0.8; k-mers hashed, pairs indexed
    and reads classified per second.  The counters are zeroed just
    before it and read just after it;
15. ``cops_bucket_walk`` at phase 13's shapes and at phase 14's classify
    (its queries on the Fig. 8 index), and ``kmer_hash`` at phase 14's
    reads, each alone and its plain version, compared and timed, with
    their bounds (the k-mer's: each base read once, each hash written
    once);
16. ``cops_update`` / ``cops_update64`` vs plain at 2^20 rows under the
    update contract (``contract.run_update_case``): every group-by
    aggregate at 64, 2^16 and 2^19 groups, the counting table's saturating
    count (counters at 0xFFFFFFF0 take 32 more), W = 8 and 32, cops and
    linear, tombstones, a table too small for its groups (FULL), and
    two-word keys sharing plane-0 words; each fold op (add, min, max, the
    saturating add, and the saturating add reached through a group's
    other rows only) at R - 1, R and R + 1 groups (R: the most whose rows
    the kernel combines in shared memory, ``ops.shared_groups``), every
    group in the first batch, and on a batch whose rows all share one key;
    and the hash set's add, contains and remove on 2^20 keys against a
    table-free reference;
17. the relational path at the paper's scale (``benchmarks/
    fig9_relational.py`` with n = paper_n_pairs / 2 = 2^27): the inner
    hash join of 2^27 distinct build keys and 2^27 probe keys drawn from
    a universe of 8n (about 1/8 match) at rho 0.5 and 0.95, the four
    flavours at rho 0.5, the group-by (sum, count, mean) at 64, 1024 and
    2^25 groups, and DISTINCT at duplication 8, each exact against a
    table-free reference on the card and timed (median of 5 after a
    warm-up), the sort-based group-by beside it.  The counters are zeroed
    just before it and read just after it;
18. the composite-key parity gate of ``fig9_relational.py:161-217`` at
    n = 2^24 (the join, the group-by and DISTINCT on two columns, each
    against the same columns packed into one word; counters zeroed just
    before and read just after), then ``cops_update`` alone on phase 17's
    2^25-, 1024- and 64-group sums and ``cops_update64`` alone on the
    composite group-by, each into an empty table (every group claims) and
    again into the table it filled (every group folds), against their
    plain versions, timed, with byte bounds from each run's own statuses,
    this design's own traffic beside them (the combine's scratch), and the
    kernels of one call (the combine, then the walk) named with their
    times by ``torch.profiler``;
19. ``bloom_insert`` / ``bloom_query`` vs their plain versions at 2^20
    keys (each ~4 times, half masked) for 256-, 512- and 1024-bit blocks,
    k = 1, 4, 8, one filter and a stack of 8 with a plane per key (some
    out of range), and an empty batch, each insert and query by both paths
    (the filter whole: the direct ones; cut into 64 KiB ranges: the
    partitioned ones): filter words and hits bit-exact;
20. the elastic service (``serving/elastic.py``) at fig12's shape
    (``benchmarks/fig12_serve.py:57-62``: 8 shards, 16 bloom bits per key,
    slack 2.5) scaled to the card: 2^25 slots per shard (2^28 in all),
    2^27 keys preloaded in batches of 2^24, then a warm-up step and 16
    timed serve steps of 2^20
    upserts (3/4 new keys, 1/4 live), 2^20 lookups (half live, half from a
    disjoint absent range) and 2^18 erases of live keys, every status,
    value, found and erased flag held against a table-free model of the
    live set (sorted keys, last writer wins); step p50 / p99 from CUDA
    events, steps/s, operations/s, the skip share of absent lookups, the
    false-positive share and the step split (routing, shard inserts, bloom
    kernels, shard lookups, erases, gathers); ``compact_all`` (the
    advertised-dead share drops, no live key lost).  Every bloom launch of
    the last preload batch, the warm-up step, ``compact_all`` and the
    lookups after it is held, on its own inputs, against the plain
    version: filter words and admission bits bit-exact; the preload and
    ``compact_all`` take the partitioned insert, the serve steps the
    direct one.  Then save through the
    ``SnapshotWriter`` -> ``load`` (bit-exact shard planes) and ``reshard``
    8 -> 16 (``check_ownership``) at 2^22 slots per shard, so the snapshot
    on disk stays under 300 MiB.  The counters are zeroed just before and
    read just after;
21. ``bloom_insert`` and ``bloom_query`` alone (each by its partitioned
    path, and by its direct path beside) at 2^28 keys into a filter
    of 2^32 bits (next_prime(2^23) blocks of 512 bits, 512 MiB of words,
    k = 4) and their plain versions, compared and timed; the bound is the
    sectors this run's keys touch, each once (about the filter, read and
    written once), + the key and hit streams, or the integer operations
    if more; the designs' own traffic (the partitioned paths' passes
    over the keys, slots and answers, every key's sectors for the direct
    ones) beside it; and
    the false-positive rate on 2^28 absent keys;
22. ``flash_fwd`` through ``flash_attention`` vs its plain version
    (``ref.gqa_attention``, f32 softmax attention, TF32 off) on the same
    card tensors for every case of ``tests/test_torch_flash.py`` and the
    configs' widths at S up to 1024 (starcoder2-3b 24 / 2 heads, hd 128;
    smollm-360m 15 / 5, hd 64; olmo-1b 16 / 16, hd 128; hd 16; Sk != S;
    tq 64 / tk 128; in bf16 also S = 1, S = 130 and hd 32), and
    ``flash_call`` on panels, at the reference's elementwise tolerances
    (2e-5 f32, 2e-2 bf16) and at limits scaled to the output: the
    relative error of the whole output and of each row (one query of one
    head);
23. the main path: ``flash_attention`` at starcoder2-3b's widths, causal,
    on the train_4k sequence (bf16, B = 4, S = 4096), the prefill_32k
    sequence (bf16, B = 1, S = 32768) and the 4k sequence in f32 (B = 1);
    the counter zeroed just before and read just after; each output held
    against the plain version (timed once) at phase 22's limits, and so is
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
    (B, H, S, hd) views of the same tensors, at scaled limits of its own
    (it rounds P to bf16); ``flash_fwd`` and SDPA timed
    (median of 5 after a warm-up), and the CUDA kernels of one call of
    each named by ``torch.profiler`` (which SDPA backend ran); the bound:
    the flops (4 hd per visible pair) at the type's peak (989 TFLOP/s
    bf16, 67 f32), the bytes (q, k, v, o once) and the exponentials beside
    it;
24. the lookups' probe-length launches (``plen=True``, the ``PLEN``
    instantiations of ``cops_lookup`` / ``cops_lookup64``) vs
    ``lookup_plain``'s probe lengths, bit-exact, the lookup's outputs
    unchanged (``contract.run_plen_case``): 2^20 keys at rho = 0.9 in
    phase 2's four geometries, u32 and two-plane keys, with absent and
    sentinel keys, TOMBSTONE-only windows and budgets of 1 and 2 windows;
    budgets of num_rows + 3 on a 2^12-slot store without an EMPTY slot;
    batches of 1, 7, 8, 9 and 33 keys; then the lookup of fig5's 2^28
    keys (u32, u64) with and without ``plen``, in turns, with its bound;
25. ``stats=True`` on the main paths (``obs.metrics``): fig5's u32 and
    u64 cells through ``sv.insert`` and ``sv.retrieve``, fig9's group-by
    rows through ``counting.insert`` and the wc-oa r = 8 cell through
    ``mv.count_values``, each ``TableStats`` held to a ``bincount`` of the
    statuses, a count over key plane 0 and the plain walk of the same
    store, the outputs to the call's without stats; each call timed with
    and without stats, each cell's mean / p50 / p99 probe length printed.
    The counters are zeroed just before and read just after;
26. growth at full width (``core.migrate``): fig5's 2^28 keys in 16
    batches through ``sv.insert_or_grow`` from ``create(2^24)``, then
    erases past the tombstone density and a batch that compacts; fig9's
    2^27 rows through ``counting.insert_or_grow`` from ``create(2^20)``;
    wc-oa's 2^28 pairs through ``mv.insert_or_grow`` from
    ``create(2^24)``, all under ``GrowthPolicy(max_capacity=2^30)``, each
    checked (no FULL, every key and count, ``retrieve_all`` per key) and
    timed, its migrations apart.  The counters are zeroed just before and
    read just after.

The second-to-last line is the ``{"kernels": [...]}`` record, one entry per
kernel; its ``bound_by`` is "bytes" or "operations" (the larger term), and
``bound_rate`` names which operations at which peak rate (32-bit integer
operations, or flops of the input's type).  ``elements`` counts what the
main path's launches took (keys, rows, pairs, queries, k-mers or scores),
``timed_elements`` what the timed launch took, and ``path_loss_ms`` is
their ratio times the timed launch's ms above its bound: the ranking of
the kernels for their redesign.  The last is
``{"ok": true, "device": ...}``, printed only when every phase passed.
Exits non-zero without a card, or when the repository's sources are not
beside this script.
"""

from __future__ import annotations

import contextlib
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
# (cell, W, scheme, r, max_probes, layout): fig7_multi_value.py:83-85
MV_CASES = (("wc-oa", 32, "cops", 1, None, "runs"),
            ("wc-oa", 32, "cops", 8, None, "runs"),
            ("wc-oa", 32, "cops", 8, None, "offset"),
            ("wc-oa", 32, "cops", 8, None, "interleaved"),
            ("wc-oa", 32, "cops", 8, None, "shuffled"),
            ("wc-oa", 32, "cops", 32, None, "runs"),
            ("wc-oa", 32, "cops", 100, None, "runs"),
            ("lp-oa", 1, "linear", 8, 8192, "runs"))
FULL_CASES = ((32, "cops"), (2, "linear"), (128, "cops"))  # near-full
# phases 5 and 8: the retrieve's long and cut walks (W, scheme), on stores
# of RETRIEVE_CAPACITY slots (contract.run_retrieve_case)
RETRIEVE_CASES = tuple((w, s) for w in (32, 64, 128)
                       for s in ("cops", "linear"))
RETRIEVE_CAPACITY = 2 ** 14
# phases 2 and 8: (W, scheme) of the single-value kernel-vs-plain cases
SINGLE_CASES = ((32, "cops"), (1, "cops"), (1, "linear"), (128, "linear"))
R_WIDE = 32               # phase 7's r = 32 variant: 2^23 keys
SHUFFLE_SEED = 7          # phase 7's shuffled variant
PLEN_BATCHES = (1, 7, 8, 9, 33)  # phase 24: around a warp's 8 walks
GROW_START = 2 ** 24      # phase 26: the tables the streams start from
GROW_BATCHES = 16         # phase 26: fig5's keys in batches of 2^24
GROW_CAP = 1 << 30        # phase 26: the policy's cap (default 2^24)
N_BL = 2 ** 28            # fig7 wc-bl: 2^25 keys x r = 8, as phase 6
BL_CASES = (("wc-bl-1", 1.1, 1, 1), ("wc-bl-1", 1.1, 1, 8),
            ("wc-bl-1", 1.1, 1, 32), ("wc-bl-2", 1.0, 1, 1),
            ("wc-bl-2", 1.0, 8, 8), ("wc-bl-2", 1.0, 32, 32))  # fig7:115-124
KMER_KS = (8, 16, 20, 31)
N_KMER_CHECK = 2 ** 24    # bases of phase 12's k-mer cases
N_ANCESTORS, N_STRAINS = 32, 8        # the reference: 256 genomes
GENOME_LEN = 2 ** 22
K_MER, SKETCH, WIN_LEN, WIN_STRIDE = 16, 16, 127, 112   # MetaCache defaults
N_READS, READ_LEN = 2 ** 20, 150
N_REL = 2 ** 27           # fig9_relational.py:57: n = paper_n_pairs // 2
REL_RHOS = (0.5, 0.95)
REL_GROUPS = (64, 1024, 2 ** 25)
REL_AGGS = ("sum", "count", "mean")
N_COMPOSITE = 2 ** 24
UPDATE_GROUPS = (64, 2 ** 16, 2 ** 19)
# phase 16's cases at R - 1, R and R + 1 groups and at one key: a
# contract.UPDATES entry per fold op (add, min, max, the saturating add,
# and the saturating add reached through a group's other rows only)
UPDATE_OPS = ("sum", "min", "max", "counting", "saturating")
# benchmarks/fig12_serve.py:57-62 (8 shards, 16 bloom bits per key, slack
# 2.5; each step nb upserts, nb lookups, nb // 4 erases) scaled to the card
EL_SHARDS, EL_BITS_PER_KEY, EL_SLACK = 8, 16, 2.5
EL_CAPACITY = 2 ** 25     # per shard: 2^28 slots in all
EL_PRELOAD, EL_PRELOAD_BATCH = 2 ** 27, 2 ** 24
EL_NB, EL_STEPS = 2 ** 20, 16
EL_SNAP_CAPACITY = 2 ** 22  # the save / load / reshard leg, per shard
N_BLOOM = 2 ** 28         # phase 21: keys into a filter of 2^32 bits
SMALL_RANGE_BYTES = 2 ** 16  # phase 19's ranges of the partitioned insert
BLOOM_BITS = 2 ** 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
# phases 22-23: flash attention at starcoder2-3b's attention widths
# (configs/starcoder2_3b.py:7-8: 24 query heads on 2 KV heads, hd 128) and
# the repo's sequences (configs/base.py:9-10: train_4k, prefill_32k);
# (cell, dtype, batch, sequence), all causal
FLASH_HEADS = (24, 2, 128)
FLASH_MAIN = (("flash-starcoder2-3b-4k", "bfloat16", 4, 4096),
              ("flash-starcoder2-3b-32k", "bfloat16", 1, 32768),
              ("flash-starcoder2-3b-4k-f32", "float32", 1, 4096))
# phase 22's cases: (B, S, Sk, H, Hkv, hd, dtype, causal, tq, tk) — those of
# tests/test_torch_flash.py, then the configs' widths at S up to 1024:
# starcoder2-3b (24 / 2 / 128), smollm-360m (15 / 5 / 64,
# configs/smollm_360m.py:7-8), olmo-1b (16 / 16 / 128), the SMOKE head dim 16
FLASH_CASES = (
    (2, 256, 256, 4, 2, 64, "float32", True, 128, 128),
    (2, 256, 256, 4, 2, 64, "float32", False, 128, 128),
    (1, 384, 384, 2, 2, 32, "float32", True, 128, 128),
    (1, 384, 384, 2, 2, 32, "float32", False, 128, 128),
    (2, 128, 128, 4, 4, 64, "float32", True, 128, 128),
    (2, 128, 128, 4, 4, 64, "float32", False, 128, 128),
    (1, 256, 256, 2, 2, 64, "bfloat16", True, 128, 128),
    (1, 128, 128, 24, 2, 32, "float32", True, 128, 128),
    (1, 128, 128, 4, 2, 16, "float32", True, 128, 128),
    (1, 128, 256, 2, 1, 32, "float32", True, 128, 128),
    (1, 256, 128, 2, 1, 32, "float32", False, 128, 128),
    (1, 256, 256, 2, 2, 32, "float32", True, 64, 128),
    (2, 1024, 1024, 24, 2, 128, "bfloat16", True, 128, 128),
    (2, 1024, 1024, 24, 2, 128, "float32", True, 64, 128),
    (2, 1024, 1024, 15, 5, 64, "bfloat16", True, 128, 128),
    (2, 1024, 1024, 15, 5, 64, "float32", False, 128, 128),
    (1, 1024, 1024, 16, 16, 128, "bfloat16", True, 128, 128),
    (1, 1024, 1024, 16, 16, 128, "float32", False, 128, 128),
    (1, 512, 1024, 24, 2, 128, "bfloat16", True, 128, 128),
    (1, 1024, 384, 24, 2, 128, "float32", False, 128, 128),
    (2, 1024, 1024, 4, 2, 16, "bfloat16", True, 128, 128),
    # the bf16 kernel's ragged edges: one row; one row past a 128-row tile
    (1, 1, 1, 24, 2, 128, "bfloat16", True, 1, 1),
    (1, 130, 130, 24, 2, 128, "bfloat16", True, 130, 130),
    (1, 384, 384, 2, 2, 32, "bfloat16", False, 128, 128),
)
# the reference's tolerances (tests/test_kernels.py::TestFlashKernel):
# |got - want| <= tol + tol |want| for every value
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# limits scaled to the output, which the elementwise ones are not at long
# sequences (a causal output over n keys of N(0, 1) values spreads about
# sqrt(e / n): ~0.013 at 32k, below 2e-2): the relative error
# ||got - want|| / ||want|| of the whole output and the largest of one
# output row (one query of one head).  f32: 4-16x the largest reading of
# a sound run (PERF.md).  bf16: the kernel runs P V on the tensor
# cores and so rounds the probabilities to bf16 first, as SDPA does, which
# puts its whole-output error near 2e-3 (SDPA read 2.14e-3 / 2.24e-3,
# worst row 4.08e-3 / 4.49e-3 at 4k / 32k, PERF.md): it is held to SDPA's
# class, where a kernel that drops key tiles reads 0.1 / 0.7.
FLASH_LIMITS = {"flash_fwd": {"float32": (1e-5, 5e-5),
                              "bfloat16": (5e-3, 1.5e-2)},
                "sdpa": {"float32": (1e-5, 5e-5),
                         "bfloat16": (5e-3, 1.5e-2)}}
# peak rates for the flash bound (NVIDIA's H100 SXM data sheet, dense):
# flops per second by input type
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# 132 SMs x 16 special-function lanes x 1.98 GHz: exponentials per second
EXP_PER_S = 132 * 16 * 1.98e9
# 132 SMs x 64 INT32 lanes x 1.98 GHz (the Hopper white paper; the guide's
# table has no integer rate): 32-bit integer operations per second
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# the fewest 32-bit operations per k-mer of the hash function: a rolling
# update of the forward and reverse words (6), validity (3), the min (1),
# fmix32 (8: three xor-shifts, two multiplies) and the INVALID select (1)
OPS_PER_KMER = 19
# the fewest 32-bit operations per key of a bloom insert or query: the two
# xor-ins (2), murmur3 twice and xxhash once (8 + 8 + 9), the block's
# modulo and row address (3), and per bit a multiply-add, its mask and the
# word / bit split (4 per bit, added at the call)
OPS_PER_BLOOM_KEY = 30
KMER_DESIGN = ("flat: a thread rolls 8 consecutive outputs over the block's "
               "span of bases, staged in shared memory; 16-byte stores")
SOURCE = "src/repro_torch/kernels/cops/csrc/cops.cu"
MINHASH_SOURCE = "src/repro_torch/kernels/minhash/csrc/minhash.cu"
BLOOM_SOURCE = "src/repro_torch/kernels/bloom/csrc/bloom.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash/csrc/flash.cu"
REPLACES = {"cops_insert": "src/repro/kernels/cops/kernel.py:75",
            "cops_lookup": "src/repro/kernels/cops/kernel.py:789",
            "cops_append": "src/repro/kernels/cops/kernel.py:103",
            "cops_retrieve": "src/repro/kernels/cops/kernel.py:334",
            "cops_insert64": "src/repro/kernels/cops/kernel.py:518",
            "cops_lookup64": "src/repro/kernels/cops/kernel.py:629",
            "cops_append64": "src/repro/kernels/cops/kernel.py:547",
            "cops_retrieve64": "src/repro/kernels/cops/kernel.py:694",
            "cops_bucket_walk": "src/repro/kernels/cops/kernel.py:435",
            "cops_update": "src/repro/kernels/cops/kernel.py:203",
            "cops_update64": "src/repro/kernels/cops/kernel.py:203",
            "kmer_hash": "src/repro/kernels/minhash/kernel.py:33",
            "bloom_insert": "src/repro/kernels/bloom/kernel.py:45",
            "bloom_query": "src/repro/kernels/bloom/kernel.py:83",
            "flash_fwd": "src/repro/kernels/flash/kernel.py:35"}


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
    """Yield ``(attempt, index, keys, windows, match)`` for every step of the
    probe walks of ``keys`` ((n,) words or (n, kw) planes) over the key
    planes ((p, W) or (kw, p, W)), 2^22 keys at a time: ``index`` is each
    walking key's position in ``keys``, ``keys`` its (m, kw) planes,
    ``windows`` its plane-0 row (m, W) and ``match`` where that row holds
    the key on every plane.  A walk ends after the window where
    ``stop(windows, match)`` holds, or at ``budget``."""
    from repro_torch.core import bulk, probing
    from repro_torch.core.single_value import key_hash_word
    planes = table_keys if table_keys.ndim == 3 else table_keys[None]
    p = planes.shape[1]
    for s in range(0, keys.shape[0], 1 << 22):
        chunk = keys[s:s + (1 << 22)]
        k = bulk._key_cols(chunk)
        idx = torch.arange(s, s + k.shape[0], device=keys.device)
        words = key_hash_word(chunk)
        row = probing.initial_row(words, p, seed)
        step = probing.row_step(scheme, words, p, seed)
        for attempt in range(budget):
            if idx.numel() == 0:
                break
            win, match = bulk.window_match(planes, row, k)
            yield attempt, idx, k, win, match
            go = ~stop(win, match)
            k, idx, step = k[go], idx[go], step[go]
            row = probing.advance_row(row[go], step, p)


def plane1_sectors(win, key) -> int:
    """The 32-byte plane-1 sectors a two-plane walk reads in these windows:
    those holding a lane whose plane 0 is the key's low word."""
    hit = win == key[:, :1]
    return int(hit.view(hit.shape[0], max(1, hit.shape[1] // 8), -1)
               .any(2).sum())


def walk_windows(torch, table_keys, keys, seed, scheme, budget):
    """(windows, plane-1 sectors) that the read-only walks of ``keys``, to
    a match or an EMPTY window, read on the store ``table_keys``."""
    from repro_torch.core.common import EMPTY_WORD
    windows = sectors = 0
    for _, idx, k, win, match in probe_walks(
            torch, table_keys, keys, seed, scheme, budget,
            lambda w, m: (m | (w == EMPTY_WORD)).any(1)):
        windows += idx.numel()
        if k.shape[1] == 2:
            sectors += plane1_sectors(win, k)
    return windows, sectors


def multi_walk_windows(torch, table_keys, keys, seed, scheme, budget):
    """For the distinct ``keys`` of a multi-value store: (the windows their
    walks read up to and including the first EMPTY window; the windows up to
    the last one holding a pair of the key — what an append of the key's
    pairs into an empty store must read; the plane-1 sectors the first
    walks read, for two-plane keys), each summed over the keys."""
    from repro_torch.core.common import EMPTY_WORD
    walked = sectors = 0
    last = torch.zeros(keys.shape[:1], dtype=torch.int64, device=keys.device)
    for attempt, idx, k, win, match in probe_walks(
            torch, table_keys, keys, seed, scheme, budget,
            lambda w, m: (w == EMPTY_WORD).any(1)):
        walked += idx.numel()
        if k.shape[1] == 2:
            sectors += plane1_sectors(win, k)
        last[idx[match.any(1)]] = attempt + 1
    return walked, int(last.sum()), sectors


class Counts(dict):
    """The launches of each kernel since its module's ``reset_launches``,
    with the elements they took (keys, rows, pairs, queries, k-mers or
    scores) in ``elements``."""

    elements: dict


def path_counts(*modules) -> Counts:
    """The launch and element counters of the kernels of the wrapper
    ``modules`` (``kernels/*/ops.py``), as they stand."""
    out = Counts()
    out.elements = {}
    for m in modules:
        out.update(m.LAUNCHES)
        out.elements.update(m.ELEMENTS)
    return out


def kernel_record(name, launches, err, times, plain_times, bound_bytes, *,
                  elements, source=SOURCE, bound_ops=0, bound_flops=0,
                  flops_rate=None, library_times=None, design=None):
    """One entry of the ``{"kernels": [...]}`` line: the main path's
    ``launches`` of the kernel (``Counts``) and the elements they took, the
    elements of the timed launch, its median time of ``times``, the plain
    version's time, the library call's median time where there is one, and
    the bound: the largest of the bytes at the card's memory rate, the
    32-bit integer operations at its integer rate and the flops at
    ``flops_rate``.  ``bound_by`` says "bytes" or "operations", and
    ``bound_rate`` which operations at which rate.  ``path_loss_ms`` ranks
    the kernels for their redesign: the path's elements over the timed
    launch's, times the timed launch's ms above its bound.  ``design``
    names the timed launch's design where a kernel has several."""
    by_bytes = bound_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = bound_ops / INT32_OPS_PER_S * 1e3
    by_flops = bound_flops / flops_rate * 1e3 if bound_flops else 0.0
    bound = max(by_bytes, by_ops, by_flops)
    if bound == by_bytes:
        rate = "bytes at 3.35 TB/s"
    elif bound == by_ops:
        rate = (f"32-bit integer operations at "
                f"{INT32_OPS_PER_S / 1e12:.2f} Tops/s")
    else:
        rate = f"flops at {flops_rate / 1e12:g} TFLOP/s"
    ms = statistics.median(times)
    path = launches.elements[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms,
            "plain_ms": plain_times[0], "bound_ms": bound,
            "bound_by": "bytes" if bound == by_bytes else "operations",
            "bound_rate": rate,
            "library_ms": (statistics.median(library_times)
                           if library_times else None),
            "elements": path, "timed_elements": elements,
            "path_loss_ms": path / elements * (ms - bound), "design": design}


def pair_err(a, b) -> float:
    """Largest value difference between two sorted (key, value) lists
    (``contract.live_pairs``), inf when their keys differ."""
    if a[0].shape != b[0].shape or not bool((a[0] == b[0]).all()):
        return float("inf")
    return int((a[1] - b[1]).abs().max()) if a[1].numel() else 0


class Checks:
    """The run's named checks; ``failed`` lists the ones that failed."""

    def __init__(self):
        self.failed = []

    def __call__(self, name, ok):
        if not ok:
            self.failed.append(name)
        return ok

    def status(self, since=0) -> str:
        return "ok" if len(self.failed) == since else "FAILED"


def width(keys) -> tuple[int, str]:
    """(key words, label) of a key batch: (n,) u32 words or (n, 2) planes."""
    return (1, "") if keys.ndim == 1 else (2, "64")


def single_cases(torch, check, phase, key_words):
    """Phases 2 and 8: the single-value kernels vs plain at N_CHECK keys."""
    from repro_torch.kernels.cops import contract
    what = "kernel" if key_words == 1 else "64-bit kernel"
    for window, scheme in SINGLE_CASES:
        t0 = time.perf_counter()
        checks = contract.run_case(N_CHECK, window=window, scheme=scheme,
                                   device="cuda", rho=RHO,
                                   key_words=key_words)
        torch.cuda.synchronize()
        bad = [k for k, ok in checks.items() if not check(
            f"phase{phase} W={window} {scheme} {k}", ok)]
        print(f"phase {phase} {what} vs plain W={window} {scheme} "
              f"n={N_CHECK} rho={RHO}"
              f"{' (a quarter of the keys share 2^10 plane-0 words)' if key_words == 2 else ''}"
              f": {'ok' if not bad else 'FAILED ' + str(bad)} "
              f"({len(checks)} checks, {time.perf_counter() - t0:.1f} s)",
              flush=True)


def multi_cases(torch, check, phase, cases, key_words):
    """Phases 5 and 8: the multi-value kernels vs plain at N_CHECK pairs,
    then the near-full cases and the retrieve's long and cut walks."""
    from repro_torch.kernels.cops import contract
    what = "kernel" if key_words == 1 else "64-bit kernel"
    for name, window, scheme, r, max_probes, layout in cases:
        t0 = time.perf_counter()
        checks = contract.run_multi_case(N_CHECK, window=window,
                                         scheme=scheme, device="cuda", r=r,
                                         max_probes=max_probes,
                                         key_words=key_words, layout=layout)
        torch.cuda.synchronize()
        tag = f"phase{phase} {name} r={r} {layout}"
        bad = [k for k, ok in checks.items() if not check(f"{tag} {k}", ok)]
        print(f"phase {phase} multi-value {what} vs plain {name} W={window} "
              f"{scheme} r={r} {layout} n={N_CHECK} load={contract.LOAD}: "
              f"{'ok' if not bad else 'FAILED ' + str(bad)} "
              f"({len(checks)} checks, {time.perf_counter() - t0:.1f} s)",
              flush=True)
    for window, scheme in FULL_CASES:
        t0 = time.perf_counter()
        checks = contract.run_full_case(N_CHECK, window=window,
                                        scheme=scheme, device="cuda",
                                        key_words=key_words)
        torch.cuda.synchronize()
        tag = f"phase{phase} near-full W={window} {scheme}"
        bad = [k for k, ok in checks.items() if not check(f"{tag} {k}", ok)]
        print(f"phase {phase} append {what} vs plain, runs going FULL "
              f"partway: W={window} {scheme} capacity ~{N_CHECK} budget "
              f"{contract.FULL_PROBES}: "
              f"{'ok' if not bad else 'FAILED ' + str(bad)} "
              f"({len(checks)} checks, {time.perf_counter() - t0:.1f} s)",
              flush=True)
    for window, scheme in RETRIEVE_CASES:
        t0 = time.perf_counter()
        checks = contract.run_retrieve_case(window=window, scheme=scheme,
                                            device="cuda",
                                            key_words=key_words,
                                            capacity=RETRIEVE_CAPACITY)
        torch.cuda.synchronize()
        tag = f"phase{phase} retrieve walks W={window} {scheme}"
        bad = [k for k, ok in checks.items() if not check(f"{tag} {k}", ok)]
        print(f"phase {phase} retrieve {what} vs plain, long and cut walks "
              f"(runs of {'/'.join(map(str, contract.RETRIEVE_RUNS))}, "
              f"TOMBSTONE-only windows, budgets 1 / 2 / table / num_rows + 3"
              f", masked groups of 8): W={window} {scheme} capacity "
              f"~{RETRIEVE_CAPACITY}: "
              f"{'ok' if not bad else 'FAILED ' + str(bad)} "
              f"({len(checks)} checks, {time.perf_counter() - t0:.1f} s)",
              flush=True)


def single_value_path(torch, card, check, phase, keys, vals, absent):
    """Phases 3 and 9: the single-value main path through the public entry
    points — insert, upsert, retrieve, absent retrieve, erase and re-insert
    of ``keys`` into ``create(n / 0.9)``, every result checked, insert and
    retrieve timed.  The launch counters are zeroed just before and read
    just after.  Returns ``(launches, walk parameters, fresh)``."""
    from repro_torch.core import bulk, single_value as sv
    from repro_torch.core.common import STATUS_INSERTED, STATUS_UPDATED
    from repro_torch.kernels.cops import contract, ops
    key_words, suffix = width(keys)
    tag = "" if key_words == 1 else "u64 "
    since = len(check.failed)
    note = ""
    if key_words == 2:
        p0 = torch.sort(keys[:, 0]).values
        same = p0[1:] == p0[:-1]
        dup = torch.zeros(p0.shape, dtype=torch.bool, device=keys.device)
        dup[1:] |= same
        dup[:-1] |= same
        shared = int(dup.sum())
        note = (f"; {shared} keys ({shared / N_MAIN:.2%}) share their "
                f"plane-0 word with another key")
        del p0, same, dup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    def fresh():
        return (sv.create(int(N_MAIN / RHO), window=WINDOW, device="cuda",
                          key_words=key_words),)

    ins_t, (table, st) = timed(torch, lambda t: sv.insert(t, keys, vals),
                               fresh)
    print(f"phase {phase} table: p={table.num_rows} W={WINDOW} capacity="
          f"{table.capacity} ({table.capacity * 4 * (key_words + 1) / 1e9:.2f}"
          f" GB){note}", flush=True)
    check(f"{tag}insert all INSERTED", bool((st == STATUS_INSERTED).all()))
    check(f"{tag}insert count == n", table.count == N_MAIN)
    vals2 = contract.values_for(keys, 2)
    table, st = sv.insert(table, keys, vals2)
    check(f"{tag}upsert all UPDATED", bool((st == STATUS_UPDATED).all()))
    check(f"{tag}upsert count unchanged", table.count == N_MAIN)
    ret_t, (got, found) = timed(torch, lambda: sv.retrieve(table, keys))
    check(f"{tag}retrieve all found", bool(found.all()))
    check(f"{tag}retrieve values", bool(torch.equal(got, vals2)))
    del got, found, vals2
    got, found = sv.retrieve(table, absent)
    check(f"{tag}absent none found", not bool(found.any()))
    check(f"{tag}absent values 0", not bool(got.any()))
    if key_words == 2:
        twins = keys[:N_SIDE] ^ torch.tensor([0, 1], dtype=torch.int32,
                                              device=keys.device)
        check("u64 high-word twins not contained",
              not bool(sv.contains(table, twins).any()))
        del twins
    gone = keys[:N_SIDE]
    table, erased = sv.erase(table, gone)
    check(f"{tag}erase all erased", bool(erased.all()))
    check(f"{tag}erase count", table.count == N_MAIN - N_SIDE)
    check(f"{tag}erased not contained",
          not bool(sv.contains(table, gone).any()))
    check(f"{tag}others contained",
          bool(sv.contains(table, keys[N_SIDE:2 * N_SIDE]).all()))
    vals3 = contract.values_for(gone, 3)
    table, st = sv.insert(table, gone, vals3)
    check(f"{tag}re-insert all INSERTED", bool((st == STATUS_INSERTED).all()))
    check(f"{tag}re-insert count", table.count == N_MAIN)
    got, found = sv.retrieve(table, gone)
    check(f"{tag}re-inserted values",
          bool(found.all() and torch.equal(got, vals3)))
    torch.cuda.synchronize()
    launches = path_counts(ops)
    for name in ("cops_insert", "cops_lookup"):
        check(f"{name}{suffix} launched on the {tag}main path",
              launches[name + suffix] > 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase {phase} {tag}main path n={N_MAIN} rho={RHO} W={WINDOW} "
          f"cops: {check.status(since)}; "
          f"insert {spread(ins_t)} = "
          f"{N_MAIN / statistics.median(ins_t) / 1e6:.3f} G ops/s, "
          f"retrieve {spread(ret_t)} = "
          f"{N_MAIN / statistics.median(ret_t) / 1e6:.3f} G ops/s "
          f"(5 runs each, CUDA events, end to end through sv.insert / "
          f"sv.retrieve); peak {peak:.1f} GB; launches {launches}; "
          f"card {card}", flush=True)
    kw = dict(seed=table.seed, scheme=table.scheme,
              max_probes=bulk._tstatic(table)[3])
    return launches, kw, fresh


def single_value_kernels(torch, card, check, phase, keys, vals, absent, kw,
                         fresh, launches):
    """Phases 4 and 11: the insert and lookup kernels (u32 or two-plane)
    and their plain versions on the main path's inputs, compared and
    timed, with their byte bounds; the insert both as the build and as
    the upsert of every key into the table it built; the lookup of every
    key and of the ``absent`` keys, each bit-exact (values, found, slots).
    The launches of a build, an upsert and both lookups are named with
    their times by ``torch.profiler`` in a child process (for two-plane
    keys the upsert's match pass and claim pass).  Returns the insert's
    and the lookup's kernel records."""
    from repro_torch.core.common import STATUS_UPDATED
    from repro_torch.kernels.cops import contract, ops
    key_words, suffix = width(keys)
    insert = getattr(ops, "insert" + suffix)
    lookup = getattr(ops, "lookup" + suffix)
    since = len(check.failed)

    def planes(t):
        return contract.table_planes(t)

    ins_t, (built_k, kst) = timed(torch, lambda t: (t, insert(
        *planes(t), keys, vals, count=0, **kw)), fresh)
    ins_p_t, (built_p, pst) = timed(torch, lambda t: (t, ops.insert_plain(
        *planes(t), keys, vals, count=0, **kw)), fresh, reps=1, warmup=0)
    for part, ok in contract.check_insert(planes(built_k), planes(built_p),
                                          kst, pst, **kw).items():
        check(f"phase{phase} insert{suffix} {part}", ok)
    # the upsert of every key: each walk ends at its match (two-plane
    # keys: pass 1 finds them all, pass 2 claims nothing)
    vals2 = contract.values_for(keys, 2)
    ups_t, ust = timed(torch, lambda: insert(
        *planes(built_k), keys, vals2, count=N_MAIN, **kw))
    ups_p_t, upst = timed(torch, lambda: ops.insert_plain(
        *planes(built_p), keys, vals2, count=N_MAIN, **kw), reps=1,
        warmup=0)
    check(f"phase{phase} insert{suffix} upsert all UPDATED",
          bool((ust == STATUS_UPDATED).all()))
    for part, ok in contract.check_insert(
            planes(built_k), planes(built_p), ust, upst, **kw).items():
        check(f"phase{phase} insert{suffix} upsert {part}", ok)
    split = upsert_launches(key_words)
    del vals2, ust, upst
    _, pv, _ = contract.live_map(*planes(built_p))
    _, kv, _ = contract.live_map(*planes(built_k))
    ins_err = (int((kv - pv).abs().max()) if kv.shape == pv.shape
               else float("inf"))
    del built_p, pst, pv, kv, kst
    look_t, kout = timed(torch, lambda: lookup(*planes(built_k), keys, **kw))
    look_p_t, pout = timed(torch, lambda: ops.lookup_plain(
        *planes(built_k), keys, slots=True, **kw), reps=1, warmup=0)
    look_err = int((kout[0].long() - pout[0].long()).abs().max())
    kslot = lookup(*planes(built_k), keys, slots=True, **kw)[2]
    check(f"phase{phase} lookup{suffix} bit-exact",
          torch.equal(kout[0], pout[0]) and torch.equal(kout[1], pout[1])
          and torch.equal(kslot, pout[2]))
    del kout, pout, kslot
    # the absent keys: each walk ends after its first window holding an
    # EMPTY
    abs_t, kout = timed(torch, lambda: lookup(*planes(built_k), absent, **kw))
    abs_p_t, pout = timed(torch, lambda: ops.lookup_plain(
        *planes(built_k), absent, slots=True, **kw), reps=1, warmup=0)
    kslot = lookup(*planes(built_k), absent, slots=True, **kw)[2]
    check(f"phase{phase} absent lookup{suffix} bit-exact",
          torch.equal(kout[0], pout[0]) and torch.equal(kout[1], pout[1])
          and torch.equal(kslot, pout[2]))
    check(f"phase{phase} absent lookup{suffix} none found",
          not bool(kout[1].any()))
    del kout, pout, kslot
    windows, p1 = walk_windows(torch, planes(built_k)[0], keys, kw["seed"],
                               kw["scheme"], kw["max_probes"])
    abs_windows, abs_p1 = walk_windows(torch, planes(built_k)[0], absent,
                                       kw["seed"], kw["scheme"],
                                       kw["max_probes"])
    del built_k
    # each walk's windows (128-byte lines of plane 0) + the plane-1 sectors
    # it reads + the value's 32-byte sector; a claim also writes its slot's
    # plane-1 sector (two-plane build); + the streams: insert reads the key
    # (4 B per word) and value and writes the status, lookup reads the key
    # and writes the value and found
    win_bytes = 4 * WINDOW
    ins_bytes = (windows * win_bytes
                 + N_MAIN * (32 * key_words + 4 * key_words + 8))
    look_bytes = (windows * win_bytes + p1 * 32
                  + N_MAIN * (32 + 4 * key_words + 5))
    # an absent key reads no value sector
    n_abs = absent.shape[0]
    abs_bytes = (abs_windows * win_bytes + abs_p1 * 32
                 + n_abs * (4 * key_words + 5))
    # the upsert: the walks to each match + the value's written sector +
    # the streams (key, value, status)
    ups_bytes = (windows * win_bytes + p1 * 32
                 + N_MAIN * (32 + 4 * key_words + 8))
    print(f"phase {phase} {'64-bit single-value ' if key_words == 2 else ''}"
          f"kernels at n={N_MAIN}: {check.status(since)}; mean windows per "
          f"walk {windows / N_MAIN:.4f}"
          f"{f', plane-1 sectors per walk {p1 / N_MAIN:.4f}' if key_words == 2 else ''}"
          f"; cops_insert{suffix} {spread(ins_t)}, plain {ins_p_t[0]:.3f} ms,"
          f" bound {ins_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; upsert "
          f"{spread(ups_t)}, plain {ups_p_t[0]:.3f} ms, bound "
          f"{ups_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; the kernels of one "
          f"{split}; cops_lookup{suffix} {spread(look_t)}, plain "
          f"{look_p_t[0]:.3f} ms, bound "
          f"{look_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; of {n_abs} absent "
          f"keys (windows per walk {abs_windows / n_abs:.4f}"
          f"{f', plane-1 sectors per walk {abs_p1 / n_abs:.4f}' if key_words == 2 else ''}"
          f") {spread(abs_t)}, plain {abs_p_t[0]:.3f} ms, bound "
          f"{abs_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; card {card}",
          flush=True)
    return [kernel_record("cops_insert" + suffix, launches, ins_err, ins_t,
                          ins_p_t, ins_bytes, elements=N_MAIN),
            kernel_record("cops_lookup" + suffix, launches, look_err, look_t,
                          look_p_t, look_bytes, elements=N_MAIN)]


def multi_value_path(torch, card, check, phase, base, absent):
    """Phases 6 and 10: Fig. 7's wc-oa cell at r = 8 through the public
    entry points — the distinct ``base`` keys, R_MV in a row, values
    0 .. n-1, into ``multi_value.create(n / 0.8)``: insert, count_values,
    retrieve_all (present, absent and duplicate queries), erase and
    re-insert, every result checked; insert, count and retrieve_all timed,
    retrieve_all split into dedup, walk kernel and compaction.  The launch
    counters are zeroed just before and read just after.  Returns
    ``(launches, walk parameters, fresh, keys, values)``."""
    from repro_torch.core import bulk, bulk_retrieve, multi_value as mv
    from repro_torch.core.common import STATUS_INSERTED
    from repro_torch.kernels.cops import contract, ops
    key_words, suffix = width(base)
    tag = "mv " if key_words == 1 else "u64 mv "
    n_keys = base.shape[0]
    keys = base.repeat_interleave(R_MV, dim=0)
    vals = torch.arange(N_MV, dtype=torch.int32, device="cuda")
    want = vals.view(n_keys, R_MV)           # key i holds 8i .. 8i+7
    side = N_MV_SIDE
    since = len(check.failed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    def fresh():
        return (mv.create(int(N_MV / contract.LOAD), window=WINDOW,
                          device="cuda", key_words=key_words),)

    def sorted_segments(values, n):
        return values[:n * R_MV].view(n, R_MV).sort(dim=1).values

    ins_t, (mtab, st) = timed(torch, lambda t: mv.insert(t, keys, vals),
                              fresh)
    print(f"phase {phase} table: p={mtab.num_rows} W={WINDOW} capacity="
          f"{mtab.capacity} ({mtab.capacity * 4 * (key_words + 1) / 1e9:.2f}"
          f" GB store, {mtab.capacity * 8 / 1e9:.2f} GB of collect arenas)",
          flush=True)
    check(f"{tag}insert all INSERTED", bool((st == STATUS_INSERTED).all()))
    check(f"{tag}insert count == n", mtab.count == N_MV)
    del st
    cnt_t, cnt = timed(torch, lambda: mv.count_values(mtab, base))
    check(f"{tag}count_values all r", bool((cnt == R_MV).all()))
    ret_t, (got, offs, cnt) = timed(
        torch, lambda: mv.retrieve_all(mtab, base, N_MV))
    check(f"{tag}retrieve_all counts", bool((cnt == R_MV).all()))
    check(f"{tag}retrieve_all offsets", torch.equal(
        offs.long(), torch.arange(n_keys + 1, device="cuda") * R_MV))
    check(f"{tag}retrieve_all segments",
          torch.equal(sorted_segments(got, n_keys), want))
    del got, offs, cnt
    got, offs, cnt = mv.retrieve_all(mtab, absent, absent.shape[0])
    check(f"{tag}absent counts 0", not bool(cnt.any()))
    check(f"{tag}absent output zeros",
          not bool(got.any()) and not bool(offs.any()))
    q = base[:side]
    got, offs, cnt = mv.retrieve_all(mtab, torch.cat([q, q]),
                                     2 * side * R_MV)
    check(f"{tag}duplicate queries counts", bool((cnt == R_MV).all()))
    check(f"{tag}duplicate queries equal halves",
          torch.equal(got[:side * R_MV], got[side * R_MV:]))
    mtab, erased = mv.erase(mtab, q)
    check(f"{tag}erase counts", bool((erased == R_MV).all()))
    check(f"{tag}erase count", mtab.count == N_MV - side * R_MV)
    check(f"{tag}erased count 0", not bool(mv.count_values(mtab, q).any()))
    check(f"{tag}others count r", bool(
        (mv.count_values(mtab, base[side:2 * side]) == R_MV).all()))
    mtab, st = mv.insert(mtab, keys[:side * R_MV], vals[:side * R_MV])
    check(f"{tag}re-insert all INSERTED", bool((st == STATUS_INSERTED).all()))
    check(f"{tag}re-insert count", mtab.count == N_MV)
    got, offs, cnt = mv.retrieve_all(mtab, q, side * R_MV)
    check(f"{tag}re-inserted segments", bool((cnt == R_MV).all()) and
          torch.equal(sorted_segments(got, side), want[:side]))
    del got, offs, cnt, erased, st
    torch.cuda.synchronize()
    launches = path_counts(ops)
    for name in ("cops_append", "cops_retrieve"):
        check(f"{name}{suffix} launched on the {tag}path",
              launches[name + suffix] > 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the split of retrieve_all, by difference (outside the counted run)
    every = torch.ones((n_keys,), dtype=torch.bool, device="cuda")
    kw = dict(seed=mtab.seed, scheme=mtab.scheme,
              max_probes=bulk._tstatic(mtab)[3])
    walk = getattr(ops, "retrieve_walk" + suffix)
    key_planes = contract.table_planes(mtab)[0]
    dedup_t, _ = timed(torch, lambda: bulk_retrieve.group_queries(base,
                                                                  every))
    walk_t, _ = timed(torch, lambda: walk(key_planes, base, every,
                                          collect=True, **kw))
    ret_ms, dedup_ms, walk_ms = (statistics.median(ret_t),
                                 statistics.median(dedup_t),
                                 statistics.median(walk_t))
    print(f"phase {phase} {'u64 ' if key_words == 2 else ''}multi-value main "
          f"path n={N_MV} r={R_MV} load={contract.LOAD} W={WINDOW} cops: "
          f"{check.status(since)}; insert {spread(ins_t)} = "
          f"{N_MV / statistics.median(ins_t) / 1e6:.3f} G pairs/s, "
          f"count_values {spread(cnt_t)} = "
          f"{N_MV / statistics.median(cnt_t) / 1e6:.3f} G values/s, "
          f"retrieve_all {spread(ret_t)} = {N_MV / ret_ms / 1e6:.3f} G "
          f"values/s (5 runs each, CUDA events, through mv.insert / "
          f"mv.count_values / mv.retrieve_all); retrieve_all split: dedup "
          f"{dedup_ms:.3f} ms, walk kernel (arena fill included) "
          f"{walk_ms:.3f} ms, compaction {ret_ms - dedup_ms - walk_ms:.3f} "
          f"ms (by difference); peak {peak:.1f} GB; launches {launches}; "
          f"card {card}", flush=True)
    return launches, kw, fresh, keys, vals


def multi_value_kernels(torch, card, check, phase, base, keys, vals, kw,
                        fresh, launches):
    """Phases 7 and 11: the append and retrieve-walk kernels (u32 or
    two-plane) and their plain versions at the multi-value main path's
    shapes, compared and timed, with their byte bounds; also the append of
    N_MV pairs of N_MV distinct keys (r = 1), of N_MV / R_WIDE keys R_WIDE
    times in a row, and of the main path's pairs shuffled.  Returns their
    two kernel records.  The launches of one collecting and one counting
    retrieve are named with their times by ``torch.profiler`` in a child
    process."""
    from repro_torch.core.common import EMPTY_WORD, STATUS_INSERTED
    from repro_torch.kernels.cops import contract, ops
    key_words, suffix = width(base)
    append = getattr(ops, "append" + suffix)
    walk = getattr(ops, "retrieve_walk" + suffix)
    n_keys = base.shape[0]
    since = len(check.failed)
    win_bytes = 4 * WINDOW

    def planes(t):
        return contract.table_planes(t)

    def append_bytes(table_keys, landed, pairs):
        """What an append into an empty store, now ``table_keys``, must
        move: per distinct key the windows up to the last one its pairs
        landed in (``landed``, summed), each 128-byte line read once however
        many of the key's pairs walk it; each 32-byte sector of each key
        plane and of the values that holds a pair written once; the key,
        value and status streams."""
        plane0 = ops._planes(table_keys)[0]
        sectors = int((plane0.reshape(-1, 8) != EMPTY_WORD).any(1).sum())
        return (landed * win_bytes + 32 * (key_words + 1) * sectors
                + pairs * (4 * key_words + 8))

    def variant(label, vkeys, vvals, distinct=None):
        """The append of (vkeys, vvals) into a fresh table, timed, with its
        byte bound from the walks of its ``distinct`` keys (default: the
        batch's own) on the store it built; all INSERTED and its live pairs
        the batch's.  Returns (the phase line's timing, its windows per
        key)."""
        distinct = vkeys if distinct is None else distinct
        times, (tab, st) = timed(torch, lambda t: (t, append(
            *planes(t), vkeys, vvals, **kw)), fresh)
        check(f"phase{phase} append{suffix} {label} all INSERTED",
              bool((st == STATUS_INSERTED).all()))
        check(f"phase{phase} append{suffix} {label} live pairs == batch",
              pair_err(contract.live_pairs(*planes(tab)),
                       contract.pairs_of(vkeys, vvals)) == 0)
        _, landed_v, _ = multi_walk_windows(torch, planes(tab)[0], distinct,
                                            kw["seed"], kw["scheme"],
                                            kw["max_probes"])
        vbytes = append_bytes(planes(tab)[0], landed_v, vkeys.shape[0])
        return (f", {label} {spread(times)}, bound "
                f"{vbytes / HBM_BYTES_PER_S * 1e3:.3f} ms",
                f", {label} {landed_v / distinct.shape[0]:.4f}")

    # the same append with N_MV distinct keys (r = 1): what the r = 8
    # duplicates cost; with fewer, longer runs (r = 32); and with the
    # duplicates scattered over the batch (shuffled: no runs to walk once)
    r1, r1_windows = variant(
        "r=1 (distinct keys)",
        contract.distinct_keys(0, N_MV, "cuda") if key_words == 1
        else contract.distinct_keys64(0, N_MV, "cuda"), vals)
    wide = base[:N_MV // R_WIDE]
    r32, r32_windows = variant(f"r={R_WIDE}",
                               wide.repeat_interleave(R_WIDE, dim=0), vals,
                               wide)
    gen = torch.Generator(device="cuda").manual_seed(SHUFFLE_SEED)
    perm = torch.randperm(N_MV, generator=gen, device="cuda")
    shuf, shuf_windows = variant(f"shuffled r={R_MV}", keys[perm], vals[perm],
                                 base)
    del perm, wide
    app_t, (mk_t, kst) = timed(torch, lambda t: (t, append(
        *planes(t), keys, vals, **kw)), fresh)
    app_p_t, (mp_t, pst) = timed(torch, lambda t: (t, ops.append_plain(
        *planes(t), keys, vals, **kw)), fresh, reps=1, warmup=0)
    for part, ok in contract.check_append(planes(mk_t), planes(mp_t), keys,
                                          kst, pst, **kw).items():
        check(f"phase{phase} append{suffix} {part}", ok)
    app_err = pair_err(contract.live_pairs(*planes(mk_t)),
                       contract.live_pairs(*planes(mp_t)))
    del mp_t, pst, kst
    mkp = planes(mk_t)[0]
    every = torch.ones((n_keys,), dtype=torch.bool, device="cuda")
    cnt_t, _ = timed(torch, lambda: walk(mkp, base, every, collect=False,
                                         **kw))
    rw_t, kout = timed(torch, lambda: walk(mkp, base, every, collect=True,
                                           **kw))
    rw_p_t, pout = timed(torch, lambda: ops.retrieve_walk_plain(
        mkp, base, every, collect=True, **kw), reps=1, warmup=0)
    rw_err = max(int((a.long() - b.long()).abs().max())
                 for a, b in zip(kout, pout))
    check(f"phase{phase} retrieve{suffix} bit-exact",
          all(torch.equal(a, b) for a, b in zip(kout, pout)))
    del kout, pout
    walked, landed, p1 = multi_walk_windows(torch, mkp, base, kw["seed"],
                                            kw["scheme"], kw["max_probes"])
    app_bytes = append_bytes(mkp, landed, N_MV)
    # retrieve: each query's windows up to its first EMPTY one + its plane-1
    # sectors + the key, active and count streams, + with collect both
    # (p * W,) int32 arenas written once in full (the wrapper's fill, the
    # kernel's stamps)
    cnt_bytes = walked * win_bytes + p1 * 32 + n_keys * (4 * key_words + 5)
    rw_bytes = cnt_bytes + ops._planes(mkp)[0].numel() * 8
    del mk_t, mkp
    named = upsert_launches(key_words, "retrieve")
    print(f"phase {phase} {'64-bit ' if key_words == 2 else ''}multi-value "
          f"kernels at n={N_MV} pairs, {n_keys} queries: "
          f"{check.status(since)}; append windows per key "
          f"{landed / n_keys:.4f} ({r1_windows[2:]}{r32_windows}"
          f"{shuf_windows}), "
          f"walk windows per query {walked / n_keys:.4f}"
          f"{f', plane-1 sectors per query {p1 / n_keys:.4f}' if key_words == 2 else ''}"
          f"; cops_append{suffix} {spread(app_t)}, plain {app_p_t[0]:.3f} "
          f"ms, bound {app_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms{r1}{r32}"
          f"{shuf}; "
          f"cops_retrieve{suffix} collect {spread(rw_t)}, plain "
          f"{rw_p_t[0]:.3f} ms, bound {rw_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms; counts only {spread(cnt_t)}, bound "
          f"{cnt_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; the kernels of one "
          f"{named}; card {card}",
          flush=True)
    return [kernel_record("cops_append" + suffix, launches, app_err, app_t,
                          app_p_t, app_bytes, elements=N_MV),
            kernel_record("cops_retrieve" + suffix, launches, rw_err, rw_t,
                          rw_p_t, rw_bytes, elements=n_keys)]


def bucket_cases(torch, check, phase):
    """Phase 12: ``cops_bucket_walk`` vs plain at N_CHECK pairs on the
    wc-bl cells of Fig. 7, and on scattered chains of many insert batches
    (``contract.run_chain_case``) at growth 1.1 (s0 1) and 2 (s0 4)."""
    from repro_torch.kernels.cops import contract, ops
    for growth, s0 in ((1.1, 1), (2.0, 4)):
        t0 = time.perf_counter()
        checks = contract.run_chain_case(growth=growth, s0=s0, device="cuda",
                                         warp_keys=ops.bucket_keys())
        torch.cuda.synchronize()
        bad = [k for k, ok in checks.items()
               if not check(f"phase{phase} chains growth {growth} {k}", ok)]
        print(f"phase {phase} bucket walk vs plain on scattered chains "
              f"(growth {growth}, s0 {s0}, {contract.CHAIN_ROUNDS} insert "
              f"batches, K = {ops.bucket_keys()} chains a warp): "
              f"{'ok' if not bad else 'FAILED ' + str(bad)} "
              f"({len(checks)} checks, {time.perf_counter() - t0:.1f} s)",
              flush=True)
    for name, growth, s0, r in BL_CASES:
        t0 = time.perf_counter()
        checks = contract.run_bucket_case(N_CHECK, r=r, growth=growth, s0=s0,
                                          device="cuda")
        torch.cuda.synchronize()
        bad = [k for k, ok in checks.items()
               if not check(f"phase{phase} {name} r={r} {k}", ok)]
        print(f"phase {phase} bucket walk vs plain {name} (growth {growth}, "
              f"s0 {s0}) r={r} n={N_CHECK}: "
              f"{'ok' if not bad else 'FAILED ' + str(bad)} "
              f"({len(checks)} checks, {time.perf_counter() - t0:.1f} s)",
              flush=True)


def random_bases(torch, gen, shape, n_rate):
    """uint8 base codes on the card, with N (code 4) at ``n_rate``."""
    bases = torch.randint(0, 4, shape, dtype=torch.uint8, device="cuda",
                          generator=gen)
    n = torch.rand(shape, device="cuda", generator=gen) < n_rate
    return torch.where(n, 4, bases).to(torch.uint8)


def kmer_cases(torch, check, phase):
    """Phase 12: ``kmer_hash`` vs plain on N_KMER_CHECK bases with 0.1% N,
    as one row and as 150-base reads, for every k of KMER_KS."""
    from repro_torch.kernels.minhash import ops as mh
    from repro_torch.kernels.minhash import ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    row = random_bases(torch, gen, (1, N_KMER_CHECK), 0.001)
    reads = row[0, :N_KMER_CHECK // READ_LEN * READ_LEN].view(-1, READ_LEN)
    t0 = time.perf_counter()
    bad = []
    for k in KMER_KS:
        for label, bases in (("row", row), ("reads", reads)):
            ok = torch.equal(mh.kmer_hash(bases, k), ref.kmer_hashes(bases, k))
            if not check(f"phase{phase} kmer k={k} {label} exact", ok):
                bad.append(f"k={k} {label}")
    torch.cuda.synchronize()
    print(f"phase {phase} kmer_hash vs plain on {N_KMER_CHECK} bases (0.1% N;"
          f" one row and {reads.shape[0]} reads of {READ_LEN}) k={KMER_KS}: "
          f"{'ok' if not bad else 'FAILED ' + str(bad)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def pair_reference(torch, keys, vals, queries):
    """What ``retrieve_all(queries)`` must give for a table built from the
    pairs (``keys``, ``vals``) in this order, without a table: each
    query's values in insertion order, read off a stable sort of the
    pairs by key.  Returns ``(values, offsets, counts)``."""
    sk, order = torch.sort(keys, stable=True)
    sv = vals[order]
    del order
    lo = torch.searchsorted(sk, queries)
    counts = torch.searchsorted(sk, queries, right=True) - lo
    del sk
    offsets = torch.zeros(queries.shape[0] + 1, dtype=torch.int64,
                          device=queries.device)
    offsets[1:] = torch.cumsum(counts, 0)
    seg = torch.repeat_interleave(
        torch.arange(queries.shape[0], device=queries.device), counts)
    pos = lo[seg] + torch.arange(seg.shape[0], device=seg.device) - offsets[seg]
    return sv[pos], offsets.to(torch.int32), counts.to(torch.int32)


def check_retrieval(torch, check, tag, got, want):
    """``retrieve_all``'s (values, offsets, counts) exactly as ``want``."""
    values, offsets, counts = got
    m = want[0].shape[0]
    check(f"{tag} counts", torch.equal(counts, want[2]))
    check(f"{tag} offsets", torch.equal(offsets, want[1]))
    check(f"{tag} segments in insertion order",
          values.shape[0] >= m and torch.equal(values[:m], want[0]))


def chain_bytes(torch, pool, found, ptr, rcnt, bidx, schedule):
    """(links followed, 32-byte arena sectors stamped) by the chain walks
    of the ``found`` queries: each bucket run of ``valid`` 4-byte slots
    from ``start`` touches its sectors of both arenas once."""
    sizes, cum = (x.long() for x in schedule)
    q = torch.nonzero(found).squeeze(1)
    j, p, c = bidx[q].long(), ptr[q].long() & 0xFFFFFFFF, rcnt[q].long()
    links = sectors = 0
    while q.numel():
        link = j > 0
        valid = torch.minimum(c - cum[j], sizes[j])
        start = p + link
        run = valid > 0
        sectors += 2 * int(((start + valid - 1) // 8 - start // 8 + 1)[run]
                           .sum())
        links += int(link.sum())
        q, j, c = q[link], j[link] - 1, c[link]
        p = pool[p[link]].long() & 0xFFFFFFFF
    return links, sectors


def bucket_list_path(torch, card, check, phase, base, absent):
    """Phase 13: Fig. 7's wc-bl-1 cell at r = 8 through the public entry
    points — the distinct ``base`` keys, R_MV in a row, values 0 .. n-1,
    into ``bucket_list.create(n_keys / 0.8, 2n + 64)``, s0 = 1, growth
    1.1, W = 32, cops: insert, count_values and retrieve_all (present and
    absent keys), each checked exactly against ``pair_reference``, and
    timed.  The counters are zeroed just before and read just after.
    Returns ``(launches, table)``."""
    from repro_torch.core import bucket_list as bl
    from repro_torch.core import bulk
    from repro_torch.core.common import STATUS_INSERTED, as_u32, table_geometry
    from repro_torch.kernels.cops import contract, ops
    n_keys = base.shape[0]
    keys = base.repeat_interleave(R_MV)
    vals = torch.arange(N_BL, dtype=torch.int32, device="cuda")
    since = len(check.failed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    def fresh():
        return (bl.create(int(n_keys / contract.LOAD), 2 * N_BL + 64, s0=1,
                          growth=1.1, window=WINDOW, device="cuda"),)

    ins_t, (table, st) = timed(torch, lambda t: bl.insert(t, keys, vals),
                               fresh)
    insert_peak = torch.cuda.max_memory_allocated() / 1e9
    check("bl insert all INSERTED", bool((st == STATUS_INSERTED).all()))
    check("bl key count", table.num_keys() == n_keys)
    del st
    cnt_t, cnt = timed(torch, lambda: bl.count_values(table, base))
    ret_t, got = timed(torch, lambda: bl.retrieve_all(table, base, N_BL))
    want = pair_reference(torch, keys, vals, base)
    check("bl count_values exact", torch.equal(cnt, want[2]))
    check_retrieval(torch, check, "bl retrieve_all", got, want)
    check("bl every key holds r values", bool((want[2] == R_MV).all()))
    del got, want, cnt
    got = bl.retrieve_all(table, absent, absent.shape[0])
    check("bl absent counts 0", not bool(got[2].any()))
    check("bl absent output zeros",
          not bool(got[0].any()) and not bool(got[1].any()))
    check("bl absent count_values 0",
          not bool(bl.count_values(table, absent).any()))
    del got
    torch.cuda.synchronize()
    launches = path_counts(ops)
    for name in ("cops_lookup", "cops_bucket_walk"):
        check(f"{name} launched on the bucket-list path", launches[name] > 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    density = table.storage_density()
    oa_rows, oa_cap = table_geometry(int(N_MV / contract.LOAD), WINDOW)
    # the split of the insert, by difference (outside the counted run):
    # the stable sort of the batch alone, and the claim placement of the
    # n_keys new keys (priority: each key's first batch position) alone
    sort_t, _ = timed(torch, lambda: bulk._sort_batch(keys, None, [vals]))
    empty = fresh()[0].key_store
    words = as_u32(base)
    every = torch.ones((n_keys,), dtype=torch.bool, device="cuda")
    prio = torch.arange(0, N_BL, R_MV, device="cuda")
    claim_t, _ = timed(torch, lambda: bulk.place_claims(
        bulk._tstatic(empty), empty.store, words, every, prio=prio))
    del empty, words, every, prio
    ins_ms = statistics.median(ins_t)
    sort_ms, claim_ms = statistics.median(sort_t), statistics.median(claim_t)
    print(f"phase {phase} bucket list (wc-bl-1) n={N_BL} r={R_MV} keys="
          f"{n_keys}: key store p={table.key_store.num_rows} W={WINDOW} "
          f"capacity {table.key_capacity}, pool {table.pool_capacity} slots"
          f" ({(table.key_capacity * 12 + table.pool_capacity * 4) / 1e9:.2f}"
          f" GB), pool used {table.alloc_top}; {check.status(since)}; "
          f"insert {spread(ins_t)} = "
          f"{N_BL / statistics.median(ins_t) / 1e6:.3f} G pairs/s, "
          f"count_values {spread(cnt_t)} = "
          f"{N_BL / statistics.median(cnt_t) / 1e6:.3f} G values/s, "
          f"retrieve_all {spread(ret_t)} = "
          f"{N_BL / statistics.median(ret_t) / 1e6:.3f} G values/s (5 runs "
          f"each, CUDA events, through bl.insert / bl.count_values / "
          f"bl.retrieve_all); insert split: stable sort {sort_ms:.3f} ms, "
          f"claim placement of {n_keys} keys {claim_ms:.3f} ms, the rest "
          f"{ins_ms - sort_ms - claim_ms:.3f} ms (by difference); storage "
          f"density {density:.4f} (wc-oa at load "
          f"{contract.LOAD}, phase 6: {N_MV / oa_cap:.4f}, p={oa_rows}); "
          f"peak {insert_peak:.1f} GB in the insert, {peak:.1f} GB in the "
          f"phase; launches {launches}; card {card}", flush=True)
    return launches, table


def make_reference(torch, gen):
    """The synthetic reference of phase 14: N_ANCESTORS random genomes of
    GENOME_LEN bases, each the ancestor of N_STRAINS strains at 1% point
    substitutions (to another base); (genomes, length) uint8 on the
    card, strains of one ancestor in consecutive rows."""
    anc = torch.randint(0, 4, (N_ANCESTORS, GENOME_LEN), dtype=torch.uint8,
                        device="cuda", generator=gen)
    genomes = anc.repeat_interleave(N_STRAINS, dim=0)
    del anc
    for g in range(genomes.shape[0]):
        sub = torch.rand(GENOME_LEN, device="cuda", generator=gen) < 0.01
        shift = torch.randint(1, 4, (GENOME_LEN,), dtype=torch.uint8,
                              device="cuda", generator=gen)
        genomes[g] = torch.where(sub, (genomes[g] + shift) % 4, genomes[g])
    return genomes


def genome_windows(torch, genome):
    """A genome's sketching windows: WIN_LEN bases at stride WIN_STRIDE,
    so each k-mer lies in one window; the tail padded with the invalid
    code 255.  (windows, WIN_LEN) uint8."""
    kmers = genome.shape[0] - K_MER + 1
    n_win = -(-kmers // WIN_STRIDE)
    pad = (n_win - 1) * WIN_STRIDE + WIN_LEN - genome.shape[0]
    padded = torch.cat([genome, torch.full((pad,), 255, dtype=torch.uint8,
                                           device=genome.device)])
    return padded.unfold(0, WIN_LEN, WIN_STRIDE)


def sketch_keys(torch, sketch):
    """A sketch's valid hashes as bucket-list keys: INVALID dropped, the
    two sentinel words clamped to 0xFFFFFFFD (examples/metagenomics.py)."""
    h = sketch.reshape(-1)
    h = h[h != -1]                      # INVALID = 0xFFFFFFFF
    return torch.where(h == -2, -3, h)  # 0xFFFFFFFE -> 0xFFFFFFFD


def metagenomics_path(torch, card, check, phase):
    """Phase 14: the pipeline of ``examples/metagenomics.py`` and
    ``benchmarks/fig8_metagenomics.py`` at the size of a real reference:
    sketch every genome's windows (``sketch_reads``), insert each
    genome's (hash, genome id) pairs (``bl.insert``), then classify reads
    by k-mer votes (``sketch_reads``, ``count_values``, ``retrieve_all``,
    a bincount), every retrieval exact against ``pair_reference`` and the
    species-level accuracy at least 0.8.  The counters are zeroed just
    before and read just after.  Returns ``(launches, reads, table,
    queries)``: the index and the classify's queries, for phase 15."""
    from repro_torch.core import bucket_list as bl
    from repro_torch.core import bulk
    from repro_torch.core.common import STATUS_INSERTED
    from repro_torch.kernels.cops import ops
    from repro_torch.kernels.minhash import ops as mh
    since = len(check.failed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    t0 = time.perf_counter()
    genomes = make_reference(torch, gen)
    n_gen = genomes.shape[0]
    gid = torch.randint(0, n_gen, (N_READS,), device="cuda", generator=gen)
    pos = torch.randint(0, GENOME_LEN - READ_LEN + 1, (N_READS,),
                        device="cuda", generator=gen)
    reads = genomes[gid[:, None], pos[:, None]
                    + torch.arange(READ_LEN, device="cuda")]
    sub = torch.rand(reads.shape, device="cuda", generator=gen) < 0.01
    shift = torch.randint(1, 4, reads.shape, dtype=torch.uint8, device="cuda",
                          generator=gen)
    reads = torch.where(sub, (reads + shift) % 4, reads)
    nbase = torch.rand(reads.shape, device="cuda", generator=gen) < 0.001
    reads = torch.where(nbase, 4, reads).to(torch.uint8)
    del pos, sub, shift, nbase
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    n_win = genome_windows(torch, genomes[0]).shape[0]
    pairs_est = n_gen * n_win * SKETCH
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    mh.reset_launches()

    # sketch every genome, then build the index genome by genome
    sketches = []

    def sketch_all():
        for g in range(n_gen):
            sketches.append(sketch_keys(torch, mh.sketch_reads(
                genome_windows(torch, genomes[g]), k=K_MER, s=SKETCH,
                device="cuda")))

    sk_t, _ = timed(torch, sketch_all, reps=1, warmup=0)
    table = bl.create(2 * pairs_est, 4 * pairs_est, s0=1, growth=1.1,
                      window=WINDOW, device="cuda")
    statuses_ok = True

    def build():
        nonlocal table, statuses_ok
        for g in range(n_gen):
            table, st = bl.insert(table, sketches[g], torch.full(
                sketches[g].shape, g, dtype=torch.int32, device="cuda"))
            statuses_ok &= bool((st == STATUS_INSERTED).all())

    build_t, _ = timed(torch, build, reps=1, warmup=0)
    pairs = sum(x.shape[0] for x in sketches)
    check("fig8 every pair INSERTED", statuses_ok)
    check("fig8 pool holds every pair", table.alloc_top <= table.pool_capacity)

    def classify():
        sk = mh.sketch_reads(reads, k=K_MER, s=SKETCH, device="cuda")
        valid = sk != -1
        q = sk[valid]
        q = torch.where(q == -2, -3, q)
        read_of = torch.nonzero(valid)[:, 0]
        counts = bl.count_values(table, q)
        got = bl.retrieve_all(table, q, int(counts.sum()))
        hit_read = torch.repeat_interleave(read_of, got[2].long())
        votes = torch.bincount(hit_read * n_gen + got[0][:hit_read.shape[0]],
                               minlength=N_READS * n_gen)
        return q, counts, got, votes.view(N_READS, n_gen).argmax(1)

    cls_t, (q, counts, got, pred) = timed(torch, classify, reps=3)
    torch.cuda.synchronize()
    launches = path_counts(ops, mh)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # what every insert pays whatever its size (outside the counted run): a
    # claim placement of no key still scans the whole key store for free
    # lanes
    ks = table.key_store
    none = torch.zeros((0,), dtype=torch.int64, device="cuda")
    scan_t, _ = timed(torch, lambda: bulk.place_claims(
        bulk._tstatic(ks), ks.store, none, none.bool(), prio=none))
    for name in ("kmer_hash", "cops_lookup", "cops_bucket_walk"):
        check(f"{name} launched on the metagenomics path", launches[name] > 0)
    want = pair_reference(torch, torch.cat(sketches), torch.cat([
        torch.full(x.shape, g, dtype=torch.int32, device="cuda")
        for g, x in enumerate(sketches)]), q)
    check("fig8 count_values exact", torch.equal(counts, want[2]))
    check_retrieval(torch, check, "fig8 retrieve_all", got, want)
    species = float(((pred // N_STRAINS) == (gid // N_STRAINS)).float().mean())
    genome_acc = float((pred == gid).float().mean())
    check("fig8 species-level accuracy >= 0.8", species >= 0.8)
    kmers = n_gen * (GENOME_LEN - K_MER + 1)
    print(f"phase {phase} metagenomics (fig8) reference {n_gen} genomes x "
          f"{GENOME_LEN} bases ({N_ANCESTORS} ancestors x {N_STRAINS} "
          f"strains, 1% substitutions; made in {data_s:.1f} s), k={K_MER}, "
          f"windows {WIN_LEN}/{WIN_STRIDE} ({n_win} per genome), s={SKETCH}: "
          f"{check.status(since)}; sketch {sk_t[0]:.3f} ms = "
          f"{kmers / sk_t[0] / 1e6:.3f} G k-mers hashed/s; build of {pairs} "
          f"pairs ({table.num_keys()} keys, {pairs / table.num_keys():.3f} "
          f"values per key; key capacity {table.key_capacity}, pool "
          f"{table.pool_capacity}, used {table.alloc_top}; storage density "
          f"{table.storage_density():.4f}) {build_t[0]:.3f} ms = "
          f"{pairs / build_t[0] / 1e6:.3f} G pairs indexed/s, "
          f"{build_t[0] / n_gen:.3f} ms per genome's insert, of which the "
          f"free-lane scan of the key store {statistics.median(scan_t):.3f} "
          f"ms (a placement of no key, timed alone); classify "
          f"{N_READS} reads of {READ_LEN} (1% substitutions, 0.1% N; "
          f"{q.shape[0]} queries, {int(counts.sum())} values) "
          f"{spread(cls_t)} = {N_READS / statistics.median(cls_t) * 1e3:.0f}"
          f" reads/s; species-level accuracy {species:.4f}, genome-level "
          f"{genome_acc:.4f}; peak {peak:.1f} GB; launches {launches}; card "
          f"{card}", flush=True)
    return launches, reads, table, q


def new_kernels(torch, card, check, phase, table, base, reads, bl_launches,
                mg_launches, mg_table, mg_queries):
    """Phase 15: ``cops_bucket_walk`` at phase 13's shapes (2^25 queries on
    the wc-bl-1 r = 8 table) and at phase 14's classify (its queries on the
    Fig. 8 index, whose chains are longer and scattered), and ``kmer_hash``
    at phase 14's reads, each alone and its plain version, compared and
    timed, with their bounds.  Returns their two kernel records (the walk's
    at phase 13's shapes)."""
    from repro_torch.core import bucket_list as bl
    from repro_torch.kernels.cops import ops
    from repro_torch.kernels.minhash import ops as mh
    from repro_torch.kernels.minhash import ref
    since = len(check.failed)

    def walk(tbl, queries, tag):
        found, ptr, rcnt, bidx = bl._handle_probe(tbl, queries)[2:6]
        schedule = bl._schedule(tbl)
        args = (tbl.pool, ptr, rcnt, bidx, found, *schedule)
        walk_t, kout = timed(torch, lambda: ops.bucket_walk(*args))
        walk_p_t, pout = timed(torch, lambda: ops.bucket_walk_plain(*args),
                               reps=1, warmup=0)
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(kout, pout))
        check(f"phase{phase} bucket walk exact ({tag})",
              all(torch.equal(a, b) for a, b in zip(kout, pout)))
        del kout, pout
        links, sectors = chain_bytes(torch, tbl.pool, found, ptr, rcnt, bidx,
                                     schedule)
        return walk_t, walk_p_t, err, links, sectors, found, rcnt, bidx

    f8_t, f8_p_t, f8_err, f8_links, _, f8_found, f8_cnt, f8_bidx = walk(
        mg_table, mg_queries, "fig8")
    walk_t, walk_p_t, walk_err, links, sectors, _, rcnt, _ = walk(
        table, base, "wc-bl-1")
    n_q = base.shape[0]
    stamp_bytes = 13 * n_q + 32 * links + 32 * sectors
    walk_bytes = 13 * n_q + 32 * links + 8 * table.pool_capacity
    rows, length = reads.shape
    n_out = length - K_MER + 1
    kmer_t, kout = timed(torch, lambda: mh.kmer_hash(reads, K_MER))
    kmer_p_t, pout = timed(torch, lambda: ref.kmer_hashes(reads, K_MER),
                           reps=1, warmup=0)
    kmer_err = int((kout.long() - pout.long()).abs().max())
    check(f"phase{phase} kmer_hash exact", torch.equal(kout, pout))
    del kout, pout
    kmer_bytes = rows * length + 4 * rows * n_out   # each base, each hash
    kmer_ops = OPS_PER_KMER * rows * n_out
    ms = 1e3 / HBM_BYTES_PER_S
    print(f"phase {phase} new kernels: {check.status(since)}; "
          f"cops_bucket_walk (K = {ops.bucket_keys()} chains a warp) on "
          f"{n_q} queries ({int(rcnt.sum())} values, "
          f"{links} links) {spread(walk_t)}, plain {walk_p_t[0]:.3f} ms, bound"
          f" {walk_bytes * ms:.3f} ms (both (P,) arenas written in full, "
          f"P={table.pool_capacity}; the stamps alone {stamp_bytes * ms:.3f}"
          f" ms); on phase 14's classify queries ({mg_queries.shape[0]}, "
          f"{int(f8_found.sum())} found, {int(f8_cnt[f8_found].sum())} "
          f"values, {f8_links} links, the longest chain "
          f"{int(f8_bidx[f8_found].max()) + 1} buckets; pool "
          f"{mg_table.pool_capacity}) {spread(f8_t)}, plain "
          f"{f8_p_t[0]:.3f} ms; kmer_hash k={K_MER} on {rows} x {length} "
          f"bases "
          f"{spread(kmer_t)}, plain {kmer_p_t[0]:.3f} ms, bound "
          f"{kmer_bytes * ms:.3f} ms by bytes ({kmer_ops} operations: "
          f"{kmer_ops / INT32_OPS_PER_S * 1e3:.3f} ms); card {card}",
          flush=True)
    walk_err = max(walk_err, f8_err)
    return [kernel_record("cops_bucket_walk", bl_launches, walk_err, walk_t,
                          walk_p_t, walk_bytes, elements=n_q),
            kernel_record("kmer_hash", mg_launches, kmer_err, kmer_t,
                          kmer_p_t, kmer_bytes, elements=rows * n_out,
                          source=MINHASH_SOURCE, bound_ops=kmer_ops,
                          design=KMER_DESIGN)]


def update_cases(torch, check, phase):
    """Phase 16: the update kernels vs plain at N_CHECK rows, and the hash
    set against a table-free reference."""
    from repro_torch.kernels.cops import contract, ops
    cases = [(what, g, 32, "cops", 0.9, 1, False) for what in
             ("sum", "min", "max", "count", "mean") for g in UPDATE_GROUPS]
    cases += [("counting", 2 ** 16, 32, "cops", 0.9, 1, False),
              ("sum", 2 ** 16, 8, "cops", 0.9, 1, False),
              ("sum", 2 ** 16, 8, "linear", 0.9, 1, False),
              ("max", 2 ** 16, 32, "linear", 0.9, 1, False),
              ("sum", 2 ** 16, 32, "cops", 1.2, 1, False),
              ("sum", 2 ** 16, 32, "cops", 0.9, 2, False),
              ("min", 2 ** 16, 8, "linear", 0.9, 2, False),
              ("counting", 2 ** 16, 32, "cops", 0.9, 2, False)]
    # the combine on both sides of R groups in shared memory, and a batch
    # whose rows all share one key, every group in batch 1, for each op
    r = ops.shared_groups()
    for what in UPDATE_OPS:
        cases += [(what, g, 32, "cops", 0.9, 1, True)
                  for g in (r - 1, r, r + 1)]
        cases.append((what, 1, 32, "cops", 1 / 256, 1, True))
    cases += [("saturating", r, 32, "cops", 0.9, 2, True),
              ("saturating", 1, 32, "cops", 1 / 256, 2, True)]
    for what, groups, window, scheme, rho, key_words, cover in cases:
        t0 = time.perf_counter()
        checks = contract.run_update_case(
            N_CHECK, window=window, scheme=scheme, device="cuda", what=what,
            groups=groups, rho=rho, key_words=key_words, cover=cover)
        torch.cuda.synchronize()
        tag = (f"phase{phase} {what} g={groups} W={window} {scheme} "
               f"rho={rho:g} kw={key_words}")
        bad = [k for k, ok in checks.items() if not check(f"{tag} {k}", ok)]
        print(f"phase {phase} update{'64' if key_words == 2 else ''} kernel "
              f"vs plain {what} n={N_CHECK} groups={groups}"
              f"{' (every one in batch 1)' if cover else ''} W={window} "
              f"{scheme} rho={rho:g}"
              f"{' (FULL reported)' if rho > 1 else ''}: "
              f"{'ok' if not bad else 'FAILED ' + str(bad)} "
              f"({len(checks)} checks, {time.perf_counter() - t0:.1f} s)",
              flush=True)
    hashset_case(torch, check, phase)


def first_occurrence(torch, keys):
    """(unique keys in first-occurrence order, first-occurrence mask)."""
    uk, inv = torch.unique(keys, return_inverse=True)
    n = keys.shape[0]
    first = torch.full(uk.shape, n, dtype=torch.int64, device=keys.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=keys.device), "amin")
    return (uk[torch.argsort(first)],
            torch.arange(n, device=keys.device) == first[inv])


def hashset_case(torch, check, phase):
    """Phase 16: the hash set (no value plane) on the card: add of N_CHECK
    keys with duplicates, contains of present and absent keys, remove and
    re-add, against a table-free reference."""
    from repro_torch.core import hashset
    from repro_torch.kernels.cops import contract
    t0 = time.perf_counter()
    since = len(check.failed)
    pool = contract.distinct_keys(0, N_CHECK, "cuda")
    keys, absent = pool[: N_CHECK // 2], pool[N_CHECK // 2:]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    batch = keys[torch.randint(0, keys.shape[0], (N_CHECK,), generator=gen,
                               device="cuda")]
    present = torch.isin(keys, batch)
    s = hashset.create(N_CHECK, device="cuda")
    s, added = hashset.add(s, batch)
    _, fresh = first_occurrence(torch, batch)
    check("set add = first occurrences", torch.equal(added, fresh))
    check("set size", hashset.size(s) == int(present.sum()))
    check("set contains", torch.equal(hashset.contains(s, keys), present)
          and not bool(hashset.contains(s, absent).any()))
    gone = keys[: keys.shape[0] // 8]
    s, erased = hashset.remove(s, gone)
    check("set remove", torch.equal(erased, present[: gone.shape[0]]))
    check("set removed not contained",
          not bool(hashset.contains(s, gone).any()))
    s, added = hashset.add(s, gone)
    check("set re-add", bool(added.all())
          and hashset.size(s) == int(present.sum()) + int((~present[
              : gone.shape[0]]).sum()))
    torch.cuda.synchronize()
    print(f"phase {phase} hash set (no value plane) n={N_CHECK}: "
          f"{check.status(since)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def join_rows(torch, probe_idx, build_idx):
    """A join's (probe row, build row) pairs as sorted int64 words: the
    per-probe-row multisets, whatever the order within a row."""
    return torch.sort(probe_idx.long() * (1 << 32) + build_idx.long()).values


def check_join(torch, check, tag, res, how, want, n):
    """``res`` (a JoinResult) against ``pair_reference``'s (values,
    offsets, counts) of the build (key, row) pairs for the probe keys."""
    vals, _, counts = want
    matched = counts > 0
    rows = torch.arange(n, device="cuda")
    if how in ("inner", "left"):
        ref = join_rows(torch, torch.repeat_interleave(rows, counts.long()),
                        vals)
        if how == "left":
            lone = rows[~matched]
            ref = torch.sort(torch.cat([ref, join_rows(
                torch, lone, torch.full_like(lone, -1))])).values
        total = int((counts.clamp(min=1) if how == "left" else counts).sum())
        v = res.valid
        ok = torch.equal(join_rows(torch, res.probe_idx[v], res.build_idx[v]),
                         ref)
    else:
        sel = matched if how == "semi" else ~matched
        total = int(sel.sum())
        v = res.valid
        ok = (torch.equal(res.probe_idx[v].long(), rows[sel])
              and not bool((res.build_idx != -1).any()))
    check(f"{tag} rows", ok)
    check(f"{tag} total", int(res.total) == total)
    check(f"{tag} matched", torch.equal(res.matched, matched))


def groupby_reference(torch, keys, vals, agg):
    """(sorted unique keys, their aggregates) without a table."""
    from repro_torch.core.common import as_word
    uk, inv = torch.unique(keys, return_inverse=True)
    acc = torch.zeros(uk.shape, dtype=torch.int64, device=keys.device)
    acc.scatter_add_(0, inv, vals.long() & 0xFFFFFFFF)
    cnt = torch.bincount(inv, minlength=uk.shape[0])
    acc = acc & 0xFFFFFFFF
    if agg == "mean":
        return uk, acc.float() / cnt.clamp(min=1).float()
    return uk, as_word(cnt if agg == "count" else acc)


def relational_path(torch, card, check, phase):
    """Phase 17: fig9's join, group-by and DISTINCT at n = N_REL through
    the public relational entry points, each exact against a table-free
    reference and timed.  The counters are zeroed just before and read just
    after.  Returns ``(launches, {g: keys and values} of each group-by)``."""
    from repro_torch.core import hashing
    from repro_torch.core.common import as_u32, as_word
    from repro_torch.kernels.cops import contract, ops
    from repro_torch.relational import distinct, groupby, join
    n = N_REL
    since = len(check.failed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    build = contract.distinct_keys(0, n, "cuda")
    probe = as_u32(hashing.mix_murmur3(torch.randint(
        0, 8 * n, (n,), generator=gen, device="cuda")))
    probe = as_word(torch.where(probe >= 0xFFFFFFFE, probe ^ 4, probe))
    row_ids = torch.arange(n, dtype=torch.int32, device="cuda")
    want = pair_reference(torch, build, row_ids, probe)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    lines = []
    for rho in REL_RHOS:
        hows = join.HOW if rho == REL_RHOS[0] else ("inner",)
        for how in hows:
            t, res = timed(torch, lambda: join.hash_join(
                build, probe, 2 * n, how, capacity=int(n / rho),
                device="cuda"))
            check_join(torch, check, f"join {how} rho={rho}", res, how,
                       want, n)
            ms = statistics.median(t)
            lines.append(f"join {how} rho={rho} {spread(t)} = "
                         f"{2 * n / ms / 1e6:.3f} G rows/s (total "
                         f"{int(res.total)})")
            del res
    del want, probe, row_ids
    batches = {}
    for g in REL_GROUPS:
        keys = torch.randint(1, g + 1, (n,), dtype=torch.int32,
                             generator=gen, device="cuda")
        vals = torch.randint(0, 2 ** 16, (n,), dtype=torch.int32,
                             generator=gen, device="cuda")
        cap = groupby.capacity_for(g)
        for agg in REL_AGGS:
            t, (gk, out, live, table) = timed(torch, lambda: groupby.aggregate(
                keys, vals, cap, agg, device="cuda"))
            ref_t, (uk, ref) = timed(torch, lambda: groupby_reference(
                torch, keys, vals, agg))
            lk, lo = gk[live], out[live]
            order = torch.argsort(lk)
            check(f"groupby {agg} g={g} keys", torch.equal(lk[order], uk))
            check(f"groupby {agg} g={g} aggregates",
                  torch.equal(lo[order], ref))
            check(f"groupby {agg} g={g} count", table.count == uk.shape[0])
            lines.append(f"groupby {agg} g={g} {spread(t)} = "
                         f"{n / statistics.median(t) / 1e6:.3f} G rows/s "
                         f"(sort-based reference {spread(ref_t)})")
            del gk, out, live, table, uk, ref, lk, lo
        batches[g] = (keys, vals)
    dk = torch.randint(1, n // 8, (n,), dtype=torch.int32, generator=gen,
                       device="cuda")
    t, (u, n_u, fresh) = timed(torch, lambda: distinct.distinct(
        dk, n, device="cuda"))
    ref_u, ref_fresh = first_occurrence(torch, dk)
    m = ref_u.shape[0]
    check("distinct count", int(n_u) == m)
    check("distinct keys in first-occurrence order",
          torch.equal(u[:m], ref_u) and not bool(u[m:].any()))
    check("distinct mask", torch.equal(fresh, ref_fresh))
    lines.append(f"distinct dup8 {spread(t)} = "
                 f"{n / statistics.median(t) / 1e6:.3f} G rows/s "
                 f"(unique {m})")
    del dk, u, fresh, ref_u, ref_fresh
    torch.cuda.synchronize()
    launches = path_counts(ops)
    for name in ("cops_update", "cops_append", "cops_retrieve",
                 "cops_insert"):
        check(f"{name} launched on the relational path", launches[name] > 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase {phase} relational path (fig9) n={n}: "
          f"{check.status(since)}; " + "; ".join(lines)
          + f" (5 runs each after a warm-up, CUDA events, through "
          f"join.hash_join / groupby.aggregate / distinct.distinct); peak "
          f"{peak:.1f} GB; launches {launches}; card {card}", flush=True)
    return launches, batches


def composite_path(torch, card, check, phase):
    """Phase 18, first part: fig9's composite parity gate at N_COMPOSITE
    rows: each two-column run against the same columns packed into one
    word (the high column shifted past the low one's bits: 16 for the
    join's, as fig9 packs, and 17 for the group-by's low column below
    n / 128 = 2^17).  The counters are zeroed just before and read just after.
    Returns ``(launches, the composite group-by's columns and values)``."""
    from repro_torch.kernels.cops import ops
    from repro_torch.relational import distinct, groupby, join
    n = N_COMPOSITE
    since = len(check.failed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)

    def cols(hi, lo_min, lo_max):
        return (torch.randint(0, hi, (n,), dtype=torch.int32, generator=gen,
                              device="cuda"),
                torch.randint(lo_min, lo_max, (n,), dtype=torch.int32,
                              generator=gen, device="cuda"))

    def pack(c, bits=16):
        return (c[0] << bits) | c[1]

    bc, pc = cols(1 << 10, 1, 1 << 16), cols(1 << 10, 1, 1 << 16)
    gc = cols(16, 1, n // 128)
    # the group-by's low column needs log2(n / 128) bits (17 at 2^24)
    gbits = max(16, (n // 128 - 1).bit_length())
    gv = torch.randint(0, 1 << 16, (n,), dtype=torch.int32, generator=gen,
                       device="cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    jt_c, rc = timed(torch, lambda: join.hash_join(bc, pc, 2 * n, "inner",
                                                   device="cuda"))
    rp = join.hash_join(pack(bc), pack(pc), 2 * n, "inner", device="cuda")
    check("composite join rows", torch.equal(
        join_rows(torch, rc.probe_idx[rc.valid], rc.build_idx[rc.valid]),
        join_rows(torch, rp.probe_idx[rp.valid], rp.build_idx[rp.valid])))
    check("composite join total, matched",
          int(rc.total) == int(rp.total) and torch.equal(rc.matched,
                                                         rp.matched))
    cap = groupby.capacity_for(max(n // 8, 8))
    gt_c, (_, _, _, tc) = timed(torch, lambda: groupby.aggregate(
        gc, gv, cap, "sum", device="cuda"))
    tp = groupby.aggregate(pack(gc, gbits), gv, cap, "sum",
                           device="cuda")[3]
    out_c, f_c = groupby.lookup(tc, "sum", gc)
    out_p, f_p = groupby.lookup(tp, "sum", pack(gc, gbits))
    check("composite groupby", torch.equal(out_c, out_p)
          and torch.equal(f_c, f_p) and bool(f_c.all())
          and tc.count == tp.count)
    dt_c, ((uh, ul), n_c, fr_c) = timed(torch, lambda: distinct.distinct(
        gc, n, device="cuda"))
    up, n_p, fr_p = distinct.distinct(pack(gc, gbits), n, device="cuda")
    check("composite distinct", int(n_c) == int(n_p)
          and torch.equal(fr_c, fr_p)
          and torch.equal(pack((uh, ul), gbits), up))
    torch.cuda.synchronize()
    launches = path_counts(ops)
    for name in ("cops_update64", "cops_append64", "cops_retrieve64",
                 "cops_insert64"):
        check(f"{name} launched on the composite path", launches[name] > 0)
    print(f"phase {phase} composite keys (fig9 parity gate) n={n}: "
          f"{check.status(since)}; join {spread(jt_c)} "
          f"({int(rc.total)} rows), groupby sum {spread(gt_c)} "
          f"({tc.count} groups), distinct {spread(dt_c)} ({int(n_c)} "
          f"unique), each equal to its packed one-word run; launches "
          f"{launches}; card {card}", flush=True)
    return launches, (gc, gv)


def update_bytes(torch, table_keys, rkeys, status, n, seed, scheme, budget):
    """The bytes an update of ``n`` rows must move, from its own outcome:
    the windows its representatives ``rkeys`` walk on the store it left
    (128-byte lines of plane 0, and the plane-1 sectors a two-plane walk
    reads); per representative a written 32-byte sector of each key plane
    where it claimed, and of each of the two value planes a written sector
    where it claimed or a read and a written one where it matched; the
    representatives' streams (key, operand, status), and the rows' (the
    representative of each row, and the operand of every other one)."""
    from repro_torch.core.common import STATUS_INSERTED, STATUS_UPDATED
    key_words = 1 if rkeys.ndim == 1 else 2
    reps = rkeys.shape[0]
    claimed = int((status == STATUS_INSERTED).sum())
    matched = int((status == STATUS_UPDATED).sum())
    windows, p1 = walk_windows(torch, table_keys, rkeys, seed, scheme, budget)
    nbytes = (windows * 4 * WINDOW + p1 * 32 + claimed * 32 * key_words
              + 2 * (claimed * 32 + matched * 64)
              + reps * (4 * key_words + 8 + 4) + n * 4 + (n - reps) * 8)
    return nbytes, windows / reps


def update_kernel(torch, card, check, phase, cases, launches, name):
    """Phase 18: ``name`` (``cops_update`` or ``cops_update64``) alone, on
    each case ``(label, keys, vals, groups)`` of ``cases`` (keys (n,) words
    or (n, 2) planes): a sum group-by of the rows through the torch front
    end, first into an empty table for ``groups`` groups (every
    representative claims, as on the main path), then the same rows again
    into the table it filled (every representative matches and folds).
    Each run against its plain version under the update contract, timed
    (a fresh copy of the table per run, outside the timing), with its byte
    bound from its own statuses and, beside it, this design's own traffic:
    the bound's plus the acc scratch (filled, read by the walk, and above
    R groups a 32-byte sector read and written per row it combines); and
    the CUDA kernels of one more call, named with their times by
    ``torch.profiler``.  Returns the kernel record of the first case's
    first run."""
    from repro_torch.core import bulk
    from repro_torch.core.common import STATUS_INSERTED, STATUS_UPDATED
    from repro_torch.kernels.cops import contract, ops
    from repro_torch.relational import groupby
    fold = ("add", "add")
    kernel = getattr(ops, "update" if name == "cops_update" else "update64")
    shared = ops.shared_groups()
    record = None
    for label, keys, vals, groups in cases:
        since = len(check.failed)
        key_words = 1 if keys.ndim == 1 else 2
        payload = torch.stack([vals, torch.ones_like(vals)], dim=1)
        rkeys, x, claim, rest, _ = bulk.update_front(keys, payload, payload)
        n, reps = keys.shape[0], rkeys.shape[0]
        table = groupby.create(groupby.capacity_for(groups),
                               key_words=key_words, device="cuda")
        kw = dict(seed=table.seed, scheme=table.scheme,
                  max_probes=bulk._tstatic(table)[3])
        empty = (contract.table_planes(table)[0], table.store["values"])
        # a group's value after one batch, and after two
        gain = bulk.fold_rest(fold, rest, payload, reps)
        once = bulk.fold_words(fold, claim, gain)
        twice = bulk.fold_words(fold, once, bulk.fold_words(fold, x, gain))
        del gain
        lines, err = [], 0
        start = {"kernel": empty, "plain": empty}
        for run, count, want in (("empty", 0, once), ("filled", reps, twice)):
            outs = {}
            for who, fn in (("kernel", kernel), ("plain", ops.update_plain)):
                base = start[who]
                t, out = timed(
                    torch, lambda pl: (pl, fn(*pl, rkeys, x, claim, rest,
                                              payload, ops=fold, count=count,
                                              **kw)),
                    lambda: (tuple(p.clone() for p in base),),
                    **({} if who == "kernel" else dict(reps=1, warmup=0)))
                outs[who] = (t, *out)
            (k_t, kpl, kst), (p_t, ppl, pst) = outs["kernel"], outs["plain"]
            for part, ok in contract.check_update(kpl, ppl, rkeys, want, kst,
                                                  pst, **kw).items():
                check(f"phase{phase} {name} {label} {run} {part}", ok)
            expect = STATUS_INSERTED if run == "empty" else STATUS_UPDATED
            check(f"phase{phase} {name} {label} {run} all "
                  f"{'INSERTED' if run == 'empty' else 'UPDATED'}",
                  bool((kst == expect).all()))
            _, kv, _ = contract.live_map(*kpl)
            _, pv, _ = contract.live_map(*ppl)
            err = max(err, int((kv - pv).abs().max()) if kv.shape == pv.shape
                      else float("inf"))
            nbytes, per_walk = update_bytes(torch, kpl[0], rkeys, kst, n,
                                            kw["seed"], kw["scheme"],
                                            kw["max_probes"])
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            acc_bytes = 2 * reps * len(fold) * 4 + (
                (n - reps) * 64 if reps > shared else 0)
            split = device_kernels(torch, lambda pl=tuple(
                p.clone() for p in start["kernel"]): kernel(
                    *pl, rkeys, x, claim, rest, payload, ops=fold,
                    count=count, **kw))
            lines.append(f"into the {run} table {spread(k_t)}, plain "
                         f"{p_t[0]:.3f} ms, bound {bound:.3f} ms by bytes "
                         f"({nbytes} B; {per_walk:.4f} windows per walk); "
                         f"this design's traffic {nbytes + acc_bytes} B "
                         f"({(nbytes + acc_bytes) / HBM_BYTES_PER_S * 1e3:.3f}"
                         f" ms; the acc scratch {acc_bytes} B, combined in "
                         f"{'shared' if reps <= shared else 'device'} memory)"
                         f"; the kernels of one call: {split}")
            if record is None:
                record = kernel_record(name, launches, None, k_t, p_t, nbytes,
                                       elements=n)
            start = {"kernel": kpl, "plain": ppl}
        print(f"phase {phase} {name} alone, {label}: {n} rows -> {reps} "
              f"groups (sum, capacity {table.capacity}, W={WINDOW}): "
              f"{check.status(since)}; " + "; ".join(lines)
              + f"; card {card}", flush=True)
        record["max_abs_err"] = max(record["max_abs_err"] or 0, err)
        del payload, rkeys, x, claim, rest, once, twice, start, kpl, ppl
    return record


def words_err(torch, a, b) -> int:
    """Largest difference between two tensors of int32 words (as u32) or
    bools."""
    from repro_torch.core.common import as_u32
    if a.numel() == 0:
        return 0
    if a.dtype == torch.bool:
        return int((a.to(torch.int8) - b.to(torch.int8)).abs().max())
    return int((as_u32(a) - as_u32(b)).abs().max())


def bloom_cases(torch, check, phase):
    """Phase 19: ``bloom_insert`` / ``bloom_query`` vs their plain versions
    on the same card tensors at N_CHECK keys (each key ~4 times, half of
    them masked), for 256-, 512- and 1024-bit blocks, k = 1, 4 and 8, one
    filter and a stack of 8 with a plane per key (some out of range), at
    16 bits per key, each insert and query by the direct path (the filter
    is one range) and by the partitioned one (``RANGE_BYTES`` set to
    SMALL_RANGE_BYTES): filter words and hits bit-exact, every inserted
    key hit, an empty batch a no-op.  Returns the largest error."""
    from repro_torch.core import bloom
    from repro_torch.kernels.bloom import ops as bloom_ops
    from repro_torch.kernels.cops import contract
    t0 = time.perf_counter()
    since = len(check.failed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    base = contract.distinct_keys(0, N_CHECK // 4, "cuda")
    keys = base[torch.randint(0, base.shape[0], (N_CHECK,), generator=gen,
                              device="cuda")]
    mask = torch.rand((N_CHECK,), generator=gen, device="cuda") < 0.5
    queries = torch.cat([keys, contract.distinct_keys(2 ** 31, N_CHECK,
                                                      "cuda")])
    empty = keys[:0]
    err = cases = 0
    bloom_ops.reset_launches()
    default = bloom_ops.RANGE_BYTES
    for planes in (1, 8):
        owners = (torch.randint(-1, planes + 1, (N_CHECK,), generator=gen,
                                device="cuda") if planes > 1 else None)
        qowners = None if owners is None else torch.cat([owners, owners])
        for block_bits in (256, 512, 1024):
            nb = bloom.num_blocks_for(16 * N_CHECK // planes, block_bits)
            words = torch.zeros((planes, nb, block_bits // 32),
                                dtype=torch.int32, device="cuda")
            for k, ranges in ((k, r) for k in (1, 4, 8)
                              for r in (default, SMALL_RANGE_BYTES)):
                kw = dict(k_hashes=k, seed=0x9E3779B9)
                tag = (f"bloom P={planes} bits={block_bits} k={k} ranges of "
                       f"{ranges} B")
                bloom_ops.RANGE_BYTES = ranges
                try:
                    got = words.clone()
                    bloom_ops.insert_words(got, keys, mask, planes=owners,
                                           **kw)
                    bloom_ops.insert_words(got, empty, **kw)
                    # the query's path by its plan, the planes aside:
                    # direct for one range, partitioned for many
                    plan = bloom_ops.query_plan(
                        queries.shape[0], planes * nb, block_bits // 32)
                    hit = bloom_ops.query_launch(got, queries, qowners,
                                                 plan=plan, **kw)
                finally:
                    bloom_ops.RANGE_BYTES = default
                want = bloom_ops.insert_plain(words.clone(), keys, mask,
                                              planes=owners, **kw)
                want_hit = bloom_ops.query_plain(want, queries,
                                                 planes=qowners, **kw)
                err = max(err, words_err(torch, got, want),
                          words_err(torch, hit, want_hit))
                live = mask if owners is None else (
                    mask & (owners >= 0) & (owners < planes))
                check(f"{tag} exact",
                      torch.equal(got, want) and torch.equal(hit, want_hit))
                check(f"{tag} no false negative",
                      bool(hit[:N_CHECK][live].all()))
                check(f"{tag} empty",
                      bloom_ops.query_words(got, empty, **kw).shape == (0,))
                cases += 1
    torch.cuda.synchronize()
    paths = dict(bloom_ops.PATHS)
    check(f"phase{phase} bloom_insert and bloom_query took both paths",
          set(paths.values()) == {cases // 2})
    print(f"phase {phase} bloom kernels vs plain n={N_CHECK} (x2 queries, "
          f"half absent), {cases} cases (P 1 / 8 (planes -1 .. 8), block "
          f"bits 256 / 512 / 1024, k 1 / 4 / 8, half masked, ~4 copies of "
          f"each key, an empty batch; each filter whole ({default} B ranges:"
          f" the direct paths) and in ranges of {SMALL_RANGE_BYTES} B (the "
          f"partitioned ones)): {check.status(since)}, the paths taken "
          f"{paths}, max error {err} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return err


class BloomTap:
    """Holds every bloom launch made while it is active against the plain
    version on the same inputs: ``with tap:`` swaps ``insert_words`` /
    ``query_words`` of the ops module (which the service and
    ``core.bloom`` call through) for versions that clone the filter
    before an insert, call the kernel's wrapper, then run ``insert_plain``
    / ``query_plain`` on the clone and record whether the two agree.  The
    plain versions launch no kernel, so the launch counts are those of the
    path alone; ``seconds`` is the host time the checks took (the card
    synchronized around each), for a caller that times the path."""

    def __init__(self, torch, bloom_ops):
        self.torch, self.ops = torch, bloom_ops
        self.calls = {"insert": 0, "query": 0}
        self.exact, self.err, self.seconds, self.shapes = True, 0, 0.0, set()

    def _check(self, kind, got, plain, words, keys):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        self.calls[kind] += 1
        self.exact &= bool(self.torch.equal(got, want))
        self.err = max(self.err, words_err(self.torch, got, want))
        self.shapes.add((kind, tuple(words.shape), keys.shape[0]))
        self.seconds += time.perf_counter() - t0

    def __enter__(self):
        ops = self.ops
        self._saved = ops.insert_words, ops.query_words
        insert, query = self._saved

        def tapped_insert(words, keys, mask=None, **kw):
            before = words.clone()
            out = insert(words, keys, mask, **kw)
            self._check("insert", words, lambda: ops.insert_plain(
                before, keys, mask, **kw), words, keys)
            return out

        def tapped_query(words, keys, **kw):
            hit = query(words, keys, **kw)
            self._check("query", hit, lambda: ops.query_plain(
                words, keys, **kw), words, keys)
            return hit

        ops.insert_words, ops.query_words = tapped_insert, tapped_query
        return self

    def __exit__(self, *exc):
        self.ops.insert_words, self.ops.query_words = self._saved
        return False


def _percentile(torch, values, q) -> float:
    return float(torch.quantile(torch.tensor(values, dtype=torch.float64),
                                q / 100))


def elastic_path(torch, card, check, phase):
    """Phase 20: the elastic service at fig12's shape on one card (see the
    module docstring).  The launch counters are zeroed just before and read
    just after.  Returns the launches and the largest error of the
    path's bloom launches against their plain versions."""
    import shutil
    from repro_torch.core import bloom, hashing, snapshot
    from repro_torch.core.common import (
        STATUS_INSERTED,
        STATUS_UPDATED,
        as_u32,
        as_word,
    )
    from repro_torch.kernels.bloom import ops as bloom_ops
    from repro_torch.kernels.cops import contract, ops
    from repro_torch.serving import elastic
    since = len(check.failed)
    dev = "cuda"
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    bloom_ops.reset_launches()
    st = elastic.create(EL_SHARDS, EL_CAPACITY,
                        bloom_bits_per_key=EL_BITS_PER_KEY, slack=EL_SLACK,
                        device=dev)
    keys = contract.distinct_keys(0, EL_PRELOAD, dev)
    vals = contract.values_for(keys, 20)
    t0 = time.perf_counter()
    ok = True
    tap = BloomTap(torch, bloom_ops)
    for s in range(0, EL_PRELOAD, EL_PRELOAD_BATCH):
        last = s + EL_PRELOAD_BATCH >= EL_PRELOAD
        with (tap if last else contextlib.nullcontext()):
            st, status = elastic.insert(st, keys[s:s + EL_PRELOAD_BATCH],
                                        vals[s:s + EL_PRELOAD_BATCH])
        ok &= bool((status == STATUS_INSERTED).all())
    torch.cuda.synchronize()
    preload_s = time.perf_counter() - t0 - tap.seconds
    check("elastic preload all INSERTED",
          ok and elastic.count(st) == EL_PRELOAD)
    slots = sum(t.capacity for t in st.shards)
    print(f"phase {phase} service: {EL_SHARDS} shards x {st.shards[0].capacity}"
          f" slots ({slots * 8 / 2 ** 30:.2f} GiB of key and value planes), "
          f"filters {tuple(st.filter_words.shape)} "
          f"({st.filter_words.numel() * 4 / 2 ** 20:.0f} MiB of words); "
          f"preload {EL_PRELOAD} keys in batches of {EL_PRELOAD_BATCH} in "
          f"{preload_s:.3f} s (the last batch's bloom launch held against the "
          f"plain version, not timed)", flush=True)
    # the table-free model of the live set: sorted u32 keys, their values
    mk = as_u32(keys)
    order = torch.argsort(mk)
    mk, mv = mk[order], vals[order]
    del keys, vals, order

    def members(q):
        """(live, position in the model) of int64 u32 queries."""
        pos = torch.searchsorted(mk, q).clamp(max=mk.numel() - 1)
        return mk[pos] == q, pos

    def sample(n):
        return mk[torch.randint(0, mk.numel(), (n,), generator=gen,
                                device=dev)]

    step_ms, split, dead = [], {}, []
    next_fresh, skips, fps, n_absent = EL_PRELOAD, 0, 0, 0
    overflow = 0
    for step in range(EL_STEPS + 1):    # step 0 is the warm-up, not timed
        n_fresh = EL_NB - EL_NB // 4
        ik = torch.cat([contract.distinct_keys(next_fresh, n_fresh, dev),
                        as_word(sample(EL_NB // 4))])
        next_fresh += n_fresh
        iv = torch.randint(-2 ** 31, 2 ** 31, (EL_NB,), dtype=torch.int32,
                           generator=gen, device=dev)
        absent = contract.distinct_keys(2 ** 31 + step * EL_NB, EL_NB // 2,
                                        dev)
        gk = torch.cat([as_word(sample(EL_NB // 2)), absent])
        dk = sample(EL_NB // 4)
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with (tap if step == 0 else contextlib.nullcontext()):
            st, (status, got, found, erased, stats) = elastic.serve_step(
                st, ik, iv, gk, as_word(dk), mark=mark)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        prev = start
        for name, e in marks + [("other", end)]:
            if step:
                split[name] = split.get(name, 0.0) + prev.elapsed_time(e)
            prev = e
        # the model: upserts (last writer wins), then lookups, then erases
        ik64 = as_u32(ik)
        live, _ = members(ik64)
        uk, inv = torch.unique(ik64, return_inverse=True)
        idx = torch.arange(EL_NB, device=dev)
        first = torch.full(uk.shape, EL_NB, device=dev).scatter_reduce(
            0, inv, idx, "amin")
        last = torch.full(uk.shape, -1, device=dev).scatter_reduce(
            0, inv, idx, "amax")
        want = torch.where(live | (first[inv] != idx), STATUS_UPDATED,
                           STATUS_INSERTED).to(torch.int32)
        check(f"elastic step {step} statuses", torch.equal(status, want))
        uv = iv[last]
        uhit, upos = members(uk)
        mv[upos[uhit]] = uv[uhit]
        mk = torch.cat([mk, uk[~uhit]])
        mv = torch.cat([mv, uv[~uhit]])
        order = torch.argsort(mk)
        mk, mv = mk[order], mv[order]
        del order, uk, inv, first, last, uv, uhit, upos
        hit, pos = members(as_u32(gk))
        check(f"elastic step {step} lookups",
              torch.equal(found, hit)
              and torch.equal(got, torch.where(hit, mv[pos], 0)))
        check(f"elastic step {step} erases", bool(erased.all()))
        mk_keep = ~torch.isin(mk, dk)
        mk, mv = mk[mk_keep], mv[mk_keep]
        dead.append(dk)
        skips += int(stats["skips"])
        fps += int(stats["false_positives"])
        overflow += int(stats["overflow"])
        n_absent += EL_NB // 2
    check("elastic no exchange overflow", overflow == 0)
    check("elastic skips + false positives == absent lookups",
          skips + fps == n_absent)
    check("elastic live count", elastic.count(st) == mk.numel())
    warm, step_ms = step_ms[0], step_ms[1:]
    p50, p99 = (_percentile(torch, step_ms, q) for q in (50, 99))
    mean = sum(step_ms) / len(step_ms)
    ops_per_step = EL_NB + EL_NB + EL_NB // 4
    check("elastic skip share of absent lookups >= 0.5",
          skips / n_absent >= 0.5)
    parts = ", ".join(f"{name} {ms / EL_STEPS:.3f} ms ({ms / sum(step_ms):.1%})"
                      for name, ms in split.items())
    print(f"phase {phase} serve: {EL_STEPS} steps (after a warm-up step of "
          f"{warm:.3f} ms, its bloom launches held against the plain "
          f"versions inside it) of {EL_NB} upserts (3/4 "
          f"new, 1/4 live) + {EL_NB} lookups (half live, half absent) + "
          f"{EL_NB // 4} erases of live keys; step p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms, mean {mean:.3f} ms (CUDA events) = "
          f"{1e3 / mean:.3f} steps/s = {ops_per_step * 1e3 / mean / 1e6:.3f} M"
          f" ops/s; skip share of absent lookups {skips / n_absent:.6f}, "
          f"false-positive share {fps / n_absent:.6f}; per step: {parts}; "
          f"live {mk.numel()}; every status, value, found and erased flag "
          f"equal to the table-free model: {check.status(since)}",
          flush=True)
    # compaction: the advertised-dead share drops, no live key is lost
    dead = torch.unique(torch.cat(dead))
    dead = dead[~members(dead)[0]]

    def advertised(keys64):
        owners = hashing.hash_owner(keys64, st.num_shards)
        return float(bloom.contains_stack(st.filters[0], st.filter_words,
                                          owners, keys64).float().mean())

    before = advertised(dead)
    torch.cuda.synchronize()
    t0, held = time.perf_counter(), tap.seconds
    with tap:
        st = elastic.compact_all(st)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0 - (tap.seconds - held)
    after = advertised(dead)
    check("elastic compact_all drops the advertised-dead share",
          after < before and after < 0.05)
    lost = wrong = 0
    with tap:
        for s in range(0, mk.numel(), EL_PRELOAD_BATCH):
            g, f, stt = elastic.lookup(st,
                                       as_word(mk[s:s + EL_PRELOAD_BATCH]))
            lost += int((~f).sum())
            wrong += int((g != mv[s:s + EL_PRELOAD_BATCH]).sum())
            overflow += int(stt["overflow"])
    check("elastic compact_all lost no live key",
          lost == 0 and wrong == 0 and overflow == 0
          and elastic.count(st) == mk.numel())
    check("elastic path's bloom launches equal to their plain versions",
          tap.exact and tap.calls["insert"] > 0 and tap.calls["query"] > 0)
    print(f"phase {phase} compact_all in {compact_s:.3f} s (its bloom "
          f"checks not timed): advertised-dead share of {dead.numel()} "
          f"erased keys {before:.6f} -> {after:.6f}; {mk.numel()} live keys "
          f"looked up, {lost} lost, {wrong} wrong; the path's bloom launches "
          f"held against the plain versions on their own inputs: "
          f"{tap.calls['insert']} inserts, {tap.calls['query']} queries, "
          f"shapes (kind, filter, keys) {sorted(tap.shapes)}, exact "
          f"{tap.exact}, max error {tap.err}", flush=True)
    del st, mk, mv, dead
    torch.cuda.empty_cache()
    # save -> load through the writer, and reshard 8 -> 16, at a reduced size
    small = elastic.create(EL_SHARDS, EL_SNAP_CAPACITY,
                           bloom_bits_per_key=EL_BITS_PER_KEY, slack=EL_SLACK,
                           device=dev)
    n_small = EL_SHARDS * EL_SNAP_CAPACITY // 2
    sk = contract.distinct_keys(2 ** 30, n_small, dev)
    sv_ = contract.values_for(sk, 21)
    small, _ = elastic.insert(small, sk, sv_)
    small, _ = elastic.erase(small, sk[: n_small // 8])
    path = HERE / "build" / "chip_smoke_elastic"
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with snapshot.SnapshotWriter() as w:
        elastic.save(small, str(path), writer=w)
        queued_s = time.perf_counter() - t0
        w.flush()
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in path.iterdir())
    t0 = time.perf_counter()
    back = elastic.load(str(path), device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check("elastic load bit-exact shard planes", all(
        torch.equal(a.store["keys"], b.store["keys"])
        and torch.equal(a.store["values"], b.store["values"])
        and a.count == b.count for a, b in zip(small.shards, back.shards)))
    check("elastic load filters a subset of the incremental ones",
          not bool((back.filter_words & ~small.filter_words).any()))
    live_k, live_v = sk[n_small // 8:], sv_[n_small // 8:]
    t0 = time.perf_counter()
    big = elastic.reshard(back, 2 * EL_SHARDS)
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    elastic.check_ownership(big)
    for name, svc in (("load", back), ("reshard", big)):
        g, f, _ = elastic.lookup(svc, live_k)
        _, f_gone, _ = elastic.lookup(svc, sk[: n_small // 8])
        check(f"elastic {name} keeps every live key",
              bool(f.all()) and torch.equal(g, live_v)
              and not bool(f_gone.any())
              and elastic.count(svc) == live_k.numel())
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.synchronize()
    launches = path_counts(ops, bloom_ops)
    for name in ("bloom_insert", "bloom_query", "cops_insert", "cops_lookup"):
        check(f"{name} launched on the elastic path", launches[name] > 0)
    paths = dict(bloom_ops.PATHS)
    check("bloom_insert took both paths on the elastic path",
          paths["direct"] > 0 and paths["partitioned"] > 0)
    print(f"phase {phase} save / load / reshard at capacity_per_shard="
          f"{EL_SNAP_CAPACITY} (reduced from {EL_CAPACITY} so the snapshot "
          f"on disk stays under 300 MiB): {n_small} keys, 1/8 erased; save "
          f"through SnapshotWriter {save_s:.3f} s ({queued_s:.3f} s to queue"
          f"), {size / 2 ** 20:.1f} MiB; load {load_s:.3f} s, bit-exact; "
          f"reshard {EL_SHARDS} -> {2 * EL_SHARDS} {reshard_s:.3f} s, "
          f"ownership exact: {check.status(since)}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB; launches "
          f"{launches}; the bloom kernels' paths {paths}; card {card}",
          flush=True)
    return launches, tap.err


def bloom_sectors(torch, words, keys, k, seed) -> tuple[int, int]:
    """The 32-byte sectors of the filter that ``keys``' k bits fall in:
    (summed over keys, each key's distinct ones: the traffic of a design
    that visits every key's row; distinct over the whole run: each sector
    once, what the work needs)."""
    from repro_torch.kernels.bloom import ref
    nb, wpb = words.shape
    per_block = wpb * 32 // 256
    touched = torch.zeros(nb * per_block, dtype=torch.bool,
                          device=words.device)
    total = 0
    for s in range(0, keys.shape[0], 1 << 24):
        block, bit = ref.positions(keys[s:s + (1 << 24)], nb, 32 * wpb, k,
                                   seed)
        sec = torch.sort(block[:, None] * per_block + bit // 256, dim=1).values
        touched[sec.reshape(-1)] = True
        total += int((1 + (sec[:, 1:] != sec[:, :-1]).sum(1)).sum())
    return total, int(touched.sum())


def bloom_kernels(torch, card, check, phase, launches, err_before):
    """Phase 21: ``bloom_insert`` and ``bloom_query`` alone
    (``insert_plan``'s and ``query_plan``'s partitioned paths, and each
    direct path beside) at N_BLOOM keys into a filter of BLOOM_BITS bits
    (512-bit blocks, k = 4), and their plain versions, compared and timed,
    with bounds from the run's own data (the distinct sectors its keys
    touch, or the integer operations) and the designs' own traffic; the
    false-positive rate on N_BLOOM absent keys.  Returns their two kernel
    records (``err_before``: the largest error of phases 19, 20)."""
    from repro_torch.core import bloom
    from repro_torch.kernels.bloom import ops as bloom_ops
    from repro_torch.kernels.cops import contract
    since = len(check.failed)
    f = bloom.create(BLOOM_BITS, device="cuda")
    kw = dict(k_hashes=f.k, seed=f.seed)
    keys = contract.distinct_keys(0, N_BLOOM, "cuda")
    plan = bloom_ops.insert_plan(N_BLOOM, f.num_blocks, f.words.shape[1])
    check(f"phase{phase} bloom_insert partitioned", plan.partitioned)
    # the direct path at the same shape: the design before the partition
    direct = torch.zeros_like(f.words)
    dir_t, _ = timed(torch, lambda w: bloom_ops.insert_launch(
        w, keys, None, None, plan=bloom_ops.Plan(False), **kw),
        lambda: (direct.zero_(),))
    ins_t, _ = timed(torch, lambda w: bloom_ops.insert_words(w, keys, **kw),
                     lambda: (f.words.zero_(),))
    plain = torch.zeros_like(f.words)
    ins_p_t, plain = timed(
        torch, lambda w: bloom_ops.insert_plain(w, keys, **kw),
        lambda: (plain.zero_(),), reps=1, warmup=0)
    err = max(words_err(torch, f.words, plain),
              words_err(torch, direct, plain))
    check(f"phase{phase} bloom_insert exact", torch.equal(f.words, plain))
    check(f"phase{phase} bloom_insert's direct path exact",
          torch.equal(direct, plain))
    del plain, direct
    qplan = bloom_ops.query_plan(N_BLOOM, f.num_blocks, f.words.shape[1])
    check(f"phase{phase} bloom_query partitioned", qplan.partitioned)
    bloom_ops.reset_launches()
    q_t, hit = timed(torch, lambda: bloom_ops.query_words(f.words, keys, **kw))
    q_paths = dict(bloom_ops.PATHS)
    check(f"phase{phase} bloom_query took the partitioned path",
          q_paths["query_partitioned"] > 0 and q_paths["query_direct"] == 0)
    # the direct path at the same shape
    q_dir_t, dir_hit = timed(torch, lambda: bloom_ops.query_launch(
        f.words, keys, None, plan=bloom_ops.Plan(False), **kw))
    q_p_t, want = timed(torch, lambda: bloom_ops.query_plain(f.words, keys,
                                                              **kw),
                        reps=1, warmup=0)
    err = max(err, err_before, words_err(torch, hit, want),
              words_err(torch, dir_hit, want))
    check(f"phase{phase} bloom_query exact and no false negative",
          torch.equal(hit, want) and bool(hit.all()))
    check(f"phase{phase} bloom_query's direct path exact",
          torch.equal(dir_hit, want))
    del hit, dir_hit, want
    absent = contract.distinct_keys(2 ** 31, N_BLOOM, "cuda")
    a_hit = bloom_ops.query_words(f.words, absent, **kw)
    fp = float(a_hit.float().mean())
    check(f"phase{phase} bloom false-positive rate below 1%", fp < 0.01)
    del absent, a_hit
    filter_bytes = f.words.numel() * 4
    per_key, distinct = bloom_sectors(torch, f.words, keys, f.k, f.seed)
    ins_bytes = 64 * distinct + 4 * N_BLOOM
    q_bytes = 32 * distinct + 5 * N_BLOOM
    ops_ = (OPS_PER_BLOOM_KEY + 4 * f.k) * N_BLOOM
    ms = 1e3 / HBM_BYTES_PER_S
    print(f"phase {phase} bloom kernels alone: {N_BLOOM} keys, "
          f"{f.num_blocks} blocks x {f.block_bits} bits "
          f"({filter_bytes / 2 ** 20:.0f} MiB), k={f.k}: "
          f"{check.status(since)}; bloom_insert {spread(ins_t)} "
          f"(partitioned: {plan.tiles} tiles of {plan.rows_per_tile} "
          f"blocks ({plan.rows_per_tile * f.block_bits // 8 >> 10} KiB) in "
          f"{plan.ranges} ranges of {plan.tiles_per_range} tiles; "
          f"{N_BLOOM / (f.num_blocks * f.block_bits / 256):.2f} keys a "
          f"filter sector, threshold "
          f"{bloom_ops.PARTITION_KEYS_PER_SECTOR}), the direct path "
          f"{spread(dir_t)}, plain {ins_p_t[0]:.3f} ms; bloom_query "
          f"{spread(q_t)} (partitioned, the insert's cut; threshold "
          f"{bloom_ops.QUERY_KEYS_PER_SECTOR} keys a sector; paths "
          f"{q_paths}), the direct path {spread(q_dir_t)}, plain "
          f"{q_p_t[0]:.3f} ms; bounds: bytes {ins_bytes * ms:.3f} / "
          f"{q_bytes * ms:.3f} ms ({distinct} distinct sectors, "
          f"{32 * distinct / filter_bytes:.6f} of the filter, read and "
          f"written / read once, + keys (+ hits)), integer operations "
          f"{ops_ / INT32_OPS_PER_S * 1e3:.3f} ms each; the designs' own "
          f"traffic: the partitioned insert's, the keys read four times "
          f"and written twice, the filter read and written once, "
          f"{(24 * N_BLOOM + 2 * filter_bytes) * ms:.3f} ms; the "
          f"partitioned query's, the keys read four times and written "
          f"twice, two slot arrays written and read once, the answers "
          f"written and read twice and written once more, the filter read "
          f"once, {(45 * N_BLOOM + filter_bytes) * ms:.3f} ms; the direct "
          f"insert's and query's, every key's sectors ({per_key}, "
          f"{per_key / N_BLOOM:.4f} a key): "
          f"{(64 * per_key + 4 * N_BLOOM) * ms:.3f} / "
          f"{(32 * per_key + 5 * N_BLOOM) * ms:.3f} ms; false-positive rate "
          f"on {N_BLOOM} absent keys {fp:.6f}; card {card}", flush=True)
    return [kernel_record("bloom_insert", launches, err, ins_t, ins_p_t,
                          ins_bytes, elements=N_BLOOM, source=BLOOM_SOURCE,
                          bound_ops=ops_, design="partitioned: a histogram, "
                          "a scan, two scatters by range then tile, a block "
                          "a 64 KiB tile ORing in shared memory"),
            kernel_record("bloom_query", launches, err, q_t, q_p_t, q_bytes,
                          elements=N_BLOOM, source=BLOOM_SOURCE,
                          bound_ops=ops_, design="partitioned: the insert's "
                          "sort by tile with each key's slots, a block a "
                          "64 KiB tile testing in shared memory, two "
                          "gathers back to batch order")]


def flash_inputs(torch, seed, b, s, sk, h, hkv, hd, dtype):
    """Seeded N(0, 1) (B, S, H, hd) q and (B, Sk, Hkv, hd) k, v on the card
    in ``dtype`` (rounded from f32)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(
        getattr(torch, dtype))
        for shape in ((b, s, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]


def flash_err(torch, got, want, dtype, of="flash_fwd"
              ) -> tuple[float, float, float, bool]:
    """(max abs difference, relative error of the whole output, largest
    relative error of one output row, within every limit): every value
    finite, the reference's elementwise FLASH_TOL, and the relative errors
    within ``FLASH_LIMITS[of]``."""
    tol = FLASH_TOL[dtype]
    rel_tol, row_tol = FLASH_LIMITS[of][dtype]
    got, want = got.float(), want.float()
    diff = got - want
    norm = torch.linalg.vector_norm
    rel = float(norm(diff) / norm(want))
    row = float((norm(diff, dim=-1)
                 / norm(want, dim=-1).clamp_min(1e-30)).max())
    diff = diff.abs_()
    ok = (bool(torch.isfinite(got).all())
          and bool((diff <= tol + tol * want.abs()).all())
          and rel <= rel_tol and row <= row_tol)
    return float(diff.max()), rel, row, ok


def flash_cases(torch, check, phase):
    """Phase 22: ``flash_fwd`` through ``flash_attention`` vs the plain
    version (``ref.gqa_attention``) on the same card tensors for every case
    of FLASH_CASES, and ``flash_call`` vs ``ref.attention`` on panels of the
    first; the reference's tolerances and the scaled limits (``flash_err``).
    Returns the largest error."""
    from repro_torch.kernels.flash import ops as fl, ref
    t0 = time.perf_counter()
    since = len(check.failed)
    worst = {d: [0.0, 0.0, 0.0] for d in FLASH_TOL}  # abs, whole, row

    def held(name, got, want, dtype, shape_ok=True):
        *errs, ok = flash_err(torch, got, want, dtype)
        worst[dtype] = [max(x) for x in zip(worst[dtype], errs)]
        check(f"phase{phase} {name}", ok and shape_ok)

    for i, (b, s, sk, h, hkv, hd, dtype, causal, tq, tk) in enumerate(
            FLASH_CASES):
        q, k, v = flash_inputs(torch, 22_000 + i, b, s, sk, h, hkv, hd,
                               dtype)
        got = fl.flash_attention(q, k, v, causal=causal, tq=tq, tk=tk)
        held(f"flash B={b} S={s} Sk={sk} H={h}/{hkv} hd={hd} {dtype} "
             f"causal={causal} tq={tq} tk={tk}", got,
             ref.gqa_attention(q, k, v, causal=causal), dtype,
             got.shape == q.shape and got.dtype == q.dtype)
    b, s, sk, h, hkv, hd, dtype, causal, tq, tk = FLASH_CASES[0]
    q, k, v = flash_inputs(torch, 22_100, b * h, s, sk, 1, 1, hd, dtype)
    panels = [x[:, :, 0] for x in (q, k, v)]
    held("flash_call panels", fl.flash_call(*panels),
         ref.attention(*panels), dtype)
    torch.cuda.synchronize()
    print(f"phase {phase} flash kernel vs plain, {len(FLASH_CASES)} cases "
          f"(f32 / bf16, causal and not, hd 16 / 32 / 64 / 128, H / Hkv "
          f"4 / 2, 24 / 2, 15 / 5, 16 / 16, Sk != S, tq 64 / tk 128, S up to "
          f"{max(c[1] for c in FLASH_CASES)}) + flash_call: "
          f"{check.status(since)}; "
          + "; ".join(f"{d}: max error {e:.3g} (limit {FLASH_TOL[d]:g} + "
                      f"{FLASH_TOL[d]:g} |want|), relative {r:.3g} (limit "
                      f"{FLASH_LIMITS['flash_fwd'][d][0]:g}), worst row "
                      f"{w:.3g} (limit {FLASH_LIMITS['flash_fwd'][d][1]:g})"
                      for d, (e, r, w) in worst.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return max(e for e, _, _ in worst.values())


def upsert_launches(key_words, what="upsert") -> str:
    """Phases 4, 7 and 11: the kernels that calls at the main path's
    shapes launch, by device time, as a child process (``python3
    chip_smoke.py --upsert-launches KEY_WORDS [retrieve]``) names them:
    with ``what`` "upsert", one build, one upsert of every key and one
    lookup of every key and of N_SIDE absent keys (phase 3's shape); with
    "retrieve", one collecting and one counting retrieve walk of every key
    of phase 6's table.  The profiler sees the card's kernels in a
    process's first sessions, but not after it has run the card for a
    while since one (it then reports no device time), so a child
    profiles them, each kind in a process of its own, and phase 18's
    splits stay this process's first sessions."""
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--upsert-launches", str(key_words), what],
                         capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        return (f"{what}: not measured (the child exited "
                f"{res.returncode}: {res.stderr.strip()[-300:]})")
    return lines[-1]


def retrieve_launches_main(key_words) -> int:
    """The child of ``upsert_launches(key_words, "retrieve")``: phase 6's
    (phase 10's) table, N_MV / R_MV distinct keys of ``key_words`` words,
    R_MV in a row, appended into ``multi_value.create(N_MV / 0.8)``,
    W = 32, cops; then one collecting and one counting retrieve walk of
    every key, each profiled."""
    import torch
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.core import bulk, multi_value as mv
    from repro_torch.kernels.cops import contract, ops
    n_keys = N_MV // R_MV
    base = (contract.distinct_keys(0, n_keys, "cuda") if key_words == 1
            else contract.distinct_keys64(0, n_keys, "cuda"))
    table = mv.create(int(N_MV / contract.LOAD), window=WINDOW,
                      device="cuda", key_words=key_words)
    kw = dict(seed=table.seed, scheme=table.scheme,
              max_probes=bulk._tstatic(table)[3])
    planes = contract.table_planes(table)
    (ops.append if key_words == 1 else ops.append64)(
        *planes, base.repeat_interleave(R_MV, dim=0),
        torch.arange(N_MV, dtype=torch.int32, device="cuda"), **kw)
    walk = ops.retrieve_walk if key_words == 1 else ops.retrieve_walk64
    every = torch.ones((n_keys,), dtype=torch.bool, device="cuda")
    collect = device_kernels(torch, lambda: walk(planes[0], base, every,
                                                 collect=True, **kw))
    counts = device_kernels(torch, lambda: walk(planes[0], base, every,
                                                collect=False, **kw))
    print(f"collecting retrieve of {n_keys} keys: {collect}; of one "
          f"counting retrieve: {counts}", flush=True)
    return 0


def upsert_launches_main(key_words) -> int:
    """The child of ``upsert_launches(key_words)``: N_MAIN distinct keys of
    ``key_words`` words into ``create(N_MAIN / RHO)``, W = 32, cops, once
    as the build and once as the upsert of every key, then the lookup of
    every key and of the main path's absent keys, each profiled."""
    import torch
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.core import bulk, single_value as sv
    from repro_torch.kernels.cops import contract, ops
    if key_words == 1:
        keys = contract.distinct_keys(0, N_MAIN, "cuda")
        absent = contract.distinct_keys(N_MAIN + 2, N_SIDE, "cuda")
    else:
        keys = contract.distinct_keys64(0, N_MAIN, "cuda")
        absent = contract.distinct_keys64(2 * N_MAIN, N_SIDE, "cuda")
    vals = contract.values_for(keys, 1)
    table = sv.create(int(N_MAIN / RHO), window=WINDOW, device="cuda",
                      key_words=key_words)
    kw = dict(seed=table.seed, scheme=table.scheme,
              max_probes=bulk._tstatic(table)[3])
    planes = contract.table_planes(table)
    insert = ops.insert if key_words == 1 else ops.insert64
    lookup = ops.lookup if key_words == 1 else ops.lookup64
    build = device_kernels(torch, lambda: insert(*planes, keys, vals,
                                                 count=0, **kw))
    upsert = device_kernels(torch, lambda: insert(*planes, keys, vals,
                                                  count=N_MAIN, **kw))
    present = device_kernels(torch, lambda: lookup(*planes, keys, **kw))
    gone = device_kernels(torch, lambda: lookup(*planes, absent, **kw))
    print(f"build: {build}; of one upsert of every key: {upsert}; of one "
          f"lookup of every key: {present}; of {N_SIDE} absent keys: {gone}",
          flush=True)
    return 0


def device_kernels(torch, fn) -> str:
    """The CUDA kernels that one call of ``fn`` runs, by device time, as
    ``torch.profiler`` names them ("not measured" where it sees none)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:
        return f"not measured (profiler: {exc})"
    rows = sorted(((e.device_time_total, e.key) for e in prof.key_averages()
                   if e.device_time_total > 0), reverse=True)
    if not rows:
        return "not measured (the profiler saw no device time)"
    return "; ".join(f"{name[:100]} {us / 1e3:.3f} ms" for us, name in rows)


def flash_path(torch, card, check, phase, err_before):
    """Phase 23: the FLASH_MAIN cells through ``flash_attention`` (causal),
    the launch counter zeroed just before and read just after; then per
    cell the output held against the plain version (timed once) and
    against ``scaled_dot_product_attention`` on (B, H, S, hd) views of the
    same tensors, ``flash_fwd`` and SDPA timed (median of 5 after a
    warm-up), with the bound from the cell's bytes and flops.  Returns the
    kernel record at the first cell."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash import ops as fl, ref
    h, hkv, hd = FLASH_HEADS
    since = len(check.failed)
    cells = {name: flash_inputs(torch, 23_000 + i, b, s, s, h, hkv, hd,
                                dtype)
             for i, (name, dtype, b, s) in enumerate(FLASH_MAIN)}
    torch.cuda.synchronize()
    fl.reset_launches()
    outs = {name: fl.flash_attention(*cells[name], causal=True)
            for name, *_ in FLASH_MAIN}
    torch.cuda.synchronize()
    launches = path_counts(fl)
    check(f"phase{phase} flash_fwd launched on the path",
          launches["flash_fwd"] == len(FLASH_MAIN))
    record, err = None, err_before
    for name, dtype, b, s in FLASH_MAIN:
        q, k, v = cells.pop(name)
        got = outs.pop(name)
        plain_t, want = timed(torch, lambda: ref.gqa_attention(q, k, v),
                              reps=1, warmup=0)
        e, rel, row, ok = flash_err(torch, got, want, dtype)
        err = max(err, e)
        check(f"phase{phase} {name} kernel vs plain",
              ok and got.shape == q.shape and got.dtype == q.dtype)
        del got
        t, _ = timed(torch, lambda: fl.flash_attention(q, k, v))
        views = [x.transpose(1, 2) for x in (q, k, v)]
        lib_t, lib = timed(torch, lambda: F.scaled_dot_product_attention(
            *views, is_causal=True, enable_gqa=True))
        e_lib, rel_lib, row_lib, ok = flash_err(torch, lib.transpose(1, 2),
                                                want, dtype, of="sdpa")
        check(f"phase{phase} {name} SDPA vs plain", ok)
        del lib, want
        print(f"phase {phase} {name}: device kernels of one call: "
              f"flash_attention: "
              f"{device_kernels(torch, lambda: fl.flash_attention(q, k, v))}"
              f" | SDPA: " + device_kernels(
                  torch, lambda: F.scaled_dot_product_attention(
                      *views, is_causal=True, enable_gqa=True)), flush=True)
        del views
        pairs = b * h * s * (s + 1) // 2   # causal: query i sees i + 1 keys
        flops = 4 * hd * pairs
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, k, v, o
        by_flops = flops / FLOPS_PER_S[dtype] * 1e3
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        med = statistics.median(t)
        print(f"phase {phase} {name}: B={b} S={s} H={h} Hkv={hkv} hd={hd} "
              f"{dtype} causal; flash_fwd {spread(t)} "
              f"({flops / med / 1e9:.1f} TFLOP/s), plain {plain_t[0]:.3f} ms, "
              f"SDPA {spread(lib_t)} "
              f"({flops / statistics.median(lib_t) / 1e9:.1f} TFLOP/s); "
              f"max error {e:.3g}, relative {rel:.3g}, worst row {row:.3g} "
              f"(SDPA {e_lib:.3g}, {rel_lib:.3g}, {row_lib:.3g}; limits "
              f"{FLASH_TOL[dtype]:g} + {FLASH_TOL[dtype]:g} |want|, then "
              f"{FLASH_LIMITS['flash_fwd'][dtype]} for the kernel, "
              f"{FLASH_LIMITS['sdpa'][dtype]} for SDPA); "
              f"bound {max(by_flops, by_bytes):.3f} ms ({flops:.4g} flops at "
              f"{FLOPS_PER_S[dtype] / 1e12:g} TFLOP/s: {by_flops:.3f} ms; "
              f"{nbytes:.4g} bytes: {by_bytes:.3f} ms; {pairs:.4g} "
              f"exponentials: {pairs / EXP_PER_S * 1e3:.3f} ms); kernel at "
              f"{med / max(by_flops, by_bytes):.1f}x its bound, "
              f"{med / statistics.median(lib_t):.1f}x SDPA; card {card}",
              flush=True)
        if record is None:
            record = (t, plain_t, nbytes, flops, FLOPS_PER_S[dtype], lib_t,
                      b * h * s * s)
        del q, k, v
        torch.cuda.empty_cache()
    print(f"phase {phase} flash main path: {check.status(since)}, launches "
          f"{launches}", flush=True)
    t, plain_t, nbytes, flops, rate, lib_t, scores = record
    return kernel_record("flash_fwd", launches, err, t, plain_t, nbytes,
                         elements=scores, source=FLASH_SOURCE,
                         bound_flops=flops, flops_rate=rate,
                         library_times=lib_t)


def walk_lengths(torch, table_keys, keys, seed, scheme, budget):
    """(n,) int64: the windows the read-only walk of each of ``keys`` reads
    on the store ``table_keys`` to its match or its first window holding an
    EMPTY (the budget where it reads neither), by ``probe_walks``: the
    plain walk of ``walk_windows``."""
    from repro_torch.core.common import EMPTY_WORD
    out = torch.zeros(keys.shape[:1], dtype=torch.int64, device=keys.device)
    for attempt, idx, _, _, _ in probe_walks(
            torch, table_keys, keys, seed, scheme, budget,
            lambda w, m: (m | (w == EMPTY_WORD)).any(1)):
        out[idx] = attempt + 1
    return out


def length_hist(torch, lengths):
    """The probe histogram of ``lengths`` (>= 1) computed apart from
    ``obs.metrics``: bin ceil(log2(length)), the last bin open-ended."""
    from repro_torch.obs import metrics
    b = torch.ceil(torch.log2(lengths.double())).long()
    b = b.clamp(0, metrics.NUM_PROBE_BINS - 1)
    return torch.bincount(b, minlength=metrics.NUM_PROBE_BINS)


def plen_cases(torch, card, check, phase):
    """Phase 24: the lookups' probe-length launches (``plen=True``: the
    ``PLEN`` instantiations of ``cops_lookup`` / ``cops_lookup64``) against
    ``lookup_plain``'s probe lengths, bit-exact, with values, found and
    slots unchanged (``contract.run_plen_case``): at N_CHECK keys, rho =
    0.9, in phase 2's four geometries, u32 and two-plane keys, absent and
    sentinel keys, TOMBSTONE-only windows, budgets of the table's, 1 and 2
    windows; at 2^12 slots also num_rows + 3 on a store with no EMPTY
    slot; and batches of PLEN_BATCHES keys.  Then at fig5's N_MAIN keys
    the lookup of every key with and without ``plen``, timed in turns
    (without, with, with, without; median of 5 each after a warm-up), the
    probe lengths held against the plain version, with the lookup's byte
    bound + 4 B a key."""
    from repro_torch.core import bulk, single_value as sv
    from repro_torch.kernels.cops import contract, ops
    since = len(check.failed)
    t0 = time.perf_counter()
    n_cases = 0
    for key_words in (1, 2):
        for window, scheme in SINGLE_CASES:
            kw = dict(window=window, scheme=scheme, device="cuda",
                      key_words=key_words)
            runs = {"2^20": contract.run_plen_case(
                        capacity=int(N_CHECK / RHO), load=RHO, revisit=False,
                        **kw),
                    "rows3": contract.run_plen_case(**kw)}
            for b in PLEN_BATCHES:
                runs[f"batch{b}"] = contract.run_plen_case(batch=b, **kw)
            for label, checks in runs.items():
                n_cases += 1
                for name, ok in checks.items():
                    check(f"phase{phase} plen kw={key_words} W={window} "
                          f"{scheme} {label} {name}", ok)
    torch.cuda.synchronize()
    case_s = time.perf_counter() - t0
    lines = []
    for key_words in (1, 2):
        suffix = "" if key_words == 1 else "64"
        keys = (contract.distinct_keys(0, N_MAIN, "cuda") if key_words == 1
                else contract.distinct_keys64(0, N_MAIN, "cuda"))
        table = sv.create(int(N_MAIN / RHO), window=WINDOW, device="cuda",
                          key_words=key_words)
        planes = contract.table_planes(table)
        kw = dict(seed=table.seed, scheme=table.scheme,
                  max_probes=bulk._tstatic(table)[3])
        getattr(ops, "insert" + suffix)(*planes, keys,
                                        contract.values_for(keys, 1),
                                        count=0, **kw)
        lookup = getattr(ops, "lookup" + suffix)
        off1, base = timed(torch, lambda: lookup(*planes, keys, **kw))
        on1, got = timed(torch, lambda: lookup(*planes, keys, plen=True,
                                               **kw))
        on2, _ = timed(torch, lambda: lookup(*planes, keys, plen=True, **kw))
        off2, _ = timed(torch, lambda: lookup(*planes, keys, **kw))
        want = ops.lookup_plain(*planes, keys, plen=True, **kw)
        check(f"phase{phase} plen{suffix} at n={N_MAIN} bit-exact",
              torch.equal(got[3], want[3]))
        check(f"phase{phase} plen{suffix} at n={N_MAIN} outputs unchanged",
              torch.equal(got[0], base[0]) and torch.equal(got[1], base[1]))
        windows = int(want[3].sum())
        p1 = 0 if key_words == 1 else walk_windows(
            torch, planes[0], keys, kw["seed"], kw["scheme"],
            kw["max_probes"])[1]
        look_bytes = (windows * 4 * WINDOW + p1 * 32
                      + N_MAIN * (32 + 4 * key_words + 5))
        plen_bytes = look_bytes + 4 * N_MAIN
        off, on = off1 + off2, on1 + on2
        lines.append(
            f"cops_lookup{suffix} of every key without plen {spread(off)}, "
            f"with plen {spread(on)} "
            f"({statistics.median(on) / statistics.median(off) - 1:+.2%}; "
            f"runs in turns: without {statistics.median(off1):.3f} / "
            f"{statistics.median(off2):.3f}, with "
            f"{statistics.median(on1):.3f} / {statistics.median(on2):.3f}), "
            f"bound without {look_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms, "
            f"with {plen_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; mean probe "
            f"length {windows / N_MAIN:.4f}")
        del keys, table, planes, base, got, want
        torch.cuda.empty_cache()
    print(f"phase {phase} lookup probe lengths vs plain: "
          f"{check.status(since)}; {n_cases} cases ({N_CHECK} keys rho="
          f"{RHO}, 2^12 slots with num_rows + 3 on a store without EMPTY, "
          f"batches "
          f"of {PLEN_BATCHES}) in {case_s:.1f} s; at n={N_MAIN} W={WINDOW} "
          f"cops: " + "; ".join(lines) + f"; card {card}", flush=True)


def telemetry_path(torch, card, check, phase):
    """Phase 25: ``stats=True`` on the main paths.  fig5's cells (N_MAIN
    distinct u32 keys, then u64 keys, into ``create(N_MAIN / RHO)``, W =
    32, cops): ``sv.insert`` and ``sv.retrieve`` with and without stats;
    fig9's group-by rows (N_REL keys uniform in [1, 2^25]) through
    ``counting.insert``; the wc-oa r = 8 table through
    ``mv.count_values``.  Each ``TableStats`` is held to the run: the
    status histogram to a ``bincount`` of the statuses, the slot census to
    a count over key plane 0, and the probe sum, count and histogram to
    the plain walk of the same store (``walk_lengths``, ``probe_walks``)
    of the batch's distinct keys; the outputs to the same call's without
    stats (the same statuses, the same live map).  Each call timed with
    and without stats (median of 5 after a warm-up), each cell's mean /
    p50 / p99 probe length printed.  The counters are zeroed just before
    and read just after: the bolt-on walks are lookup launches."""
    from repro_torch.core import bulk, counting, multi_value as mv
    from repro_torch.core import single_value as sv
    from repro_torch.core.common import (
        EMPTY_WORD, STATUS_INSERTED, TOMBSTONE_WORD)
    from repro_torch.kernels.cops import contract, ops
    from repro_torch.obs import metrics
    from repro_torch.relational import groupby
    since = len(check.failed)
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()

    def held(tag, st, table, walkers, status=None, lengths=None):
        """Hold ``st`` to the run; returns the plain walk's lengths."""
        kp0 = table.store["keys"][0]
        want_status = (torch.zeros(metrics.NUM_STATUS, dtype=torch.int64,
                                   device="cuda") if status is None else
                       torch.bincount(status.long(),
                                      minlength=metrics.NUM_STATUS))
        check(f"phase{phase} {tag} status_hist",
              torch.equal(st.status_hist, want_status))
        live = int(((kp0 != EMPTY_WORD) & (kp0 != TOMBSTONE_WORD)).sum())
        check(f"phase{phase} {tag} slot census",
              int(st.live_slots) == live
              and int(st.tombstone_slots) == int((kp0 == TOMBSTONE_WORD)
                                                 .sum())
              and abs(float(st.load_factor) - live / table.capacity) < 1e-6)
        if lengths is None:
            lengths = walk_lengths(torch, contract.table_planes(table)[0],
                                   walkers, table.seed, table.scheme,
                                   bulk._tstatic(table)[3])
        check(f"phase{phase} {tag} probe_sum / probe_n",
              int(st.probe_sum) == int(lengths.sum())
              and int(st.probe_n) == walkers.shape[0])
        check(f"phase{phase} {tag} probe_hist",
              torch.equal(st.probe_hist, length_hist(torch, lengths)))
        check(f"phase{phase} {tag} fixpoint_iters 0",
              int(st.fixpoint_iters) == 0)
        return lengths

    def cost(off_t, on_t):
        off, on = statistics.median(off_t), statistics.median(on_t)
        return (f"stats=False {spread(off_t)}, stats=True {spread(on_t)} "
                f"({on / off - 1:+.1%})")

    def probe(st):
        return (f"probe length mean {st.mean_probe_len():.4f} p50 "
                f"{st.probe_quantile(0.5):g} p99 {st.probe_quantile(0.99):g}")

    for key_words in (1, 2):
        tag = "fig5 u32" if key_words == 1 else "fig5 u64"
        keys = (contract.distinct_keys(0, N_MAIN, "cuda") if key_words == 1
                else contract.distinct_keys64(0, N_MAIN, "cuda"))
        vals = contract.values_for(keys, 1)

        def fresh():
            return (sv.create(int(N_MAIN / RHO), window=WINDOW,
                              device="cuda", key_words=key_words),)

        off_t, (t_off, s_off) = timed(torch, lambda t: sv.insert(t, keys,
                                                                 vals), fresh)
        on_t, (t_on, s_on, st) = timed(
            torch, lambda t: sv.insert(t, keys, vals, stats=True), fresh)
        check(f"phase{phase} {tag} insert statuses as without stats",
              torch.equal(s_on, s_off)
              and bool((s_on == STATUS_INSERTED).all()))
        v_off, f_off = sv.retrieve(t_off, keys)
        check(f"phase{phase} {tag} insert live map as without stats",
              t_on.count == t_off.count == N_MAIN and bool(f_off.all())
              and torch.equal(v_off, vals))
        del t_off, s_off, v_off, f_off
        lengths = held(f"{tag} sv.insert", st, t_on, keys, s_on)
        ins_line = f"sv.insert {cost(off_t, on_t)}, {probe(st)}"
        roff_t, (v_off, f_off) = timed(torch, lambda: sv.retrieve(t_on, keys))
        ron_t, (v_on, f_on, rst) = timed(
            torch, lambda: sv.retrieve(t_on, keys, stats=True))
        check(f"phase{phase} {tag} retrieve outputs as without stats",
              torch.equal(v_on, v_off) and torch.equal(f_on, f_off)
              and torch.equal(v_on, vals) and bool(f_on.all()))
        held(f"{tag} sv.retrieve", rst, t_on, keys, lengths=lengths)
        lines.append(f"{tag}: {ins_line}; sv.retrieve {cost(roff_t, ron_t)}"
                     f", {probe(rst)}")
        del keys, vals, t_on, s_on, lengths, v_off, f_off, v_on, f_on
        torch.cuda.empty_cache()

    # fig9's group-by rows through the counting table
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    rows = torch.randint(1, REL_GROUPS[-1] + 1, (N_REL,), dtype=torch.int32,
                         generator=gen, device="cuda")
    uk, ucnt = torch.unique(rows, return_counts=True)

    def fresh_counting():
        return (counting.create(groupby.capacity_for(REL_GROUPS[-1]),
                                window=WINDOW, device="cuda"),)

    off_t, (c_off, s_off) = timed(torch, lambda t: counting.insert(t, rows),
                                  fresh_counting)
    on_t, (c_on, s_on, st) = timed(
        torch, lambda t: counting.insert(t, rows, stats=True), fresh_counting)
    check(f"phase{phase} counting statuses as without stats",
          torch.equal(s_on, s_off))
    got = counting.counts(c_on, uk)
    check(f"phase{phase} counting counts exact",
          torch.equal(got, ucnt.to(torch.int32))
          and torch.equal(counting.counts(c_off, uk), got))
    held("fig9 counting.insert", st, c_on, uk, s_on)
    lines.append(f"fig9 counting.insert n={N_REL} g={REL_GROUPS[-1]} "
                 f"({uk.shape[0]} keys): {cost(off_t, on_t)}, {probe(st)}")
    del rows, uk, ucnt, c_off, c_on, s_off, s_on, got
    torch.cuda.empty_cache()

    # the wc-oa r = 8 cell through the counting pass
    base = contract.distinct_keys(0, N_MV // R_MV, "cuda")
    mtab = mv.create(int(N_MV / contract.LOAD), window=WINDOW,
                     device="cuda")
    mtab, _ = mv.insert(mtab, base.repeat_interleave(R_MV),
                        torch.arange(N_MV, dtype=torch.int32, device="cuda"))
    off_t, c_off = timed(torch, lambda: mv.count_values(mtab, base))
    on_t, (c_on, st) = timed(torch, lambda: mv.count_values(mtab, base,
                                                            stats=True))
    check(f"phase{phase} wc-oa counts as without stats",
          torch.equal(c_on, c_off) and bool((c_on == R_MV).all()))
    held("wc-oa mv.count_values", st, mtab, base)
    lines.append(f"fig7 wc-oa r={R_MV} mv.count_values of {base.shape[0]} "
                 f"keys: {cost(off_t, on_t)}, {probe(st)}")
    del base, mtab, c_off, c_on
    torch.cuda.synchronize()
    launches = path_counts(ops)
    for name in ("cops_lookup", "cops_lookup64"):
        check(f"phase{phase} {name} launched on the path", launches[name] > 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    print(f"phase {phase} telemetry (stats=True): {check.status(since)}; "
          + "; ".join(lines) + f" (5 runs each after a warm-up, CUDA events"
          f"); peak {peak:.1f} GB; launches {launches}; card {card}",
          flush=True)


def growth_path(torch, card, check, phase):
    """Phase 26: ``insert_or_grow`` at full width under
    ``GrowthPolicy(max_capacity=GROW_CAP)``: fig5's N_MAIN distinct u32
    keys in GROW_BATCHES batches into ``sv.create(GROW_START)`` (no element
    FULL, at least one grow, the final capacity at least live / 0.85, every
    key retrieved with its value), then erases past the tombstone density
    and one more batch, which must compact first and keep every live key;
    fig9's N_REL group-by rows in 8 batches through
    ``counting.insert_or_grow`` from ``counting.create(2^20)`` (counts
    equal to a ``torch.unique`` count); wc-oa's N_MV pairs in 8 batches
    through ``mv.insert_or_grow`` from ``mv.create(GROW_START)``
    (``retrieve_all``'s counts and offsets equal to ``pair_reference``'s,
    each key's values as a multiset).  Each stream timed on
    the host clock around synchronised work, its migrations (``grow`` /
    ``compact``, wrapped) apart."""
    from repro_torch.core import counting, migrate, multi_value as mv
    from repro_torch.core import single_value as sv
    from repro_torch.core.common import STATUS_FULL
    from repro_torch.kernels.cops import contract, ops
    from repro_torch.obs.registry import REGISTRY
    since = len(check.failed)
    policy = migrate.GrowthPolicy(max_capacity=GROW_CAP)
    spent = {"ms": 0.0, "n": 0}
    grow, compact = migrate.grow, migrate.compact

    def clocked(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent["ms"] += (time.perf_counter() - t0) * 1e3
            spent["n"] += 1
            return out
        return run

    def counters():
        return [REGISTRY.counter(n).value
                for n in ("table.grows", "table.compactions")]

    def stream(insert, table, batches):
        """(table, FULL elements, ms, migration ms, migrations) of the
        batches through ``insert``."""
        spent.update(ms=0.0, n=0)
        full = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            table, st = insert(table, *batch)
            full += int((st == STATUS_FULL).sum())
        torch.cuda.synchronize()
        return (table, full, (time.perf_counter() - t0) * 1e3, spent["ms"],
                spent["n"])

    migrate.grow, migrate.compact = clocked(grow), clocked(compact)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    lines = []
    try:
        keys = contract.distinct_keys(0, N_MAIN, "cuda")
        vals = contract.values_for(keys, 1)
        step = N_MAIN // GROW_BATCHES
        g0 = counters()
        table, full, ms, mig_ms, mig_n = stream(
            lambda t, k, v: sv.insert_or_grow(t, k, v, policy=policy),
            sv.create(GROW_START, window=WINDOW, device="cuda"),
            [(keys[i:i + step], vals[i:i + step])
             for i in range(0, N_MAIN, step)])
        grows = counters()[0] - g0[0]
        check(f"phase{phase} sv stream no FULL", full == 0)
        check(f"phase{phase} sv stream grew", grows >= 1)
        check(f"phase{phase} sv stream count", table.count == N_MAIN)
        check(f"phase{phase} sv stream capacity >= live / 0.85",
              table.capacity >= table.count / policy.max_load_factor)
        got, found = sv.retrieve(table, keys)
        check(f"phase{phase} sv stream every key retrieved",
              bool(found.all()) and torch.equal(got, vals))
        del got, found
        lines.append(f"sv.insert_or_grow of {N_MAIN} keys in {GROW_BATCHES}"
                     f" batches from create({GROW_START}): {ms:.1f} ms, of "
                     f"which {mig_n} migrations {mig_ms:.1f} ms ({grows:g} "
                     f"grows), capacity {table.capacity}, load "
                     f"{table.count / table.capacity:.4f}")
        # tombstones past the policy's density, then one more batch
        n_gone = int(policy.max_tombstone_density * table.capacity) + step
        table, erased = sv.erase(table, keys[:n_gone])
        check(f"phase{phase} sv erase", bool(erased.all()))
        more = contract.distinct_keys(N_MAIN, step, "cuda")
        c0 = counters()[1]
        table, full, ms, mig_ms, mig_n = stream(
            lambda t, k, v: sv.insert_or_grow(t, k, v, policy=policy),
            table, [(more, contract.values_for(more, 1))])
        check(f"phase{phase} sv batch after erases compacted",
              counters()[1] == c0 + 1 and full == 0)
        check(f"phase{phase} sv live keys after the compaction",
              table.count == N_MAIN - n_gone + step
              and migrate.occupancy(table)[1] == 0)
        got, found = sv.retrieve(table, keys[n_gone:])
        ok = bool(found.all()) and torch.equal(got, vals[n_gone:])
        got, found = sv.retrieve(table, more)
        check(f"phase{phase} sv every live key retrieved after it",
              ok and bool(found.all())
              and torch.equal(got, contract.values_for(more, 1)))
        lines.append(f"erase of {n_gone} keys, then a batch of {step}: "
                     f"{ms:.1f} ms, of which {mig_n} compaction "
                     f"{mig_ms:.1f} ms")
        del keys, vals, table, erased, more, got, found
        torch.cuda.empty_cache()

        gen = torch.Generator(device="cuda")
        gen.manual_seed(26)
        rows = torch.randint(1, REL_GROUPS[-1] + 1, (N_REL,),
                             dtype=torch.int32, generator=gen, device="cuda")
        step = N_REL // 8
        g0 = counters()
        table, full, ms, mig_ms, mig_n = stream(
            lambda t, k: counting.insert_or_grow(t, k, policy=policy),
            counting.create(2 ** 20, window=WINDOW, device="cuda"),
            [(rows[i:i + step],) for i in range(0, N_REL, step)])
        uk, ucnt = torch.unique(rows, return_counts=True)
        check(f"phase{phase} counting stream no FULL", full == 0)
        check(f"phase{phase} counting stream counts exact",
              table.count == uk.shape[0] and torch.equal(
                  counting.counts(table, uk), ucnt.to(torch.int32)))
        lines.append(f"counting.insert_or_grow of {N_REL} rows "
                     f"({uk.shape[0]} keys) in 8 batches from create(2^20):"
                     f" {ms:.1f} ms, of which {mig_n} migrations "
                     f"{mig_ms:.1f} ms ({counters()[0] - g0[0]:g} grows), "
                     f"capacity {table.capacity}")
        del rows, uk, ucnt, table
        torch.cuda.empty_cache()

        base = contract.distinct_keys(0, N_MV // R_MV, "cuda")
        mkeys = base.repeat_interleave(R_MV)
        mvals = torch.arange(N_MV, dtype=torch.int32, device="cuda")
        step = N_MV // 8
        g0 = counters()
        table, full, ms, mig_ms, mig_n = stream(
            lambda t, k, v: mv.insert_or_grow(t, k, v, policy=policy),
            mv.create(GROW_START, window=WINDOW, device="cuda"),
            [(mkeys[i:i + step], mvals[i:i + step])
             for i in range(0, N_MV, step)])
        check(f"phase{phase} mv stream no FULL", full == 0)
        check(f"phase{phase} mv stream count", table.count == N_MV)
        # a migration re-inserts the sweep in slot order, so a key whose
        # pairs span windows of a walk that wraps past row 0 keeps its
        # values but not their order (as the reference's): per-key
        # multisets, the ROADMAP's multi-value contract
        got = mv.retrieve_all(table, base, N_MV)
        want = pair_reference(torch, mkeys, mvals, base)
        check(f"phase{phase} mv stream retrieve_all counts and offsets",
              torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])
              and bool((got[2] == R_MV).all()))
        check(f"phase{phase} mv stream retrieve_all per-key values",
              torch.equal(got[0].view(-1, R_MV).sort(dim=1).values,
                          want[0].view(-1, R_MV).sort(dim=1).values))
        del got, want
        lines.append(f"mv.insert_or_grow of wc-oa's {N_MV} pairs (r = "
                     f"{R_MV}) in 8 batches from create({GROW_START}): "
                     f"{ms:.1f} ms, of which {mig_n} migrations "
                     f"{mig_ms:.1f} ms ({counters()[0] - g0[0]:g} grows), "
                     f"capacity {table.capacity}")
        del base, mkeys, mvals, table
    finally:
        migrate.grow, migrate.compact = grow, compact
    torch.cuda.synchronize()
    launches = path_counts(ops)
    for name in ("cops_insert", "cops_append", "cops_update",
                 "cops_lookup", "cops_retrieve"):
        check(f"phase{phase} {name} launched on the growth path",
              launches[name] > 0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    print(f"phase {phase} growth (insert_or_grow, GrowthPolicy(max_capacity="
          f"{GROW_CAP})): {check.status(since)}; " + "; ".join(lines)
          + f" (host clock around synchronised work); peak {peak:.1f} GB; "
          f"launches {launches}; card {card}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.cops import contract

    check = Checks()
    dev = "cuda"
    n_keys = N_MV // R_MV

    # -- phase 1: the card and the build ------------------------------------
    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"phase 1 build: {sorted(built)} in "
          f"{time.perf_counter() - t0:.2f} s (concurrent nvcc)", flush=True)

    # -- phases 2-4: the u32 single-value path ------------------------------
    single_cases(torch, check, 2, key_words=1)
    keys = contract.distinct_keys(0, N_MAIN, dev)
    vals = contract.values_for(keys, 1)
    absent = contract.distinct_keys(N_MAIN + 2, N_SIDE, dev)
    launches, kw, fresh = single_value_path(torch, card, check, 3, keys, vals,
                                            absent)
    records = single_value_kernels(torch, card, check, 4, keys, vals, absent,
                                   kw, fresh, launches)
    del keys, vals, absent

    # -- phases 5-7: the u32 multi-value path (fig7 wc-oa, r = 8) ----------
    multi_cases(torch, check, 5, MV_CASES, key_words=1)
    pool = contract.distinct_keys(0, n_keys + N_MV_ABSENT, dev)
    launches, kw, fresh, keys, vals = multi_value_path(
        torch, card, check, 6, pool[:n_keys], pool[n_keys:])
    records += multi_value_kernels(torch, card, check, 7, pool[:n_keys],
                                   keys, vals, kw, fresh, launches)
    del pool, keys, vals
    torch.cuda.empty_cache()

    # -- phases 8-11: the u64 paths -----------------------------------------
    single_cases(torch, check, 8, key_words=2)
    multi_cases(torch, check, 8, [c for c in MV_CASES
                                  if c[0] == "wc-oa" and c[3] == R_MV],
                key_words=2)
    keys = contract.distinct_keys64(0, N_MAIN, dev)
    vals = contract.values_for(keys, 1)
    absent = contract.distinct_keys64(2 * N_MAIN, N_SIDE, dev)
    sv_launches, sv_kw, sv_fresh = single_value_path(
        torch, card, check, 9, keys, vals, absent)
    pool = contract.distinct_keys64(0, n_keys + N_MV_ABSENT, dev)
    mv_launches, mv_kw, mv_fresh, mkeys, mvals = multi_value_path(
        torch, card, check, 10, pool[:n_keys], pool[n_keys:])
    records += single_value_kernels(torch, card, check, 11, keys, vals,
                                    absent, sv_kw, sv_fresh, sv_launches)
    del keys, vals, absent
    records += multi_value_kernels(torch, card, check, 11, pool[:n_keys],
                                   mkeys, mvals, mv_kw, mv_fresh, mv_launches)
    del pool, mkeys, mvals
    torch.cuda.empty_cache()

    # -- phases 12-15: the bucket list and the metagenomics front end -------
    bucket_cases(torch, check, 12)
    kmer_cases(torch, check, 12)
    pool = contract.distinct_keys(0, n_keys + N_MV_ABSENT, dev)
    bl_launches, table = bucket_list_path(torch, card, check, 13,
                                          pool[:n_keys], pool[n_keys:])
    mg_launches, reads, mg_table, mg_queries = metagenomics_path(
        torch, card, check, 14)
    records += new_kernels(torch, card, check, 15, table, pool[:n_keys],
                           reads, bl_launches, mg_launches, mg_table,
                           mg_queries)
    del table, pool, reads, mg_table, mg_queries
    torch.cuda.empty_cache()

    # -- phases 16-18: the relational layer (fig9) -------------------------
    update_cases(torch, check, 16)
    rel_launches, batches = relational_path(torch, card, check, 17)
    torch.cuda.empty_cache()
    cmp_launches, (gc, gv) = composite_path(torch, card, check, 18)
    records.append(update_kernel(
        torch, card, check, 18,
        [(f"g={g}", *batches.pop(g), g) for g in REL_GROUPS[::-1]],
        rel_launches, "cops_update"))
    torch.cuda.empty_cache()
    from repro_torch.core.hashing import pack_columns
    records.append(update_kernel(
        torch, card, check, 18,
        [("composite", pack_columns(gc), gv, N_COMPOSITE // 8)],
        cmp_launches, "cops_update64"))
    del gc, gv, batches
    torch.cuda.empty_cache()

    # -- phases 19-21: the elastic service and the bloom kernels (fig12) ----
    err19 = bloom_cases(torch, check, 19)
    el_launches, err20 = elastic_path(torch, card, check, 20)
    torch.cuda.empty_cache()
    records += bloom_kernels(torch, card, check, 21, el_launches,
                             max(err19, err20))
    torch.cuda.empty_cache()

    # -- phases 22-23: flash attention at starcoder2-3b's widths -----------
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version: f32
    torch.backends.cudnn.allow_tf32 = False
    err22 = flash_cases(torch, check, 22)
    records.append(flash_path(torch, card, check, 23, err22))
    torch.cuda.empty_cache()

    # -- phases 24-26: telemetry and growth (item 8) ------------------------
    plen_cases(torch, card, check, 24)
    telemetry_path(torch, card, check, 25)
    growth_path(torch, card, check, 26)

    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    if check.failed:
        print(f"chip_smoke: FAILED {check.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--upsert-launches"]:
        sys.exit(retrieve_launches_main(int(sys.argv[2]))
                 if sys.argv[3:4] == ["retrieve"]
                 else upsert_launches_main(int(sys.argv[2])))
    sys.exit(main())
