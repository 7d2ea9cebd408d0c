"""Elastic sharded serving: the table as a service.

The port of ``repro.serving.elastic``.  A :class:`ShardedTable` is P
same-geometry single-value shards in one process that

- **route** inserts, lookups and erases through the padded owner exchange
  (``core.exchange``: ``hash_owner`` of the folded key word, then
  ``make_plan`` / ``scatter_to_buffer``; with the shards in one process
  the buffer is the post-all-to-all layout, axis 0 the shard);
- **filter** lookups through per-shard blocked bloom filters
  (``core.bloom``): each query is admission-tested against its owner's
  filter *before* routing, so an absent key dies locally (a filter miss is
  proof of absence) and never takes an exchange slot.  Filters learn each
  inserted key incrementally and are rebuilt from the live set by
  ``compact_all``; an erase leaves them permissive (the bloom staleness
  contract);
- **checkpoint** through ``core.snapshot``: ``save`` / ``load`` write one
  versioned, checksummed snapshot per shard plus a manifest, and ``load``
  onto a different shard count reshards (``check_ownership`` asserts that
  every shard then holds exactly the keys it owns).

Differences from the reference:

- The P filters are one stacked ``(P, num_blocks, words)`` tensor of
  packed u32 words (``filter_words``), each ``BloomFilter`` of
  ``filters`` a view of one plane.  So ``insert`` updates every owner's
  filter in one ``bloom_insert`` launch (the reference calls
  ``bloom.insert`` once per shard with the mask ``owners == i``), and the
  admission test is one ``bloom_query`` launch.
- Shards and filters are updated **in place**; ``insert`` / ``erase``
  return the same service object.  The reference's donated ``jax.jit``
  serve step is a plain function here: nothing is traced, so there is no
  retrace check.
- ``lookup``'s ``stats`` are 0-d int32 tensors, as the reference's are
  arrays.

Shards live on the CUDA card unless ``create`` gets ``device="cpu"``.
Registry counters: ``elastic.bloom_probes`` / ``elastic.bloom_skips`` /
``elastic.bloom_false_positives`` / ``elastic.hits`` /
``elastic.reshards``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import torch

from repro_torch.core import bloom, exchange, hashing, migrate, snapshot
from repro_torch.core import single_value as sv
from repro_torch.core.common import DEFAULT_SEED, EMPTY_WORD, STATUS_MASKED
from repro_torch.kernels.bloom import ops as bloom_ops
from repro_torch.obs.registry import REGISTRY

#: manifest version for ``save``/``load`` directories
ELASTIC_VERSION = 1
_MANIFEST = "manifest.json"

#: the ``sv.create`` geometry that ``reshard`` copies from shard 0
_GEOMETRY = ("key_words", "value_words", "window", "scheme", "layout",
             "seed")


@dataclasses.dataclass
class ShardedTable:
    """P same-geometry single-value shards + their bloom filters.

    ``filter_words`` is the ``(P, num_blocks, words)`` stack the kernels
    work on; ``filters[i]`` is the ``BloomFilter`` whose words are its
    plane i.  ``slack`` is the exchange capacity factor.
    """
    shards: list               # P x sv.SingleValueHashTable
    filter_words: torch.Tensor
    filters: tuple             # P x bloom.BloomFilter (views of the stack)
    num_shards: int
    slack: float

    @property
    def key_words(self) -> int:
        return self.shards[0].key_words

    @property
    def value_words(self) -> int:
        return self.shards[0].value_words

    @property
    def device(self) -> torch.device:
        return self.filter_words.device


def _with_filters(shards, slack, num_blocks, block_bits, k, seed):
    """A service over ``shards`` with empty filters of one geometry."""
    p = len(shards)
    words = torch.zeros((p, num_blocks, block_bits // 32), dtype=torch.int32,
                        device=shards[0].device)
    filters = tuple(bloom.BloomFilter(words=words[i], num_blocks=num_blocks,
                                      block_bits=block_bits, k=k, seed=seed)
                    for i in range(p))
    return ShardedTable(shards=list(shards), filter_words=words,
                        filters=filters, num_shards=p, slack=slack)


def create(num_shards: int, capacity_per_shard: int, *,
           bloom_bits_per_key: int = 16, slack: float = 2.0,
           **table_kwargs) -> ShardedTable:
    """A fresh sharded service; ``table_kwargs`` pass to ``sv.create``
    (``device`` among them).  The filters have ``bloom.create``'s
    defaults: 512-bit blocks, k = 4."""
    shards = [sv.create(capacity_per_shard, **table_kwargs)
              for _ in range(num_shards)]
    num_blocks = bloom.num_blocks_for(bloom_bits_per_key * shards[0].capacity)
    return _with_filters(shards, slack, num_blocks, 512, 4, DEFAULT_SEED)


def count(st: ShardedTable) -> int:
    """Total live entries across shards."""
    return sum(t.count for t in st.shards)


# ---------------------------------------------------------------------------
# owner routing over the shards of one process
# ---------------------------------------------------------------------------

def _noop(_):
    pass


def _cap(st: ShardedTable, n: int) -> int:
    return int(math.ceil(n / st.num_shards * st.slack))


def _route(st: ShardedTable, keys, mask=None):
    """Normalized keys (and mask) -> (plan, (P, cap[, kw]) key buffer,
    (P, cap) valid, owners, words): ``owner_of -> make_plan -> scatter``;
    unused slots hold EMPTY."""
    words = sv.key_hash_word(keys)
    owners = hashing.hash_owner(words, st.num_shards)
    p, cap = st.num_shards, _cap(st, keys.shape[0])
    plan = exchange.make_plan(owners, p, cap, mask=mask)
    kbuf = exchange.scatter_to_buffer(plan, keys, p, fill=EMPTY_WORD)
    return (plan, kbuf.reshape(p, cap, *keys.shape[1:]),
            plan.valid_send.reshape(p, cap), owners, words)


def insert(st: ShardedTable, keys, values, mask=None, *, mark=_noop):
    """Route (key, value) pairs to their owners, insert, update filters.

    Returns ``(st, status)`` with ``status`` aligned to the input batch
    (``STATUS_MASKED`` for masked-out or overflowed elements).  Every
    unmasked key's folded word is set in its owner's filter, in one launch
    over the filter stack.  ``mark(name)`` is called after each part
    (``"route"``, ``"shard_insert"``, ``"bloom_insert"``, ``"gather"``): a
    hook for a caller that times them.
    """
    keys = sv.normalize_key_batch(keys, st.key_words, st.device)
    mask = sv.normalize_mask(mask, keys.shape[0], st.device)
    values = sv.normalize_words(values, st.value_words, "values", st.device)
    plan, kbuf, mbuf, owners, words = _route(st, keys, mask)
    p, cap = st.num_shards, plan.cap
    vbuf = exchange.scatter_to_buffer(plan, values, p) \
        .reshape(p, cap, *values.shape[1:])
    mark("route")
    statuses = []
    for i, t in enumerate(st.shards):
        st.shards[i], s = sv.insert(t, kbuf[i], vbuf[i], mask=mbuf[i])
        statuses.append(s)
    mark("shard_insert")
    f = st.filters[0]
    bloom_ops.insert_words(st.filter_words, bloom.key_batch(words, st.device),
                           mask, k_hashes=f.k, seed=f.seed, planes=owners)
    mark("bloom_insert")
    status = exchange.gather_from_buffer(plan, torch.cat(statuses),
                                         fill=STATUS_MASKED)
    mark("gather")
    return st, status


def lookup(st: ShardedTable, keys, *, mark=_noop):
    """Bloom-filtered sharded lookup.

    Each query is admission-tested against its owner shard's filter
    BEFORE routing; a filter miss is proof of absence, so the query is
    answered ``found=False`` locally and takes no exchange slot.  Returns
    ``(values, found, stats)``: ``stats`` holds ``probes`` (batch size),
    ``skips`` (queries the filter killed), ``hits`` (found),
    ``false_positives`` (admitted but not found: filter false positives
    plus erase staleness) and ``overflow``.  ``mark`` names
    ``"bloom_query"``, ``"route"``, ``"shard_lookup"`` and ``"gather"``.
    """
    keys_n = sv.normalize_key_batch(keys, st.key_words, st.device)
    words = sv.key_hash_word(keys_n)
    owners = hashing.hash_owner(words, st.num_shards)
    admit = bloom.contains_stack(st.filters[0], st.filter_words, owners,
                                 words)
    mark("bloom_query")
    p, cap = st.num_shards, _cap(st, keys_n.shape[0])
    plan = exchange.make_plan(owners, p, cap, mask=admit)
    kbuf = exchange.scatter_to_buffer(plan, keys_n, p, fill=EMPTY_WORD) \
        .reshape(p, cap, *keys_n.shape[1:])
    mark("route")
    vals, founds = [], []
    for t, kb in zip(st.shards, kbuf):
        v, fnd = sv.retrieve(t, kb)
        vals.append(v)
        founds.append(fnd)
    mark("shard_lookup")
    # skipped and unmapped queries take the gather fill: found=False, 0
    out_vals = exchange.gather_from_buffer(plan, torch.cat(vals))
    out_found = exchange.gather_from_buffer(plan, torch.cat(founds),
                                            fill=False)
    i32 = torch.int32
    stats = {"probes": torch.tensor(keys_n.shape[0], dtype=i32,
                                    device=st.device),
             "skips": (~admit).sum().to(i32),
             "hits": out_found.sum().to(i32),
             "false_positives": (admit & ~out_found).sum().to(i32),
             "overflow": plan.overflow}
    mark("gather")
    return out_vals, out_found, stats


def erase(st: ShardedTable, keys, *, mark=_noop):
    """Route erases to owners.  Filters are deliberately NOT touched — a
    bloom filter cannot delete (shared bits); the dead key keeps
    advertising until ``compact_all`` rebuilds from the live set.
    Returns ``(st, erased)`` aligned with the input batch.  ``mark``
    names ``"route"``, ``"shard_erase"`` and ``"gather"``.
    """
    plan, kbuf, mbuf, _, _ = _route(
        st, sv.normalize_key_batch(keys, st.key_words, st.device))
    mark("route")
    eras = []
    for i, t in enumerate(st.shards):
        st.shards[i], e = sv.erase(t, kbuf[i], mask=mbuf[i])
        eras.append(e)
    mark("shard_erase")
    erased = exchange.gather_from_buffer(plan, torch.cat(eras), fill=False)
    mark("gather")
    return st, erased


# ---------------------------------------------------------------------------
# maintenance: compaction (+ filter rebuild), resharding
# ---------------------------------------------------------------------------

def compact_all(st: ShardedTable) -> ShardedTable:
    """Compact every shard and rebuild its filter from the live set.

    This closes the bloom staleness loop: after the rebuild a shard's
    filter stops advertising erased keys, so the false-positive rate
    recovers to the live-set baseline.
    """
    st.shards = [migrate.compact(t) for t in st.shards]
    for f, t in zip(st.filters, st.shards):
        bloom.rebuild_from_table(f, t)
    return st


def check_ownership(st: ShardedTable) -> None:
    """Assert every shard holds exactly the keys it owns."""
    for i, t in enumerate(st.shards):
        keys, _, live = migrate.live_entries(t)
        owners = hashing.hash_owner(sv.key_hash_word(keys), st.num_shards)
        stray = int((live & (owners != i)).sum())
        if stray:
            raise AssertionError(
                f"shard {i} holds {stray} keys owned elsewhere — "
                "ownership partition violated")


def reshard(st: ShardedTable, new_num_shards: int, *,
            capacity_per_shard: int | None = None,
            bloom_bits_per_key: int = 16) -> ShardedTable:
    """Re-partition every live entry onto ``new_num_shards`` shards.

    Sweeps each shard's live set, concatenates, and replays the ownership
    exchange over the resized set of shards — ``hash_owner`` is a pure
    function of (key, P), so the new partition is exactly the one a fresh
    cluster of P' shards would build.  Filters are rebuilt tight.  The
    new shards copy shard 0's ``sv.create`` geometry (the port's tables
    have no ``backend``).  Raises if any live entry fails to land.
    """
    sweeps = [migrate.live_entries(t) for t in st.shards]
    keys = torch.cat([s[0] for s in sweeps])
    vals = torch.cat([s[1] for s in sweeps])
    live = torch.cat([s[2] for s in sweeps])
    total = int(live.sum())
    cap = capacity_per_shard or st.shards[0].capacity
    kw = {f: getattr(st.shards[0], f) for f in _GEOMETRY}
    # a whole-table sweep routed at once needs slack >= the skew ratio;
    # exact per-segment sizing keeps the reshard overflow-free
    n = keys.shape[0]
    owners = hashing.hash_owner(sv.key_hash_word(keys), new_num_shards)
    seg = int(torch.bincount(owners[live], minlength=new_num_shards).max()) \
        if total else 0
    reslack = max(st.slack, new_num_shards * max(seg, 1) / max(n, 1) * 1.01)
    fresh = create(new_num_shards, cap, bloom_bits_per_key=bloom_bits_per_key,
                   slack=reslack, device=st.device, **kw)
    fresh, _ = insert(fresh, keys, vals, mask=live)
    fresh.slack = st.slack
    landed = count(fresh)
    if landed != total:
        raise ValueError(
            f"reshard({st.num_shards}->{new_num_shards}) landed {landed} of "
            f"{total} live entries — raise capacity_per_shard")
    REGISTRY.counter("elastic.reshards").inc(1)
    return fresh


# ---------------------------------------------------------------------------
# checkpoint/restore (one snapshot per shard + manifest)
# ---------------------------------------------------------------------------

def save(st: ShardedTable, path: str, *,
         writer: snapshot.SnapshotWriter | None = None) -> None:
    """Checkpoint the service to directory ``path``: one ``core.snapshot``
    file per shard plus ``manifest.json`` (the shard count, slack and
    filter geometry), the reference's layout.  With ``writer`` the shard
    writes go through the async double-buffered path (call
    ``writer.flush()`` for durability); filters are derived state, rebuilt
    on load."""
    os.makedirs(path, exist_ok=True)
    f0 = st.filters[0]
    manifest = {"version": ELASTIC_VERSION, "num_shards": st.num_shards,
                "slack": st.slack,
                "bloom": {"num_blocks": f0.num_blocks,
                          "block_bits": f0.block_bits,
                          "k": f0.k, "seed": f0.seed}}
    tmp = os.path.join(path, f"{_MANIFEST}.tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh)
    os.replace(tmp, os.path.join(path, _MANIFEST))
    for i, t in enumerate(st.shards):
        dst = os.path.join(path, f"shard_{i}.snap")
        if writer is None:
            snapshot.save(t, dst)
        else:
            writer.save(t, dst)


def load(path: str, *, num_shards: int | None = None,
         capacity_per_shard: int | None = None, device=None) -> ShardedTable:
    """Restore a service from ``save`` output (either package's).

    Every shard restores bit-exactly and its filter is rebuilt from its
    live set; a different ``num_shards`` then reshards.  Raises
    :class:`~repro_torch.core.snapshot.SnapshotError` on torn or corrupted
    state — never a silently wrong service.
    """
    mf = os.path.join(path, _MANIFEST)
    if not os.path.exists(mf):
        raise snapshot.SnapshotError(f"no {_MANIFEST} in {path!r}")
    with open(mf) as fh:
        try:
            manifest = json.load(fh)
        except json.JSONDecodeError as e:
            raise snapshot.SnapshotError(
                f"corrupted {_MANIFEST} in {path!r}: {e}") from e
    if manifest.get("version") != ELASTIC_VERSION:
        raise snapshot.SnapshotError(
            f"unsupported elastic manifest version "
            f"{manifest.get('version')!r}")
    saved_p = manifest["num_shards"]
    shards = [snapshot.load(os.path.join(path, f"shard_{i}.snap"), device)
              for i in range(saved_p)]
    b = manifest["bloom"]
    st = _with_filters(shards, manifest["slack"], b["num_blocks"],
                       b["block_bits"], b["k"], b["seed"])
    for f, t in zip(st.filters, st.shards):
        bloom.rebuild_from_table(f, t)
    if num_shards is not None and num_shards != saved_p:
        bits_per_key = (b["num_blocks"] * b["block_bits"]
                        // max(shards[0].capacity, 1))
        st = reshard(st, num_shards, capacity_per_shard=capacity_per_shard,
                     bloom_bits_per_key=max(bits_per_key, 1))
    return st


# ---------------------------------------------------------------------------
# the serve step
# ---------------------------------------------------------------------------

def serve_step(st: ShardedTable, ins_keys, ins_vals, get_keys, del_keys, *,
               mark=_noop):
    """One mixed-traffic step: upsert a batch, answer a bloom-filtered
    lookup batch, erase a batch.  Returns ``(st, (status, values, found,
    erased, stats))``.

    The reference's step is one donated ``jax.jit`` graph with a
    zero-retrace contract; here it is a plain function that updates the
    shard stores and the filter stack in place, so nothing is copied per
    step and nothing is traced (there is no retrace to check).
    """
    st, status = insert(st, ins_keys, ins_vals, mark=mark)
    vals, found, stats = lookup(st, get_keys, mark=mark)
    st, erased = erase(st, del_keys, mark=mark)
    return st, (status, vals, found, erased, stats)


def serve_traffic(st: ShardedTable, traffic, *, tracer=None):
    """Drive the serve step closed-loop over a traffic iterable.

    ``traffic`` yields ``(ins_keys, ins_vals, get_keys, del_keys)``
    batches; each step starts when the last one ends (the reference's
    open-loop ``rate_hz`` pacing is not ported).  Every step is spanned
    (``elastic.serve_step``) and waits for the card before the span ends,
    so ``tracer.percentiles`` gives true p50/p95/p99.  Bloom counters
    accumulate into the global REGISTRY.  Returns ``(st, tracer, steps,
    totals)`` where ``totals`` sums the stats dicts; raises on exchange
    overflow (undersized ``slack``).
    """
    from repro_torch.obs.trace import Tracer

    if tracer is None:
        tracer = Tracer()
    steps = 0
    totals = {k: 0 for k in ("probes", "skips", "hits", "false_positives",
                             "overflow")}
    for batch in traffic:
        with tracer.span("elastic.serve_step", step=steps):
            st, outs = serve_step(st, *batch)
            if st.device.type == "cuda":
                torch.cuda.synchronize(st.device)
        for k in totals:
            totals[k] += int(outs[-1][k])
        if totals["overflow"]:
            raise AssertionError(
                "elastic exchange overflowed — raise ShardedTable.slack")
        steps += 1
    REGISTRY.counter("elastic.bloom_probes").inc(totals["probes"])
    REGISTRY.counter("elastic.bloom_skips").inc(totals["skips"])
    REGISTRY.counter("elastic.bloom_false_positives").inc(
        totals["false_positives"])
    REGISTRY.counter("elastic.hits").inc(totals["hits"])
    return st, tracer, steps, totals
