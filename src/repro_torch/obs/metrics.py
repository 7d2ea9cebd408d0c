"""Table telemetry: the ``TableStats`` record of ``stats=True``.

The port of ``repro.obs.metrics`` (its ``TableStats`` and the functions
that build one).  The single-value, counting and multi-value entry points
(``single_value.insert`` / ``retrieve`` / ``update_values``,
``counting.insert`` / ``counts``, ``multi_value.insert`` / ``count_values``
/ ``retrieve_all``) take ``stats: bool = False``; with ``True`` they
return a ``TableStats`` beside their usual results.  The bucket list
refuses ``stats=True`` (ROADMAP.md queue 1 item 5b).

Semantics are those of the JAX package's ``"pallas"`` backend, whose ops
run a kernel as the port's do: the operation runs **unchanged** (its
outputs and store are bit-exact with ``stats=False``), then
``bolt_on_stats`` measures probe lengths with a read-only walk of the
batch's distinct live keys against the post-op store.  That walk is the
lookup kernel's ``PLEN`` instantiation (``kernels.cops.ops.lookup(...,
plen=True)``) on a CUDA table, its plain version
(``bulk.probe_matches(stats=True)``) on a CPU table; nothing walks in
torch on the card.

Conventions (the reference's):

- **probe length** = probe windows an element's walk examined before it
  stopped at a match or at a window holding an EMPTY; a walk that spends
  its budget reports the budget.  Only the first live occurrence of each
  distinct key walks; masked and duplicate elements are excluded.  A
  multi-value walk stops at its key's first pair (the ``"pallas"``
  backend's count, not the ``"jax"`` engine's walk to the first EMPTY
  window).
- **probe histogram**: bin i counts lengths in ``(2^(i-1), 2^i]`` (bin 0
  = length 1), the last bin open-ended; ``probe_sum`` / ``probe_n`` hold
  the exact first moment.
- **status histogram**, indexed by the STATUS_* codes (INSERTED = 0 ..
  POOL_FULL = 4); zero for pure retrievals.
- **fixpoint_iters** is 0 throughout: the port's kernels place claims
  with atomics and run no arbitration sweep (``bulk.place_claims`` is only
  the plain version's).  Where the reference runs its engine under the
  ``"pallas"`` backend (``update_values`` and so ``counting.insert``) it
  counts its sweeps there; that is the one field in which the two differ.
- **live / tombstone slots, load factor**: a census of key plane 0 of the
  post-op store.

The fields are torch tensors on the table's device.  Building them reads
back to the host only what the walk's batch needs (the grouping's
duplicate test in ``bulk._group_fast`` and the representatives' count);
the fields themselves stay on the card until a reader (``mean_probe_len``,
``probe_quantile``, ``as_dict``) asks for them.  Counts are int64:
the reference's int32 ``probe_sum`` wraps past 2^31 windows, which 2^28
keys reach at a mean of 8; below that the values are the reference's.
``StreamCounters`` is not ported (ROADMAP.md queue 1 item 10, streaming).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.common import EMPTY_WORD, TOMBSTONE_WORD

NUM_STATUS = 5                       # INSERTED/UPDATED/FULL/MASKED/POOL_FULL
NUM_PROBE_BINS = 16                  # bin i <=> probe length in (2^(i-1), 2^i]
_EDGES = (2 ** np.arange(NUM_PROBE_BINS)).astype(np.int32)   # 1,2,4,...,2^15

_I64 = torch.int64


@dataclasses.dataclass
class TableStats:
    """Per-op telemetry, every field a tensor on the table's device."""
    status_hist: torch.Tensor        # (NUM_STATUS,) int64
    probe_hist: torch.Tensor         # (NUM_PROBE_BINS,) int64
    probe_sum: torch.Tensor          # int64 — sum of probe lengths
    probe_n: torch.Tensor            # int64 — number of walking elements
    fixpoint_iters: torch.Tensor     # int64 — always 0 (see the module)
    live_slots: torch.Tensor         # int64
    tombstone_slots: torch.Tensor    # int64
    load_factor: torch.Tensor        # float32 — live / capacity

    # -- host-side readers ---------------------------------------------------
    def mean_probe_len(self) -> float:
        n = int(self.probe_n)
        return float(self.probe_sum) / n if n else 0.0

    def probe_quantile(self, q: float) -> float:
        """Approximate quantile from the histogram (upper bin edge)."""
        hist = self.probe_hist.cpu().numpy()
        total = int(hist.sum())
        if total == 0:
            return 0.0
        cum = np.cumsum(hist)
        i = int(np.searchsorted(cum, q * total, side="left"))
        return float(_EDGES[min(i, NUM_PROBE_BINS - 1)])

    def as_dict(self) -> dict:
        """Plain-python rendering (for JSON rows / report tables)."""
        return {
            "status_hist": [int(x) for x in self.status_hist.tolist()],
            "probe_len_mean": self.mean_probe_len(),
            "probe_len_p50": self.probe_quantile(0.50),
            "probe_len_p99": self.probe_quantile(0.99),
            "fixpoint_iters": int(self.fixpoint_iters),
            "live_slots": int(self.live_slots),
            "tombstone_slots": int(self.tombstone_slots),
            "load_factor": float(self.load_factor),
        }


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=_I64, device=device)


def empty(device="cpu") -> TableStats:
    return TableStats(
        status_hist=torch.zeros((NUM_STATUS,), dtype=_I64, device=device),
        probe_hist=torch.zeros((NUM_PROBE_BINS,), dtype=_I64, device=device),
        probe_sum=_zero(device), probe_n=_zero(device),
        fixpoint_iters=_zero(device), live_slots=_zero(device),
        tombstone_slots=_zero(device),
        load_factor=torch.zeros((), dtype=torch.float32, device=device))


def _bincount(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """Counts of ``idx`` in [0, bins) as (bins,) int64 (other values are
    dropped): a comparison and a sum a bin.  ``torch.bincount`` reads its
    range back to the host on CUDA, and a scatter-add of n ones into a few
    counters serialises on their atomics (~0.25 s for 2^28 elements on an
    H100); a bin's pass reads the batch once."""
    return torch.stack([(idx == i).sum(dtype=_I64) for i in range(bins)])


def status_hist(status: torch.Tensor) -> torch.Tensor:
    """(n,) STATUS_* codes -> (NUM_STATUS,) counts."""
    return _bincount(status.clamp(0, NUM_STATUS - 1), NUM_STATUS)


def probe_hist(plen: torch.Tensor, active: torch.Tensor | None = None):
    """Bin probe lengths of ``active`` elements (None: every element) into
    the power-of-two histogram.  Returns (hist, probe_sum, probe_n)."""
    counted = plen > 0
    if active is not None:
        counted &= active
    edges = torch.as_tensor(_EDGES, dtype=plen.dtype, device=plen.device)
    # bin = first i with plen <= 2^i  (length 1 -> bin 0)
    b = torch.bucketize(plen, edges, out_int32=True)
    b = torch.where(counted, b.clamp(max=NUM_PROBE_BINS - 1), NUM_PROBE_BINS)
    return (_bincount(b, NUM_PROBE_BINS),
            torch.where(counted, plen, 0).sum(dtype=_I64),
            counted.sum(dtype=_I64))


def slot_stats(ops, store):
    """Census of key plane 0: (live, tombstones, load_factor)."""
    kp0 = ops.key_planes(store)[0]
    live = ((kp0 != EMPTY_WORD) & (kp0 != TOMBSTONE_WORD)).sum(dtype=_I64)
    tomb = (kp0 == TOMBSTONE_WORD).sum(dtype=_I64)
    # the reference's f32 live / f32(capacity)
    cap = torch.tensor(max(ops.num_rows * ops.window, 1), dtype=torch.float32,
                       device=kp0.device)
    return live, tomb, live.to(torch.float32) / cap


def table_stats(ops, store, *, status=None, plen=None, active=None,
                fixpoint_iters=None) -> TableStats:
    """Assemble a ``TableStats`` from whatever an op measured.

    ``store`` is the *post-op* store (slot census); any of the walk-level
    inputs may be omitted (pure retrieval has no statuses)."""
    dev = ops.key_planes(store).device
    st = empty(dev)
    live, tomb, lf = slot_stats(ops, store)
    sh = st.status_hist if status is None else status_hist(status)
    if plen is not None:
        ph, ps, pn = probe_hist(plen, active)
    else:
        ph, ps, pn = st.probe_hist, st.probe_sum, st.probe_n
    fx = (st.fixpoint_iters if fixpoint_iters is None
          else torch.as_tensor(fixpoint_iters, dtype=_I64, device=dev))
    return TableStats(status_hist=sh, probe_hist=ph, probe_sum=ps,
                      probe_n=pn, fixpoint_iters=fx, live_slots=live,
                      tombstone_slots=tomb, load_factor=lf)


def merge(a: TableStats, b: TableStats) -> TableStats:
    """Accumulate two ops' stats (slot census / load factor taken from b,
    the later op)."""
    return TableStats(
        status_hist=a.status_hist + b.status_hist,
        probe_hist=a.probe_hist + b.probe_hist,
        probe_sum=a.probe_sum + b.probe_sum,
        probe_n=a.probe_n + b.probe_n,
        fixpoint_iters=a.fixpoint_iters + b.fixpoint_iters,
        live_slots=b.live_slots, tombstone_slots=b.tombstone_slots,
        load_factor=b.load_factor)


def measure_probe_lengths(table, keys: torch.Tensor,
                          active: torch.Tensor | None = None) -> torch.Tensor:
    """Bolt-on probe-length measurement: (n,) int32, each ``active`` key's
    windows examined by a read-only walk against the table's store to its
    match or its first window holding an EMPTY, 0 elsewhere.  Only the
    active keys (None: every key) walk, through ``kernels.cops.ops.lookup(
    ..., plen=True)`` (``lookup64`` for two-word keys), the ``PLEN`` kernel
    on the card."""
    from repro_torch.core import bulk
    _, scheme, seed, max_probes = bulk._tstatic(table)
    lookup, table_keys = bulk._cops(table, "lookup")

    def walk(k):
        return lookup(table_keys, None, k, seed=seed, scheme=scheme,
                      max_probes=max_probes, plen=True)[3]

    if active is None:
        return walk(keys)
    idx = torch.nonzero(active).squeeze(1)
    plen = torch.zeros(active.shape, dtype=torch.int32, device=keys.device)
    plen[idx] = walk(keys[idx])
    return plen


def bolt_on_stats(table, keys, status=None, mask=None) -> TableStats:
    """TableStats for an op that ran unchanged (the reference's scan and
    pallas backends, and every port op).

    ``keys`` is the op's normalized batch ((n,) or (n, 2) int32 words on
    the table's device) and ``mask`` its live mask (None: every element).
    Groups the batch like the bulk engines (one walking representative per
    distinct live key: ``bulk._group_fast``, the grouping of
    ``bulk_retrieve.group_queries``) and measures their probe lengths
    against the post-op store; a batch with no mask and no duplicate walks
    as it is.  The status histogram and the slot census come from the op's
    own outputs and state."""
    from repro_torch.core import bulk, bulk_retrieve
    n = keys.shape[0]
    if n == 0:
        return table_stats(table.ops, table.store, status=status)
    live = bulk_retrieve._live(n, mask, keys.device)
    is_rep, _, _, has_dups = bulk._group_fast(keys, live, last=False)
    walkers = is_rep if mask is not None or has_dups else None
    plen = measure_probe_lengths(table, keys, walkers)
    return table_stats(table.ops, table.store, status=status, plen=plen,
                       active=walkers)
