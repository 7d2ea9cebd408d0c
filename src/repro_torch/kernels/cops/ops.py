"""The COPS kernels' wrappers, their plain versions and launch counters.

The wrappers take the table's bare (p, W) int32 key (and value) planes
(SOA plane 0, u32 bits) and int32 word batches:

- ``insert`` (single-value upsert of distinct keys) -> ``cops_insert``;
- ``lookup`` (value, found, slot) -> ``cops_lookup``;
- ``append`` (multi-value append, every pair its own claimer) ->
  ``cops_append``;
- ``retrieve_walk`` (the multi-value walk: per-query match counts and,
  with ``collect``, the (query, rank) slot arena) -> ``cops_retrieve``.

On **CUDA** tensors a wrapper checks dtype, shape, device and contiguity,
launches its kernel (``csrc/cops.cu``, built by ``kernels.build``) on the
current stream, adds one to ``LAUNCHES``, and raises if the launch
reports a CUDA error.  On **CPU** tensors it runs its plain version below:
``insert_plain`` (the bulk engine's fast lane: probe -> virtual-fill
placement -> apply), ``lookup_plain`` (``bulk.probe_matches`` + a
gather), ``append_plain`` (virtual-fill placement of every pair, as
``repro.core.bulk.insert_multi``) and ``retrieve_walk_plain`` (the port of
``repro.core.bulk_retrieve.fused_walk``), each bit-exact against the JAX
engine.  On any other device it raises.  Nothing falls back: a CUDA
tensor never reaches a plain version.

The plain versions run on any device (``chip_smoke.py`` holds the kernels
against them on the card) and walk at most ``PLAIN_CHUNK`` keys at a
time: chunks in batch order give the same store and statuses as one
whole batch, since the engine replays sequential insert order, and the
read-only walk has no order to keep.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import bulk, layouts, probing
from repro_torch.core.common import (
    EMPTY_WORD,
    STATUS_FULL,
    STATUS_INSERTED,
    STATUS_UPDATED,
    SUPPORTED_WINDOWS,
    as_u32,
)

#: launches of each kernel since the last ``reset_launches``
LAUNCHES = {"cops_insert": 0, "cops_lookup": 0, "cops_append": 0,
            "cops_retrieve": 0}

#: keys per walk of the plain versions (bounds their (n, W) temporaries)
PLAIN_CHUNK = 1 << 22

_SCHEMES = ("cops", "linear")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _tstatic(planes, scheme, seed, max_probes):
    num_rows, window = planes.shape
    return (layouts.SoaOps(num_rows, window, 1, 1), scheme, seed, max_probes)


def insert_plain(table_keys, table_values, keys, values, *, seed, scheme,
                 max_probes, count):
    """Upsert DISTINCT keys into the planes, in place; status (m,) int32
    (INSERTED / UPDATED / FULL).  ``count`` is the store's live count
    before the batch (0 skips the match walk)."""
    tstat = _tstatic(table_keys, scheme, seed, max_probes)
    ops = tstat[0]
    store = {"keys": table_keys[None], "values": table_values[None]}
    status = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    for s in range(0, keys.shape[0], PLAIN_CHUNK):
        k, v = keys[s:s + PLAIN_CHUNK], values[s:s + PLAIN_CHUNK]
        words = as_u32(k)
        every = torch.ones(k.shape, dtype=torch.bool, device=k.device)
        matched, mrow, mlane = bulk.probe_matches(tstat, store, k, words,
                                                  every, count)
        placed, crow, clane, _ = bulk.place_claims(tstat, store, words,
                                                   ~matched)
        count += bulk._apply(ops, store, k, matched, mrow, mlane, placed,
                             crow, clane, v)
        status[s:s + PLAIN_CHUNK] = torch.where(
            matched, STATUS_UPDATED,
            torch.where(placed, STATUS_INSERTED, STATUS_FULL))
    return status


def lookup_plain(table_keys, table_values, keys, *, seed, scheme, max_probes,
                 slots=False):
    """``(values int32, found bool, slot int64 or None)``: each key's value
    (0 if absent) and flat slot ``row * W + lane`` (-1 if absent)."""
    tstat = _tstatic(table_keys, scheme, seed, max_probes)
    window = table_keys.shape[1]
    flat_v = table_values.reshape(-1)
    values = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    found = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    slot = torch.empty(keys.shape, dtype=torch.int64, device=keys.device)
    for s in range(0, keys.shape[0], PLAIN_CHUNK):
        k = keys[s:s + PLAIN_CHUNK]
        every = torch.ones(k.shape, dtype=torch.bool, device=k.device)
        matched, mrow, mlane = bulk.probe_matches(
            tstat, {"keys": table_keys[None]}, k, as_u32(k), every)
        at = torch.where(matched, mrow * window + mlane, -1)
        values[s:s + PLAIN_CHUNK] = torch.where(matched,
                                                flat_v[at.clamp(min=0)], 0)
        found[s:s + PLAIN_CHUNK] = matched
        slot[s:s + PLAIN_CHUNK] = at
    return values, found, (slot if slots else None)


def append_plain(table_keys, table_values, keys, values, *, seed, scheme,
                 max_probes):
    """Append every (key, value) pair into the planes, in place; status
    (m,) int32 (INSERTED / FULL).  Each pair claims the lowest EMPTY /
    TOMBSTONE lane of the first window of its walk that has one, in batch
    order (``bulk.place_claims`` with every element a claimer)."""
    tstat = _tstatic(table_keys, scheme, seed, max_probes)
    ops = tstat[0]
    store = {"keys": table_keys[None], "values": table_values[None]}
    status = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    for s in range(0, keys.shape[0], PLAIN_CHUNK):
        k, v = keys[s:s + PLAIN_CHUNK], values[s:s + PLAIN_CHUNK]
        every = torch.ones(k.shape, dtype=torch.bool, device=k.device)
        placed, row, lane, _ = bulk.place_claims(tstat, store, as_u32(k),
                                                 every)
        ops.scatter_batch(store, (row * ops.window + lane)[placed],
                          k[placed][:, None], v[placed][:, None],
                          every[placed])
        status[s:s + PLAIN_CHUNK] = torch.where(placed, STATUS_INSERTED,
                                                STATUS_FULL)
    return status


def retrieve_walk_plain(table_keys, keys, active, *, seed, scheme,
                        max_probes, collect):
    """``(counts int32 (n,), qarena, rank_arena)`` of the multi-value walk.

    Each active key walks to the first window holding an EMPTY (tombstones
    do not stop it) or to the budget, counting its matches.  With
    ``collect`` the two (p * W,) int32 arenas give, per slot, the batch
    index of the key that matched there (``n`` if none) and the match's
    rank in walk order (window by window, lane order within a window; 0
    if none); else both are None.  Active keys must be distinct.
    """
    num_rows, window = table_keys.shape
    n, dev = keys.shape[0], keys.device
    counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    qa = ra = None
    if collect:
        qa = torch.full((num_rows * window,), n, dtype=torch.int32, device=dev)
        ra = torch.zeros((num_rows * window,), dtype=torch.int32, device=dev)
    reps = torch.nonzero(active).squeeze(1)
    for s in range(0, reps.shape[0], PLAIN_CHUNK):
        act = reps[s:s + PLAIN_CHUNK]
        key = keys[act]
        words = as_u32(key)
        row = probing.initial_row(words, num_rows, seed)
        step = probing.row_step(scheme, words, num_rows, seed)
        seen = torch.zeros(act.shape, dtype=torch.int64, device=dev)
        for _ in range(max_probes):
            if act.numel() == 0:
                break
            win = table_keys[row]                                  # (m, W)
            match = win == key[:, None]
            if collect:
                rank = seen[:, None] + torch.cumsum(match, dim=1) - 1
                who, lane = torch.nonzero(match, as_tuple=True)
                slot = row[who] * window + lane
                qa[slot] = act[who].to(torch.int32)
                ra[slot] = rank[who, lane].to(torch.int32)
            nm = match.sum(dim=1)
            counts[act] += nm.to(torch.int32)
            seen += nm
            go = ~(win == EMPTY_WORD).any(dim=1)
            act, key, step, seen = act[go], key[go], step[go], seen[go]
            row = probing.advance_row(row[go], step, num_rows)
    return counts, qa, ra


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.library("cops")
    vp, ll, ui, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int
    lib.cops_insert.argtypes = [vp, vp, vp, vp, vp, ll, ui, i, ui, i, ll, vp]
    lib.cops_insert.restype = ctypes.c_int
    lib.cops_lookup.argtypes = [vp, vp, vp, vp, vp, vp, ll, ui, i, ui, i, ll,
                                vp]
    lib.cops_lookup.restype = ctypes.c_int
    lib.cops_append.argtypes = [vp, vp, vp, vp, vp, ll, ui, i, ui, i, ll, vp]
    lib.cops_append.restype = ctypes.c_int
    lib.cops_retrieve.argtypes = [vp, vp, vp, vp, vp, vp, ll, ui, i, ui, i,
                                  ll, vp]
    lib.cops_retrieve.restype = ctypes.c_int
    return lib


def _on_cpu(*tensors, masks=()) -> bool:
    """True for CPU tensors; validates CUDA tensors (int32 words, bool
    ``masks``) for a launch; raises on anything else."""
    devices = {t.device for t in (*tensors, *masks)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the COPS kernels run on CUDA or CPU tensors, not {dev}")
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"expected contiguous int32 tensors, got {t.dtype}"
                             f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    for m in masks:
        if m.dtype != torch.bool or not m.is_contiguous():
            raise ValueError(f"expected a contiguous bool mask, got {m.dtype}")
    return False


def _check_geometry(planes, keys, others, scheme):
    table_keys = planes[0]
    if table_keys.ndim != 2 or any(p.shape != table_keys.shape for p in planes):
        raise ValueError(f"planes must be equal (p, W) tensors, got "
                         f"{[tuple(p.shape) for p in planes]}")
    if table_keys.shape[0] >= 2 ** 31:
        raise ValueError("the kernels need fewer than 2^31 rows")
    if table_keys.shape[1] not in SUPPORTED_WINDOWS:
        raise ValueError(f"window {table_keys.shape[1]} not in {SUPPORTED_WINDOWS}")
    if keys.ndim != 1 or any(o.shape != keys.shape for o in others):
        raise ValueError("key, value and output batches must be equal (n,) tensors")
    if scheme not in _SCHEMES:
        raise ValueError(f"scheme {scheme!r} not in {_SCHEMES}")


def _launched(name: str, rc: int) -> None:
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def insert(table_keys, table_values, keys, values, *, seed, scheme,
           max_probes, count):
    """Upsert DISTINCT keys into the planes in place -> status (m,) int32."""
    _check_geometry((table_keys, table_values), keys, [values], scheme)
    if _on_cpu(table_keys, table_values, keys, values):
        return insert_plain(table_keys, table_values, keys, values, seed=seed,
                            scheme=scheme, max_probes=max_probes, count=count)
    status = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    if keys.shape[0]:
        with torch.cuda.device(keys.device):
            rc = _lib().cops_insert(
                table_keys.data_ptr(), table_values.data_ptr(),
                keys.data_ptr(), values.data_ptr(), status.data_ptr(),
                keys.shape[0], table_keys.shape[0], table_keys.shape[1],
                seed & 0xFFFFFFFF, int(scheme == "linear"), max_probes,
                torch.cuda.current_stream().cuda_stream)
            _launched("cops_insert", rc)
    return status


def lookup(table_keys, table_values, keys, *, seed, scheme, max_probes,
           slots=False):
    """``(values int32, found bool, slot int64 or None)`` for each key."""
    _check_geometry((table_keys, table_values), keys, [], scheme)
    if _on_cpu(table_keys, table_values, keys):
        return lookup_plain(table_keys, table_values, keys, seed=seed,
                            scheme=scheme, max_probes=max_probes, slots=slots)
    n = keys.shape[0]
    values = torch.empty((n,), dtype=torch.int32, device=keys.device)
    found = torch.empty((n,), dtype=torch.bool, device=keys.device)
    slot = (torch.empty((n,), dtype=torch.int64, device=keys.device)
            if slots else None)
    if n:
        with torch.cuda.device(keys.device):
            rc = _lib().cops_lookup(
                table_keys.data_ptr(), table_values.data_ptr(),
                keys.data_ptr(), values.data_ptr(), found.data_ptr(),
                slot.data_ptr() if slots else None, n, table_keys.shape[0],
                table_keys.shape[1], seed & 0xFFFFFFFF,
                int(scheme == "linear"), max_probes,
                torch.cuda.current_stream().cuda_stream)
            _launched("cops_lookup", rc)
    return values, found, slot


def append(table_keys, table_values, keys, values, *, seed, scheme,
           max_probes):
    """Append every (key, value) pair into the planes in place -> status
    (m,) int32 (INSERTED / FULL)."""
    _check_geometry((table_keys, table_values), keys, [values], scheme)
    if _on_cpu(table_keys, table_values, keys, values):
        return append_plain(table_keys, table_values, keys, values, seed=seed,
                            scheme=scheme, max_probes=max_probes)
    status = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    if keys.shape[0]:
        with torch.cuda.device(keys.device):
            rc = _lib().cops_append(
                table_keys.data_ptr(), table_values.data_ptr(),
                keys.data_ptr(), values.data_ptr(), status.data_ptr(),
                keys.shape[0], table_keys.shape[0], table_keys.shape[1],
                seed & 0xFFFFFFFF, int(scheme == "linear"), max_probes,
                torch.cuda.current_stream().cuda_stream)
            _launched("cops_append", rc)
    return status


def retrieve_walk(table_keys, keys, active, *, seed, scheme, max_probes,
                  collect):
    """``(counts, qarena, rank_arena)`` of the multi-value walk of the
    active (distinct) keys; see ``retrieve_walk_plain``."""
    _check_geometry((table_keys,), keys, [active], scheme)
    n = keys.shape[0]
    if n >= 2 ** 31:
        raise ValueError("the arena holds int32 batch indices: n < 2^31")
    if _on_cpu(table_keys, keys, masks=(active,)):
        return retrieve_walk_plain(table_keys, keys, active, seed=seed,
                                   scheme=scheme, max_probes=max_probes,
                                   collect=collect)
    dev = keys.device
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    qa = ra = None
    if collect:
        cap = table_keys.numel()
        qa = torch.full((cap,), n, dtype=torch.int32, device=dev)
        ra = torch.zeros((cap,), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            rc = _lib().cops_retrieve(
                table_keys.data_ptr(), keys.data_ptr(), active.data_ptr(),
                counts.data_ptr(), qa.data_ptr() if collect else None,
                ra.data_ptr() if collect else None, n, table_keys.shape[0],
                table_keys.shape[1], seed & 0xFFFFFFFF,
                int(scheme == "linear"), max_probes,
                torch.cuda.current_stream().cuda_stream)
            _launched("cops_retrieve", rc)
    return counts, qa, ra
