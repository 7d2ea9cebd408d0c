"""The COPS kernels' wrappers, their plain versions and launch counters.

The u32 wrappers take the table's bare (p, W) int32 key plane (SOA plane
0, u32 bits), the value plane and (n,) int32 word batches; each has a
two-plane twin for two-word keys (u64 and two-column composite keys) that
takes the (2, p, W) key planes and (n, 2) key batches (plane 0 the low
word, which holds the sentinels):

- ``insert`` / ``insert64`` (single-value upsert of distinct keys) ->
  ``cops_insert`` / ``cops_insert64``;
- ``lookup`` / ``lookup64`` (value, found, slot and, with ``plen``, each
  key's probe length: the windows its walk examined) -> ``cops_lookup`` /
  ``cops_lookup64`` (their ``PLEN`` instantiations where ``plen``);
- ``append`` / ``append64`` (multi-value append: the kernel walks each
  run of equal adjacent keys once and claims its lanes together) ->
  ``cops_append`` / ``cops_append64``;
- ``retrieve_walk`` / ``retrieve_walk64`` (the multi-value walk: per-query
  match counts and, with ``collect``, the (query, rank) slot arena) ->
  ``cops_retrieve`` / ``cops_retrieve64``;
- ``bucket_walk`` (the bucket list's chain walk over its value pool: the
  (query, rank) pool arena of pre-probed handles) -> ``cops_bucket_walk``;
- ``update`` / ``update64`` (the read-modify-write behind the counting
  table and the group-by: every other row of the batch is first combined
  into its representative's entry of a scratch, then the walk of distinct
  representatives folds each one's operand and combined rows into a
  present key's value planes, or claims a slot holding its claim value
  folded with them) -> ``cops_update`` / ``cops_update64``.

``insert`` and ``lookup`` (and their twins) also take a table with no
value plane (``table_values=None``, a hash set): the insert then takes no
values, and the lookup returns None for them.

On **CUDA** tensors a wrapper checks dtype, shape, device and contiguity,
launches its kernel (``csrc/cops.cu``, built by ``kernels.build``) on the
current stream, adds one to ``LAUNCHES`` and the elements it took (keys,
rows, pairs or queries) to ``ELEMENTS``, and raises if the launch
reports a CUDA error.  On **CPU** tensors it runs its plain version below,
one for each pair of twins, over (p, W) or (kw, p, W) key planes:
``insert_plain`` (the bulk engine's lane: probe -> virtual-fill placement
-> apply), ``lookup_plain`` (``bulk.probe_matches`` + a gather; its
probe-length counter where ``plen``),
``append_plain`` (virtual-fill placement of every pair, as
``repro.core.bulk.insert_multi``), ``retrieve_walk_plain`` (the port of
``repro.core.bulk_retrieve.fused_walk``), ``bucket_walk_plain`` (the
port of ``repro.core.bucket_list.chain_arena``) and ``update_plain``
(``bulk.fold_rest`` of the rows, folded into each representative's
operand and claim value by ``bulk.fold_words``, then probe -> placement
-> ``bulk.fold_words``; with ``bulk.update_front`` bit-exact against
``repro.core.bulk.update_single``), each bit-exact against the JAX
engine.  A match holds on every key plane; the walk's row and step come
from the key's probe word (``single_value.key_hash_word``).  On any other
device a wrapper raises.  Nothing falls back: a CUDA tensor never reaches
a plain version.

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
    as_word,
)
from repro_torch.core.single_value import key_hash_word

#: launches of each kernel since the last ``reset_launches``
LAUNCHES = {"cops_insert": 0, "cops_lookup": 0, "cops_append": 0,
            "cops_retrieve": 0, "cops_insert64": 0, "cops_lookup64": 0,
            "cops_append64": 0, "cops_retrieve64": 0, "cops_bucket_walk": 0,
            "cops_update": 0, "cops_update64": 0}
#: the elements those launches took: keys (insert, lookup), pairs
#: (append), queries (retrieve, bucket walk), the batch's rows (update)
ELEMENTS = dict.fromkeys(LAUNCHES, 0)

#: keys per walk of the plain versions (bounds their (n, W) temporaries)
PLAIN_CHUNK = 1 << 22

_SCHEMES = ("cops", "linear")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = ELEMENTS[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _planes(table_keys):
    """(kw, p, W) view of a (p, W) key plane or of (kw, p, W) planes."""
    return table_keys if table_keys.ndim == 3 else table_keys[None]


def _tstatic(planes, scheme, seed, max_probes, value_words=1):
    key_words, num_rows, window = planes.shape
    return (layouts.SoaOps(num_rows, window, key_words, value_words), scheme,
            seed, max_probes)


def _value_planes(table_values, table_keys):
    """(V, p, W) value planes: a (p, W) plane, (V, p, W) planes, or None
    (no value plane: (0, p, W))."""
    if table_values is None:
        return table_keys.new_empty((0, *table_keys.shape[-2:]))
    return table_values if table_values.ndim == 3 else table_values[None]


def _upsert_plain(table_keys, table_values, keys, operand, claimv, fold, *,
                  seed, scheme, max_probes, count):
    """The bulk engine's lane over DISTINCT keys, in place: a matched key's
    value words become ``fold(old, operand)`` (``fold`` None: the
    operand), a placed claimer writes ``claimv``; (m, V) words each.
    Returns status (m,) int32: INSERTED / UPDATED / FULL."""
    kps = _planes(table_keys)
    vps = _value_planes(table_values, kps)
    tstat = _tstatic(kps, scheme, seed, max_probes, vps.shape[0])
    ops = tstat[0]
    store = {"keys": kps, "values": vps}
    status = torch.empty(keys.shape[:1], dtype=torch.int32, device=keys.device)
    for s in range(0, keys.shape[0], PLAIN_CHUNK):
        k = keys[s:s + PLAIN_CHUNK]
        x, c = operand[s:s + PLAIN_CHUNK], claimv[s:s + PLAIN_CHUNK]
        words = key_hash_word(k)
        every = torch.ones(k.shape[:1], dtype=torch.bool, device=k.device)
        matched, mrow, mlane = bulk.probe_matches(tstat, store, k, words,
                                                  every, count)
        placed, crow, clane, _ = bulk.place_claims(tstat, store, words,
                                                   ~matched)
        if fold is not None:
            x = bulk.fold_words(fold, ops.arena_values(
                store, mrow * ops.window + mlane), x)
        count += bulk._apply(ops, store, k, matched, mrow, mlane, placed,
                             crow, clane, x, c)
        status[s:s + PLAIN_CHUNK] = torch.where(
            matched, STATUS_UPDATED,
            torch.where(placed, STATUS_INSERTED, STATUS_FULL))
    return status


def insert_plain(table_keys, table_values, keys, values, *, seed, scheme,
                 max_probes, count):
    """Upsert DISTINCT keys into the planes, in place; status (m,) int32
    (INSERTED / UPDATED / FULL).  ``count`` is the store's live count
    before the batch (0 skips the match walk).  With no value plane
    (``table_values`` None) ``values`` is None."""
    v = (keys.new_empty((keys.shape[0], 0)) if values is None
         else values[:, None])
    return _upsert_plain(table_keys, table_values, keys, v, v, None,
                         seed=seed, scheme=scheme, max_probes=max_probes,
                         count=count)


def update_plain(table_keys, table_values, keys, operand, claimv,
                 rest_rep=None, rest_operand=None, *, ops, seed, scheme,
                 max_probes, count):
    """The read-modify-write over the (V, p, W) value planes, in place.

    Every present DISTINCT key's value word w becomes ``ops[w](old,
    operand[:, w])`` (``bulk.FOLD_OPS``), an absent key claims a slot
    holding ``claimv``; and row i of ``rest_operand`` ((N, V) words) folds
    into the slot of key ``rest_rep[i]`` ((N,) int32, -1 for none), unless
    that key is FULL.  In the kernel's order: the rows are combined per
    key first (``bulk.fold_rest``) and folded into its operand and claim
    value, then the keys walk once.  The folds are associative and
    commutative, so this is the row-by-row chain.  Status (m,) int32
    (INSERTED / UPDATED / FULL)."""
    ops = tuple(ops)
    if rest_rep is not None:
        red = bulk.fold_rest(ops, rest_rep, rest_operand, keys.shape[0])
        operand = bulk.fold_words(ops, operand, red)
        claimv = bulk.fold_words(ops, claimv, red)
    return _upsert_plain(table_keys, table_values, keys, operand, claimv, ops,
                         seed=seed, scheme=scheme, max_probes=max_probes,
                         count=count)


def lookup_plain(table_keys, table_values, keys, *, seed, scheme, max_probes,
                 slots=False, plen=False):
    """``(values int32, found bool, slot int64 or None)``: each key's value
    (0 if absent; None with no value plane) and flat slot ``row * W +
    lane`` (-1 if absent); with ``plen`` a fourth, each key's probe length
    (int32): the windows its walk examined, to its match or a window
    holding an EMPTY, else the whole budget."""
    kps = _planes(table_keys)
    tstat = _tstatic(kps, scheme, seed, max_probes)
    window = kps.shape[2]
    n, dev = keys.shape[0], keys.device
    values = (None if table_values is None
              else torch.empty((n,), dtype=torch.int32, device=dev))
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    slot = torch.empty((n,), dtype=torch.int64, device=dev)
    lengths = torch.empty((n,), dtype=torch.int32, device=dev)
    for s in range(0, n, PLAIN_CHUNK):
        k = keys[s:s + PLAIN_CHUNK]
        every = torch.ones(k.shape[:1], dtype=torch.bool, device=dev)
        matched, mrow, mlane, *walked = bulk.probe_matches(
            tstat, {"keys": kps}, k, key_hash_word(k), every, stats=plen)
        at = torch.where(matched, mrow * window + mlane, -1)
        if values is not None:
            values[s:s + PLAIN_CHUNK] = torch.where(
                matched, table_values.reshape(-1)[at.clamp(min=0)], 0)
        found[s:s + PLAIN_CHUNK] = matched
        slot[s:s + PLAIN_CHUNK] = at
        if plen:
            lengths[s:s + PLAIN_CHUNK] = walked[0]
    out = values, found, (slot if slots else None)
    return out + (lengths,) if plen else out


def append_plain(table_keys, table_values, keys, values, *, seed, scheme,
                 max_probes):
    """Append every (key, value) pair into the planes, in place; status
    (m,) int32 (INSERTED / FULL).  Each pair claims the lowest EMPTY /
    TOMBSTONE lane of the first window of its walk that has one, in batch
    order (``bulk.place_claims`` with every element a claimer)."""
    kps = _planes(table_keys)
    tstat = _tstatic(kps, scheme, seed, max_probes)
    ops = tstat[0]
    store = {"keys": kps, "values": table_values[None]}
    status = torch.empty(keys.shape[:1], dtype=torch.int32, device=keys.device)
    for s in range(0, keys.shape[0], PLAIN_CHUNK):
        k, v = keys[s:s + PLAIN_CHUNK], values[s:s + PLAIN_CHUNK]
        every = torch.ones(v.shape, dtype=torch.bool, device=k.device)
        placed, row, lane, _ = bulk.place_claims(tstat, store,
                                                 key_hash_word(k), every)
        ops.scatter_batch(store, (row * ops.window + lane)[placed],
                          bulk._key_cols(k)[placed], v[placed][:, None],
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
    kps = _planes(table_keys)
    _, num_rows, window = kps.shape
    n, dev = keys.shape[0], keys.device
    counts = torch.zeros((n,), dtype=torch.int32, device=dev)
    qa = ra = None
    if collect:
        qa = torch.full((num_rows * window,), n, dtype=torch.int32, device=dev)
        ra = torch.zeros((num_rows * window,), dtype=torch.int32, device=dev)
    reps = torch.nonzero(active).squeeze(1)
    for s in range(0, reps.shape[0], PLAIN_CHUNK):
        act = reps[s:s + PLAIN_CHUNK]
        key = bulk._key_cols(keys)[act]
        words = key_hash_word(keys[act])
        row = probing.initial_row(words, num_rows, seed)
        step = probing.row_step(scheme, words, num_rows, seed)
        seen = torch.zeros(act.shape, dtype=torch.int64, device=dev)
        for _ in range(max_probes):
            if act.numel() == 0:
                break
            win, match = bulk.window_match(kps, row, key)          # (m, W)
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


def bucket_walk_plain(pool, ptr, cnt, bidx, active, sizes, cum):
    """``(qarena, rank_arena)`` of the bucket list's chain walk.

    Each active query i walks its chain from its tail bucket ``bidx[i]``
    (at pool address ``ptr[i]``) down to bucket 0, all walking queries one
    bucket per round.  Bucket j's values start at ``ptr + (j > 0)`` (after
    the link to the previous bucket) and hold ``min(cnt - cum[j],
    sizes[j])`` of the key's ``cnt`` values.  Each value slot of the two
    (P,) int32 arenas gets qa = i and ra = the value's head-first rank
    ``cum[j] + lane``; every other slot keeps qa = n and ra = 0.  Active
    queries must own distinct chains.
    """
    n, dev = ptr.shape[0], ptr.device
    cap = pool.shape[0]
    qa = torch.full((cap,), n, dtype=torch.int32, device=dev)
    ra = torch.zeros((cap,), dtype=torch.int32, device=dev)
    sizes, cum = sizes.to(torch.int64), cum.to(torch.int64)
    walking = torch.nonzero(active).squeeze(1)
    for s in range(0, walking.shape[0], PLAIN_CHUNK):
        q = walking[s:s + PLAIN_CHUNK]
        j, p, c = bidx[q].to(torch.int64), as_u32(ptr[q]), cnt[q].to(torch.int64)
        while q.numel():
            link = j > 0
            base = cum[j]
            valid = torch.minimum(c - base, sizes[j]).clamp(min=0)
            who = torch.repeat_interleave(
                torch.arange(q.shape[0], device=dev), valid)
            lane = (torch.arange(who.shape[0], device=dev)
                    - (torch.cumsum(valid, 0) - valid)[who])
            slot = p[who] + link[who] + lane
            qa[slot] = q[who].to(torch.int32)
            ra[slot] = (base[who] + lane).to(torch.int32)
            q, j, c = q[link], j[link] - 1, c[link]
            p = as_u32(pool[p[link]])
    return qa, ra


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.library("cops")
    vp, ll, ui, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint, ctypes.c_int
    walk = [ll, ui, i, ui, i, ll]     # n, num_rows, window, seed, linear, max_probes
    for name, args in (("cops_insert", [vp] * 5 + walk),
                       ("cops_lookup", [vp] * 7 + walk),
                       ("cops_append", [vp] * 5 + walk),
                       ("cops_retrieve", [vp] * 6 + walk),
                       ("cops_insert64", [vp] * 5 + walk + [i]),
                       ("cops_lookup64", [vp] * 7 + walk),
                       ("cops_append64", [vp] * 5 + walk),
                       ("cops_retrieve64", [vp] * 6 + walk)):
        fn = getattr(lib, name)
        fn.argtypes = args + [vp]     # ... and the stream
        fn.restype = ctypes.c_int
    for name, args in (("cops_update", [vp] * 9 + walk + [i, i, ll]),
                       ("cops_update64", [vp] * 9 + walk + [i, i, ll, i])):
        fn = getattr(lib, name)
        fn.argtypes = args + [vp]
        fn.restype = ctypes.c_int
    lib.cops_update_shared_groups.argtypes = []
    lib.cops_update_shared_groups.restype = ctypes.c_int
    lib.cops_bucket_keys.argtypes = []
    lib.cops_bucket_keys.restype = ctypes.c_int
    lib.cops_bucket_walk.argtypes = [vp] * 9 + [ll, vp]
    lib.cops_bucket_walk.restype = ctypes.c_int
    return lib


def _on_cpu(*tensors, masks=()) -> bool:
    """True for CPU tensors; validates CUDA tensors (int32 words, bool
    ``masks``; None for a null one) for a launch; raises on anything
    else."""
    tensors = [t for t in tensors if t is not None]
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


def _check_geometry(key_words, table_keys, keys, planes, batches, scheme):
    """``table_keys`` (p, W) for 1-word keys, (key_words, p, W) otherwise;
    the other ``planes`` (p, W); ``keys`` (n,) or (n, key_words); the other
    ``batches`` (n,)."""
    if key_words == 1:
        planes_ok, keys_ok = table_keys.ndim == 2, keys.ndim == 1
    else:
        planes_ok = (table_keys.ndim == 3
                     and table_keys.shape[0] == key_words)
        keys_ok = keys.ndim == 2 and keys.shape[1] == key_words
    if not planes_ok:
        raise ValueError(f"key planes of shape {tuple(table_keys.shape)} for "
                         f"{key_words}-word keys")
    shape = table_keys.shape[-2:]
    if any(p.shape != shape for p in planes):
        raise ValueError(f"planes must be equal (p, W) tensors, got "
                         f"{[tuple(p.shape) for p in planes]} beside {tuple(shape)}")
    if shape[0] >= 2 ** 31:
        raise ValueError("the kernels need fewer than 2^31 rows")
    if shape[1] not in SUPPORTED_WINDOWS:
        raise ValueError(f"window {shape[1]} not in {SUPPORTED_WINDOWS}")
    if not keys_ok or any(b.shape != keys.shape[:1] for b in batches):
        raise ValueError(f"a batch of {key_words}-word keys of shape "
                         f"{tuple(keys.shape)} beside batches "
                         f"{[tuple(b.shape) for b in batches]}")
    if scheme not in _SCHEMES:
        raise ValueError(f"scheme {scheme!r} not in {_SCHEMES}")


def _launch(name, table_keys, n, seed, scheme, max_probes, *args,
            extra=(), elements=None):
    """Launch kernel ``name`` on the current stream with the tensors
    ``args`` (pointers; None for a null one), the walk's parameters and
    ``extra`` ints; count it and its ``elements`` (default ``n``) and raise
    on a CUDA error."""
    num_rows, window = table_keys.shape[-2:]
    with torch.cuda.device(table_keys.device):
        rc = getattr(_lib(), name)(
            *(None if a is None else a.data_ptr() for a in args), n,
            num_rows, window, seed & 0xFFFFFFFF, int(scheme == "linear"),
            max_probes, *extra, torch.cuda.current_stream().cuda_stream)
    LAUNCHES[name] += 1
    ELEMENTS[name] += n if elements is None else elements
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def _present(*tensors):
    return [t for t in tensors if t is not None]


def _insert(key_words, table_keys, table_values, keys, values, *, seed,
            scheme, max_probes, count):
    if (table_values is None) != (values is None):
        raise ValueError("values go with a value plane, None with none")
    _check_geometry(key_words, table_keys, keys, _present(table_values),
                    _present(values), scheme)
    if _on_cpu(table_keys, table_values, keys, values):
        return insert_plain(table_keys, table_values, keys, values, seed=seed,
                            scheme=scheme, max_probes=max_probes, count=count)
    n = keys.shape[0]
    status = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n:
        # the two-plane insert's first pass, the match walk, can only
        # find something in a store that holds a key
        extra = () if key_words == 1 else (int(count > 0),)
        _launch("cops_insert" if key_words == 1 else "cops_insert64",
                table_keys, n, seed, scheme, max_probes, table_keys,
                table_values, keys, values, status, extra=extra)
    return status


def insert(table_keys, table_values, keys, values, *, seed, scheme,
           max_probes, count):
    """Upsert DISTINCT keys into the planes in place -> status (m,) int32."""
    return _insert(1, table_keys, table_values, keys, values, seed=seed,
                   scheme=scheme, max_probes=max_probes, count=count)


def insert64(table_keys, table_values, keys, values, *, seed, scheme,
             max_probes, count):
    """``insert`` of DISTINCT (m, 2) keys into the (2, p, W) key planes."""
    return _insert(2, table_keys, table_values, keys, values, seed=seed,
                   scheme=scheme, max_probes=max_probes, count=count)


def _lookup(key_words, table_keys, table_values, keys, *, seed, scheme,
            max_probes, slots, plen):
    _check_geometry(key_words, table_keys, keys, _present(table_values), [],
                    scheme)
    if _on_cpu(table_keys, table_values, keys):
        return lookup_plain(table_keys, table_values, keys, seed=seed,
                            scheme=scheme, max_probes=max_probes, slots=slots,
                            plen=plen)
    n, dev = keys.shape[0], keys.device
    values = (None if table_values is None
              else torch.empty((n,), dtype=torch.int32, device=dev))
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    slot = torch.empty((n,), dtype=torch.int64, device=dev) if slots else None
    lengths = torch.empty((n,), dtype=torch.int32, device=dev) if plen else None
    if n:
        _launch("cops_lookup" if key_words == 1 else "cops_lookup64",
                table_keys, n, seed, scheme, max_probes, table_keys,
                table_values, keys, values, found, slot, lengths)
    return (values, found, slot) + ((lengths,) if plen else ())


def lookup(table_keys, table_values, keys, *, seed, scheme, max_probes,
           slots=False, plen=False):
    """``(values int32 or None, found bool, slot int64 or None)`` for each
    key (values None for ``table_values`` None); with ``plen`` a fourth,
    each key's probe length (int32, ``lookup_plain``'s), from the kernel's
    ``PLEN`` instantiation."""
    return _lookup(1, table_keys, table_values, keys, seed=seed,
                   scheme=scheme, max_probes=max_probes, slots=slots,
                   plen=plen)


def lookup64(table_keys, table_values, keys, *, seed, scheme, max_probes,
             slots=False, plen=False):
    """``lookup`` of (n, 2) keys in the (2, p, W) key planes."""
    return _lookup(2, table_keys, table_values, keys, seed=seed,
                   scheme=scheme, max_probes=max_probes, slots=slots,
                   plen=plen)


def _append(key_words, table_keys, table_values, keys, values, *, seed,
            scheme, max_probes):
    _check_geometry(key_words, table_keys, keys, [table_values], [values],
                    scheme)
    if _on_cpu(table_keys, table_values, keys, values):
        return append_plain(table_keys, table_values, keys, values, seed=seed,
                            scheme=scheme, max_probes=max_probes)
    n = keys.shape[0]
    status = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n:
        _launch("cops_append" if key_words == 1 else "cops_append64",
                table_keys, n, seed, scheme, max_probes, table_keys,
                table_values, keys, values, status)
    return status


def append(table_keys, table_values, keys, values, *, seed, scheme,
           max_probes):
    """Append every (key, value) pair into the planes in place -> status
    (m,) int32 (INSERTED / FULL)."""
    return _append(1, table_keys, table_values, keys, values, seed=seed,
                   scheme=scheme, max_probes=max_probes)


def append64(table_keys, table_values, keys, values, *, seed, scheme,
             max_probes):
    """``append`` of (m, 2) keys into the (2, p, W) key planes."""
    return _append(2, table_keys, table_values, keys, values, seed=seed,
                   scheme=scheme, max_probes=max_probes)


def _retrieve_walk(key_words, table_keys, keys, active, *, seed, scheme,
                   max_probes, collect):
    _check_geometry(key_words, table_keys, keys, [], [active], scheme)
    n, dev = keys.shape[0], keys.device
    if n >= 2 ** 31:
        raise ValueError("the arena holds int32 batch indices: n < 2^31")
    if _on_cpu(table_keys, keys, masks=(active,)):
        return retrieve_walk_plain(table_keys, keys, active, seed=seed,
                                   scheme=scheme, max_probes=max_probes,
                                   collect=collect)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    qa = ra = None
    if collect:
        cap = table_keys.shape[-2] * table_keys.shape[-1]
        qa = torch.full((cap,), n, dtype=torch.int32, device=dev)
        ra = torch.zeros((cap,), dtype=torch.int32, device=dev)
    if n:
        _launch("cops_retrieve" if key_words == 1 else "cops_retrieve64",
                table_keys, n, seed, scheme, max_probes, table_keys, keys,
                active, counts, qa, ra)
    return counts, qa, ra


def retrieve_walk(table_keys, keys, active, *, seed, scheme, max_probes,
                  collect):
    """``(counts, qarena, rank_arena)`` of the multi-value walk of the
    active (distinct) keys; see ``retrieve_walk_plain``."""
    return _retrieve_walk(1, table_keys, keys, active, seed=seed,
                          scheme=scheme, max_probes=max_probes,
                          collect=collect)


def retrieve_walk64(table_keys, keys, active, *, seed, scheme, max_probes,
                    collect):
    """``retrieve_walk`` of (n, 2) keys over the (2, p, W) key planes."""
    return _retrieve_walk(2, table_keys, keys, active, seed=seed,
                          scheme=scheme, max_probes=max_probes,
                          collect=collect)


def _update(key_words, table_keys, table_values, keys, operand, claimv,
            rest_rep, rest_operand, *, ops, seed, scheme, max_probes, count):
    ops = tuple(ops)
    if table_values.ndim != 3 or table_values.shape[0] not in (1, 2):
        raise ValueError(f"(V, p, W) value planes with V in (1, 2), got "
                         f"{tuple(table_values.shape)}")
    vw = table_values.shape[0]
    if len(ops) != vw or any(op not in bulk.FOLD_OPS for op in ops):
        raise ValueError(f"one op of {bulk.FOLD_OPS} per value plane, got "
                         f"{ops} for {vw}")
    if any(t.shape != (keys.shape[0], vw) for t in (operand, claimv)):
        raise ValueError(f"(n, {vw}) operands and claim values, got "
                         f"{tuple(operand.shape)} and {tuple(claimv.shape)}")
    rest = _present(rest_rep, rest_operand)
    if len(rest) == 1 or (rest and (
            rest_rep.ndim != 1 or rest_rep.dtype != torch.int32
            or rest_operand.shape != (rest_rep.shape[0], vw))):
        raise ValueError(f"rest rows: (N,) int32 representatives beside "
                         f"(N, {vw}) operands, or neither")
    if rest and rest_rep.numel():
        # the combine launch indexes the representatives' scratch with them
        lo, hi = (int(v) for v in torch.aminmax(rest_rep))
        if lo < -1 or hi >= keys.shape[0]:
            raise ValueError(f"rest representatives in [-1, {keys.shape[0]}),"
                             f" got [{lo}, {hi}]")
    _check_geometry(key_words, table_keys, keys, list(table_values), [],
                    scheme)
    if _on_cpu(table_keys, table_values, keys, operand, claimv, *rest):
        return update_plain(table_keys, table_values, keys, operand, claimv,
                            rest_rep, rest_operand, ops=ops, seed=seed,
                            scheme=scheme, max_probes=max_probes, count=count)
    n = keys.shape[0]
    status = torch.empty((n,), dtype=torch.int32, device=keys.device)
    if n:
        n_rest = rest_rep.shape[0] if rest else 0
        # each representative's other rows, combined by launch 1 from each
        # op's identity, folded in by the walk
        acc = None
        if n_rest:
            ident = [bulk._FOLD_REDUCE[op][0] for op in ops]
            acc = as_word(torch.tensor(ident, device=keys.device)).repeat(n, 1)
        codes = sum(bulk.FOLD_OPS.index(op) << 4 * w for w, op in enumerate(ops))
        # the two-plane update's first pass, as the insert's
        extra = (vw, codes, n_rest) + (() if key_words == 1
                                       else (int(count > 0),))
        _launch("cops_update" if key_words == 1 else "cops_update64",
                table_keys, n, seed, scheme, max_probes, table_keys,
                table_values, keys, operand, claimv, status,
                rest_rep if n_rest else None,
                rest_operand if n_rest else None, acc, extra=extra,
                elements=n_rest or n)
    return status


def shared_groups() -> int:
    """R: the most representatives whose rows ``cops_update`` /
    ``cops_update64`` combine in shared memory (``csrc/cops.cu``:
    ``kSharedGroups``); above it they combine in device memory.  Loads the
    kernels, so it needs nvcc."""
    return _lib().cops_update_shared_groups()


def update(table_keys, table_values, keys, operand, claimv, rest_rep=None,
           rest_operand=None, *, ops, seed, scheme, max_probes, count):
    """The read-modify-write of a batch into the (V, p, W) value planes in
    place (see ``update_plain``) -> status (m,) int32 of the DISTINCT
    ``keys``."""
    return _update(1, table_keys, table_values, keys, operand, claimv,
                   rest_rep, rest_operand, ops=ops, seed=seed, scheme=scheme,
                   max_probes=max_probes, count=count)


def update64(table_keys, table_values, keys, operand, claimv, rest_rep=None,
             rest_operand=None, *, ops, seed, scheme, max_probes, count):
    """``update`` of DISTINCT (m, 2) keys into the (2, p, W) key planes."""
    return _update(2, table_keys, table_values, keys, operand, claimv,
                   rest_rep, rest_operand, ops=ops, seed=seed, scheme=scheme,
                   max_probes=max_probes, count=count)


def bucket_keys() -> int:
    """K: the chains a warp of ``cops_bucket_walk`` walks
    (``csrc/cops.cu``: ``kBucketKeys``).  Loads the kernels, so it needs
    nvcc."""
    return _lib().cops_bucket_keys()


def bucket_walk(pool, ptr, cnt, bidx, active, sizes, cum):
    """``(qarena, rank_arena)`` of the bucket list's chain walk (see
    ``bucket_walk_plain``): ``pool`` (P,) int32 words; ``ptr``, ``cnt``,
    ``bidx`` (n,) int32 and ``active`` (n,) bool, the handles of the
    queries; ``sizes`` (L,) and ``cum`` (L + 1,) int32, the growth
    schedule."""
    n = ptr.shape[0]
    if pool.ndim != 1 or any(t.shape != (n,) for t in (cnt, bidx, active)):
        raise ValueError(f"a (P,) pool and (n,) handles, got {tuple(pool.shape)}"
                         f" and {[tuple(t.shape) for t in (ptr, cnt, bidx, active)]}")
    if sizes.ndim != 1 or cum.shape != (sizes.shape[0] + 1,):
        raise ValueError(f"a schedule of (L,) sizes and (L + 1,) cum, got "
                         f"{tuple(sizes.shape)} and {tuple(cum.shape)}")
    if n >= 2 ** 31 or pool.shape[0] >= 2 ** 31:
        raise ValueError("the arenas hold int32 indices: n, P < 2^31")
    if _on_cpu(pool, ptr, cnt, bidx, sizes, cum, masks=(active,)):
        return bucket_walk_plain(pool, ptr, cnt, bidx, active, sizes, cum)
    qa = torch.full(pool.shape, n, dtype=torch.int32, device=pool.device)
    ra = torch.zeros(pool.shape, dtype=torch.int32, device=pool.device)
    if n:
        with torch.cuda.device(pool.device):
            rc = _lib().cops_bucket_walk(
                *(t.data_ptr() for t in (pool, ptr, cnt, bidx, active, sizes,
                                         cum, qa, ra)),
                n, torch.cuda.current_stream().cuda_stream)
        LAUNCHES["cops_bucket_walk"] += 1
        ELEMENTS["cops_bucket_walk"] += n
        if rc != 0:
            raise RuntimeError(f"cops_bucket_walk launch failed with CUDA "
                               f"error {rc}")
    return qa, ra
