"""Vectorized bulk-build engine — ``repro.core.bulk`` for 1- and 2-word keys.

``insert_single`` runs the engine's two halves:

1. **Dedup** (``_group_fast``): duplicate keys of a batch are grouped by a
   bare sort of one word per key + ``searchsorted``, and one
   *representative* per distinct live key survives — the group's first
   live occurrence, carrying the group's last live value (last writer
   wins).  A 1-word key is its own sort word; a two-word key sorts as one
   int64 word holding both planes, which renders the JAX engine's general
   lane (``_sort_batch`` + ``_group_structure``): the same groups and the
   same claim priority, the batch position of each group's first live
   element.
2. **Upsert of the representatives** (``kernels.cops.ops.insert``, or
   ``insert64`` for two-word keys): on a CUDA table the ``cops_insert`` /
   ``cops_insert64`` kernel, one warp-cooperative walk per representative
   with an ``atomicCAS`` claim; on a CPU table their plain version,
   ``kernels.cops.ops.insert_plain``, which is this module's
   ``probe_matches`` -> ``place_claims`` -> ``_apply`` pipeline:

   - **Probe**: one walk per representative against the pre-batch store
     finds the keys already present (a match holds on every key plane;
     stop at a match or at a window holding an EMPTY).  Representatives
     are distinct, so no write of the batch can create or destroy a
     match.  An empty store skips the walk.
   - **Arbitrate**: the virtual-fill fixpoint places the claimers.  Per
     sweep, claimers targeting a row are ranked by batch position; rank k
     takes the k-th lowest EMPTY / TOMBSTONE lane of plane 0, and ranks
     past the row's free-lane count bump to the next row of their own
     walk.  The fixpoint ends where the sequential scan would have placed
     every claimer.
   - **Apply**: one batched write of values (matches and claims) and of
     every key plane (claims).

3. **Statuses** (``_finish_fast``) fan out from the representatives to
   every element in batch order.

``update_single`` is the read-modify-write upsert behind
``single_value.update_values`` (the counting table and the group-by): the
same dedup (``update_front``) picks one representative per distinct live
key, the group's first live element, and maps every other live element to
its representative (``rest_rep``).  ``kernels.cops.ops.update`` /
``update64`` (the ``cops_update`` / ``cops_update64`` kernel, or on a CPU
table ``update_plain``) then combines every other live element's operand
into its representative's (``fold_rest``) and walks the representatives:
a present key's value words take that operand through the fold
(``fold_words``: ``add``, ``min``, ``max``, ``sat_add`` per word), an
absent key claims a slot holding the representative's ``init`` folded
with the combined rest.  The folds are associative and commutative on
u32, so the result is the sequential chain's, and equals the JAX engine's
pre-aggregated ``fold(old, combine(operands))`` wherever its combiner
meets its contract.  Two-word keys take the same
lane (their groups and claim priority are those of the JAX engine's
``_update_general``).

``insert_multi`` is the multi-value append: no dedup, every live element
is a claimer and duplicates of a key take slots of their own
(``kernels.cops.ops.append`` / ``append64``: the ``cops_append`` /
``cops_append64`` kernel on a CUDA table, their plain version
``append_plain`` — ``place_claims`` + ``scatter_batch`` — on a CPU
table).

The plain lane is bit-exact against ``repro.core.bulk.insert_single`` and
``insert_multi`` (the same store planes and statuses); the kernel lane
meets the four-part contract of ``ROADMAP.md`` (same live key->value map,
or pair multiset; same statuses when nothing is FULL; every key at or
before the first EMPTY window of its walk; retrieve parity), checked by
``kernels/cops/contract.py``.  ``lax.cond`` / ``while_loop`` of the JAX
engine are Python branches and loops on host-read scalars here.

The bucket list (``core.bucket_list``) builds in the JAX engine's sorted
domain: ``_sort_batch`` and ``_group_structure`` (1-word keys) give it
the per-key runs in batch order, and it places its new keys through
``place_claims`` with each claimer's batch position as ``prio``.

Not ported yet: keys wider than two words, the bitwise combiner specs
(``or``, ``and``, ``xor``) and combiner callables, and quotient stores.
The engines carry no telemetry: ``stats=True`` measures with a read-only
walk after the operation (``obs.metrics.bolt_on_stats``), whose plain
version is ``probe_matches(stats=True)``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import probing
from repro_torch.core.common import (
    EMPTY_WORD,
    STATUS_FULL,
    STATUS_INSERTED,
    STATUS_MASKED,
    STATUS_UPDATED,
    TOMBSTONE_WORD,
    as_u32,
    as_word,
)

_I64 = torch.int64

#: per-word combiner specs that ``single_value.update_values`` accepts (its
#: duplicates are then reorderable); the JAX package's ``or`` / ``and`` /
#: ``xor`` wait for ROADMAP.md queue 1 item 1c
COMBINE_OPS = ("add", "min", "max")

#: per-word folds of a stored value with an operand, in the order of the
#: kernels' op codes (``csrc/cops.cu``: kAdd .. kSatAdd), all on u32
FOLD_OPS = ("add", "min", "max", "sat_add")

_BITWISE = ("or", "and", "xor")

#: fold op -> (identity as u32, ``scatter_reduce`` reduction of a run of
#: operands in int64) for ``fold_rest``
_FOLD_REDUCE = {"add": (0, "sum"), "min": (0xFFFFFFFF, "amin"),
                "max": (0, "amax"), "sat_add": (0, "sum")}


def _tstatic(table):
    """(store protocol, scheme, seed, max_probes) — the engines' static
    tuple, with the coverage-clamped budget (``probing.effective_probes``)."""
    return (table.ops, table.scheme, table.seed,
            probing.effective_probes(table.scheme, table.max_probes,
                                     table.num_rows))


def _cops(table, name):
    """``(wrapper, key planes)`` of the COPS kernel ``name`` for the
    table's key width: the u32 wrapper over key plane 0, or its two-plane
    twin (``name + "64"``) over the (2, p, W) key planes."""
    from repro_torch.kernels.cops import ops as cops_ops
    if table.key_words == 1:
        return getattr(cops_ops, name), table.store["keys"][0]
    return getattr(cops_ops, name + "64"), table.store["keys"]


def check_spec(spec, allowed, what):
    """Raise unless ``spec`` is a tuple of op names from ``allowed``:
    NotImplementedError naming the ROADMAP.md item for the JAX package's
    bitwise specs and for callables, ValueError otherwise."""
    if callable(spec):
        raise NotImplementedError(
            f"a {what} callable is not ported to repro_torch yet: see "
            f"ROADMAP.md queue 1 item 1b (the rest of the single-value "
            f"table); pass a per-word spec of {tuple(allowed)}")
    for name in spec:
        if name in _BITWISE:
            raise NotImplementedError(
                f"the {what} op {name!r} is not ported to repro_torch yet: "
                f"see ROADMAP.md queue 1 item 1c (bitwise combiners)")
        if name not in allowed:
            raise ValueError(f"{what} op {name!r} not in {tuple(allowed)}")


def fold_words(spec, old, x):
    """``spec[w](old[:, w], x[:, w])`` for each word w of the (m, V) int32
    word tensors ``old`` and ``x``: the plain version of the kernels' fold
    (``FOLD_OPS``), on u32 values; add wraps mod 2^32, sat_add stops at
    0xFFFFFFFF."""
    a, b = as_u32(old), as_u32(x)
    out = []
    for w, name in enumerate(spec):
        aw, bw = a[:, w], b[:, w]
        if name == "add":
            out.append(aw + bw)
        elif name == "min":
            out.append(torch.minimum(aw, bw))
        elif name == "max":
            out.append(torch.maximum(aw, bw))
        elif name == "sat_add":
            out.append((aw + bw).clamp(max=0xFFFFFFFF))
        else:
            raise ValueError(f"fold op {name!r} not in {FOLD_OPS}")
    return as_word(torch.stack(out, dim=1)) if out else old


def fold_rest(spec, rest_rep, operand, m):
    """Per representative, the ``spec`` fold of the operands of the
    elements that ``rest_rep`` maps to it -> (m, V) int32 words, the op's
    identity where none: ``operand`` (n, V) int32 words, ``rest_rep`` (n,)
    int32 positions in [0, m) or -1 (not folded).  Folding the result into
    a value gives what folding each operand in one by one gives: add wraps
    mod 2^32, sat_add sums exactly and stops at 0xFFFFFFFF."""
    live = rest_rep >= 0
    at = torch.where(live, rest_rep.to(_I64), m)
    out = []
    for w, name in enumerate(spec):
        ident, reduce = _FOLD_REDUCE[name]
        arena = torch.full((m + 1,), ident, dtype=_I64, device=operand.device)
        arena.scatter_reduce_(0, at, as_u32(operand[:, w]), reduce)
        red = arena[:m]
        out.append(red.clamp(max=0xFFFFFFFF) if name == "sat_add" else red)
    return as_word(torch.stack(out, dim=1))


def _key_cols(keys):
    """(n, kw) view of a key batch: (n,) 1-word keys or (n, kw) planes."""
    return keys[:, None] if keys.ndim == 1 else keys


def window_match(key_planes, row, key):
    """``(plane-0 windows (m, W), match (m, W))`` of the rows ``row`` of
    the (kw, p, W) key planes: a lane matches where it holds ``key``
    ((m, kw) planes) on every plane."""
    win = key_planes[0][row]
    match = win == key[:, :1]
    for plane in range(1, key.shape[1]):
        match &= key_planes[plane][row] == key[:, plane:plane + 1]
    return win, match


# ---------------------------------------------------------------------------
# dedup (original batch order)
# ---------------------------------------------------------------------------

def pack_keys(keys):
    """One int64 word per key, equal exactly where the keys are: the u32
    value of a 1-word key, ``plane0 << 32 | plane1`` (plane 0 signed) of
    a two-word key."""
    if keys.ndim == 1:
        return as_u32(keys)
    return (keys[:, 0].to(_I64) << 32) | as_u32(keys[:, 1])


def _group_fast(keys, live, last=True):
    """Group structure for 1- or 2-word keys without any payload sort.

    Each element sorts as one word: a 1-word key as itself (the cheaper
    int32 sort), a two-word key as its ``pack_keys`` word.  Masked elements
    sort as a word whose plane 0 is EMPTY, which no user key holds, so they
    never join a live group.  Returns ``(is_rep, rep_of, lww_of,
    has_dups)`` in batch order; ``rep_of`` / ``lww_of`` map every element
    to its group's first / last live element (``n`` / 0 for a group with
    no live element), itself when the batch is duplicate-free.  With
    ``last`` False ``lww_of`` is None (one scatter less).
    """
    n = keys.shape[0]
    idx = torch.arange(n, dtype=_I64, device=keys.device)
    if keys.ndim == 1:
        sentinel, k = EMPTY_WORD, keys
    else:
        sentinel, k = EMPTY_WORD << 32, pack_keys(keys)
    k = torch.where(live, k, sentinel)
    sk = torch.sort(k).values
    has_dups = bool(((sk[1:] == sk[:-1]) & (sk[:-1] != sentinel)).any())
    if has_dups:
        gid = torch.searchsorted(sk, k)
        rep = torch.full((n,), n, dtype=_I64, device=keys.device)
        rep.scatter_reduce_(0, gid, torch.where(live, idx, n), "amin")
        rep_of, lww_of = rep[gid], None
        if last:
            lww = torch.zeros((n,), dtype=_I64, device=keys.device)
            lww.scatter_reduce_(0, gid, torch.where(live, idx, 0), "amax")
            lww_of = lww[gid]
    else:
        rep_of = lww_of = idx
    is_rep = live & (rep_of == idx)
    return is_rep, rep_of, lww_of, has_dups


# ---------------------------------------------------------------------------
# dedup (sorted domain, 1-word keys) — the bucket list's build works here
# ---------------------------------------------------------------------------

def _sort_batch(keys, mask, payload_cols):
    """Stable sort of (n,) 1-word keys by (masked, key as u32, batch index).

    One int64 word ``masked << 32 | key`` sorts stably with
    ``torch.sort``, so masked elements cluster at the end and a key's live
    elements stay in batch order.  Returns ``(flag, skeys, sidx,
    payload)``: the sorted masked flags (int32), keys and batch indices
    (int64), and each payload column gathered into the same order.
    """
    masked = torch.zeros(keys.shape, dtype=_I64, device=keys.device)
    if mask is not None:
        masked = (~mask).to(_I64)
    sw, sidx = torch.sort((masked << 32) | as_u32(keys), stable=True)
    flag = (sw >> 32).to(torch.int32)
    del sw
    return flag, keys[sidx], sidx, [c[sidx] for c in payload_cols]


def _group_structure(flag, skeys):
    """Segment layout of the sorted batch: ``(live, is_rep, first_pos,
    last_pos)``.

    Segments are maximal runs of equal live keys (a masked element is a
    segment of its own, never read); ``is_rep`` marks the first live
    element of each group, and ``first_pos`` / ``last_pos`` (int32) bound
    each element's segment.
    """
    n = flag.shape[0]
    dev = flag.device
    live = flag == 0
    cont = torch.zeros((n,), dtype=torch.bool, device=dev)
    cont[1:] = (skeys[1:] == skeys[:-1]) & live[1:] & live[:-1]
    runstart = ~cont
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    first_pos = torch.cummax(torch.where(runstart, pos, -1), 0).values
    nxt = torch.ones((n,), dtype=torch.bool, device=dev)
    nxt[:-1] = runstart[1:]
    last_pos = torch.cummin(torch.where(nxt, pos, n).flip(0), 0).values.flip(0)
    return live, live & runstart, first_pos, last_pos


# ---------------------------------------------------------------------------
# probe — one walk per active element (batch version of the sequential walk)
# ---------------------------------------------------------------------------

def probe_matches(tstatic, store, keys, words, active, count=None,
                  stats=False):
    """One COPS walk for every active element against the current store.

    ``keys`` are (n,) 1-word keys or (n, kw) planes, ``words`` their probe
    words.  Returns ``(matched, row, lane)``, the position of each key
    already present: a match holds on every key plane.  A walk stops at a
    match or at a window holding an EMPTY (on plane 0); only
    the elements still walking are gathered each round.  When ``count`` is
    given and zero the walk is skipped (an empty store holds no match), and
    ``row`` is then the initial row, as in the JAX engine.

    ``stats`` adds a fourth output, the JAX engine's per-element probe
    length (int32): the windows each walk examined before it stopped, the
    whole budget for a walk that spent it, 0 for an inactive element.
    """
    ops, scheme, seed, max_probes = tstatic
    num_rows, w = ops.num_rows, ops.window
    n = keys.shape[0]
    dev = keys.device
    row0 = probing.initial_row(words, num_rows, seed)
    matched = torch.zeros((n,), dtype=torch.bool, device=dev)
    lane = torch.zeros((n,), dtype=_I64, device=dev)
    plen = (torch.zeros((n,), dtype=torch.int32, device=dev),) if stats else ()
    if count is not None and count == 0:
        return (matched, row0, lane) + plen
    mrow = torch.zeros((n,), dtype=_I64, device=dev)
    kps = ops.key_planes(store)
    act = torch.nonzero(active).squeeze(1)
    row, key = row0[act], _key_cols(keys)[act]
    step = probing.row_step(scheme, words[act], num_rows, seed)
    for _ in range(max_probes):
        if act.numel() == 0:
            break
        if stats:
            plen[0][act] += 1
        win, match = window_match(kps, row, key)              # (m, W)
        m_lane = probing.vote_lowest(match)
        hit = m_lane < w
        has_empty = probing.vote_any(win == EMPTY_WORD)
        hit_at = act[hit]
        mrow[hit_at] = row[hit]
        lane[hit_at] = m_lane[hit]
        matched[hit_at] = True
        go = ~(hit | has_empty)
        act, key, step = act[go], key[go], step[go]
        row = probing.advance_row(row[go], step, num_rows)
    return (matched, mrow, lane) + plen


# ---------------------------------------------------------------------------
# arbitrate — the virtual-fill fixpoint
# ---------------------------------------------------------------------------

def _rank_by_row(row, alive, prio=None):
    """Rank each alive claimer among same-row claimers by ``prio``
    (distinct values in [0, 2^31); by default the position).

    One int64 sort of the packed ``row << 31 | prio`` word covers both
    forms of the JAX engine (its u32 packing and its two-key overflow
    sort); the sort's permutation takes each rank back to its claimer.
    Dead claimers get rank 0.
    """
    n = row.shape[0]
    pos = torch.arange(n, dtype=_I64, device=row.device)
    prio = pos if prio is None else prio
    sent = torch.iinfo(_I64).max
    sp, order = torch.sort(torch.where(alive, (row << 31) | prio, sent))
    srow = sp >> 31
    newrow = torch.ones((n,), dtype=torch.bool, device=row.device)
    newrow[1:] = srow[1:] != srow[:-1]
    rank_sorted = pos - torch.cummax(torch.where(newrow, pos, -1), 0).values
    rank = torch.empty((n,), dtype=_I64, device=row.device)
    rank[order] = torch.where(sp == sent, 0, rank_sorted)
    return rank


def _popcount32(x):
    """Set bits of each u32 value in the int64 tensor ``x`` (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _nth_set_lane(mask32, rank, window):
    """Lane index of the ``rank``-th set bit of a per-element candidate
    bitmask — a 5-step popcount binary search (the vector analogue of
    ``__fns`` on a ballot mask).  Requires W <= 32."""
    lane = torch.zeros_like(rank)
    cur, r = mask32, rank
    for shift in (16, 8, 4, 2, 1):
        if shift >= window:
            continue
        low = cur & ((1 << shift) - 1)
        c = _popcount32(low)
        hi = r >= c
        r = r - torch.where(hi, c, 0)
        lane = lane + torch.where(hi, shift, 0)
        cur = torch.where(hi, cur >> shift, low)
    return lane


def place_claims(tstatic, store, words, claim, prio=None):
    """Assign every claimer a slot — or FULL — via the virtual-fill fixpoint.

    Claimers of a row are served in ``prio`` order: distinct int64 values
    in [0, 2^31), by default the position in ``words`` (sequential insert
    order).  A caller in a sorted domain passes each element's batch
    position.  Returns ``(placed, row, lane, full)``.
    """
    ops, scheme, seed, max_probes = tstatic
    num_rows, w = ops.num_rows, ops.window
    n = words.shape[0]
    kp0 = ops.key_planes(store)[0]
    cand = (kp0 == EMPTY_WORD) | (kp0 == TOMBSTONE_WORD)         # (p, W)
    if w <= 32:
        # each row's candidate lanes as one u32 ballot mask
        bits = 1 << torch.arange(w, dtype=_I64, device=kp0.device)
        cmask = (cand.to(_I64) * bits).sum(dim=1)
        n_cand = _popcount32(cmask)                              # (p,)
    else:
        cmask = None
        n_cand = cand.sum(dim=1)
    row = probing.initial_row(words, num_rows, seed)
    step = probing.row_step(scheme, words, num_rows, seed)

    def advance(attempt, row, move, full):
        """Advance bumped claimers to their next row with any free lane."""
        pending = move & ~full
        while bool(pending.any()):
            row = torch.where(pending, probing.advance_row(row, step, num_rows),
                              row)
            attempt = attempt + pending.to(_I64)
            pending = pending & (attempt < max_probes) & (n_cand[row] == 0)
        # past the budget, or stranded on a candidate-free row: FULL
        full = full | (move & ((attempt > max_probes) | (n_cand[row] == 0)))
        return attempt, row, full

    attempt = torch.ones((n,), dtype=_I64, device=words.device)
    full = torch.zeros((n,), dtype=torch.bool, device=words.device)
    rank = _rank_by_row(row, claim, prio)
    over = claim & (rank >= n_cand[row])
    while bool(over.any()):
        attempt, row, full = advance(attempt, row, over, full)
        alive = claim & ~full
        rank = _rank_by_row(row, alive, prio)
        over = alive & (rank >= n_cand[row])
    placed = claim & ~full
    # rank-th lowest free lane of the assigned row
    if cmask is not None:
        lane = _nth_set_lane(cmask[row], rank, w)
    else:
        crow = cand[row]                                          # (n, W)
        crank = torch.cumsum(crow.to(_I64), dim=1) - 1
        lanes = torch.arange(w, dtype=_I64, device=crow.device)
        lane = torch.where(crow & (crank == rank[:, None]), lanes, w).amin(1)
    return placed, row, torch.where(placed, lane, 0), full


# ---------------------------------------------------------------------------
# apply, statuses and the entry point
# ---------------------------------------------------------------------------

def _apply(ops, store, keys, matched, mrow, mlane, placed, crow, clane,
           matched_vals, claim_vals):
    """One write phase, in place: ``matched_vals`` into matched slots,
    ``claim_vals`` and every key plane into claimed ones (values (m, V)
    words).  Returns the number of claimed slots."""
    write = matched | placed
    row = torch.where(matched, mrow, crow)
    lane = torch.where(matched, mlane, clane)
    slots = (row * ops.window + lane)[write]
    vals = torch.where(matched[:, None], matched_vals, claim_vals)
    ops.scatter_batch(store, slots, _key_cols(keys)[write], vals[write],
                      placed[write])
    return int(placed.sum())


def dedup(keys, values, mask=None):
    """The dedup front end: ``(rep_keys, rep_values, groups)``.

    One representative per distinct live key, in batch order, carrying its
    group's last live value.  ``groups`` is what ``_finish_fast`` needs to
    fan statuses back out, or None when every element represents itself
    (no mask, no duplicates) and the batch passes through untouched.
    """
    n = keys.shape[0]
    live = (torch.ones((n,), dtype=torch.bool, device=keys.device)
            if mask is None else mask)
    is_rep, rep_of, lww_of, has_dups = _group_fast(keys, live)
    if mask is None and not has_dups:
        return keys, values, None
    rep_idx = torch.nonzero(is_rep).squeeze(1)
    return (keys[rep_idx], values[lww_of[rep_idx]],
            (live, is_rep, rep_of, rep_idx))


def update_front(keys, values, init, mask=None):
    """The read-modify-write's dedup front end: ``(rep_keys, operand,
    claim, rest_rep, groups)``.

    One representative per distinct live key, in batch order (the group's
    first live element), with its own operand (``values``, (n, V) words)
    and its ``init`` ((n, V)), the value it claims a slot with.
    ``rest_rep`` ((n,) int32, or None when the batch holds no duplicate)
    maps every other live element to its representative's position, and
    the representatives and masked elements to -1: their operands are
    combined into the representative's before the walk.  ``groups`` as in
    ``dedup``.
    """
    n = keys.shape[0]
    live = (torch.ones((n,), dtype=torch.bool, device=keys.device)
            if mask is None else mask)
    is_rep, rep_of, _, has_dups = _group_fast(keys, live, last=False)
    if mask is None and not has_dups:
        return keys, values, init, None, None
    rep_idx = torch.nonzero(is_rep).squeeze(1)
    operand = values[rep_idx]
    claim = operand if init is values else init[rep_idx]
    groups = (live, is_rep, rep_of, rep_idx)
    if not has_dups:
        return keys[rep_idx], operand, claim, None, groups
    pos = torch.cumsum(is_rep, 0, dtype=torch.int32) - 1
    rest_rep = torch.where(live & ~is_rep, pos[rep_of.clamp(max=n - 1)], -1)
    return keys[rep_idx], operand, claim, rest_rep, groups


def _finish_fast(groups, rep_status):
    """Statuses in batch order from the representatives' statuses.

    A representative keeps its own status; a later duplicate reports
    UPDATED when its representative landed (INSERTED or UPDATED) and FULL
    otherwise; masked elements report MASKED.
    """
    if groups is None:
        return rep_status
    live, is_rep, rep_of, rep_idx = groups
    n = live.shape[0]
    per = torch.full((n,), STATUS_FULL, dtype=torch.int32, device=live.device)
    per[rep_idx] = rep_status
    rep_ok = per[rep_of.clamp(max=n - 1)] != STATUS_FULL
    dup = torch.where(rep_ok, STATUS_UPDATED, STATUS_FULL).to(torch.int32)
    return torch.where(~live, STATUS_MASKED,
                       torch.where(is_rep, per, dup)).to(torch.int32)


def insert_single(table, keys, values, mask=None):
    """Bulk path for ``single_value.insert`` (plain upsert, LWW dedup).

    ``keys`` ((n,) or (n, 2) planes) / ``values`` are int32 word tensors
    and ``mask`` a bool tensor (or None), all on the table's device.  The
    store is updated in place.
    """
    if keys.shape[0] == 0:
        return table, torch.zeros((0,), dtype=torch.int32, device=keys.device)
    rkeys, rvals, groups = dedup(keys, values, mask)
    _, scheme, seed, max_probes = _tstatic(table)
    insert, table_keys = _cops(table, "insert")
    plane = value_plane(table)
    rep_status = insert(
        table_keys, plane, rkeys, None if plane is None else rvals,
        seed=seed, scheme=scheme, max_probes=max_probes, count=table.count)
    inserted = int((rep_status == STATUS_INSERTED).sum())
    return (dataclasses.replace(table, count=table.count + inserted),
            _finish_fast(groups, rep_status))


def update_single(table, keys, fold, init, values, mask=None):
    """Bulk path for ``single_value.update_values`` (RMW upsert).

    ``keys`` ((n,) or (n, 2) planes), ``init`` and ``values`` ((n, V) int32
    words) and ``mask`` (bool or None) lie on the table's device; ``fold``
    (``FOLD_OPS``) is a per-word spec whose folds commute.  A present key
    folds every live operand of its group in; an absent key claims a slot
    holding its first live element's ``init``, and the group's other live
    operands fold into it, as the sequential chain would.  The store is
    updated in place.
    """
    if keys.shape[0] == 0:
        return table, torch.zeros((0,), dtype=torch.int32, device=keys.device)
    rkeys, operand, claim, rest_rep, groups = update_front(keys, values,
                                                           init, mask)
    _, scheme, seed, max_probes = _tstatic(table)
    update, table_keys = _cops(table, "update")
    rep_status = update(
        table_keys, table.store["values"], rkeys, operand.contiguous(),
        claim.contiguous(), rest_rep,
        None if rest_rep is None else values.contiguous(), ops=fold,
        seed=seed, scheme=scheme, max_probes=max_probes, count=table.count)
    inserted = int((rep_status == STATUS_INSERTED).sum())
    return (dataclasses.replace(table, count=table.count + inserted),
            _finish_fast(groups, rep_status))


def value_plane(table):
    """The table's one value plane ((p, W)) for the kernels that store a
    value, or None for a table with no value plane (a hash set)."""
    return table.store["values"][0] if table.value_words else None


def insert_multi(table, keys, values, mask=None):
    """Bulk path for ``multi_value.insert`` (append; no dedup).

    Masked elements report MASKED and claim nothing: the live elements are
    compacted, in batch order, before the append and their statuses fanned
    back out.  The store is updated in place.
    """
    n = keys.shape[0]
    if n == 0:
        return table, torch.zeros((0,), dtype=torch.int32, device=keys.device)
    live = None if mask is None else torch.nonzero(mask).squeeze(1)
    if live is not None:
        keys, values = keys[live], values[live]
    _, scheme, seed, max_probes = _tstatic(table)
    append, table_keys = _cops(table, "append")
    status = append(table_keys, table.store["values"][0], keys, values,
                    seed=seed, scheme=scheme, max_probes=max_probes)
    inserted = int((status == STATUS_INSERTED).sum())
    if live is not None:
        per = torch.full((n,), STATUS_MASKED, dtype=torch.int32,
                         device=keys.device)
        per[live] = status
        status = per
    return dataclasses.replace(table, count=table.count + inserted), status
