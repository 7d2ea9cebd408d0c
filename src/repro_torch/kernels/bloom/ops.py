"""The blocked bloom filter's kernel wrappers, plain versions and launch
counters.

``insert_words`` / ``query_words`` replace ``repro.kernels.bloom.ops``'s
jitted wrappers over the Pallas tiles (kernels #9 and #10).  They work on
packed words, int32 tensors holding u32 bits: one filter ``(num_blocks,
wpb)`` or a stack of filters ``(P, num_blocks, wpb)`` with a plane index
per key (``planes``; None means plane 0).  On CUDA tensors they launch
``bloom_insert`` / ``bloom_query`` (``csrc/bloom.cu``, built by
``kernels.build``) on the current stream, add one to ``LAUNCHES`` and
their keys to ``ELEMENTS``, and raise if the launch reports a CUDA error;
on CPU tensors they run the plain versions below; on any other device
they raise.  There is no fallback: a CUDA tensor launches the kernel or
raises.

Each has two paths, picked by ``insert_plan`` / ``query_plan`` from the
batch's keys per filter sector: the direct one (one thread per key, in
batch order) and, for a batch that visits each sector many times, the
partitioned one (``bloom_insert_partitioned`` / ``bloom_query_partitioned``:
the keys sorted by 64 KiB tile of the filter in two passes, then each
tile's keys meet the tile in shared memory: the insert ORs them in and
ORs the tile into the filter once; the query tests them there and brings
the answers back to batch order through the slots each pass gave the
keys), whose scratch (two copies of the keys, and of their planes, in
tile order; the tiles' counts; for the query two slot arrays and two
arrays of answers) the wrapper allocates.  Either is one wrapper call:
one count in ``LAUNCHES``; ``PATHS`` counts which path each took.
``insert_launch`` / ``query_launch`` take a plan, so a caller can force a
path to time or test it.

Unlike the reference, the insert updates ``words`` **in place** (and
returns it): a filter of the card's size is never copied per batch.  A
key whose mask is False, or whose plane is outside [0, P), is not
inserted and queries as False.

The plain versions follow the reference's own structure (torch has no
bitwise-OR scatter): the insert writes ones into the bit view
(``ref.unpack_bits``) with ``index_put_`` and repacks; the query gathers
each key's k words and tests its bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.common import as_u32
from repro_torch.kernels.bloom import ref

#: launches of each kernel since the last ``reset_launches``
LAUNCHES = {"bloom_insert": 0, "bloom_query": 0}
#: the keys those launches took
ELEMENTS = dict.fromkeys(LAUNCHES, 0)

#: the path each ``bloom_insert`` ("direct", "partitioned") and
#: ``bloom_query`` ("query_direct", "query_partitioned") launch took since
#: the last ``reset_launches``
PATHS = {"direct": 0, "partitioned": 0, "query_direct": 0,
         "query_partitioned": 0}

#: keys per pass of the plain versions (bounds their (n, k) temporaries)
PLAIN_CHUNK = 1 << 22

#: the partitioned insert's cut of a filter: tiles of at most TILE_WORDS
#: words (``csrc/bloom.cu``: ``kTileWords``, a tile ORed in shared memory),
#: at most MAX_TILES of them (``kMaxTiles``), grouped for its first pass
#: into ranges of about RANGE_BYTES, at most MAX_LOCAL ranges of at most
#: MAX_LOCAL tiles (``kMaxLocal``).  At 2^28 keys into 2^32 bits (NVIDIA
#: H100 80GB HBM3, 700.00 W; tools/probe_cops_update.py bloom) 64 KiB tiles
#: in ranges of 2 / 4 / 16 MiB took 5.403 / 4.554 / 5.120 ms, 32 KiB tiles
#: 5.418 / 4.679 / 5.581
TILE_WORDS = 1 << 14
MAX_TILES = 1 << 15
RANGE_BYTES = 4 << 20
MAX_LOCAL = 1024
#: a batch with at least this many keys per 32-byte sector of its filter
#: takes the partitioned insert, a sparser one the direct insert.  Into
#: fig12's 8 x 64 MiB stack (NVIDIA H100 80GB HBM3, 700.00 W;
#: tools/probe_cops_update.py bloom): at 0.25 keys a sector direct 0.584 ms,
#: partitioned 0.659; at 0.5, 1.031 and 0.803; they cross near 0.3
PARTITION_KEYS_PER_SECTOR = 0.3
#: the same for the query of a lone filter.  Into phase 21's 512 MiB filter
#: (same card; tools/probe_cops_update.py bloom; half the keys absent):
#: at 1 key a sector direct 0.612 ms, partitioned 0.726; at 2, 1.153 and
#: 1.097; at 16, 8.970 and 7.064.  A batch with a plane per key stays
#: direct: into fig12's stack the direct query was faster at every batch up
#: to 16 keys a sector (10.263 against 11.021 ms there), since the planes
#: ride along every pass of the partitioned one
QUERY_KEYS_PER_SECTOR = 2.0


class Plan(NamedTuple):
    """How a bloom kernel runs a batch: ``partitioned`` or direct; the
    partitioned path's ``tiles`` of ``rows_per_tile`` filter rows, in
    ``ranges`` of ``tiles_per_range`` tiles."""

    partitioned: bool
    rows_per_tile: int = 0
    tiles: int = 0
    tiles_per_range: int = 0
    ranges: int = 0


def _plan(n: int, num_rows: int, wpb: int, keys_per_sector: float) -> Plan:
    """Partitioned when the filter spans more than one range of
    ``RANGE_BYTES`` (a filter of one range lies in the card's L2 as it
    is), the keys per 32-byte sector of it reach ``keys_per_sector`` and
    the cut fits the kernels' limits, else direct."""
    rows_per_tile = max(1, TILE_WORDS // wpb)
    tiles = -(-num_rows // rows_per_tile)
    per_range = max(1, RANGE_BYTES // (4 * wpb * rows_per_tile))
    per_range = max(per_range, -(-tiles // MAX_LOCAL))
    ranges = -(-tiles // per_range)
    sectors = num_rows * wpb * 4 / 32
    if (ranges < 2 or n < keys_per_sector * sectors
            or tiles > MAX_TILES or per_range > MAX_LOCAL
            or num_rows >= 2 ** 32 or n >= 2 ** 31):
        return Plan(False)
    return Plan(True, rows_per_tile, tiles, per_range, ranges)


def insert_plan(n: int, num_rows: int, wpb: int) -> Plan:
    """The insert's path for ``n`` keys into a filter of ``num_rows``
    rows (planes x blocks) of ``wpb`` words, at
    ``PARTITION_KEYS_PER_SECTOR`` (see ``_plan``)."""
    return _plan(n, num_rows, wpb, PARTITION_KEYS_PER_SECTOR)


def query_plan(n: int, num_rows: int, wpb: int, planes: bool = False) -> Plan:
    """The query's path, as ``insert_plan``'s at ``QUERY_KEYS_PER_SECTOR``;
    direct for a batch with a plane per key (``planes``)."""
    if planes:
        return Plan(False)
    return _plan(n, num_rows, wpb, QUERY_KEYS_PER_SECTOR)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = ELEMENTS[name] = 0
    for name in PATHS:
        PATHS[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.library("bloom")
    vp, ll, ui, i = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                     ctypes.c_int)
    geometry = [ll, i, ui, i, i, ui, vp]   # n, planes, blocks, wpb, k, seed, stream
    lib.bloom_insert.argtypes = [vp] * 4 + geometry
    lib.bloom_query.argtypes = [vp] * 4 + geometry
    cut = [ui, i, i, i]   # rows_per_tile, tiles, tiles_per_range, ranges
    lib.bloom_insert_partitioned.argtypes = (
        [vp] * 4 + geometry[:-1] + cut + [vp] * 6)
    lib.bloom_query_partitioned.argtypes = (
        [vp] * 4 + geometry[:-1] + cut + [vp] * 10)
    for f in (lib.bloom_insert, lib.bloom_query, lib.bloom_insert_partitioned,
              lib.bloom_query_partitioned):
        f.restype = ctypes.c_int
    return lib


def _stack(words: torch.Tensor) -> torch.Tensor:
    """(P, num_blocks, wpb) view of one filter or of a stack."""
    return words if words.ndim == 3 else words[None]


def _check(words, keys, mask, planes) -> bool:
    """Validate the arguments; True for CPU tensors (the plain versions),
    False for CUDA tensors (a launch), raise on anything else."""
    if words.dtype != torch.int32 or words.ndim not in (2, 3):
        raise ValueError(f"expected (num_blocks, wpb) or (P, num_blocks, "
                         f"wpb) int32 words, got {tuple(words.shape)} "
                         f"{words.dtype}")
    if keys.dtype != torch.int32 or keys.ndim != 1:
        raise ValueError(f"expected (n,) int32 key words, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    n = keys.shape[0]
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (n,)):
        raise ValueError(f"expected a ({n},) bool mask, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if planes is not None and (planes.is_floating_point()
                               or planes.shape != (n,)):
        raise ValueError(f"expected ({n},) integer planes, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    tensors = [t for t in (words, keys, mask, planes) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"the bloom kernels run on CUDA or CPU tensors, "
                         f"not {dev}")
    if not words.is_contiguous():
        raise ValueError("the filter words must be contiguous")
    return False


def _launch(name, words, keys, args, k_hashes, seed, entry=None,
            extra=()) -> None:
    """Launch kernel ``name`` (through the C function ``entry``, default
    ``name``) on the current stream with the pointers ``args`` (None for
    a null one) and the arguments ``extra`` after the geometry; count it
    and raise on a CUDA error."""
    stack = _stack(words)
    with torch.cuda.device(words.device):
        rc = getattr(_lib(), entry or name)(
            *(None if a is None else a.data_ptr() for a in args),
            keys.shape[0], stack.shape[0], stack.shape[1], stack.shape[2],
            k_hashes, seed & 0xFFFFFFFF,
            *(e.data_ptr() if isinstance(e, torch.Tensor) else e
              for e in extra),
            torch.cuda.current_stream().cuda_stream)
    LAUNCHES[name] += 1
    ELEMENTS[name] += keys.shape[0]
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


def _plane_index(planes, n, num_planes, device):
    """(plane int64 (n,) clamped into range, in_range bool (n,))."""
    if planes is None:
        return (torch.zeros((n,), dtype=torch.int64, device=device),
                torch.ones((n,), dtype=torch.bool, device=device))
    planes = planes.to(torch.int64)
    ok = (planes >= 0) & (planes < num_planes)
    return planes.clamp(0, num_planes - 1), ok


def insert_plain(words, keys, mask=None, *, k_hashes, seed, planes=None):
    """The plain insert: ones into the bit view, repacked into ``words``
    in place."""
    stack = _stack(words)
    p, nb, wpb = stack.shape
    bits = ref.unpack_bits(stack).view(p * nb, wpb * 32)
    for s in range(0, keys.shape[0], PLAIN_CHUNK):
        k = keys[s:s + PLAIN_CHUNK]
        block, bit = ref.positions(k, nb, wpb * 32, k_hashes, seed)
        plane, live = _plane_index(
            None if planes is None else planes[s:s + PLAIN_CHUNK],
            k.shape[0], p, k.device)
        if mask is not None:
            live = live & mask[s:s + PLAIN_CHUNK]
        rows = (plane * nb + block)[live]
        bits.index_put_((rows[:, None].expand(-1, k_hashes), bit[live]),
                        torch.ones((), dtype=torch.uint8, device=k.device))
    stack.copy_(ref.pack_bits(bits.view(p, nb, wpb * 32)))
    return words


def query_plain(words, keys, *, k_hashes, seed, planes=None):
    """The plain query: each key's k bits gathered from its row."""
    stack = _stack(words)
    p, nb, wpb = stack.shape
    flat = stack.reshape(-1)
    out = torch.empty(keys.shape, dtype=torch.bool, device=keys.device)
    for s in range(0, keys.shape[0], PLAIN_CHUNK):
        k = keys[s:s + PLAIN_CHUNK]
        block, bit = ref.positions(k, nb, wpb * 32, k_hashes, seed)
        plane, ok = _plane_index(
            None if planes is None else planes[s:s + PLAIN_CHUNK],
            k.shape[0], p, k.device)
        row = (plane * nb + block) * wpb
        got = as_u32(flat[row[:, None] + bit // 32]) >> (bit % 32)
        out[s:s + PLAIN_CHUNK] = ok & (got & 1).bool().all(1)
    return out


def insert_words(words, keys, mask=None, *, k_hashes, seed, planes=None):
    """Insert (n,) int32 key words into ``words`` in place; returns
    ``words``.  ``mask`` (n,) bool (None: every key), ``planes`` (n,)
    integers picking each key's filter of a stack."""
    if _check(words, keys, mask, planes):
        return insert_plain(words, keys, mask, k_hashes=k_hashes, seed=seed,
                            planes=planes)
    if keys.shape[0] and k_hashes:
        stack = _stack(words)
        plan = insert_plan(keys.shape[0], stack.shape[0] * stack.shape[1],
                           stack.shape[2])
        insert_launch(words, keys, mask, planes, k_hashes, seed, plan)
    return words


def insert_launch(words, keys, mask, planes, k_hashes, seed,
                  plan: Plan) -> None:
    """One ``bloom_insert`` launch of a non-empty batch on CUDA tensors by
    ``plan``'s path (``insert_words`` takes ``insert_plan``'s; a caller
    may give another to time or test a path)."""
    n, dev = keys.shape[0], keys.device
    args = (words, keys.contiguous(),
            None if mask is None else mask.contiguous(),
            None if planes is None else planes.to(torch.int32).contiguous())
    if not plan.partitioned:
        _launch("bloom_insert", words, keys, args, k_hashes, seed)
        PATHS["direct"] += 1
        return
    scratch = torch.empty((2 if planes is None else 4, n), dtype=torch.int32,
                          device=dev)
    counts = torch.zeros((3 * plan.tiles + 3 * plan.ranges + 3,),
                         dtype=torch.int32, device=dev)
    _launch("bloom_insert", words, keys, args, k_hashes, seed,
            entry="bloom_insert_partitioned",
            extra=(plan.rows_per_tile, plan.tiles, plan.tiles_per_range,
                   plan.ranges, scratch[0],
                   None if planes is None else scratch[2], scratch[1],
                   None if planes is None else scratch[3], counts))
    PATHS["partitioned"] += 1


def query_words(words, keys, *, k_hashes, seed, planes=None):
    """Membership of (n,) int32 key words -> (n,) bool: True where the
    key's row (of its plane) holds every one of its k bits."""
    if _check(words, keys, None, planes):
        return query_plain(words, keys, k_hashes=k_hashes, seed=seed,
                           planes=planes)
    stack = _stack(words)
    plan = query_plan(keys.shape[0], stack.shape[0] * stack.shape[1],
                      stack.shape[2], planes is not None)
    return query_launch(words, keys, planes, k_hashes, seed, plan)


def query_launch(words, keys, planes, k_hashes, seed,
                 plan: Plan) -> torch.Tensor:
    """One ``bloom_query`` launch on CUDA tensors by ``plan``'s path
    (``query_words`` takes ``query_plan``'s; a caller may give another to
    time or test a path); an empty batch launches nothing.  Returns the
    (n,) bool answers."""
    n, dev = keys.shape[0], keys.device
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if not n:
        return out
    args = (words, keys.contiguous(),
            None if planes is None else planes.to(torch.int32).contiguous(),
            out)
    if not plan.partitioned:
        _launch("bloom_query", words, keys, args, k_hashes, seed)
        PATHS["query_direct"] += 1
        return out
    # each row of a (., m) scratch starts 16-byte aligned
    m = -(-n // 16) * 16
    scratch = torch.empty((4 if planes is None else 6, m), dtype=torch.int32,
                          device=dev)
    answers = torch.empty((2, m), dtype=torch.uint8, device=dev)
    counts = torch.zeros((3 * plan.tiles + 3 * plan.ranges + 3,),
                         dtype=torch.int32, device=dev)
    _launch("bloom_query", words, keys, args, k_hashes, seed,
            entry="bloom_query_partitioned",
            extra=(plan.rows_per_tile, plan.tiles, plan.tiles_per_range,
                   plan.ranges, scratch[0],
                   None if planes is None else scratch[4], scratch[1],
                   None if planes is None else scratch[5], scratch[2],
                   scratch[3], answers[0], answers[1], counts))
    PATHS["query_partitioned"] += 1
    return out


def insert(f, keys, mask=None):
    """``BloomFilter`` insert through the kernel (in place; returns ``f``)."""
    from repro_torch.core import bloom
    from repro_torch.core.single_value import normalize_mask
    keys = bloom.key_batch(keys, f.device)
    mask = normalize_mask(mask, keys.shape[0], f.device)
    insert_words(f.words, keys, mask, k_hashes=f.k, seed=f.seed)
    return f


def contains(f, keys) -> torch.Tensor:
    from repro_torch.core import bloom
    return query_words(f.words, bloom.key_batch(keys, f.device),
                       k_hashes=f.k, seed=f.seed)
