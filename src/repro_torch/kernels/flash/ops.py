"""The flash-attention kernel's wrappers, plain version and launch counter.

``flash_attention`` replaces ``repro.kernels.flash.ops.flash_attention``
(kernel #12, forward only, as the reference): (B, S, H, hd) queries and
(B, Sk, Hkv, hd) keys and values with H % Hkv == 0 -> (B, S, H, hd) in the
queries' dtype (f32 or bf16), query head h reading KV head h // (H / Hkv).
``flash_call`` replaces ``repro.kernels.flash.kernel.flash_call`` on
(BH, S, hd) panels.  On CUDA tensors both launch ``flash_fwd``
(``csrc/flash.cu``, built by ``kernels.build``) on the current stream,
reading the strided tensors where they lie (no repeat of the KV heads, no
transposes), add one to ``LAUNCHES`` and their scores (B * H * S * Sk) to
``ELEMENTS``, and raise if the launch reports a CUDA error; on CPU tensors
they run the plain versions, ``ref.gqa_attention`` / ``ref.attention``; on
any other device they raise.  There is no fallback: a CUDA tensor
launches the kernel or raises.  numpy inputs go to the card.

``tq`` / ``tk`` keep the reference's contract (``tq = min(tq, S)``,
``tk = min(tk, Sk)``, each sequence a multiple of its tile, else
ValueError) but do not change the answer: the kernel tiles on its own and
bounds the causal loop at the diagonal for every tile choice, where the
reference's bound (``kernel.py:67``) drops key blocks when tq < tk.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.core.single_value import resolve_device
from repro_torch.kernels.flash import ref

DEFAULT_TQ = 128
DEFAULT_TK = 128
NEG_INF = np.float32(ref.NEG_INF)

#: head dims that ``flash_fwd`` is compiled for: the repo's configs (16 in
#: the SMOKE configs, 64 and 128 in the full ones) and 32
HEAD_DIMS = (16, 32, 64, 128)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the kernel since the last ``reset_launches``
LAUNCHES = {"flash_fwd": 0}
#: the (query, key) scores of every head those launches took, B * H * S * Sk
ELEMENTS = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = ELEMENTS[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.library("flash")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.argtypes = ([i, i] + [vp] * 4 + [i] * 5
                              + [ctypes.POINTER(ctypes.c_longlong), i,
                                 ctypes.c_float, vp])
    lib.flash_fwd.restype = ctypes.c_int
    return lib


def _tensor(x) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            resolve_device(None))
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a tensor or numpy array, got {type(x)}")
    return x


def _tiles(seq: int, seq_k: int, tq: int, tk: int) -> None:
    """The reference's tiling contract (``kernel.py:81-83``)."""
    if seq < 1 or seq_k < 1:
        raise ValueError(f"empty sequence: S={seq}, Sk={seq_k}")
    tq, tk = min(tq, seq), min(tk, seq_k)
    if tq < 1 or tk < 1 or seq % tq or seq_k % tk:
        raise ValueError(f"S={seq} and Sk={seq_k} must be multiples of "
                         f"their tiles tq={tq}, tk={tk}")


def _device(q, k, v) -> bool:
    """True for CPU tensors (the plain version), False for CUDA tensors (a
    launch); raise on anything else."""
    if not q.is_floating_point() or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"expected floating q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, "
                         f"not {dev}")
    return False


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the kernel can read it where it lies (head dim contiguous,
    16-byte aligned rows, every other stride positive, as the bf16
    kernel's TMA maps assume), else a contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and s % vec == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """``flash_fwd`` on (B, S, H, hd) q and (B, Sk, Hkv, hd) k, v."""
    b, seq, heads, hd = q.shape
    seq_k, kv_heads = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or q.dtype not in _DTYPES:
        raise NotImplementedError(
            f"flash_fwd is built for f32 and bf16 at head dims {HEAD_DIMS}, "
            f"not {q.dtype} at {hd}; other head dims and types come with "
            f"ROADMAP.md queue 1 item 12b")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, seq, heads, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        rc = _lib().flash_fwd(
            _DTYPES[q.dtype], hd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, seq, seq_k, heads, kv_heads, strides,
            int(causal), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream().cuda_stream)
    LAUNCHES["flash_fwd"] += 1
    ELEMENTS["flash_fwd"] += b * heads * seq * seq_k
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {rc}")
    return out


def flash_call(q, k, v, *, causal=True, tq=DEFAULT_TQ, tk=DEFAULT_TK):
    """q: (BH, S, hd); k, v: (BH, Sk, hd) -> (BH, S, hd) in q's dtype."""
    q, k, v = _tensor(q), _tensor(k), _tensor(v)
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"expected (BH, S, hd) q and (BH, Sk, hd) k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _tiles(q.shape[1], k.shape[1], tq, tk)
    if _device(q, k, v):
        return ref.attention(q, k, v, causal=causal)
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None],
                   causal)[:, :, 0]


def flash_attention(q, k, v, *, causal=True, tq=DEFAULT_TQ, tk=DEFAULT_TK):
    """q: (B, S, H, hd); k, v: (B, Sk, Hkv, hd) with H % Hkv == 0 ->
    (B, S, H, hd) in q's dtype."""
    q, k, v = _tensor(q), _tensor(k), _tensor(v)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"expected (B, S, H, hd) q and (B, Sk, Hkv, hd) k, "
                         f"v; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    heads, kv_heads = q.shape[2], k.shape[2]
    if kv_heads < 1 or heads % kv_heads:
        raise ValueError(f"H={heads} query heads must be a multiple of "
                         f"Hkv={kv_heads} KV heads")
    _tiles(q.shape[1], k.shape[1], tq, tk)
    if _device(q, k, v):
        return ref.gqa_attention(q, k, v, causal=causal)
    return _launch(q, k, v, causal)


#: the reference's interpret-mode switch has no counterpart here
flash_attention_auto = flash_attention
