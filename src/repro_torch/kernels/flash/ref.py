"""The plain version of the flash-attention kernel: naive full-matrix
softmax attention in f32, as ``repro.kernels.flash.ref.attention``.

``attention`` takes ``(BH, S, hd)`` panels; ``gqa_attention`` the
``(B, S, H, hd)`` queries and ``(B, Sk, Hkv, hd)`` keys and values of
``ops.flash_attention``, query head h reading KV head h // (H / Hkv).  Both
go ``chunk`` panels at a time, so a card holds the (chunk, S, Sk) f32
scores of one pass only; the result does not depend on ``chunk``.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30

#: f32 score bytes of one pass when ``chunk`` is None
SCORE_BYTES = 1 << 30


def _chunk(chunk, panels: int, sq: int, sk: int) -> int:
    if chunk is None:
        chunk = SCORE_BYTES // max(1, 4 * sq * sk)
    return max(1, min(int(chunk), panels))


def _panels(q, k, v, hidden):
    """Attention of (n, S, hd) panels -> (n, S, hd) f32; ``hidden`` (S, Sk)
    bool marks the masked scores (None: none)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    s /= math.sqrt(q.shape[-1])
    if hidden is not None:
        s.masked_fill_(hidden, NEG_INF)
    w = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bqk,bkd->bqd", w, v.float())


def gqa_attention(q, k, v, *, causal=True, chunk=None):
    """q: (B, S, H, hd); k, v: (B, Sk, Hkv, hd), H % Hkv == 0 -> (B, S, H,
    hd) in q's dtype; query head h reads KV head h // (H / Hkv)."""
    b, sq, h, _ = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    out = torch.empty_like(q)
    # the causal mask, top-left aligned: query i sees keys j <= i
    hidden = (torch.arange(sq, device=q.device)[:, None]
              < torch.arange(sk, device=q.device)[None, :]) if causal else None
    step = _chunk(chunk, b * h, sq, sk)
    for p in range(0, b * h, step):
        idx = torch.arange(p, min(p + step, b * h), device=q.device)
        bi, hi = idx // h, idx % h
        # advanced indexing gathers (n, S, hd) panels of the (B, S, H, hd)
        # tensors: index dims 0 and 2 lead, S and hd follow
        res = _panels(q[bi, :, hi], k[bi, :, hi // rep], v[bi, :, hi // rep],
                      hidden)
        out[bi, :, hi] = res.to(q.dtype)
    return out


def attention(q, k, v, *, causal=True, chunk=None):
    """q: (BH, S, hd); k, v: (BH, Sk, hd) -> (BH, S, hd) in q's dtype."""
    return gqa_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                         causal=causal, chunk=chunk)[:, :, 0]
