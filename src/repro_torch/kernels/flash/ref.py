"""The plain version of the flash-attention kernel: naive full-matrix
softmax attention in f32, as ``repro.kernels.flash.ref.attention``.

``attention`` takes ``(BH, S, hd)`` panels; ``gqa_attention`` the
``(B, S, H, hd)`` queries and ``(B, Sk, Hkv, hd)`` keys and values of
``ops.flash_attention``, query head h reading KV head h // (H / Hkv).  Both
go ``chunk`` panels at a time, so a card holds the (chunk, S, Sk) f32
scores of one pass only; the result does not depend on ``chunk``.

``blocked_attention`` is the bf16 kernel's arithmetic written plainly (an
online softmax over key tiles, P rounded before P V), so the CPU tests can
show that this rounding fits the limits the card holds the kernel to.
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


def blocked_attention(q, k, v, *, causal=True, tk=128,
                      p_dtype=torch.bfloat16):
    """q: (BH, S, hd); k, v: (BH, Sk, hd) -> (BH, S, hd) in q's dtype, as
    ``flash_fwd``'s bf16 path computes it: an f32 online softmax over key
    tiles of ``tk`` (running max m, running sum l of the f32
    probabilities), each tile's probabilities rounded to ``p_dtype`` before
    P V, the output summed in f32 and divided by max(l, 1e-30).  With
    ``p_dtype=torch.float32`` it is ``attention`` up to f32 rounding."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = torch.arange(sq, device=dev)[:, None]
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, sk, tk):
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + tk])
        s /= math.sqrt(hd)
        if causal:
            cols = torch.arange(k0, min(k0 + tk, sk), device=dev)[None, :]
            s.masked_fill_(rows < cols, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bqk,bkd->bqd",
                                        p.to(p_dtype).float(),
                                        vf[:, k0:k0 + tk])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
