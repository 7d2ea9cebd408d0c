"""The port's flash attention against the JAX reference.

The same seeded numpy inputs go through ``repro.kernels.flash`` (the
Pallas kernel #12 in interpret mode, and ``ref.attention``) and through
``repro_torch.kernels.flash``, whose wrappers run the plain version on CPU
tensors.  Tolerances are the reference's own (``tests/test_kernels.py::
TestFlashKernel``): 2e-5 in f32, 2e-2 in bf16.  The cases: that class's
three shapes, causal and not, its bf16 case, starcoder2-3b's GQA ratio of
12 (24 query heads on 2 KV heads) at a narrow width, the SMOKE configs'
head dim 16, and Sk != S.  One jitted shape per case, compiled with fast
options, no long sequence: about 20 s on one core.  ``ref.blocked_attention``
(the card's bf16 arithmetic: P rounded to bf16 before P V) is held to the
reference's plain attention at the limits the card holds the kernel to.  The CUDA kernel itself is held to the same plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import kernel as jkernel
from repro.kernels.flash import ops as jops
from repro.kernels.flash import ref as jref
from repro_torch.kernels.flash import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# the reference's jitted calls, compiled with fast options (the same
# arithmetic; a shorter compile of the interpret-mode kernel)
_FAST = {"xla_backend_optimization_level": 0,
         "xla_cpu_use_fusion_emitters": False}
_flash_attention = jax.jit(jops.flash_attention, compiler_options=_FAST,
                           static_argnames=("causal", "tq", "tk"))
_flash_call = jax.jit(jkernel.flash_call, compiler_options=_FAST)


def _inputs(seed, b, s, sk, h, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32))


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


#: (B, S, Sk, H, Hkv, hd, dtype, causal)
CASES = [
    *[(b, s, s, h, hkv, hd, "float32", causal)
      for b, s, h, hkv, hd in [(2, 256, 4, 2, 64), (1, 384, 2, 2, 32),
                               (2, 128, 4, 4, 64)]
      for causal in (True, False)],
    (1, 256, 256, 2, 2, 64, "bfloat16", True),
    (1, 128, 128, 24, 2, 32, "float32", True),     # starcoder2-3b's GQA
    (1, 128, 128, 4, 2, 16, "float32", True),      # the SMOKE head dim
    (1, 128, 256, 2, 1, 32, "float32", True),      # Sk != S
    (1, 256, 128, 2, 1, 32, "float32", False),
]


@pytest.mark.parametrize("b, s, sk, h, hkv, hd, dtype, causal", CASES)
def test_flash_attention_matches_jax_kernel(b, s, sk, h, hkv, hd, dtype,
                                            causal):
    q, k, v = _inputs(s + h + hd, b, s, sk, h, hkv, hd)
    want = _flash_attention(*(_jax(x, dtype) for x in (q, k, v)),
                            causal=causal)
    got = ops.flash_attention(*(_torch(x, dtype) for x in (q, k, v)),
                              causal=causal)
    assert got.shape == (b, s, h, hd) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_flash_call_matches_jax_kernel():
    q, k, v = (x[0].transpose(1, 0, 2) for x in _inputs(3, 1, 256, 256, 3,
                                                         3, 32))
    want = _flash_call(*(jnp.asarray(x) for x in (q, k, v)))
    got = ops.flash_call(*(torch.from_numpy(x) for x in (q, k, v)))
    assert got.shape == (3, 256, 32)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ref_attention_matches_jax_ref(causal, dtype):
    """The plain version against the JAX package's, on (BH, S, hd) panels
    with Sk != S; its answer does not depend on ``chunk``."""
    q, k, v = (x[0].transpose(1, 0, 2) for x in _inputs(5, 1, 96, 160, 5,
                                                         5, 16))
    want = jref.attention(*(_jax(x, dtype) for x in (q, k, v)),
                          causal=causal)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    got = ref.attention(tq, tk, tv, causal=causal)
    _close(got, want, dtype)
    for chunk in (1, 2, 5):
        assert torch.equal(ref.attention(tq, tk, tv, causal=causal,
                                         chunk=chunk), got)


def test_gqa_plain_reads_the_kv_head_of_its_group():
    """``ref.gqa_attention`` equals ``ref.attention`` on the KV panels
    repeated per group, the reference's layout, whatever its ``chunk``."""
    b, s, h, hkv, hd = 2, 64, 6, 2, 16
    q, k, v = (torch.from_numpy(x) for x in _inputs(7, b, s, s, h, hkv, hd))

    def panels(x):
        x = x.repeat_interleave(h // x.shape[2], dim=2)
        return x.transpose(1, 2).reshape(b * h, s, hd)

    want = ref.attention(panels(q), panels(k), panels(v))
    want = want.reshape(b, h, s, hd).transpose(1, 2)
    for chunk in (None, 1, 5):
        assert torch.equal(ref.gqa_attention(q, k, v, chunk=chunk), want)


def test_answer_does_not_depend_on_tiles():
    """At tq = 64 < tk = 128 the reference's causal bound
    (``kernel.py:67``) drops key blocks and its kernel differs from its own
    ``ref.attention``; the port computes ``ref.attention``'s answer."""
    q, k, v = _inputs(11, 1, 256, 256, 2, 2, 32)
    panels = [jnp.asarray(x.transpose(0, 2, 1, 3).reshape(2, 256, 32))
              for x in (q, k, v)]
    want = np.asarray(jref.attention(*panels)).reshape(1, 2, 256, 32)
    want = want.transpose(0, 2, 1, 3)
    bad = np.asarray(_flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      tq=64, tk=128))
    assert np.abs(bad - want).max() > 0.1      # the reference's defect
    tqkv = [torch.from_numpy(x) for x in (q, k, v)]
    for tq, tk in ((64, 128), (128, 64), (128, 128), (256, 32)):
        _close(ops.flash_attention(*tqkv, tq=tq, tk=tk), want, "float32")


#: the card's limits on the bf16 kernel (chip_smoke.py: FLASH_LIMITS): the
#: relative error of the whole output and of its worst row
BF16_LIMITS = (5e-3, 1.5e-2)


@pytest.mark.parametrize("bh, s, sk, hd, causal, p_dtype", [
    (4, 512, 512, 128, True, "bfloat16"),
    (2, 130, 130, 64, True, "bfloat16"),      # one row past a 128-key tile
    (3, 200, 320, 32, False, "bfloat16"),
    (2, 256, 256, 64, True, "float32"),
])
def test_blocked_rounding_fits_the_card_limits(bh, s, sk, hd, causal,
                                                p_dtype):
    """The bf16 kernel's arithmetic (``ref.blocked_attention``: an online
    softmax over 128-key tiles, P rounded to bf16 before P V) against the
    JAX package's ``ref.attention`` on the same bf16 inputs: within the
    reference's 2e-2 and within the card's scaled limits.  With P in f32
    and f32 inputs it is ``ref.attention`` to 2e-5."""
    q, k, v = (x[0].transpose(1, 0, 2) for x in _inputs(s + sk + hd, 1, s,
                                                         sk, bh, bh, hd))
    want = jref.attention(*(_jax(x, p_dtype) for x in (q, k, v)),
                          causal=causal)
    got = ref.blocked_attention(*(_torch(x, p_dtype) for x in (q, k, v)),
                                causal=causal,
                                p_dtype=getattr(torch, p_dtype))
    assert got.shape == (bh, s, hd) and got.dtype == getattr(torch, p_dtype)
    _close(got, want, p_dtype)
    if p_dtype == "bfloat16":
        diff = got.float().numpy() - np.asarray(want, np.float32)
        want = np.asarray(want, np.float32)
        rel = np.linalg.norm(diff) / np.linalg.norm(want)
        row = (np.linalg.norm(diff, axis=-1)
               / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)).max()
        assert rel <= BF16_LIMITS[0] and row <= BF16_LIMITS[1], (rel, row)


def test_refusals():
    q, k, v = (torch.from_numpy(x) for x in _inputs(13, 1, 200, 200, 4, 2,
                                                    16))
    with pytest.raises(ValueError, match="multiples of their tiles"):
        ops.flash_attention(q, k, v)                  # 200 % 128
    ops.flash_attention(q, k, v, tq=100, tk=40)      # tiles that divide
    with pytest.raises(ValueError, match="multiples of their tiles"):
        ops.flash_call(q[:, :, 0], k[:, :, 0], v[:, :, 0], tq=64)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q[:, :, :3], k, v, tq=100, tk=100)
    with pytest.raises(ValueError, match="one dtype"):
        ops.flash_attention(q, k.bfloat16(), v, tq=100, tk=100)
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.flash_attention(*meta, tq=100, tk=100)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.flash_attention(q.numpy(), k.numpy(), v.numpy(), tq=100,
                                tk=100)
    assert ops.flash_attention_auto is ops.flash_attention
    assert ops.LAUNCHES == {"flash_fwd": 0}
