"""The port's CUDA kernels held against their plain versions on the card.

Needs a CUDA card and nvcc; every test here skips without a card.  On a
machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import single_value as sv
from repro_torch.core.common import (
    STATUS_INSERTED,
    STATUS_MASKED,
    STATUS_UPDATED,
    SUPPORTED_WINDOWS,
    to_numpy_u32,
)
from repro_torch.kernels.cops import contract, ops


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", SUPPORTED_WINDOWS)
def test_kernels_hold_to_plain(window, scheme):
    """Insert under the four-part contract, lookup bit-exact, at rho 0.9
    with tombstones and in-batch duplicates."""
    _need_card()
    checks = contract.run_case(1 << 14, window=window, scheme=scheme,
                               device="cuda")
    torch.cuda.synchronize()
    assert all(checks.values()), checks


@pytest.mark.cuda
def test_table_on_card_goes_through_kernels():
    """The public entry points on a CUDA table launch both kernels and
    agree with the same operations on a CPU table: in-batch duplicates,
    a mask, upserts, erases and re-inserts into tombstones."""
    _need_card()
    rng = np.random.default_rng(0)
    keys = rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), 3000,
                      replace=False)
    vals = rng.integers(0, 2 ** 32, 3000, dtype=np.uint32)
    dup_keys = np.concatenate([keys[:1000], keys[:200]])
    mask = rng.random(dup_keys.shape[0]) < 0.9
    ops.reset_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        t = sv.create(4096, window=32, device=dev)
        t, st1 = sv.insert(t, keys, vals)
        t, st2 = sv.insert(t, dup_keys, dup_keys ^ 1, mask=mask)
        t, erased = sv.erase(t, keys[:500])
        t, st3 = sv.insert(t, keys[:600], vals[:600])
        v, f = sv.retrieve(t, keys)
        out[dev] = (st1.cpu(), st2.cpu(), erased.cpu(), st3.cpu(),
                    to_numpy_u32(v), f.cpu(), sv.contains(t, keys).cpu(),
                    t.count)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"cops_insert": 3, "cops_lookup": 3}
    gpu, cpu = out["cuda"], out["cpu"]
    assert bool((gpu[0] == STATUS_INSERTED).all())
    assert bool(((gpu[1] == STATUS_UPDATED) | (gpu[1] == STATUS_MASKED)).all())
    for a, b in zip(gpu, cpu):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b
