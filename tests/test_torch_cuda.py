"""The port's CUDA kernels held against their plain versions on the card.

Needs a CUDA card and nvcc; every test here skips without a card.  On a
machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import multi_value as mv
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
    assert ops.LAUNCHES == {"cops_insert": 3, "cops_lookup": 3,
                            "cops_append": 0, "cops_retrieve": 0}
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


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 8, 32])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", SUPPORTED_WINDOWS)
def test_multi_value_kernels_hold_to_plain(window, scheme, r):
    """The append under the multi-value contract, the retrieve walk
    bit-exact, at load 0.8 with r consecutive duplicates, tombstones,
    duplicate and masked queries."""
    _need_card()
    checks = contract.run_multi_case(1 << 14, window=window, scheme=scheme,
                                     device="cuda", r=r)
    torch.cuda.synchronize()
    assert all(checks.values()), checks


def _segments(values, offsets, counts):
    """Each query's values as a sorted tuple (placement sets the order)."""
    v, o = to_numpy_u32(values), offsets.cpu().numpy()
    return [tuple(sorted(v[o[i]:o[i] + c])) for i, c in
            enumerate(counts.cpu().numpy())]


@pytest.mark.cuda
def test_multi_value_table_on_card_goes_through_kernels():
    """The multi-value entry points on a CUDA table launch the append and
    retrieve kernels and agree with a CPU table, per-key multisets."""
    _need_card()
    rng = np.random.default_rng(1)
    base = rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), 400,
                      replace=False)
    keys = np.repeat(base, 5)
    vals = np.arange(keys.shape[0], dtype=np.uint32)
    mask = rng.random(keys.shape[0]) < 0.9
    queries = np.concatenate([base, base[:50], base[:20] + (1 << 20)])
    qmask = rng.random(queries.shape[0]) < 0.8
    ops.reset_launches()
    out = {}
    for dev in ("cuda", "cpu"):
        t = mv.create(4096, window=32, device=dev)
        t, st1 = mv.insert(t, keys, vals, mask=mask)
        c = mv.count_values(t, queries, mask=qmask)
        # sized by the counting pass: no segment is cut, so each holds the
        # same multiset whatever the slot placement
        seg1 = _segments(*mv.retrieve_all(t, queries, int(c.sum()),
                                          mask=qmask))
        t, erased = mv.erase(t, base[:100])
        t, st2 = mv.insert(t, keys[:300], vals[:300] + 5000)
        seg2 = _segments(*mv.retrieve_all(t, queries, 3000, mask=qmask))
        out[dev] = {"status1": st1.cpu(), "counts": c.cpu(), "seg1": seg1,
                    "erased": erased.cpu(), "status2": st2.cpu(),
                    "seg2": seg2, "count": t.count}
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"cops_insert": 0, "cops_lookup": 0,
                            "cops_append": 2, "cops_retrieve": 4}
    gpu, cpu = out["cuda"], out["cpu"]
    assert bool(((gpu["status1"] == STATUS_INSERTED)
                 | (gpu["status1"] == STATUS_MASKED)).all())
    for name, a in gpu.items():
        b = cpu[name]
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), name
