"""The port's multi-value table (``repro_torch.core.multi_value``) against
the JAX reference (``repro.core.multi_value``), bit-exact.

The same seeded numpy batches go through both packages on the CPU:
``backend="jax"`` (the bulk engines) and, for a few cases,
``backend="pallas"`` (the COPS kernels in interpret mode) on the JAX side;
the port's CPU path (the kernels' plain versions) on the other.  Store
planes, statuses, live counts, per-query counts, offsets, ``retrieve_all``
values and erase counts must be equal; the arithmetic is integer, so the
tolerance is zero.

Batch shapes are fixed per window, whatever the key multiplicity r and
whichever test, so that the jitted reference compiles once per (backend,
scheme, window).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multi_value as jmv
from repro_torch.core import convert
from repro_torch.core import multi_value as tmv
from repro_torch.core.common import (
    STATUS_FULL,
    STATUS_INSERTED,
    STATUS_MASKED,
    to_numpy_u32,
)
from repro_torch.kernels.cops import ops

MIN_CAPACITY = 512          # W=1: 521 slots ... W=128: 640 slots (<= 2^12)

def _ref_round(table, keys, values, mask, queries, qmask, gone,
               out_capacity):
    """The reference's append of one batch, its reads of the store that
    leaves (the counts-only walk and the collecting one), then an erase.
    One jitted function per table geometry compiles faster than its
    operations apart."""
    table, status = jmv.insert(table, keys, values, mask)
    found = jmv.retrieve_all(table, queries, out_capacity, qmask)
    counts = jmv.count_values(table, queries, qmask)
    erased_table, erased = jmv.erase(table, gone)
    return table, status, counts, found, erased_table, erased


#: jitted without XLA's backend optimisation passes and its CPU fusion
#: emitters: integer results are the same, and it compiles 3-5x faster
_round = jax.jit(_ref_round, static_argnums=7,
                 compiler_options={"xla_backend_optimization_level": 0,
                                   "xla_cpu_use_fusion_emitters": False})


def _keys(rng, n):
    """Distinct u32 keys over the whole range, never a sentinel."""
    return rng.choice(2 ** 32 - 2, size=n, replace=False).astype(np.uint32)


def _assert_tables(jt, tt):
    np.testing.assert_array_equal(np.asarray(jt.store["keys"]),
                                  to_numpy_u32(tt.store["keys"]))
    np.testing.assert_array_equal(np.asarray(jt.store["values"]),
                                  to_numpy_u32(tt.store["values"]))
    assert int(jt.count) == tt.count


def _assert_same(j, t):
    t = to_numpy_u32(t) if t.dtype == torch.int32 else t.numpy()
    np.testing.assert_array_equal(np.asarray(j).astype(t.dtype), t)


def _both_rounds(jt, tt, keys, values, mask, queries, qmask, gone,
                 out_capacity):
    """One round on both packages, compared after each operation: the
    append (statuses, planes, count), count_values and retrieve_all on the
    store it leaves, then the erase of ``gone`` (counts, planes).
    Returns the two tables after the erase and the port's statuses."""
    jt, js, counts, found, jt_erased, erased = _round(
        jt, keys, values, jnp.asarray(mask), queries, jnp.asarray(qmask),
        gone, out_capacity)
    tt, ts = tmv.insert(tt, keys, values, mask=mask)
    _assert_same(js, ts)
    _assert_tables(jt, tt)
    _assert_same(counts, tmv.count_values(tt, queries, mask=qmask))
    for j, t in zip(found, tmv.retrieve_all(tt, queries, out_capacity,
                                            mask=qmask)):
        _assert_same(j, t)
    tt, te = tmv.erase(tt, gone)
    _assert_same(erased, te)
    _assert_tables(jt_erased, tt)
    return jt_erased, tt, ts


def _scenario(backend, scheme, window, r, seed=0):
    """Two rounds: append (r consecutive duplicates + mask) -> count /
    retrieve_all -> erase, then append onto the tombstones -> count /
    retrieve_all -> erase.  Returns the second batch's statuses."""
    rng = np.random.default_rng([seed, window, r])
    jt = jmv.create(MIN_CAPACITY, window=window, scheme=scheme,
                    backend=backend)
    tt = tmv.create(MIN_CAPACITY, window=window, scheme=scheme, device="cpu")
    cap = jt.capacity
    b = int(0.85 * cap)
    pool = _keys(rng, 2 * b)
    base, fresh = pool[: -(-b // r)], pool[b:]
    keys = np.repeat(base, r)[:b]
    vals = rng.integers(0, 2 ** 32, b, dtype=np.uint32)
    mask = rng.random(b) < 0.95
    # distinct present keys, absent keys, duplicate queries; one fixed
    # shape.  The output holds half the slots: r = 1 fits, r = 4 and 16
    # overflow it and are truncated.
    q = 96
    queries = np.concatenate([pool[:q], fresh[:q // 4], pool[:q // 4]])
    qmask = rng.random(queries.shape[0]) < 0.8
    gone = np.concatenate([pool[: b // 64], pool[:4], fresh[:4]])
    jt, tt, _ = _both_rounds(jt, tt, keys, vals, mask, queries, qmask, gone,
                             cap // 2)

    # half more pairs of present (and erased) keys, half new keys; the
    # table runs close to full
    k2 = np.concatenate([keys[: b // 2], np.repeat(fresh[q:], r)[: b - b // 2]])
    v2 = rng.integers(0, 2 ** 32, b, dtype=np.uint32)
    m2 = (np.arange(b) % 3 == 0) & (rng.random(b) < 0.95)
    gone2 = pool[b // 64: 2 * (b // 64) + 8]     # the same shape as gone
    _, _, ts = _both_rounds(jt, tt, k2, v2, m2, queries, qmask, gone2,
                            cap // 2)
    return ts


@pytest.mark.parametrize("r", [1, 4, 16])
@pytest.mark.parametrize("window", [1, 8, 32, 128])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
def test_parity_with_jax(scheme, window, r):
    status = _scenario("jax", scheme, window, r)
    assert (status == STATUS_INSERTED).any() and (status == STATUS_MASKED).any()


@pytest.mark.parametrize("scheme, window, r", [("cops", 8, 4),
                                               ("linear", 32, 16)])
def test_parity_with_pallas(scheme, window, r):
    """The same scenario against the Pallas append and retrieve kernels."""
    status = _scenario("pallas", scheme, window, r, seed=1)
    assert (status == STATUS_INSERTED).any()


@pytest.mark.parametrize("window", [1, 32])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
def test_parity_near_full(scheme, window):
    """More pairs than slots: FULL statuses, the store they leave and the
    reads of a full table match the reference."""
    rng = np.random.default_rng(window)
    jt = jmv.create(MIN_CAPACITY, window=window, scheme=scheme,
                    backend="jax")
    tt = tmv.create(MIN_CAPACITY, window=window, scheme=scheme, device="cpu")
    b = int(0.85 * jt.capacity)             # the scenario's shapes
    base = _keys(rng, b + 8)
    base, absent = base[:b], base[b:]
    every = np.ones(b, bool)
    queries = np.concatenate([base[:96], base[-24:], base[:24]])
    for half in (base[: b // 2], base[b // 2:]):
        keys = np.repeat(half, 2)[:b]
        vals = rng.integers(0, 2 ** 32, b, dtype=np.uint32)
        # erase absent keys only: the table stays as full as it was
        jt, tt, ts = _both_rounds(jt, tt, keys, vals, every, queries,
                                  np.ones(144, bool),
                                  np.resize(absent, b // 64 + 8),
                                  jt.capacity // 2)
    assert (ts == STATUS_FULL).sum() == 2 * b - tt.capacity
    assert tt.load_factor() == 1.0


def test_empty_batches_and_empty_table():
    rng = np.random.default_rng(3)
    jt = jmv.create(MIN_CAPACITY, window=8, backend="jax")
    tt = tmv.create(MIN_CAPACITY, window=8, device="cpu")
    cap = jt.capacity
    b = int(0.85 * cap)                      # the scenario's shapes
    keys = _keys(rng, b)
    queries = keys[:144]
    # an all-masked batch leaves the table empty: nothing counted,
    # nothing retrieved, nothing erased
    jt, tt, ts = _both_rounds(jt, tt, keys, keys, np.zeros(b, bool), queries,
                              rng.random(144) < 0.8, keys[: b // 64 + 8],
                              cap // 2)
    assert bool((ts == STATUS_MASKED).all()) and tt.count == 0
    # empty batches
    tt, st = tmv.insert(tt, keys[:0], keys[:0])
    assert st.shape == (0,) and tt.count == 0
    assert tmv.count_values(tt, keys[:0]).shape == (0,)
    for j, t in zip(jmv.retrieve_all(jt, keys[:0], 5),
                    tmv.retrieve_all(tt, keys[:0], 5)):
        _assert_same(j, t)
    tt, te = tmv.erase(tt, keys[:0])
    assert te.shape == (0,)


def test_start_from_jax_state():
    """A JAX-built multi-value store with tombstones crosses the numpy
    bridge, and both packages go on from it identically."""
    rng = np.random.default_rng(5)
    jt = jmv.create(MIN_CAPACITY, window=8, backend="jax")
    cap = jt.capacity
    b = int(0.85 * cap)                      # the scenario's shapes
    base = _keys(rng, b // 2)
    keys = np.repeat(base, 4)[:b]
    every = np.ones(b, bool)
    reads = (base[:144], jnp.ones(144, bool), base[: b // 64 + 8], cap // 2)
    jt = _round(jt, keys, rng.integers(0, 2 ** 32, b, dtype=np.uint32),
                jnp.asarray(every), *reads)[4]          # after the erase
    tt = convert.multi_table_from_numpy(
        np.asarray(jt.store["keys"]), np.asarray(jt.store["values"]),
        int(jt.count), num_rows=jt.num_rows, window=jt.window,
        scheme=jt.scheme, seed=jt.seed, max_probes=jt.max_probes,
        device="cpu")
    assert isinstance(tt, tmv.MultiValueHashTable)
    _assert_tables(jt, tt)
    back = convert.table_to_numpy(tt)
    np.testing.assert_array_equal(back["keys"], np.asarray(jt.store["keys"]))
    np.testing.assert_array_equal(back["values"],
                                  np.asarray(jt.store["values"]))
    assert back["count"] == int(jt.count)
    more = np.repeat(np.concatenate([base[:b // 8], _keys(rng, b)]), 3)[:b]
    mv = rng.integers(0, 2 ** 32, b, dtype=np.uint32)
    _both_rounds(jt, tt, more, mv, rng.random(b) < 0.3, base[:144],
                 np.ones(144, bool), base[b // 64: 2 * (b // 64) + 8],
                 cap // 2)


def test_cpu_table_launches_no_kernel():
    ops.reset_launches()
    tt = tmv.create(256, device="cpu")
    keys = np.repeat(np.arange(1, 31, dtype=np.uint32), 3)
    tt, _ = tmv.insert(tt, keys, keys)
    tmv.count_values(tt, keys)
    tmv.retrieve_all(tt, keys, 300)
    tmv.erase(tt, keys[:10])
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.parametrize("kwargs", [
    {"key_words": 3}, {"value_words": 2}, {"scheme": "quadratic"},
    {"scheme": "bucketed"}, {"kind": "bucketed"}, {"layout": "aos"},
    {"layout": "packed"}, {"layout": "bucketed"},
])
def test_unported_configurations_refuse(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmv.create(64, device="cpu", **kwargs)


def test_unknown_configurations_raise():
    with pytest.raises(ValueError, match="quotient"):
        tmv.create(64, quotient=True, device="cpu")
    with pytest.raises(ValueError):
        tmv.create(64, kind="cuckoo", device="cpu")
    with pytest.raises(ValueError):
        tmv.create(64, scheme="cuckoo", device="cpu")
    with pytest.raises(ValueError):
        tmv.insert(tmv.create(64, device="cpu"), np.ones(4, np.uint32),
                   np.ones(3, np.uint32))


def test_create_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: create() uses it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmv.create(64)
