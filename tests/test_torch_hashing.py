"""The port's hashing, probing and geometry against the JAX reference.

Seeded numpy words (4096 of them, half >= 2^31) go through both packages;
every comparison is exact (integer arithmetic, zero tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import common as jcommon
from repro.core import hashing as jh
from repro.core import probing as jp
from repro_torch.core import common as tcommon
from repro_torch.core import hashing as th
from repro_torch.core import probing as tp

SEEDS = [0, 1, tcommon.DEFAULT_SEED, 0xFFFFFFFF, 0x12345678]


def _words(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    w[:8] = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 3, 2 ** 32 - 2,
             2 ** 32 - 1, 12345]
    assert (w >= 2 ** 31).sum() > n // 3
    return w


def _same(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


@pytest.mark.parametrize("spelling", ["int32", "int64"])
@pytest.mark.parametrize("name", ["mix_murmur3", "unmix_murmur3",
                                  "mix_xxhash"])
def test_mixers(name, spelling):
    w = _words()
    x = torch.from_numpy(w.view(np.int32) if spelling == "int32"
                         else w.astype(np.int64))
    _same(getattr(jh, name)(jnp.asarray(w)), getattr(th, name)(x))


def test_unmix_inverts_mix():
    x = torch.from_numpy(_words(3).astype(np.int64))
    assert torch.equal(th.unmix_murmur3(th.mix_murmur3(x)), x)


@pytest.mark.parametrize("seed", SEEDS)
def test_full_hash(seed):
    w = _words(seed & 0xFF)
    _same(jh.full_hash(jnp.asarray(w), seed),
          th.full_hash(torch.from_numpy(w.view(np.int32)), seed))


@pytest.mark.parametrize("num_rows", [3, 521, 9973, 9320683, 2 ** 31 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_rows_and_steps(num_rows, seed):
    w = _words(num_rows % 97)
    x = torch.from_numpy(w.view(np.int32))
    rows = th.hash_rows(x, num_rows, seed)
    steps = th.hash_step(x, num_rows, seed)
    _same(jh.hash_rows(jnp.asarray(w), num_rows, seed), rows)
    _same(jh.hash_step(jnp.asarray(w), num_rows, seed), steps)
    assert int(rows.min()) >= 0 and int(rows.max()) < num_rows
    assert int(steps.min()) >= 1 and int(steps.max()) <= num_rows - 1


@pytest.mark.parametrize("scheme", ["cops", "linear"])
def test_probe_walk(scheme):
    """Ten rows of every walk, bit-exact against the reference's walk."""
    w = _words(11)
    p = 9973
    seed = tcommon.DEFAULT_SEED
    jrow = jp.initial_row(jnp.asarray(w), p, seed)
    jstep = jp.row_step(scheme, jnp.asarray(w), p, seed)
    x = torch.from_numpy(w.view(np.int32))
    row = tp.initial_row(tcommon.as_u32(x), p, seed)
    step = tp.row_step(scheme, tcommon.as_u32(x), p, seed)
    for attempt in range(10):
        _same(jrow, row)
        jrow = jp.advance_row(scheme, jrow, jstep, jnp.int32(attempt), p)
        row = tp.advance_row(row, step, p)


@pytest.mark.parametrize("scheme", ["cops", "linear", "quadratic",
                                    "bucketed"])
@pytest.mark.parametrize("num_rows", [3, 5, 101, 9973])
def test_probe_budget(scheme, num_rows):
    assert tp.scheme_coverage(scheme, num_rows) == \
        jp.scheme_coverage(scheme, num_rows)
    for budget in (1, 2, num_rows // 2 + 1, num_rows, 10 * num_rows):
        assert tp.effective_probes(scheme, budget, num_rows) == \
            jp.effective_probes(scheme, budget, num_rows)


def test_unported_schemes_refuse_a_step():
    x = torch.arange(4)
    for scheme in ("quadratic", "bucketed"):
        with pytest.raises(NotImplementedError):
            tp.row_step(scheme, x, 7, 0)


@pytest.mark.parametrize("window", [1, 8, 32, 128])
def test_votes(window):
    rng = np.random.default_rng(window)
    mask = rng.random((256, window)) < 0.05
    _same(jp.vote_lowest(jnp.asarray(mask)),
          tp.vote_lowest(torch.from_numpy(mask)))
    np.testing.assert_array_equal(np.asarray(jp.vote_any(jnp.asarray(mask))),
                                  tp.vote_any(torch.from_numpy(mask)).numpy())


@pytest.mark.parametrize("window", tcommon.SUPPORTED_WINDOWS)
def test_geometry(window):
    for cap in (1, 2, 3, 64, 100, 1000, 4096, 298261856, 2 ** 28 * 10 // 9):
        assert tcommon.table_geometry(cap, window) == \
            jcommon.table_geometry(cap, window)


@pytest.mark.parametrize("window", [0, 3, 5, 48, 256])
def test_unsupported_window(window):
    with pytest.raises(ValueError):
        tcommon.table_geometry(64, window)


def test_constants_match():
    for name in ("EMPTY_KEY", "TOMBSTONE_KEY", "MAX_USER_KEY",
                 "STATUS_INSERTED", "STATUS_UPDATED", "STATUS_FULL",
                 "STATUS_MASKED", "STATUS_POOL_FULL", "SUPPORTED_WINDOWS",
                 "DEFAULT_WINDOW", "DEFAULT_SEED"):
        assert getattr(tcommon, name) == getattr(jcommon, name), name
    assert np.uint32(tcommon.EMPTY_KEY).view(np.int32) == tcommon.EMPTY_WORD
    assert (np.uint32(tcommon.TOMBSTONE_KEY).view(np.int32)
            == tcommon.TOMBSTONE_WORD)


def test_word_round_trip():
    w = _words(7)
    for x in (w, torch.from_numpy(w.view(np.int32)),
              torch.from_numpy(w.view(np.int32)).view(torch.uint32)):
        np.testing.assert_array_equal(
            tcommon.to_numpy_u32(tcommon.to_words(x)), w)
    for bad in (w.astype(np.float32), torch.from_numpy(w.astype(np.int64))):
        with pytest.raises(TypeError):
            tcommon.to_words(bad)
