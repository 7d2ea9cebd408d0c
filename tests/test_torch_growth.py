"""The port's growth policy (``repro_torch.core.migrate``: ``GrowthPolicy``,
``occupancy``, ``maybe_migrate``, ``insert_or_grow``, ``compact_in_graph``)
against the JAX package's (``repro.core.migrate``), bit-exact.

The same seeded numpy batches go through both packages on the CPU, with
the reference's default ``"jax"`` backend (the bulk engines, which build
the same planes as the port's plain versions): after every call the store
planes, the statuses, the table's capacity and count, and the deltas of
the ``table.grows`` / ``table.compactions`` / ``table.migrated_slots``
counters of each package's ``REGISTRY`` must be equal.  The reference's
host-side policy runs eagerly; its single-value and multi-value inserts
are jitted once per table shape (``monkeypatch``), the way its callers
run them.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import counting as jcnt
from repro.core import migrate as jmig
from repro.core import multi_value as jmv
from repro.core import single_value as jsv
from repro.obs.registry import REGISTRY as JREG
from repro_torch.core import counting as tcnt
from repro_torch.core import migrate as tmig
from repro_torch.core import multi_value as tmv
from repro_torch.core import single_value as tsv
from repro_torch.core.common import STATUS_FULL, to_numpy_u32
from repro_torch.obs.registry import REGISTRY as TREG

COUNTERS = ("table.grows", "table.compactions", "table.migrated_slots")
_OPT = {"xla_backend_optimization_level": 0,
        "xla_cpu_use_fusion_emitters": False}


@pytest.fixture(autouse=True)
def jitted_reference(monkeypatch):
    """The reference's inserts and erases, jitted (one compile per table
    and batch shape, cached across the tests of this file)."""
    for mod, names in ((jsv, ("insert", "erase")), (jmv, ("insert",))):
        for name in names:
            monkeypatch.setattr(mod, name, _JITTED[mod.__name__, name])


_JITTED = {(mod.__name__, name): jax.jit(getattr(mod, name),
                                         compiler_options=_OPT)
           for mod, names in ((jsv, ("insert", "erase")),
                              (jmv, ("insert",)))
           for name in names}


def _keys(rng, n):
    return rng.choice(2 ** 32 - 2, size=n, replace=False).astype(np.uint32)


def _counters(reg):
    return np.array([reg.counter(n).value for n in COUNTERS])


class Both:
    """A table in each package, driven by the same calls; ``check`` holds
    their planes, capacity, count and counter deltas equal."""

    def __init__(self, jt, tt):
        self.j, self.t = jt, tt
        self.j0, self.t0 = _counters(JREG), _counters(TREG)

    def check(self, what, js=None, ts=None):
        np.testing.assert_array_equal(np.asarray(self.j.store["keys"]),
                                      to_numpy_u32(self.t.store["keys"]),
                                      what)
        np.testing.assert_array_equal(np.asarray(self.j.store["values"]),
                                      to_numpy_u32(self.t.store["values"]),
                                      what)
        assert self.j.capacity == self.t.capacity, what
        assert int(self.j.count) == self.t.count, what
        np.testing.assert_array_equal(_counters(JREG) - self.j0,
                                      _counters(TREG) - self.t0, what)
        if js is not None:
            np.testing.assert_array_equal(np.asarray(js), ts.numpy(), what)

    def grown(self):
        return (_counters(TREG) - self.t0)[:2]


def test_policy_defaults_match():
    assert tmig.GrowthPolicy() == tmig.DEFAULT_POLICY
    for f in ("max_load_factor", "max_tombstone_density", "growth_factor",
              "max_capacity"):
        assert getattr(tmig.DEFAULT_POLICY, f) == getattr(jmig.DEFAULT_POLICY,
                                                          f)
    hash(tmig.DEFAULT_POLICY)                       # frozen: a static field
    with pytest.raises(Exception):
        tmig.DEFAULT_POLICY.max_capacity = 1


def _filled(rng, n_live, n_erase, capacity=256, window=8):
    keys = _keys(rng, n_live)
    b = Both(jsv.create(capacity, window=window),
             tsv.create(capacity, window=window, device="cpu"))
    b.j, _ = jsv.insert(b.j, keys, keys)
    b.t, _ = tsv.insert(b.t, keys, keys)
    if n_erase:
        b.j, _ = jsv.erase(b.j, keys[:n_erase])
        b.t, _ = tsv.erase(b.t, keys[:n_erase])
    return b


@pytest.mark.parametrize("decision", ["grow", "compact_tombstones",
                                      "compact_at_cap", "noop"])
def test_maybe_migrate_decisions(decision):
    """The policy's four outcomes ahead of a batch, each the reference's:
    grow for load, compact for tombstone density, compact at the capacity
    cap, and nothing below both thresholds; ``occupancy`` beside."""
    rng = np.random.default_rng([8, len(decision)])
    live, erase, incoming, pol = {
        "grow": (200, 0, 60, dict(max_load_factor=0.8)),
        "compact_tombstones": (150, 100, 0, dict(max_tombstone_density=0.2)),
        "compact_at_cap": (200, 60, 60, dict(max_capacity=256)),
        "noop": (50, 10, 20, {}),
    }[decision]
    b = _filled(rng, live, erase)
    assert tmig.occupancy(b.t) == jmig.occupancy(b.j)
    before = b.t
    b.j = jmig.maybe_migrate(b.j, jmig.GrowthPolicy(**pol), incoming)
    b.t = tmig.maybe_migrate(b.t, tmig.GrowthPolicy(**pol), incoming)
    b.check(decision)
    grows, compactions = b.grown()
    assert (grows, compactions) == {"grow": (1, 0),
                                    "compact_tombstones": (0, 1),
                                    "compact_at_cap": (0, 1),
                                    "noop": (0, 0)}[decision]
    assert (b.t is before) == (decision == "noop")


def test_single_value_insert_or_grow():
    """Batches into a 64-slot table under a policy that grows it four
    times: no element FULL, every step the reference's; then erases and a
    batch that compacts before it inserts."""
    rng = np.random.default_rng(81)
    pool = _keys(rng, 900)
    vals = rng.integers(0, 2 ** 32, 900, dtype=np.uint32)
    pol_j = jmig.GrowthPolicy(max_load_factor=0.8, max_capacity=4096)
    pol_t = tmig.GrowthPolicy(max_load_factor=0.8, max_capacity=4096)
    b = Both(jsv.create(64, window=8), tsv.create(64, window=8, device="cpu"))
    for i in range(6):
        k, v = pool[i * 100:(i + 1) * 100], vals[i * 100:(i + 1) * 100]
        mask = np.arange(100) % 9 != 4
        b.j, js = jsv.insert_or_grow(b.j, k, v, mask, policy=pol_j)
        b.t, ts = tsv.insert_or_grow(b.t, k, v, mask, policy=pol_t)
        b.check(f"batch {i}", js, ts)
        assert not (ts == STATUS_FULL).any()
    assert b.grown()[0] >= 3
    b.j, _ = jsv.erase(b.j, pool[:300])
    b.t, _ = tsv.erase(b.t, pool[:300])
    tight_j = jmig.GrowthPolicy(max_load_factor=0.8, max_capacity=4096,
                                max_tombstone_density=0.1)
    tight_t = tmig.GrowthPolicy(max_load_factor=0.8, max_capacity=4096,
                                max_tombstone_density=0.1)
    c0 = b.grown()[1]
    k = pool[600:700]
    b.j, js = jsv.insert_or_grow(b.j, k, k, policy=tight_j)
    b.t, ts = tsv.insert_or_grow(b.t, k, k, policy=tight_t)
    b.check("compacting batch", js, ts)
    assert b.grown()[1] == c0 + 1
    live = np.concatenate([pool[300:600][np.arange(300) % 100 % 9 != 4],
                           pool[600:700]])
    got, found = tsv.retrieve(b.t, live)
    assert found.all()


def test_insert_or_grow_retries_the_full_subset():
    """A budget of two windows makes elements FULL although occupancy says
    the batch fits: the emergency grow and the retry of the failed subset
    under its own mask, and FULL surfacing at the cap, as the
    reference."""
    rng = np.random.default_rng(6)
    keys = _keys(rng, 100)              # 6 of them FULL in the first insert
    for cap, label in ((4096, "retried"), (128, "at the cap")):
        b = Both(jsv.create(128, window=2, max_probes=2),
                 tsv.create(128, window=2, max_probes=2, device="cpu"))
        b.j, js = jsv.insert_or_grow(
            b.j, keys, keys, policy=jmig.GrowthPolicy(max_load_factor=0.99,
                                                      max_capacity=cap))
        b.t, ts = tsv.insert_or_grow(
            b.t, keys, keys, policy=tmig.GrowthPolicy(max_load_factor=0.99,
                                                      max_capacity=cap))
        b.check(label, js, ts)
        assert (ts == STATUS_FULL).any() == (label == "at the cap")


def test_multi_value_insert_or_grow():
    """Pairs with runs of duplicates into a 64-slot multi-value table,
    grown as the reference grows it, with a mask."""
    rng = np.random.default_rng(83)
    keys = np.repeat(_keys(rng, 150), 4)
    vals = np.arange(600, dtype=np.uint32)
    pol_j = jmig.GrowthPolicy(max_capacity=2048)
    pol_t = tmig.GrowthPolicy(max_capacity=2048)
    b = Both(jmv.create(64, window=8), tmv.create(64, window=8, device="cpu"))
    for i in range(3):
        sl = slice(i * 200, (i + 1) * 200)
        mask = np.arange(200) % 7 != 1
        b.j, js = jmv.insert_or_grow(b.j, keys[sl], vals[sl], mask,
                                     policy=pol_j)
        b.t, ts = tmv.insert_or_grow(b.t, keys[sl], vals[sl], mask,
                                     policy=pol_t)
        b.check(f"batch {i}", js, ts)
    assert b.grown()[0] >= 2
    counts = tmv.count_values(b.t, keys[::4])
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(jmv.count_values(b.j, keys[::4])))


def test_counting_insert_or_grow():
    """The counting table's adapter: running counts carried through every
    grow, each step the reference's; the counts equal a numpy count."""
    rng = np.random.default_rng(84)
    universe = _keys(rng, 300)
    b = Both(jcnt.create(32, window=8),
             tcnt.create(32, window=8, device="cpu"))
    pol_j = jmig.GrowthPolicy(max_load_factor=0.7, max_capacity=2048)
    pol_t = tmig.GrowthPolicy(max_load_factor=0.7, max_capacity=2048)
    seen = []
    for i in range(3):
        rows = universe[rng.integers(0, 100 * (i + 1), 250)]
        seen.append(rows)
        b.j, js = jcnt.insert_or_grow(b.j, rows, policy=pol_j)
        b.t, ts = tcnt.insert_or_grow(b.t, rows, policy=pol_t)
        b.check(f"batch {i}", js, ts)
    assert b.grown()[0] >= 1
    keys, want = np.unique(np.concatenate(seen), return_counts=True)
    got = to_numpy_u32(tcnt.counts(b.t, keys))
    np.testing.assert_array_equal(got, want)


def test_compact_in_graph():
    """Same-geometry compaction with no counters, as the reference's;
    multi-value and bucket-list tables raise TypeError."""
    rng = np.random.default_rng(85)
    b = _filled(rng, 150, 90)
    b.j = jmig.compact_in_graph(b.j)
    b.t = tmig.compact_in_graph(b.t)
    b.check("compact_in_graph")
    assert b.grown().tolist() == [0, 0]
    assert tmig.occupancy(b.t)[1] == 0
    from repro_torch.core import bucket_list as tbl
    for t in (tmv.create(64, device="cpu"),
              tbl.create(64, 128, device="cpu")):
        with pytest.raises(TypeError):
            tmig.compact_in_graph(t)


@pytest.mark.parametrize("call", ["insert_or_grow", "maybe_migrate",
                                  "occupancy", "grow"])
def test_bucket_list_refuses_growth(call):
    from repro_torch.core import bucket_list as tbl
    t = tbl.create(64, 128, device="cpu")
    keys = np.arange(1, 9, dtype=np.uint32)
    fn = {"insert_or_grow": lambda: tmig.insert_or_grow(t, keys, keys),
          "maybe_migrate": lambda: tmig.maybe_migrate(t, tmig.DEFAULT_POLICY),
          "occupancy": lambda: tmig.occupancy(t),
          "grow": lambda: tmig.grow(t, 256)}[call]
    with pytest.raises(NotImplementedError, match="item 5b"):
        fn()


def test_grown_capacity_steps():
    """The geometric step and its clamp, against the reference's."""
    for cap, need, pol in ((64, 1000, {}), (100, 80, {}), (64, 10 ** 9, {}),
                           (64, 300, dict(growth_factor=1.5)),
                           (1000, 5000, dict(max_capacity=3000))):
        assert (tmig._grown_capacity(cap, need, tmig.GrowthPolicy(**pol))
                == jmig._grown_capacity(cap, need, jmig.GrowthPolicy(**pol)))


def test_insert_or_grow_takes_key_spellings():
    """u64 keys and a torch mask go through the one normalization."""
    rng = np.random.default_rng(86)
    keys = rng.integers(1, 2 ** 63, 200, dtype=np.uint64)
    t = tsv.create(64, window=8, device="cpu", key_words=2)
    t, st = tsv.insert_or_grow(
        t, keys, np.arange(200, dtype=np.uint32),
        torch.ones(200, dtype=torch.bool),
        policy=tmig.GrowthPolicy(max_capacity=1024))
    assert not (st == STATUS_FULL).any() and t.count == 200
    _, found = tsv.retrieve(t, keys)
    assert found.all()

