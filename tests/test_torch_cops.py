"""The COPS kernel module of the port (``repro_torch.kernels.cops``).

On the CPU the wrappers run the plain versions, which are held here,
bit-exact, against the Pallas TPU kernels they replace — ``_insert_kernel``
(both modes), ``_lookup_kernel`` and ``_retrieve_kernel`` in interpret
mode, reached through ``repro.kernels.cops.ops`` — on the same seeded
store and batches.  The rest checks the wrappers' dispatch rules, the
contract checkers that hold the CUDA insert and append kernels on the
card, and the plain engine's building blocks.  The CUDA kernels themselves run in
``tests/test_torch_cuda.py`` (card only) and ``chip_smoke.py``.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bulk as jbulk
from repro.core import bulk_retrieve as jbr
from repro.core import multi_value as jmv
from repro.core import single_value as jsv
from repro.kernels.cops import ops as pallas_ops
from repro_torch.core import bulk as tbulk
from repro_torch.core import bulk_retrieve as tbr
from repro_torch.core import multi_value as tmv
from repro_torch.core import probing
from repro_torch.core import single_value as tsv
from repro_torch.core.common import (
    EMPTY_WORD,
    SUPPORTED_WINDOWS,
    STATUS_FULL,
    STATUS_INSERTED,
    TOMBSTONE_WORD,
    as_u32,
    as_word,
    to_numpy_u32,
)
from repro_torch.kernels import build
from repro_torch.kernels.cops import contract, ops

CASES = [(1, "cops"), (32, "cops"), (128, "cops"), (8, "linear")]
#: XLA's backend optimisation passes and CPU fusion emitters off: same
#: integer results, faster compile
_FAST = {"xla_backend_optimization_level": 0,
         "xla_cpu_use_fusion_emitters": False}


def _keys(rng, n):
    return rng.choice(2 ** 32 - 2, size=n, replace=False).astype(np.uint32)


def _store(window, scheme, seed=0):
    """A port table (CPU) at rho ~0.7 holding tombstones, plus the keys it
    holds, erased keys and never-inserted keys."""
    rng = np.random.default_rng([seed, window])
    t = tsv.create(1024, window=window, scheme=scheme, device="cpu")
    n = int(0.7 * t.capacity)
    pool = _keys(rng, 2 * n)
    keys, other = pool[:n], pool[n:]
    t, _ = tsv.insert(t, keys, rng.integers(0, 2 ** 32, n, dtype=np.uint32))
    t, _ = tsv.erase(t, keys[: n // 5])
    return t, keys, other, rng


def _pallas_table(t, module=jsv):
    """The JAX table (backend "pallas") holding the port table's state."""
    jt = module.create(t.capacity, window=t.window, scheme=t.scheme,
                       backend="pallas")
    assert jt.num_rows == t.num_rows
    return dataclasses.replace(
        jt, store={"keys": jnp.asarray(to_numpy_u32(t.store["keys"])),
                   "values": jnp.asarray(to_numpy_u32(t.store["values"]))},
        count=jnp.int32(t.count))


def _kw(t):
    return dict(seed=t.seed, scheme=t.scheme,
                max_probes=tbulk._tstatic(t)[3])


@pytest.mark.parametrize("window, scheme", CASES)
def test_insert_plain_matches_pallas_insert_kernel(window, scheme):
    """Distinct keys (what the kernel gets after dedup), half present, half
    new, onto a store with tombstones: same planes, same statuses."""
    t, keys, other, rng = _store(window, scheme)
    batch = np.concatenate([keys[: t.capacity // 8], other[: t.capacity // 8]])
    rng.shuffle(batch)
    vals = rng.integers(0, 2 ** 32, batch.shape[0], dtype=np.uint32)
    jt, jst = jax.jit(pallas_ops.insert, compiler_options=_FAST)(
        _pallas_table(t), batch, vals)
    kp, vp = t.store["keys"][0], t.store["values"][0]
    st = ops.insert(kp, vp, torch.from_numpy(batch.view(np.int32)),
                    torch.from_numpy(vals.view(np.int32)), count=t.count,
                    **_kw(t))
    np.testing.assert_array_equal(np.asarray(jst), st.numpy())
    np.testing.assert_array_equal(np.asarray(jt.store["keys"][0]),
                                  to_numpy_u32(kp))
    np.testing.assert_array_equal(np.asarray(jt.store["values"][0]),
                                  to_numpy_u32(vp))
    assert int(jt.count) == t.count + int((st == STATUS_INSERTED).sum())


@pytest.mark.parametrize("window, scheme", CASES)
def test_lookup_plain_matches_pallas_lookup_kernel(window, scheme):
    t, keys, other, _ = _store(window, scheme, seed=1)
    queries = np.concatenate([keys, other[:256]])
    jv, jf = jax.jit(pallas_ops.retrieve, compiler_options=_FAST)(
        _pallas_table(t), queries)
    kp, vp = t.store["keys"][0], t.store["values"][0]
    v, f, slot = ops.lookup(kp, vp, torch.from_numpy(queries.view(np.int32)),
                            slots=True, **_kw(t))
    np.testing.assert_array_equal(np.asarray(jv), to_numpy_u32(v))
    np.testing.assert_array_equal(np.asarray(jf), f.numpy())
    assert bool((slot[~f] == -1).all())
    np.testing.assert_array_equal(to_numpy_u32(kp.reshape(-1)[slot[f]]),
                                  queries[f.numpy()])


def _words(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("window, scheme", CASES)
def test_append_plain_matches_pallas_append_kernel(window, scheme):
    """Pairs of present, erased and new keys, each 3 times in a row, onto a
    store with tombstones, filling it: same planes, same statuses (FULL
    included)."""
    t, keys, other, rng = _store(window, scheme, seed=5)
    distinct = np.concatenate([keys[: t.capacity // 16],
                               other[: t.capacity // 8]])
    batch = np.repeat(distinct, 3)
    vals = rng.integers(0, 2 ** 32, batch.shape[0], dtype=np.uint32)
    jt, jst = jax.jit(pallas_ops.insert_multi, compiler_options=_FAST)(
        _pallas_table(t, jmv), batch, vals)
    kp, vp = t.store["keys"][0], t.store["values"][0]
    st = ops.append(kp, vp, _words(batch), _words(vals), **_kw(t))
    np.testing.assert_array_equal(np.asarray(jst), st.numpy())
    assert (st == STATUS_FULL).any() and (st == STATUS_INSERTED).any()
    np.testing.assert_array_equal(np.asarray(jt.store["keys"][0]),
                                  to_numpy_u32(kp))
    np.testing.assert_array_equal(np.asarray(jt.store["values"][0]),
                                  to_numpy_u32(vp))


@pytest.mark.parametrize("window, scheme", CASES)
def test_retrieve_walk_plain_matches_pallas_retrieve_kernel(window, scheme):
    """Counts and both slot arenas, bit for bit, against the Pallas walk
    and the JAX engine's ``fused_walk``: a multi-value store with
    tombstones, duplicate and absent queries, a mask."""
    rng = np.random.default_rng([6, window])
    t = tmv.create(1024, window=window, scheme=scheme, device="cpu")
    base = _keys(rng, t.capacity // 4)
    t, _ = tmv.insert(t, np.repeat(base, 3), _keys(rng, 3 * base.shape[0]))
    t, _ = tmv.erase(t, base[::5])
    q = np.concatenate([base[:100], base[:30], _keys(rng, 20)])
    live = rng.random(q.shape[0]) < 0.9
    qt = _words(q)
    is_rep, _ = tbr.group_queries(qt, torch.from_numpy(live))
    got = ops.retrieve_walk(t.store["keys"][0], qt, is_rep, collect=True,
                            **_kw(t))
    jt = _pallas_table(t, jmv)
    keys_n = jnp.asarray(q)[:, None]
    _, _, *pallas = pallas_ops._fused_walk_pallas(jt, keys_n,
                                                  jnp.asarray(live))
    engine = jbr.fused_walk(jbr._tstatic(jt), jt.store, keys_n,
                            jnp.asarray(q), jnp.asarray(is_rep.numpy()),
                            collect=True)
    for want in (pallas, engine):
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    counts, qa, ra = ops.retrieve_walk(t.store["keys"][0], qt, is_rep,
                                       collect=False, **_kw(t))
    assert torch.equal(counts, got[0]) and qa is None and ra is None


def test_cpu_wrappers_are_the_plain_versions():
    t, keys, other, _ = _store(16, "cops", seed=2)
    q = torch.from_numpy(np.concatenate([keys, other]).view(np.int32))
    kp, vp = t.store["keys"][0], t.store["values"][0]
    ops.reset_launches()
    got = ops.lookup(kp, vp, q, slots=True, **_kw(t))
    want = ops.lookup_plain(kp, vp, q, slots=True, **_kw(t))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    planes = [(kp.clone(), vp.clone()) for _ in range(2)]
    v = q ^ 0x5A5A
    s1 = ops.insert(*planes[0], q, v, count=t.count, **_kw(t))
    s2 = ops.insert_plain(*planes[1], q, v, count=t.count, **_kw(t))
    assert torch.equal(s1, s2)
    assert all(torch.equal(a, b) for a, b in zip(planes[0], planes[1]))
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def test_plain_chunks_replay_batch_order(monkeypatch):
    """Walking the batch in chunks gives the planes and statuses of one
    whole-batch walk (the engine replays sequential insert order)."""
    t, keys, other, rng = _store(8, "cops", seed=3)
    batch = torch.from_numpy(np.concatenate([keys, other]).view(np.int32))
    vals = batch ^ 77
    runs = []
    for chunk in (ops.PLAIN_CHUNK, 97):
        monkeypatch.setattr(ops, "PLAIN_CHUNK", chunk)
        kp, vp = t.store["keys"][0].clone(), t.store["values"][0].clone()
        st = ops.insert_plain(kp, vp, batch, vals, count=t.count, **_kw(t))
        lk = ops.lookup_plain(kp, vp, batch, slots=True, **_kw(t))
        runs.append((st, kp, vp, *lk))
    assert (runs[0][0] == STATUS_FULL).any()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_multi_plain_chunks_replay_batch_order(monkeypatch):
    """The plain append and walk give the same planes, statuses, counts
    and arenas in chunks as in one whole batch."""
    t, keys, other, _ = _store(8, "linear", seed=7)
    batch = _words(np.repeat(np.concatenate([keys[:60], other[:200]]), 3))
    vals = batch ^ 91
    runs = []
    for chunk in (ops.PLAIN_CHUNK, 97):
        monkeypatch.setattr(ops, "PLAIN_CHUNK", chunk)
        kp, vp = t.store["keys"][0].clone(), t.store["values"][0].clone()
        st = ops.append_plain(kp, vp, batch, vals, **_kw(t))
        q = batch[::3]
        walk = ops.retrieve_walk_plain(kp, q, torch.ones(q.shape, dtype=bool),
                                       collect=True, **_kw(t))
        runs.append((st, kp, vp, *walk))
    assert (runs[0][0] == STATUS_FULL).any()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_wrappers_refuse_other_devices_and_shapes():
    kp = torch.full((7, 4), EMPTY_WORD, dtype=torch.int32)
    vp = torch.zeros((7, 4), dtype=torch.int32)
    k = torch.arange(5, dtype=torch.int32)
    kw = dict(seed=1, scheme="cops", max_probes=7)
    meta = [x.to("meta") for x in (kp, vp, k)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.lookup(*meta, **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.insert(*meta, meta[2], count=0, **kw)
    with pytest.raises(ValueError, match="several devices"):
        ops.lookup(kp, vp, k.to("meta"), **kw)
    with pytest.raises(ValueError):
        ops.lookup(kp, vp, k, seed=1, scheme="quadratic", max_probes=7)
    with pytest.raises(ValueError):
        ops.insert(kp, vp, k, k[:3], count=0, **kw)
    with pytest.raises(ValueError):
        ops.lookup(kp[None], vp[None], k, **kw)
    with pytest.raises(ValueError, match="window"):
        ops.lookup(kp[:, :3], vp[:, :3], k, **kw)
    every = torch.ones(5, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.append(*meta, meta[2], **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.retrieve_walk(meta[0], meta[2], every.to("meta"), collect=True,
                          **kw)
    with pytest.raises(ValueError, match="several devices"):
        ops.retrieve_walk(kp, k, every.to("meta"), collect=True, **kw)
    with pytest.raises(ValueError):
        ops.retrieve_walk(kp, k, every[:3], collect=False, **kw)
    with pytest.raises(ValueError):
        ops.append(kp, vp[:3], k, k, **kw)


@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", SUPPORTED_WINDOWS)
def test_contract_case_runs_on_cpu(window, scheme):
    """The kernel-vs-plain case of the card, run where both sides are the
    plain versions: every check holds."""
    checks = contract.run_case(600, window=window, scheme=scheme,
                               device="cpu")
    assert len(checks) == 8 and all(checks.values()), checks


def test_contract_catches_broken_stores():
    """Each part of the contract fails on the fault it is there to catch."""
    t, _, _, _ = _store(4, "linear", seed=4)
    kw = _kw(t)
    good = (t.store["keys"][0].clone(), t.store["values"][0].clone())
    st = torch.zeros(10, dtype=torch.int32)
    assert all(contract.check_insert(good, good, st, st, **kw).values())

    bad_value = tuple(x.clone() for x in good)
    live = (bad_value[0] != EMPTY_WORD) & (bad_value[0] != TOMBSTONE_WORD)
    bad_value[1][live.nonzero()[0, 0], live.nonzero()[0, 1]] ^= 1
    assert not contract.check_insert(bad_value, good, st, st,
                                     **kw)["same_map"]

    assert not contract.check_insert(good, good, st, st + 1,
                                     **kw)["same_status"]
    full = torch.full((10,), STATUS_FULL, dtype=torch.int32)
    assert contract.check_insert(good, good, full, st, **kw)["same_status"]

    # move a key that sits in its first row, next to an EMPTY lane, into an
    # EMPTY slot of another row: the map is unchanged, but the key now lies
    # past the first EMPTY window of its walk
    moved = tuple(x.clone() for x in good)
    flat_k, flat_v = moved[0].view(-1), moved[1].view(-1)
    lk, _, lslot = contract.live_map(*moved)
    rows = lslot // t.window
    has_empty = (moved[0] == EMPTY_WORD).any(1)
    home = probing.initial_row(lk, t.num_rows, t.seed)
    src = int(lslot[(rows == home) & has_empty[rows]][0])
    empties = (flat_k == EMPTY_WORD).nonzero().squeeze(1)
    dst = int(empties[empties // t.window != src // t.window][0])
    flat_k[dst], flat_v[dst] = flat_k[src], flat_v[src]
    flat_k[src] = TOMBSTONE_WORD
    res = contract.check_insert(moved, good, st, st, **kw)
    assert res["same_map"] and not res["before_first_empty"], res


@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("values", [True, False], ids=["values", "hash-set"])
@pytest.mark.parametrize("window, batch", [(1, None), (32, None),
                                           (128, None), (32, 9)])
def test_insert_race_case_runs_on_cpu(window, batch, values, key_words):
    """The card's race of claims on one row (every key starts its walk on
    row 0), run where both sides are the plain versions: every check
    holds."""
    checks = contract.run_insert_race_case(
        window=window, device="cpu", key_words=key_words, values=values,
        rounds=4, batch=batch)
    assert len(checks) == 9 and all(checks.values()), checks


def test_insert_race_case_catches_a_lost_value(monkeypatch):
    """The race case fails when the insert stores a wrong value for a key
    it claims."""
    real = ops.insert

    def insert(table_keys, table_values, keys, values, **kw):
        status = real(table_keys, table_values, keys, values, **kw)
        _, _, slot = ops.lookup_plain(table_keys, None, keys[:1], slots=True,
                                      seed=kw["seed"], scheme=kw["scheme"],
                                      max_probes=kw["max_probes"])
        table_values.view(-1)[slot] ^= 1
        return status

    monkeypatch.setattr(ops, "insert", insert)
    checks = contract.run_insert_race_case(window=4, device="cpu", rounds=1)
    assert not checks["batch1_same_map"], checks
    assert checks["batch1_same_status"], checks


@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", [4, 32, 128])
def test_lookup_case_runs_on_cpu(window, scheme, key_words):
    """The card's lookup case (a table near full with TOMBSTONE-only
    windows, budgets of 1 and 2 windows, sentinel queries), run where both
    sides are the plain versions: every lookup agrees, and the case
    reaches the walks it is for."""
    checks = contract.run_lookup_case(window=window, scheme=scheme,
                                      device="cpu", key_words=key_words)
    assert len(checks) == 15 and all(checks.values()), checks


@pytest.mark.parametrize("fault", ["slot", "budget"])
def test_lookup_case_catches_a_wrong_lookup(monkeypatch, fault):
    """The lookup case fails when the lookup reports a found key one lane
    off ("slot": only the checks with slots fail), or walks past a budget
    of one window ("budget": only the checks at small budgets fail)."""
    real = ops.lookup

    def lookup(table_keys, table_values, keys, *, max_probes, slots=False,
               **kw):
        if fault == "budget":
            max_probes = max(max_probes, 3)
        values, found, slot = real(table_keys, table_values, keys,
                                   max_probes=max_probes, slots=slots, **kw)
        if fault == "slot" and slot is not None:
            slot = torch.where(found, slot ^ 1, slot)
        return values, found, slot

    monkeypatch.setattr(ops, "lookup", lookup)
    checks = contract.run_lookup_case(window=32, device="cpu")
    bad = {k for k, ok in checks.items() if not ok}
    if fault == "slot":
        assert bad == {k for k in checks if k.endswith("_slots")}, checks
    else:
        assert bad and all(k.startswith(("exact_b1_", "exact_b2_"))
                           for k in bad), checks


@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("window", [4, 32])
def test_plen_case_runs_on_cpu(window, key_words):
    """The card's probe-length case (``contract.run_plen_case``: TOMBSTONE-
    only windows, budgets of 1, 2 and num_rows + 3 windows on a store
    without EMPTY, sentinel queries), run where both sides are the plain
    versions: every lookup agrees, and the case reaches the walks it is
    for."""
    checks = contract.run_plen_case(window=window, device="cpu",
                                    key_words=key_words)
    assert len(checks) == 20 and all(checks.values()), checks


@pytest.mark.parametrize("fault", ["revisit", "lost_value"])
def test_plen_case_catches_a_wrong_probe_length(monkeypatch, fault):
    """The probe-length case fails when a walk that spends its budget
    reports the windows it read (its clamp at num_rows) in place of the
    budget ("revisit": only the num_rows + 3 checks fail), or when the
    ``plen`` launch loses the values ("lost_value": only the checks with a
    value plane fail)."""
    real = ops.lookup

    def lookup(table_keys, table_values, keys, *, max_probes, slots=False,
               plen=False, **kw):
        out = real(table_keys, table_values, keys, max_probes=max_probes,
                   slots=slots, plen=plen, **kw)
        if not plen:
            return out
        values, found, slot, lengths = out
        if fault == "revisit":
            lengths = lengths.clamp(max=table_keys.shape[-2])
        elif values is not None:
            values = torch.zeros_like(values)
        return values, found, slot, lengths

    monkeypatch.setattr(ops, "lookup", lookup)
    checks = contract.run_plen_case(window=32, device="cpu")
    bad = {k for k, ok in checks.items() if not ok}
    if fault == "revisit":
        assert bad == {"exact_rows3_values", "exact_rows3_set"}, checks
    else:
        assert bad == {k for k in checks
                       if k.startswith(("exact_", "same_"))
                       and k.endswith("_values")}, checks


@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", [4, 32, 128])
def test_retrieve_case_runs_on_cpu(window, scheme, key_words):
    """The card's retrieve case (runs of 1, 8 and 40 equal keys in a store
    near full, TOMBSTONE-only windows, erased pairs, masks that leave whole
    groups of 8 queries inactive, budgets of 1 and 2 windows and one past
    num_rows on a store with no EMPTY window, sentinel queries), run where
    both sides are the plain versions: every walk agrees, and the case
    reaches the walks it is for.  At W = 4 on 2^10 slots (256 rows), so
    that the walks past num_rows stay short on the CPU."""
    checks = contract.run_retrieve_case(
        window=window, scheme=scheme, device="cpu", key_words=key_words,
        capacity=1 << 10 if window == 4 else 1 << 12)
    assert len(checks) == 19 and all(checks.values()), checks


@pytest.mark.parametrize("fault", ["rank", "budget", "inactive"])
def test_retrieve_case_catches_a_wrong_walk(monkeypatch, fault):
    """The retrieve case fails where the walk is wrong, and only there: a
    stamped rank one too high ("rank": the collecting checks), a walk one
    window past its budget ("budget": the cut walks, at 1 and 2 windows
    and past num_rows; the table's budget ends no walk here), a count of 1
    for an inactive query ("inactive": the checks under the mask)."""
    real = ops.retrieve_walk

    def retrieve_walk(table_keys, keys, active, *, max_probes, collect,
                      **kw):
        if fault == "budget":
            max_probes += 1
        counts, qa, ra = real(table_keys, keys, active,
                              max_probes=max_probes, collect=collect, **kw)
        if fault == "rank" and ra is not None:
            ra = torch.where(qa < keys.shape[0], ra + 1, ra)
        if fault == "inactive":
            counts = torch.where(active, counts, 1)
        return counts, qa, ra

    monkeypatch.setattr(ops, "retrieve_walk", retrieve_walk)
    checks = contract.run_retrieve_case(window=32, device="cpu")
    bad = {k for k, ok in checks.items() if not ok}
    concerned = {"rank": lambda k: k.endswith("_collect"),
                 "budget": lambda k: k.startswith(
                     ("exact_b1_", "exact_b2_", "exact_rows3_")),
                 "inactive": lambda k: "_groups_" in k}[fault]
    assert bad == {k for k in checks if concerned(k)}, checks


@pytest.mark.parametrize("r, growth, s0", [(1, 1.1, 1), (8, 1.1, 1),
                                           (32, 1.0, 32)])
def test_bucket_case_runs_on_cpu(r, growth, s0):
    """The card's bucket-walk case (Fig. 7's wc-bl cells, chains grown
    across two batches, duplicate and absent queries) at 2^12 pairs, run
    where both sides are the plain version: every check holds."""
    checks = contract.run_bucket_case(1 << 12, r=r, growth=growth, s0=s0,
                                      device="cpu")
    assert len(checks) == 6 and all(checks.values()), checks


def _chain_reference(table, active, ptr, cnt, bidx):
    """``repro.core.bucket_list.chain_arena`` on the port table's pool,
    schedule and handles."""
    from repro.core import bucket_list as jbl
    jt = jbl.create(64, table.pool_capacity, s0=table.s0,
                    growth=table.growth)
    assert jt.sizes == table.sizes and jt.cum == table.cum
    jt = dataclasses.replace(jt, pool=jnp.asarray(to_numpy_u32(table.pool)))
    walk = jax.jit(lambda t, *a: jbl.chain_arena(t, *a),
                   compiler_options=_FAST)
    qa, ra = walk(jt, jnp.asarray(active.numpy()),
                  *(jnp.asarray(to_numpy_u32(x)) for x in (ptr, cnt, bidx)))
    return (torch.from_numpy(np.asarray(qa).astype(np.int32)),
            torch.from_numpy(np.asarray(ra).astype(np.int32)))


@pytest.mark.parametrize("growth, s0", [(1.1, 1), (2.0, 4)])
def test_chain_case_runs_on_cpu(growth, s0):
    """The card's scattered-chain case (24 insert batches, chains of up to
    18 buckets at growth 1.1 and of 128-value buckets at growth 2, batches
    of 1, 7, 8, 9 and 33 queries, whole warps inactive), run where both
    sides are the plain version: every walk agrees, gives each query its
    key's values in insertion order and, on the whole batch, equals the
    JAX package's ``chain_arena``; and the case reaches what it is for."""
    checks = contract.run_chain_case(growth=growth, s0=s0, device="cpu",
                                     reference=_chain_reference)
    assert len(checks) == 31 and all(checks.values()), checks


@pytest.mark.parametrize("fault", ["rank", "link"])
def test_chain_case_catches_a_wrong_walk(monkeypatch, fault):
    """The chain case fails where the walk is wrong, and only there: the
    ranks 0 and 1 of each chain stamped swapped ("rank"), and a walk that
    skips the link out
    of each tail bucket, so the bucket before it keeps no stamps ("link");
    every batch starts with a long key, so every walk check fails and the
    checks of the build and of what the case reaches hold."""
    real = ops.bucket_walk

    def bucket_walk(pool, ptr, cnt, bidx, active, sizes, cum):
        qa, ra = real(pool, ptr, cnt, bidx, active, sizes, cum)
        n = ptr.shape[0]
        if fault == "rank":
            ra = torch.where((qa < n) & (ra < 2), 1 - ra, ra)
        else:
            q = torch.nonzero(active & (bidx > 0)).squeeze(1)
            j = bidx[q].long() - 1
            start = as_u32(pool[as_u32(ptr[q])]) + (j > 0)
            for s, v in zip(start.tolist(), sizes.long()[j].tolist()):
                qa[s:s + v], ra[s:s + v] = n, 0
        return qa, ra

    monkeypatch.setattr(ops, "bucket_walk", bucket_walk)
    checks = contract.run_chain_case(growth=1.1, s0=1, device="cpu")
    bad = {k for k, ok in checks.items() if not ok}
    assert bad == {k for k in checks
                   if k.startswith(("exact_", "values_"))}, checks


#: every window and scheme in Fig. 7's layout (the ids these cases always
#: had), the other layouts at W = 2, 32 and 128
_MULTI_CPU_CASES = (
    [pytest.param(w, s, "runs", id=f"{w}-{s}") for w in SUPPORTED_WINDOWS
     for s in ("cops", "linear")]
    + [pytest.param(w, s, layout, id=f"{w}-{s}-{layout}")
       for layout in contract.LAYOUTS[1:] for w in (2, 32, 128)
       for s in ("cops", "linear")])


@pytest.mark.parametrize("window, scheme, layout", _MULTI_CPU_CASES)
def test_multi_contract_case_runs_on_cpu(window, scheme, layout):
    """The multi-value kernel-vs-plain case of the card, run where both
    sides are the plain versions: every check holds, in every layout."""
    checks = contract.run_multi_case(600, window=window, scheme=scheme,
                                     device="cpu", layout=layout)
    assert len(checks) == 24 and all(checks.values()), checks


@pytest.mark.parametrize("key_words", [1, 2])
@pytest.mark.parametrize("scheme", ["cops", "linear"])
@pytest.mark.parametrize("window", [w for w in SUPPORTED_WINDOWS if w > 1])
def test_full_contract_case_runs_on_cpu(window, scheme, key_words):
    """The near-full case of the card (runs that go FULL partway), run
    where both sides are the plain versions: every check holds."""
    checks = contract.run_full_case(600, window=window, scheme=scheme,
                                    device="cpu", key_words=key_words)
    assert len(checks) == 7 and all(checks.values()), checks


def test_layouts_reorder_the_runs():
    """Each layout is a reordering of the same pairs: "offset" the runs
    rolled by an odd count, "interleaved" two keys alternating, "shuffled"
    a seeded permutation; two-word keys are laid out whole."""
    keys = torch.arange(10, 15, dtype=torch.int32)
    runs = contract.lay_out(keys, 3, "runs")
    assert runs.tolist() == [10, 10, 10, 11, 11, 11, 12, 12, 12, 13, 13, 13,
                             14, 14, 14]
    assert contract.lay_out(keys, 3, "offset").tolist() == torch.roll(
        runs, contract.OFFSET).tolist()
    assert contract.lay_out(keys, 3, "interleaved").tolist() == [
        10, 11, 10, 11, 10, 11, 12, 13, 12, 13, 12, 13, 14, 14, 14]
    shuffled = contract.lay_out(keys, 3, "shuffled")
    assert shuffled.tolist() != runs.tolist()
    assert torch.equal(shuffled.sort().values, runs)
    assert torch.equal(shuffled, contract.lay_out(keys, 3, "shuffled"))
    planes = torch.stack([keys, -keys], dim=1)
    assert torch.equal(contract.lay_out(planes, 3, "interleaved")[:, 0],
                       contract.lay_out(keys, 3, "interleaved"))
    assert torch.equal(contract.lay_out(planes, 3, "interleaved")[:, 1],
                       -contract.lay_out(keys, 3, "interleaved"))
    with pytest.raises(ValueError):
        contract.lay_out(keys, 3, "sorted")


def test_multi_contract_catches_broken_stores():
    """Each part of the append contract fails on the fault it is there to
    catch."""
    t = tmv.create(512, window=8, scheme="linear", device="cpu")
    rng = np.random.default_rng(8)
    base = _keys(rng, 100)
    keys = _words(np.repeat(base, 2))
    t, st = tmv.insert(t, keys, keys ^ 5)
    kw = _kw(t)
    good = (t.store["keys"][0].clone(), t.store["values"][0].clone())
    assert all(contract.check_append(good, good, keys, st, st, **kw).values())

    bad_value = tuple(x.clone() for x in good)
    live = (bad_value[0] != EMPTY_WORD) & (bad_value[0] != TOMBSTONE_WORD)
    bad_value[1][live.nonzero()[0, 0], live.nonzero()[0, 1]] ^= 1
    res = contract.check_append(bad_value, good, keys, st, st, **kw)
    assert not res["same_pairs"] and not res["same_retrieve"], res

    assert not contract.check_append(good, good, keys, st, st + 1,
                                     **kw)["same_status"]
    # a FULL report where the walk still has a free lane
    full = st.clone()
    full[0] = STATUS_FULL
    assert not contract.check_append(good, good, keys, full, st,
                                     **kw)["same_status"]

    # move a pair that sits in its first row, next to an EMPTY lane, into
    # an EMPTY slot of another row: the multiset is unchanged, but the pair
    # now lies past the first EMPTY window of its key's walk
    moved = tuple(x.clone() for x in good)
    flat_k, flat_v = moved[0].view(-1), moved[1].view(-1)
    lk, _, lslot = contract.live_map(*moved)
    rows = lslot // t.window
    has_empty = (moved[0] == EMPTY_WORD).any(1)
    home = probing.initial_row(lk, t.num_rows, t.seed)
    src = int(lslot[(rows == home) & has_empty[rows]][0])
    empties = (flat_k == EMPTY_WORD).nonzero().squeeze(1)
    dst = int(empties[empties // t.window != src // t.window][-1])
    flat_k[dst], flat_v[dst] = flat_k[src], flat_v[src]
    flat_k[src] = TOMBSTONE_WORD
    res = contract.check_append(moved, good, keys, st, st, **kw)
    assert res["same_pairs"] and not res["before_first_empty"], res
    assert not res["same_retrieve"], res


def test_rank_and_lane_blocks_match_reference():
    """The plain placement's building blocks, bit-exact against the JAX
    engine's: the packed rank sort, popcount and the n-th set lane."""
    rng = np.random.default_rng(9)
    n, p = 2000, 211
    row = rng.integers(0, p, n).astype(np.uint32)
    alive = rng.random(n) < 0.8
    want = jbulk._rank_by_row(jnp.asarray(row), jnp.arange(n, dtype=jnp.uint32),
                              jnp.asarray(alive), p, True)
    got = tbulk._rank_by_row(torch.from_numpy(row.astype(np.int64)),
                             torch.from_numpy(alive))
    np.testing.assert_array_equal(np.asarray(want)[alive], got.numpy()[alive])
    mask = rng.integers(0, 2 ** 32, n, dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(jax.lax.population_count(jnp.asarray(mask))),
        tbulk._popcount32(torch.from_numpy(mask.astype(np.int64))).numpy())
    for window in (4, 32):
        m = mask & np.uint32((1 << window) - 1 if window < 32 else 0xFFFFFFFF)
        cnt = np.asarray(jax.lax.population_count(jnp.asarray(m)))
        rank = (rng.random(n) * np.maximum(cnt, 1)).astype(np.int32)
        want = jbulk._nth_set_lane(jnp.asarray(m), jnp.asarray(rank), window)
        got = tbulk._nth_set_lane(torch.from_numpy(m.astype(np.int64)),
                                  torch.from_numpy(rank.astype(np.int64)),
                                  window)
        ok = cnt > 0
        np.testing.assert_array_equal(np.asarray(want)[ok], got.numpy()[ok])


def test_rank_by_row_with_priorities_matches_reference():
    """The rank sort with a caller's priorities (the bucket list's batch
    positions in its sorted domain), bit-exact against the JAX engine's."""
    rng = np.random.default_rng(10)
    n, p = 2000, 211
    row = rng.integers(0, p, n).astype(np.uint32)
    alive = rng.random(n) < 0.8
    prio = rng.permutation(n).astype(np.uint32)
    want = jbulk._rank_by_row(jnp.asarray(row), jnp.asarray(prio),
                              jnp.asarray(alive), p, False)
    got = tbulk._rank_by_row(torch.from_numpy(row.astype(np.int64)),
                             torch.from_numpy(alive),
                             torch.from_numpy(prio.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(want)[alive], got.numpy()[alive])
    assert not got.numpy()[~alive].any()


def test_build_finds_sources_and_needs_nvcc():
    assert "cops" in build.sources()
    assert build.library_path("cops").parent == build.BUILD_DIR
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present here")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        pytest.skip("a CUDA toolkit is present here")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()
