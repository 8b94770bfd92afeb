"""The port's paged KV arena against the JAX reference and its own
properties: the layout (leaves, axes, offsets, planes, page bytes, pages
per request) of a synthetic cache tree and of the seven archs' caches at
REDUCED and full config, probed from ``meta`` tensors; the page pool's
invariants and LIFO order; insert/gather round trips, the zero tail of a
partial page, a scatter writing one row plus the residents, slot reuse
clearing stale state and isolation under churn; the null row that stands
for the reference's out-of-bounds sentinel staying zero; and the same
operations on the same data giving the reference's gathered caches bit
for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

import repro.configs as rconfigs
from repro.models import build_model as r_build_model
from repro.serve import KVArena as RKVArena
from repro.serve import PagePool as RPagePool
from repro.serve import gather_caches as r_gather
from repro.serve import plan_kv_layout as r_plan
from repro.serve import scatter_step as r_scatter
from repro.serve.kv_arena import build_insert_fn as r_build_insert

import repro_torch.configs as tconfigs
from repro_torch.interop import caches_from_jax, caches_to_numpy
from repro_torch.models import build_model
from repro_torch.serve import KVArena, PagePool, gather_caches, plan_kv_layout, scatter_step
from repro_torch.serve.kv_arena import build_insert_fn, tree_flatten, tree_unflatten

torch.set_num_threads(2)

PS = 4          # page_size
MAXLEN = 16     # -> 4 pages per slot


# the reference test's synthetic cache families: stacked attention-style
# (paged), recurrent state (resident), and an int8 leaf (second plane)
def spec_fn(batch, max_len):
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "blocks": {
            "k": m(2, batch, max_len, 3, 4),
            "v": m(2, batch, max_len, 3, 4),
            "k8": m(batch, max_len, 6, dtype=torch.int8),
        },
        "state": {"h": m(batch, 5, 7), "conv": m(batch, 4)},
    }


def r_spec_fn(batch, max_len):
    return jax.tree.map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.int8 if t.dtype == torch.int8
                                       else jnp.float32),
        spec_fn(batch, max_len))


@pytest.fixture(scope="module")
def layout():
    return plan_kv_layout(spec_fn, MAXLEN, PS)


def _rand_caches(rng, tokens, batch=1):
    """Random small integers in every leaf (exact in every dtype)."""
    specs, paths = tree_flatten(spec_fn(batch, tokens))
    return tree_unflatten(paths, [
        torch.from_numpy(rng.integers(-3, 4, size=tuple(s.shape))).to(s.dtype)
        for s in specs])


def _slot_view(layout, caches, slot):
    """Per-slot (batch axis dropped) leaves of a gathered batched cache."""
    vals, _ = tree_flatten(caches)
    return [torch.movedim(v, lf.batch_axis, 0)[slot].numpy()
            for lf, v in zip(layout.leaves, vals)]


def _assert_layout_equal(got, want):
    assert (got.page_size, got.tokens, got.pages_per_slot) == \
        (want.page_size, want.tokens, want.pages_per_slot)
    assert got.plane_dtypes == want.plane_dtypes
    assert got.plane_elems == want.plane_elems
    assert [dataclasses.astuple(l) for l in got.leaves] == \
        [dataclasses.astuple(l) for l in want.leaves]
    assert got.page_bytes() == want.page_bytes()
    assert (got.has_paged, got.has_resident) == (want.has_paged, want.has_resident)
    for n in (0, 1, got.page_size - 1, got.page_size, got.page_size + 1, got.tokens):
        assert got.pages_per_request(n) == want.pages_per_request(n), n


# ---------------------------------------------------------------------------
# layout planning
# ---------------------------------------------------------------------------


def test_layout_classification(layout):
    by_name = {l.name: l for l in layout.leaves}
    assert by_name["blocks/k"].paged and by_name["blocks/k"].time_axis == 1
    assert by_name["blocks/k8"].paged and by_name["blocks/k8"].time_axis == 0
    assert not by_name["state/h"].paged
    assert not by_name["state/conv"].paged
    assert layout.plane_dtypes == ("float32", "int8")
    assert layout.tokens == MAXLEN and layout.pages_per_slot == 4
    assert layout.plane_elems[0] == max(2 * 2 * PS * 3 * 4, 5 * 7 + 4)
    assert layout.plane_elems[1] == PS * 6
    # leaf order is the reference's tree_flatten order: keys sorted
    assert [l.name for l in layout.leaves] == [
        "blocks/k", "blocks/k8", "blocks/v", "state/conv", "state/h"]
    assert by_name["blocks/v"].offset == by_name["blocks/k"].numel
    assert by_name["state/h"].offset == by_name["state/conv"].numel


@pytest.mark.parametrize("max_len", [13, 16, 17])
def test_synthetic_layout_equals_reference(max_len):
    _assert_layout_equal(plan_kv_layout(spec_fn, max_len, PS),
                         r_plan(r_spec_fn, max_len, PS))
    assert plan_kv_layout(spec_fn, 13, PS).tokens == 16


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", tconfigs.reference_archs())
def test_model_layout_equals_reference(arch, full, kv):
    """Probed on ``meta`` against the reference's ``ShapeDtypeStruct``s:
    every leaf (name, per-slot shape, dtype, axes, plane, offset, numel),
    the planes, page bytes and pages per request; the full configs at the
    chip smoke's ``max_len`` 1024 and page 16, REDUCED at 48 and 8."""
    get = "get_config" if full else "get_reduced"
    rcfg = getattr(rconfigs, get)(arch).with_(kv_cache_dtype=kv)
    cfg = getattr(tconfigs, get)(arch).with_(kv_cache_dtype=kv)
    max_len, ps = (1024, 16) if full else (48, 8)
    got = plan_kv_layout(build_model(cfg, device="meta").cache_specs, max_len, ps)
    want = r_plan(r_build_model(rcfg).cache_specs, max_len, ps)
    _assert_layout_equal(got, want)
    # gemma2's local layer keeps a rolling window, resident where the
    # window (16 REDUCED, 4096 full) is shorter than the arena; the
    # recurrent states (xlstm, zamba2) and seamless's memory keys and
    # values (mem_k, mem_v: frontend_tokens long whatever max_len) are
    # resident; xlstm has no KV cache
    resident = arch in ("xlstm-125m", "zamba2-2.7b", "seamless-m4t-medium")
    assert got.has_resident == (resident or (arch == "gemma2-27b" and not full))
    if arch == "seamless-m4t-medium":
        assert [l.name for l in got.leaves if not l.paged] == ["mem_k", "mem_v"]
    assert got.has_paged == (arch != "xlstm-125m")
    assert ("int8" in got.plane_dtypes) == (kv == "int8" and arch != "xlstm-125m")


def test_full_width_page_bytes():
    """The serving arena of full-width gpt2-paper and qwen1.5-0.5b: bytes
    a token, a page and 8 slots x 1024 positions at page 16."""
    def arena_bytes(arch, kv=""):
        cfg = tconfigs.get_config(arch).with_(kv_cache_dtype=kv)
        lay = plan_kv_layout(build_model(cfg, device="meta").cache_specs, 1024, 16)
        pages = KVArena.auto_pages(lay, 8)
        return lay.page_bytes(), pages, pages * lay.page_bytes()

    assert arena_bytes("gpt2-paper") == (589_824, 512, 301_989_888)
    assert arena_bytes("gpt2-paper", "int8") == (304_128, 512, 155_713_536)
    assert arena_bytes("qwen1.5-0.5b") == (1_572_864, 512, 805_306_368)


@pytest.mark.parametrize("arch,layers,want", [
    ("zamba2-2.7b", None, ((18_544_896, 737_280), 75_654_144, 520)),
    ("zamba2-2.7b", 12, ((4_121_088, 163_840), 16_812_032, 520)),
    ("xlstm-125m", None, ((5_331_492,), 21_325_968, 8)),
])
def test_recurrent_arena_rows_equal_reference(arch, layers, want):
    """The recurrent archs' arenas at 8 slots, max_len 1024, page 16, as
    the reference lays them out: a page id indexes every plane, so each
    row of a plane is as wide as the wider of a token page and one slot's
    whole resident state; zamba2's f32 rows carry its Mamba2 states (only
    8 of its 520 rows ever hold one), xlstm has resident rows only."""
    cfg, rcfg = tconfigs.get_config(arch), rconfigs.get_config(arch)
    if layers is not None:
        cfg, rcfg = cfg.with_(num_layers=layers), rcfg.with_(num_layers=layers)
    got = plan_kv_layout(build_model(cfg, device="meta").cache_specs, 1024, 16)
    ref = r_plan(r_build_model(rcfg).cache_specs, 1024, 16)
    _assert_layout_equal(got, ref)
    elems, page_bytes, pages = want
    assert got.plane_elems == elems and got.page_bytes() == page_bytes
    assert KVArena.auto_pages(got, 8) == RKVArena.auto_pages(ref, 8) == pages


def test_arena_planes_hold_a_null_row_outside_nbytes(layout):
    arena = KVArena(layout, num_pages=6, num_slots=2, device="cpu")
    ref = RKVArena(r_plan(r_spec_fn, MAXLEN, PS), num_pages=6, num_slots=2)
    assert arena.nbytes() == ref.nbytes() == 6 * layout.page_bytes()
    assert [tuple(p.shape) for p in arena.planes] == \
        [(7, w) for w in layout.plane_elems]
    assert arena.null == ref.null == 6
    pt, rt = arena.device_tables()
    assert pt.dtype == torch.long and tuple(pt.shape) == (2, 4)
    assert torch.all(pt == 6) and torch.all(rt == 6)


def test_arena_defaults_to_the_card(layout):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVArena(layout, num_pages=2, num_slots=1)


# ---------------------------------------------------------------------------
# page pool
# ---------------------------------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 1), st.integers(0, 6)),
                    min_size=1, max_size=40))
def test_page_pool_invariants_and_order_equal_reference(ops):
    pool, ref = PagePool(8), RPagePool(8)
    held: list[list[int]] = []
    for kind, n in ops:
        if kind == 0:
            before = pool.available
            got = pool.alloc(n)
            assert got == ref.alloc(n)          # LIFO: the reference's pages
            if n > before:
                assert got is None and pool.available == before
            else:
                assert got is not None and len(got) == n
                held.append(got)
        elif held:
            pages = held.pop(n % len(held))
            pool.free(pages)
            ref.free(pages)
        out = [p for h in held for p in h]
        assert len(out) == len(set(out)), "double allocation"
        assert pool.available + len(out) == 8 == ref.available + len(out)
        assert set(out).isdisjoint(set(pool._free))


def test_page_pool_rejects_double_free():
    pool = PagePool(4)
    pages = pool.alloc(2)
    pool.free(pages)
    with pytest.raises(ValueError):
        pool.free(pages)


# ---------------------------------------------------------------------------
# gather / insert / scatter round trips
# ---------------------------------------------------------------------------


def _insert(arena, insert, slot, caches):
    ids, rid = arena.insert_ids(slot)
    insert(arena.planes, caches, ids, rid)


def _null_rows_zero(arena):
    return all(not p[-1].any() for p in arena.planes)


def test_insert_gather_round_trip(layout):
    rng = np.random.default_rng(0)
    arena = KVArena(layout, num_pages=16, num_slots=3, device="cpu")
    insert = build_insert_fn(layout)
    src = {}
    for slot in (0, 2):
        assert arena.acquire_slot(slot, MAXLEN)  # all pages
        src[slot] = _rand_caches(rng, layout.tokens)
        _insert(arena, insert, slot, src[slot])
    assert _null_rows_zero(arena)

    pt, rt = arena.device_tables()
    got = gather_caches(layout, arena.planes, pt, rt)
    for slot in (0, 2):
        want = _slot_view(layout, src[slot], 0)
        have = _slot_view(layout, got, slot)
        for lf, w, h in zip(layout.leaves, want, have):
            np.testing.assert_array_equal(w, h, err_msg=lf.name)
    # slot 1 was never allocated: gathers exact zeros
    for lf, h in zip(layout.leaves, _slot_view(layout, got, 1)):
        assert not np.any(h), lf.name


def test_partial_pages_gather_zero_tail(layout):
    """A request holding ceil(L/ps) pages gathers its own rows and exact
    zeros beyond its last page, though the prefilled cache it came from
    has values there: the null-padded tail of the insert is dropped."""
    rng = np.random.default_rng(1)
    arena = KVArena(layout, num_pages=16, num_slots=2, device="cpu")
    insert = build_insert_fn(layout)
    L = 6  # -> 2 of 4 pages
    assert arena.acquire_slot(0, L)
    src = _rand_caches(rng, layout.tokens)
    _insert(arena, insert, 0, src)
    assert _null_rows_zero(arena)

    pt, rt = arena.device_tables()
    got = gather_caches(layout, arena.planes, pt, rt)
    n_rows = 2 * PS
    for lf, w, h in zip(layout.leaves, _slot_view(layout, src, 0),
                        _slot_view(layout, got, 0)):
        if lf.paged:
            w, h = np.moveaxis(w, lf.time_axis, 0), np.moveaxis(h, lf.time_axis, 0)
            np.testing.assert_array_equal(w[:n_rows], h[:n_rows], err_msg=lf.name)
            assert not np.any(h[n_rows:]), lf.name
        else:
            np.testing.assert_array_equal(w, h, err_msg=lf.name)


def _batch2(layout, caches, other=None):
    """A batch-1 cache tree widened to 2 slots (slot 1 zeros or ``other``)."""
    vals, paths = tree_flatten(caches)
    second = tree_flatten(other)[0] if other is not None else [torch.zeros_like(v) for v in vals]
    return tree_unflatten(paths, [torch.cat([v, o], dim=lf.batch_axis)
                                  for lf, v, o in zip(layout.leaves, vals, second)])


def test_scatter_step_writes_one_row_and_residents(layout):
    """Slot 0 writes its row at ``pos`` and its residents; slot 1, with
    null tables and nonzero values, writes only the null row, which is
    zero again after the scatter."""
    rng = np.random.default_rng(2)
    arena = KVArena(layout, num_pages=16, num_slots=2, device="cpu")
    assert arena.acquire_slot(0, MAXLEN)
    pos_val = 9
    caches = _rand_caches(rng, layout.tokens)
    batched = _batch2(layout, caches, _rand_caches(rng, layout.tokens))
    pt, rt = arena.device_tables()
    pos = torch.tensor([pos_val, 0])
    scatter_step(layout, arena.planes, pt, rt, batched, pos)
    assert _null_rows_zero(arena)

    got = gather_caches(layout, arena.planes, pt, rt)
    for lf, w, h in zip(layout.leaves, _slot_view(layout, caches, 0),
                        _slot_view(layout, got, 0)):
        if lf.paged:
            w, h = np.moveaxis(w, lf.time_axis, 0), np.moveaxis(h, lf.time_axis, 0)
            np.testing.assert_array_equal(w[pos_val], h[pos_val], err_msg=lf.name)
            mask = np.ones(layout.tokens, bool)
            mask[pos_val] = False
            assert not np.any(h[mask]), f"{lf.name}: wrote outside pos row"
        else:
            np.testing.assert_array_equal(w, h, err_msg=lf.name)
    for lf, h in zip(layout.leaves, _slot_view(layout, got, 1)):
        assert not np.any(h), lf.name


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 10_000), n_ops=st.integers(2, 6))
def test_allocate_free_reuse_leaves_unrelated_slots_untouched(seed, n_ops):
    """Random allocate/insert/free churn on other slots must not perturb a
    live slot's gathered cache, bit for bit (no deadline: the property,
    not the time, is under test)."""
    layout = plan_kv_layout(spec_fn, MAXLEN, PS)
    rng = np.random.default_rng(seed)
    arena = KVArena(layout, num_pages=12, num_slots=3, device="cpu")
    insert = build_insert_fn(layout)

    assert arena.acquire_slot(0, 5)
    _insert(arena, insert, 0, _rand_caches(rng, layout.tokens))
    pt, rt = arena.device_tables()
    baseline = _slot_view(layout, gather_caches(layout, arena.planes, pt, rt), 0)

    live = set()
    for _ in range(n_ops):
        slot = int(rng.integers(1, 3))
        if slot in live:
            arena.release_slot(slot)
            live.discard(slot)
        elif arena.acquire_slot(slot, int(rng.integers(1, MAXLEN + 1))):
            _insert(arena, insert, slot, _rand_caches(rng, layout.tokens))
            live.add(slot)
        # the live slots scatter a step too (inactive ones at the null row)
        pt, rt = arena.device_tables()
        pos = torch.tensor([0] + [int(rng.integers(0, PS)) if s in live else 0
                                  for s in (1, 2)])
        widened = _batch2(layout, _rand_caches(rng, layout.tokens))
        three = tree_unflatten(layout.treedef, [
            torch.cat([torch.zeros_like(torch.narrow(v, lf.batch_axis, 0, 1)), v],
                      dim=lf.batch_axis)
            for lf, v in zip(layout.leaves, tree_flatten(widened)[0])])
        pt0 = pt.clone()
        pt0[0] = arena.null                   # slot 0 is pinned, not stepped
        rt0 = rt.clone()
        rt0[0] = arena.null
        scatter_step(layout, arena.planes, pt0, rt0, three, pos)
        assert _null_rows_zero(arena)

    pt, rt = arena.device_tables()
    after = _slot_view(layout, gather_caches(layout, arena.planes, pt, rt), 0)
    for lf, a, b in zip(layout.leaves, baseline, after):
        np.testing.assert_array_equal(a, b, err_msg=lf.name)


def test_slot_reuse_clears_stale_state(layout):
    """Insert rebuilds whole page rows from zeros: reusing a slot (and its
    recycled physical pages) for a shorter request must not expose the
    previous request's rows."""
    rng = np.random.default_rng(3)
    arena = KVArena(layout, num_pages=8, num_slots=1, device="cpu")
    insert = build_insert_fn(layout)

    assert arena.acquire_slot(0, MAXLEN)
    _insert(arena, insert, 0, _rand_caches(rng, layout.tokens))
    arena.release_slot(0)

    short = _rand_caches(rng, layout.tokens)
    vals, paths = tree_flatten(short)
    for lf, v in zip(layout.leaves, vals):
        if lf.paged:   # zero the tail beyond the short prompt, as a prefill would
            t = lf.time_axis + (1 if lf.batch_axis <= lf.time_axis else 0)
            torch.narrow(v, t, 3, v.shape[t] - 3).zero_()
    assert arena.acquire_slot(0, 3)  # one page
    _insert(arena, insert, 0, short)

    pt, rt = arena.device_tables()
    got = _slot_view(layout, gather_caches(layout, arena.planes, pt, rt), 0)
    for lf, w, h in zip(layout.leaves, _slot_view(layout, short, 0), got):
        np.testing.assert_array_equal(w, h, err_msg=lf.name)
        if lf.paged:
            assert not np.any(np.moveaxis(h, lf.time_axis, 0)[3:]), f"{lf.name}: stale rows"


# ---------------------------------------------------------------------------
# the same operations on the same data as the reference
# ---------------------------------------------------------------------------


def test_churn_equals_reference_bit_for_bit(layout):
    """Acquire, insert, scatter and release on both arenas with the same
    data: the same page tables, and the same gathered caches after every
    operation (the reference's planes carried into the port's through
    ``interop`` at the start)."""
    rlayout = r_plan(r_spec_fn, MAXLEN, PS)
    rng = np.random.default_rng(7)
    arena = KVArena(layout, num_pages=10, num_slots=3, device="cpu")
    ref = RKVArena(rlayout, num_pages=10, num_slots=3)
    insert, rinsert = build_insert_fn(layout), r_build_insert(rlayout)

    def r_tree(caches):
        return jax.tree.map(jnp.asarray, caches_to_numpy(caches))

    def check():
        assert np.array_equal(arena.page_tbl, ref.page_tbl)
        assert np.array_equal(arena.resident_tbl, ref.resident_tbl)
        pt, rt = arena.device_tables()
        got = caches_to_numpy(gather_caches(layout, arena.planes, pt, rt))
        want = r_gather(rlayout, ref.planes, *ref.device_tables())
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                tree_flatten(got)[0]):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))

    live = set()
    for i in range(14):
        slot = int(rng.integers(0, 3))
        if slot in live and rng.random() < 0.4:
            arena.release_slot(slot)
            ref.release_slot(slot)
            live.discard(slot)
        elif slot not in live:
            n = int(rng.integers(1, MAXLEN))
            ok = arena.acquire_slot(slot, n)
            assert ok == ref.acquire_slot(slot, n)
            if ok:
                caches = _rand_caches(rng, layout.tokens)
                _insert(arena, insert, slot, caches)
                ref.planes = rinsert(ref.planes, r_tree(caches), *ref.insert_ids(slot))
                live.add(slot)
        else:
            # each live slot writes a row inside the pages it holds
            pos = [int(rng.integers(0, PS * len(arena._slot_pages[s]))) if s in live else 0
                   for s in range(3)]
            caches = _rand_caches(rng, layout.tokens, batch=3)
            scatter_step(layout, arena.planes, *arena.device_tables(), caches,
                         torch.tensor(pos))
            ref.planes = r_scatter(rlayout, ref.planes, *ref.device_tables(),
                                   r_tree(caches), jnp.asarray(pos, jnp.int32))
        assert _null_rows_zero(arena)
        check()
    # the reference's planes, carried over with a zero null row appended,
    # gather the same caches through the port
    planes = [torch.cat([p, torch.zeros_like(p[:1])])
              for p in caches_from_jax([np.asarray(p) for p in ref.planes], device="cpu")]
    pt, rt = arena.device_tables()
    for x, y in zip(tree_flatten(gather_caches(layout, arena.planes, pt, rt))[0],
                    tree_flatten(gather_caches(layout, planes, pt, rt))[0]):
        assert torch.equal(x, y)
