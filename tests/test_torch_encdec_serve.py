"""Serving the two frontend families: the port's ``Engine`` against the
reference's on REDUCED seamless-m4t-medium, each request with frames of
its own (and one with none: zeros, as the reference feeds them), and on
REDUCED pixtral-12b, text only: the engines stepped in turn give the same
page and resident tables after every step, the same tokens, finish
reasons and stats (prefill calls included).  The arena's layout equals
the reference's with ``mem_k``/``mem_v`` resident, at REDUCED and full
config, where one page's row is as wide as one slot's memory keys and
values."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import build_model as r_build_model
from repro.serve import Engine as REngine
from repro.serve import KVArena as RKVArena
from repro.serve import ServeConfig as RServeConfig
from repro.serve import plan_kv_layout as r_plan

import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.serve import Engine, KVArena, ServeConfig, plan_kv_layout

torch.set_num_threads(2)

PROMPTS = [[5, 17, 3, 9], [88, 2], [1, 1, 1, 1, 1, 1, 1], [4, 40, 14]]
SC = dict(max_len=48, max_new_tokens=4, page_size=8, prefill_chunk=4)
STATS = ("requests", "completed", "prefill_calls", "prefill_tokens", "insert_calls",
         "generate_calls", "generate_tokens")


def _engines(arch, seed=0):
    rcfg = rconfigs.get_reduced(arch)
    params = jax.tree.map(np.asarray, r_build_model(rcfg).init(jax.random.PRNGKey(seed)))
    model = build_model(tconfigs.get_reduced(arch), device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    ref = REngine(r_build_model(rcfg), jax.tree.map(jax.numpy.asarray, params),
                  RServeConfig(batch_slots=3, **SC))
    return ref, Engine(model, None, ServeConfig(batch_slots=3, **SC))


def _frames(cfg, n):
    """``n`` requests' frames (1, T, d), std-0.02 normals from numpy seed
    ``i``; the last request has none."""
    out = [(0.02 * np.random.default_rng(i).standard_normal(
        (1, cfg.frontend_tokens, cfg.d_model))).astype(np.float32) for i in range(n - 1)]
    return out + [None]


def _step_in_turn(ref, eng):
    steps = 0
    while ref.busy or eng.busy:
        ref.step()
        eng.step()
        steps += 1
        assert np.array_equal(eng.arena.page_tbl, ref.arena.page_tbl), steps
        assert np.array_equal(eng.arena.resident_tbl, ref.arena.resident_tbl), steps
    assert ref.busy == eng.busy
    return steps


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_engine_equals_reference_engine(arch):
    ref, eng = _engines(arch)
    frames = (_frames(eng.model.cfg, len(PROMPTS)) if eng.model.cfg.is_encdec
              else [None] * len(PROMPTS))
    rr = [ref.submit(p, f) for p, f in zip(PROMPTS, frames)]
    rt = [eng.submit(p, f) for p, f in zip(PROMPTS, frames)]
    _step_in_turn(ref, eng)
    for a, b in zip(rr, rt):
        assert eng.results[b].tokens == ref.results[a].tokens
        assert eng.results[b].finish_reason == ref.results[a].finish_reason
    for k in STATS:
        assert eng.stats[k] == ref.stats[k], k
    assert eng.arena.nbytes() == ref.arena.nbytes()


def test_frames_condition_the_tokens():
    """The same prompt under two requests' frames: the memory changes the
    logits the first token is drawn from, so the engine reads each
    request's own frames (tensor or array); frames of zeros give the same
    tokens as no frames."""
    _, eng = _engines("seamless-m4t-medium", seed=1)
    cfg = eng.model.cfg
    logits = []
    eng.sample = lambda lg, gen=None, t=0.0: (logits.append(lg.clone()),
                                              torch.argmax(lg[:, 0], -1).int())[1]
    fr = _frames(cfg, 3)
    rids = [eng.submit([5, 17, 3], f) for f in (fr[0], torch.from_numpy(fr[1]),
                                                 np.zeros_like(fr[0]), None)]
    res = eng.run_until_done()
    assert all(res[r].finish_reason == "length" for r in rids)
    first = [lg for lg in logits if lg.shape[0] == 1]   # the prefills', batch 1
    assert len(first) == 4
    assert not torch.equal(first[0], first[1])
    assert torch.equal(first[2], first[3])
    assert res[rids[2]].tokens == res[rids[3]].tokens


@pytest.mark.parametrize("full", [False, True])
def test_encdec_layout_equals_reference_with_resident_memory(full):
    """``mem_k``/``mem_v`` are resident (their extent does not move with
    ``max_len``), the ``self`` cache paged on its time axis; at full
    config (8 slots, max_len 1024, page 16) a page's row is as wide as
    one slot's memory keys and values, 25,165,824 bf16 elements, and the
    pool holds 8 x (64 + 1) = 520 pages, as in the reference."""
    arch = "seamless-m4t-medium"
    get = "get_config" if full else "get_reduced"
    cfg, rcfg = getattr(tconfigs, get)(arch), getattr(rconfigs, get)(arch)
    max_len, ps = (1024, 16) if full else (48, 8)
    got = plan_kv_layout(build_model(cfg, device="meta").cache_specs, max_len, ps)
    want = r_plan(r_build_model(rcfg).cache_specs, max_len, ps)
    assert got.plane_dtypes == want.plane_dtypes and got.plane_elems == want.plane_elems
    assert (got.tokens, got.pages_per_slot, got.page_bytes()) == \
        (want.tokens, want.pages_per_slot, want.page_bytes())
    for a, b in zip(got.leaves, want.leaves):
        assert (a.name, a.shape, a.dtype, a.batch_axis, a.time_axis, a.plane, a.offset,
                a.numel) == (b.name, b.shape, b.dtype, b.batch_axis, b.time_axis,
                             b.plane, b.offset, b.numel)
    by_name = {l.name: l for l in got.leaves}
    assert not by_name["mem_k"].paged and not by_name["mem_v"].paged
    assert by_name["self/k"].paged and by_name["self/k"].time_axis == 1
    pages = KVArena.auto_pages(got, 8)
    assert pages == RKVArena.auto_pages(want, 8)
    if full:
        L, T, K, hd = cfg.num_layers, cfg.frontend_tokens, cfg.num_kv_heads, cfg.head_dim
        assert got.plane_dtypes == ("bfloat16",)
        assert got.plane_elems == (2 * L * T * K * hd,) == (25_165_824,)
        assert (got.page_bytes(), pages) == (50_331_648, 520)
        assert pages * got.page_bytes() == 26_172_456_960


def test_pixtral_full_config_arena():
    """pixtral-12b at its full config serves text only: its arena is the
    paged KV cache alone, 40 layers x 8 KV heads x 128 x (k, v) a token
    in bf16, 512 pages of 16 tokens at 8 slots and max_len 1024."""
    cfg, rcfg = tconfigs.get_config("pixtral-12b"), rconfigs.get_config("pixtral-12b")
    got = plan_kv_layout(build_model(cfg, device="meta").cache_specs, 1024, 16)
    want = r_plan(r_build_model(rcfg).cache_specs, 1024, 16)
    assert not got.has_resident and got.plane_elems == want.plane_elems
    pages = KVArena.auto_pages(got, 8)
    # 163,840 B a token
    assert got.page_bytes() == 16 * 40 * 8 * 128 * 2 * 2 == 16 * 163_840
    assert pages == RKVArena.auto_pages(want, 8) == 512
    assert pages * got.page_bytes() == 1_342_177_280 == pages * want.page_bytes()
