"""The MoE block's slot map and row moves (``kernels/moe_dispatch.py`` over
``kernels/csrc/moe_dispatch.cu``) against the plain path of
``models.moe`` (``dispatch``, ``slot_sources``, ``permute_plain``,
``unpermute_plain``).

On the CPU:

* the plain slot map, ``dispatch`` and its inverse ``slot_sources``, is a
  bijection between the kept assignments and the filled slots, empty
  elsewhere, token-major, at most ``C`` an expert, for the REDUCED
  deepseek and grok configs, a share of the experts from expert 0 and from
  a later one, capacity factors 0.5 and 1.25, every choice on one expert
  and no expert held;
* the kernels' arithmetic, written out in PyTorch (rows gathered by
  ``src`` and by ``slot``), equals the plain row moves forward and
  backward;
* the wrapper refuses wrong dtypes, shapes, strides and CPU tensors, and
  its slot kernels' partition covers every assignment.

Marked ``cuda`` (each skips where there is no GPU: a CUDA kernel has no
CPU mode; the file imports neither JAX nor the reference), the kernels on
the card against the plain path run on the card, at deepseek's and
moonlight's shapes and in other forms:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_dispatch.py
"""
import math

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import moe_dispatch as md
from repro_torch.models import moe

torch.set_num_threads(2)


def _cfg(arch, *, reduced=True, **fields):
    cfg = configs.get_reduced(arch) if reduced else configs.get_config(arch)
    return cfg.with_(**fields) if fields else cfg


def _top_e(N, routed, k, *, device="cpu", seed=0, skew=0.0):
    """k distinct experts a token, the top k of random scores; ``skew``
    adds a bias rising with the expert's index, so that the last experts
    overflow their capacity."""
    gen = torch.Generator(device).manual_seed(seed)
    scores = torch.rand((N, routed), generator=gen, device=device)
    scores += skew * torch.arange(routed, device=device) / routed
    return torch.topk(scores, k, dim=-1).indices


def _plain_map(top_e, cfg, C):
    slot, keep = moe.dispatch(top_e, cfg, C)
    return slot, keep, moe.slot_sources(slot, keep, cfg.num_experts * C)


# (case, config, tokens, how top_e is drawn)
MAP_CASES = {
    "deepseek": (_cfg("deepseek-moe-16b"), 64, {}),
    "deepseek-cf0.5": (_cfg("deepseek-moe-16b", moe_capacity_factor=0.5), 64, {}),
    "deepseek-skewed": (_cfg("deepseek-moe-16b"), 64, {"skew": 2.0}),
    "grok-cf0.5": (_cfg("grok-1-314b", moe_capacity_factor=0.5), 64, {}),
    "grok-cf1.25": (_cfg("grok-1-314b", moe_capacity_factor=1.25), 64, {}),
    "share-first0": (_cfg("moonlight-16b-a3b", num_experts=4, n_routed_experts=8,
                          first_expert=0), 64, {}),
    "share-first4": (_cfg("moonlight-16b-a3b", num_experts=4, n_routed_experts=8,
                          first_expert=4, moe_capacity_factor=0.5), 64, {"skew": 1.0}),
    "one-expert": (_cfg("deepseek-moe-16b", moe_capacity_factor=0.5), 64, {"one": 2}),
    "none-held": (_cfg("moonlight-16b-a3b", num_experts=4, n_routed_experts=8,
                       first_expert=4), 64, {"below": 4}),
}


def _case_top_e(cfg, N, how):
    if "one" in how:
        return torch.full((N, cfg.experts_per_token), how["one"], dtype=torch.int64)
    top_e = _top_e(N, cfg.routed_experts, cfg.experts_per_token, skew=how.get("skew", 0.0))
    if "below" in how:
        # route every token to experts under ``below`` only
        top_e = _top_e(N, how["below"], cfg.experts_per_token)
    return top_e


def _check_map(top_e, cfg, C, slot, keep, src):
    """``(slot, keep, src)`` is the slot map of ``top_e``: kept assignments
    and filled slots in bijection, token-major positions, at most ``C`` an
    expert, the rest dropped or empty."""
    E, nk = cfg.num_experts, top_e.numel()
    eid = top_e.reshape(-1) - cfg.first_expert
    mine = (eid >= 0) & (eid < E)
    a = torch.arange(nk)
    assert torch.equal(slot[~keep], torch.full_like(slot[~keep], E * C))
    assert torch.equal(src[slot[keep]].long(), a[keep])
    filled = src >= 0
    assert int(filled.sum()) == int(keep.sum())
    assert torch.equal(slot[src[filled].long()], torch.nonzero(filled)[:, 0])
    assert bool((src[~filled] == -1).all())
    # each held expert keeps its first min(n, C) assignments, in order
    for e in range(E):
        theirs = a[mine & (eid == e)]
        kept = theirs[:C]
        assert torch.equal(src[e * C:e * C + len(kept)].long(), kept)
        assert bool(keep[kept].all()) and not bool(keep[theirs[C:]].any())
    assert not bool(keep[~mine].any())


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_plain_slot_map_is_a_bijection(case):
    cfg, N, how = MAP_CASES[case]
    top_e = _case_top_e(cfg, N, how)
    C = moe.capacity(cfg, N)
    slot, keep, src = _plain_map(top_e, cfg, C)
    _check_map(top_e, cfg, C, slot, keep, src)
    kept = int(keep.sum())
    if case == "none-held":
        assert kept == 0 and bool((src == -1).all())
    elif case == "one-expert":
        assert kept == C
    elif "cf0.5" in case or case in ("deepseek-skewed", "share-first4"):
        assert 0 < kept < top_e.numel()


def _emulate_permute(x, src, k, E, C):
    """The permute kernel's rows: slot s takes x[src[s] // k], 0 if empty."""
    rows = x[(src.long().clamp(min=0)) // k] * (src >= 0)[:, None].to(x.dtype)
    return rows.reshape(E, C, x.shape[1])


def _emulate_unpermute(out_buf, w, slot, k):
    """The unpermute kernel's sum: each token's kept slots' rows times w,
    each product rounded to the dtype, summed in f32 in the order j."""
    n_slots, d = out_buf.shape
    kept = slot < n_slots
    acc = torch.zeros((slot.numel() // k, d), dtype=torch.float32)
    for j in range(k):
        s, kj = slot[j::k], kept[j::k]
        rows = (out_buf[s.clamp(max=n_slots - 1)] * w[j::k, None]).float()
        acc = acc + rows * kj[:, None].float()
    return acc.to(out_buf.dtype)


def _emulate_unpermute_backward(dy, out_buf, w, slot, src, k):
    """The unpermute backward kernel: each filled slot's gradient from its
    token's dy times its w, rounded; each kept assignment's dw the f32 sum
    over d of the rounded products dy * its row; 0 elsewhere."""
    filled = (src >= 0)[:, None]
    a = src.long().clamp(min=0)
    drows = (dy[a // k] * w[a][:, None]) * filled.to(dy.dtype)
    kept = slot < out_buf.shape[0]
    prods = dy.repeat_interleave(k, 0) * out_buf[slot.clamp(max=out_buf.shape[0] - 1)]
    dw = (prods.float().sum(1) * kept).to(w.dtype)
    return drows, dw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["deepseek-cf0.5", "share-first4"])
def test_gathers_by_src_equal_the_plain_row_moves(case, dtype):
    """The kernels' formulas, written in PyTorch on the CPU, against the
    plain row moves and their autograd backward: the buffer gathered by
    ``src`` and the experts' rows' gradient are the plain path's, bit for
    bit; the sums over a token's kept slots (y, dx) within one ulp (f32
    sums of at most k terms in another order); dw within one ulp plus the
    f32 summation bound of its d-term sum."""
    cfg, N, how = MAP_CASES[case]
    k, E, d = cfg.experts_per_token, cfg.num_experts, 24
    top_e = _case_top_e(cfg, N, how)
    C = moe.capacity(cfg, N)
    slot, keep, src = _plain_map(top_e, cfg, C)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((N, d), generator=gen).to(dtype).requires_grad_(True)
    buf = moe.permute_plain(x, slot, k, E, C)
    assert torch.equal(_emulate_permute(x.detach(), src, k, E, C), buf)
    dbuf = torch.randn((E, C, d), generator=gen).to(dtype)
    (dx,) = torch.autograd.grad(buf, x, dbuf)
    _assert_ulps(_emulate_unpermute(dbuf.reshape(E * C, d), torch.ones(N * k, dtype=dtype),
                                    slot, k), dx, 1)

    out_buf = torch.randn((E * C, d), generator=gen).to(dtype).requires_grad_(True)
    w = torch.rand(N * k, generator=gen).to(dtype).requires_grad_(True)
    y = moe.unpermute_plain(out_buf, slot, keep, w, k)
    _assert_ulps(_emulate_unpermute(out_buf.detach(), w.detach(), slot, k), y, 1)
    dy = torch.randn((N, d), generator=gen).to(dtype)
    drows, dw = torch.autograd.grad(y, (out_buf, w), dy)
    got_rows, got_w = _emulate_unpermute_backward(dy, out_buf.detach(), w.detach(), slot,
                                                  src, k)
    assert torch.equal(got_rows, drows)
    terms = (dy.repeat_interleave(k, 0).float()
             * out_buf.detach()[slot.clamp(max=E * C - 1)].float()).abs().sum(1)
    _assert_ulps(got_w, dw, 1, extra=d * 2.0**-24 * terms)


def _ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at each |x| (the least normal's at 0)."""
    bits = {torch.float32: 23, torch.bfloat16: 7}[dtype]
    tiny = torch.finfo(dtype).tiny
    _, e = torch.frexp(x.float().abs().clamp(min=tiny))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 1 - bits)


def _assert_ulps(got, want, n, extra=None):
    """|got - want| <= n ulps of the larger of the two (plus ``extra``)."""
    g, w = got.float(), want.float()
    bound = n * _ulp(torch.maximum(g.abs(), w.abs()), want.dtype)
    if extra is not None:
        bound = bound + extra
    bad = (g - w).abs() > bound
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} beyond {n} ulp(s): max |diff| "
        f"{float((g - w).abs().max()):.3g}")


def test_slot_blocks_cover_every_assignment():
    for nk in (1, 1023, 1024, 1025, 49_152, 98_304, 270_336, 270_337, 10**6):
        blocks, per_block = md.slot_blocks(nk)
        assert per_block % md.SLOT_THREADS == 0 and 1 <= blocks <= md.MAX_SLOT_BLOCKS
        assert (blocks - 1) * per_block < nk <= blocks * per_block


def _refusals():
    top_e = torch.zeros((4, 2), dtype=torch.int64)
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    slot = torch.zeros(8, dtype=torch.int64)
    src = torch.zeros(4 * 3, dtype=torch.int32)
    rows = torch.zeros((12, 8), dtype=torch.bfloat16)
    w = torch.zeros(8, dtype=torch.bfloat16)
    return {
        "top_e-int32": (lambda: md.moe_dispatch(top_e.int(), 0, 4, 3), ValueError),
        "top_e-1d": (lambda: md.moe_dispatch(top_e.reshape(-1), 0, 4, 3), ValueError),
        "top_e-strided": (lambda: md.moe_dispatch(top_e.t(), 0, 4, 3), ValueError),
        "too-many-experts": (lambda: md.moe_dispatch(top_e, 0, md.MAX_EXPERTS + 1, 3),
                             ValueError),
        "capacity-0": (lambda: md.moe_dispatch(top_e, 0, 4, 0), ValueError),
        "top_e-cpu": (lambda: md.moe_dispatch(top_e, 0, 4, 3), ValueError),
        "x-int": (lambda: md.permute(x.long(), slot, src, 2, 4, 3), TypeError),
        "x-float16": (lambda: md.permute(x.half(), slot, src, 2, 4, 3), TypeError),
        "x-strided": (lambda: md.permute(torch.zeros((8, 4), dtype=torch.bfloat16).t(),
                                         slot, src, 2, 4, 3), ValueError),
        "slot-int32": (lambda: md.permute(x, slot.int(), src, 2, 4, 3), ValueError),
        "src-short": (lambda: md.permute(x, slot, src[:-1], 2, 4, 3), ValueError),
        "slot-vs-x": (lambda: md.permute(x[:3], slot, src, 2, 4, 3), ValueError),
        "x-cpu": (lambda: md.permute(x, slot, src, 2, 4, 3), ValueError),
        "w-dtype": (lambda: md.unpermute(rows, w.float(), slot, src, 2), TypeError),
        "w-shape": (lambda: md.unpermute(rows, w[:4], slot, src, 2), ValueError),
        "rows-strided": (lambda: md.unpermute(torch.zeros((8, 12), dtype=torch.bfloat16).t(),
                                              w, slot, src, 2), ValueError),
        "rows-cpu": (lambda: md.unpermute(rows, w, slot, src, 2), ValueError),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_wrapper_refuses(case):
    before = md.moe_dispatch.launches
    fn, err = _refusals()[case]
    with pytest.raises(err):
        fn()
    assert md.moe_dispatch.launches == before


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "moonlight-16b-a3b"])
def test_cpu_moe_apply_is_the_plain_path(arch):
    """On CPU tensors ``moe_apply`` is route, ``dispatch``,
    ``permute_plain``, the experts and ``unpermute_plain``, bit for bit,
    and launches no kernel."""
    fields = {"moe_capacity_factor": 0.5}
    if arch == "moonlight-16b-a3b":
        fields.update(num_experts=4, n_routed_experts=8, first_expert=4)
    cfg = _cfg(arch, **fields)
    gen = torch.Generator().manual_seed(3)
    shapes = moe.moe_param_shapes(cfg)
    flat = {n: torch.randn(s, generator=gen) / math.sqrt(s[-2]) for n, s in shapes.items()}
    params = {n: v for n, v in flat.items() if not n.startswith("shared.")}
    params["shared"] = {n.split(".", 1)[1]: v for n, v in flat.items()
                        if n.startswith("shared.")}
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    before = md.moe_dispatch.launches
    y, aux = moe.moe_apply(params, x, cfg)
    assert md.moe_dispatch.launches == before

    E, k, N = cfg.num_experts, cfg.experts_per_token, 32
    xt = x.reshape(N, cfg.d_model)
    _, top_p, top_e, want_aux = moe.route(params, xt, cfg, 2)
    C = moe.capacity(cfg, N)
    slot, keep = moe.dispatch(top_e, cfg, C)
    buf = moe.permute_plain(xt, slot, k, E, C)
    h = torch.nn.functional.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(
        buf, params["w_up"])
    out_buf = torch.bmm(h, params["w_down"]).reshape(E * C, cfg.d_model)
    want = moe.unpermute_plain(out_buf, slot, keep, top_p.reshape(-1), k)
    want = want + moe.mlp(params["shared"], xt, cfg.mlp_act, torch.float32)
    assert torch.equal(y.reshape(N, -1), want) and torch.equal(aux, want_aux)


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


# the two MoE cells' layers: (config, tokens a layer, skew); at capacity
# factor 1.25 deepseek's uniform draw keeps every assignment, so a slight
# skew overflows its last experts (about 4% dropped)
CELLS = {
    "deepseek-moe-16b-2L.covap.b8": (_cfg("deepseek-moe-16b", reduced=False), 8192, 0.1),
    "moonlight-16b-a3b-5L-e32.covap.r2s8k": (
        _cfg("moonlight-16b-a3b", reduced=False, num_experts=32, n_routed_experts=64,
             first_expert=0), 16384, 0.0),
}
# other forms: (config, tokens, skew, d, dtype)
FORMS = {
    "moonlight-second-share-skewed": (
        _cfg("moonlight-16b-a3b", reduced=False, num_experts=32, n_routed_experts=64,
             first_expert=32), 4096, 3.0, 2048, torch.bfloat16),
    "grok-e8-k2": (_cfg("grok-1-314b", reduced=False), 2048, 1.0, 6144, torch.bfloat16),
    "deepseek-cf0.5-f32": (_cfg("deepseek-moe-16b", reduced=False, moe_capacity_factor=0.5),
                           1000, 0.0, 256, torch.float32),
    "reduced-d-unaligned": (_cfg("deepseek-moe-16b", num_experts=4), 37, 1.0, 12,
                            torch.bfloat16),
    "one-token": (_cfg("grok-1-314b"), 1, 0.0, 128, torch.float32),
}


def _card_run(cfg, N, d, dtype, *, skew=0.0, seed=0, kernels=True):
    """Slot map, permute, an expert product per held expert, unpermute,
    and the backward of a fixed cotangent, on the card, through the kernels
    or the plain path: the outputs and the gradients of x, w and the
    experts' weights."""
    k, E = cfg.experts_per_token, cfg.num_experts
    C = moe.capacity(cfg, N)
    top_e = _top_e(N, cfg.routed_experts, k, device="cuda", seed=seed, skew=skew)
    gen = torch.Generator("cuda").manual_seed(seed + 1)
    x = torch.randn((N, d), generator=gen, device="cuda").to(dtype).requires_grad_(True)
    w = torch.rand(N * k, generator=gen, device="cuda").to(dtype).requires_grad_(True)
    wx = (torch.randn((E, d, d), generator=gen, device="cuda") / math.sqrt(d)).to(dtype)
    wx.requires_grad_(True)
    dy = torch.randn((N, d), generator=gen, device="cuda").to(dtype)
    if kernels:
        slot, keep, src = md.moe_dispatch(top_e, cfg.first_expert, E, C)
        buf = md.permute(x, slot, src, k, E, C)
        out_buf = torch.bmm(buf, wx).reshape(E * C, d)
        y = md.unpermute(out_buf, w, slot, src, k)
    else:
        slot, keep, src = _plain_map(top_e, cfg, C)
        buf = moe.permute_plain(x, slot, k, E, C)
        out_buf = torch.bmm(buf, wx).reshape(E * C, d)
        y = moe.unpermute_plain(out_buf, slot, keep, w, k)
    gx, gw, gwx, gbuf = torch.autograd.grad(y, (x, w, wx, buf), dy)
    torch.cuda.synchronize()
    return {"slot": slot, "keep": keep, "src": src, "buf": buf.detach(),
            "out_buf": out_buf.detach(), "y": y.detach(), "gx": gx, "gw": gw, "gwx": gwx,
            "gbuf": gbuf, "w": w.detach(), "dy": dy}


def _compare(got, want):
    """The slot map and the buffer bit for bit; the experts' gradient
    within one ulp (the same products of bitwise-equal operands); y, dx
    and dw within one ulp plus the f32 summation bound of their sums, which
    PyTorch and the kernels take in other orders: two orders of one f32
    sum of n terms differ by at most n * 2^-24 * sum |terms| (n = k for y
    and dx, the sums over a token's kept slots; n = d for dw, its dot
    product), which shows where the terms nearly cancel."""
    for name in ("slot", "keep", "src", "buf"):
        assert torch.equal(got[name], want[name]), name
    _assert_ulps(got["gwx"], want["gwx"], 1)
    slot, keep, d = want["slot"], want["keep"], want["dy"].shape[1]
    k = slot.numel() // want["dy"].shape[0]
    n_slots = want["out_buf"].shape[0]
    ones = torch.ones(slot.numel(), device=slot.device)
    y_terms = moe.unpermute_plain(want["out_buf"].abs().float(), slot, keep,
                                  want["w"].abs().float(), k)
    dx_terms = moe.unpermute_plain(want["gbuf"].reshape(n_slots, d).abs().float(), slot,
                                   keep, ones, k)
    _assert_ulps(got["y"], want["y"], 1, extra=k * 2.0**-24 * y_terms)
    _assert_ulps(got["gx"], want["gx"], 1, extra=k * 2.0**-24 * dx_terms)
    rows = want["out_buf"][slot.clamp(max=want["out_buf"].shape[0] - 1)].float()
    terms = (rows * want["dy"].float().repeat_interleave(k, 0)).abs().sum(1) * keep
    _assert_ulps(got["gw"], want["gw"], 1, extra=d * 2.0**-24 * terms)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_card_cell_shapes_match_plain(cell, card):
    cfg, N, skew = CELLS[cell]
    got = _card_run(cfg, N, cfg.d_model, torch.bfloat16, skew=skew)
    want = _card_run(cfg, N, cfg.d_model, torch.bfloat16, skew=skew, kernels=False)
    _compare(got, want)
    assert 0 < int(got["keep"].sum()) < got["keep"].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(FORMS))
def test_card_forms_match_plain(form, card):
    cfg, N, skew, d, dtype = FORMS[form]
    got = _card_run(cfg, N, d, dtype, skew=skew)
    want = _card_run(cfg, N, d, dtype, skew=skew, kernels=False)
    _compare(got, want)


@pytest.mark.cuda
def test_card_two_runs_bitwise_and_launches(card):
    """Two runs of the moonlight layer's moves are equal bit for bit, and
    one forward and backward launches 6 kernels: 2 for the slot map, one
    for each row move and each backward."""
    cfg, N, _ = CELLS["moonlight-16b-a3b-5L-e32.covap.r2s8k"]
    before = md.moe_dispatch.launches
    a = _card_run(cfg, N, cfg.d_model, torch.bfloat16, seed=5)
    assert md.moe_dispatch.launches - before == 6
    b = _card_run(cfg, N, cfg.d_model, torch.bfloat16, seed=5)
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.cuda
def test_card_refuses_mixed_devices(card):
    x = torch.zeros((4, 8), dtype=torch.bfloat16, device="cuda")
    slot = torch.zeros(8, dtype=torch.int64)
    src = torch.zeros(12, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        md.permute(x, slot, src, 2, 4, 3)
    rows = torch.zeros((12, 8), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        md.unpermute(rows, torch.zeros(8, dtype=torch.bfloat16), slot.cuda(), src, 2)
