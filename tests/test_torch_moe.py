"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe.moe_apply`` on the REDUCED MoE configs, from the same
parameters and inputs: ``y``, the aux loss and the gradients of ``x``, the
router and the experts, at the config's capacity factor and at one small
enough that assignments are dropped; and the kept assignments themselves.
Then grok-1-314b with bfloat16 parameters through ``Trainer.run`` against
the reference's: its f32 router shares buckets with bf16 expert weights.

Top-k's order among equal probabilities is specified by neither library,
so the inputs are drawn until no two of a token's sorted router
probabilities are within ``TIE_GAP``."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.data import DataConfig as RDataConfig
from repro.data import make_loader as r_make_loader
from repro.models import build_model as r_build_model
from repro.models import moe as rmoe
from repro.optim import sgd as r_sgd
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer

import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model, moe
from repro_torch.optim import sgd
from repro_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6
TIE_GAP = 1e-6
B, S = 2, 32
TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=1)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
# grok with bfloat16 parameters: params, momenta and residuals are rounded
# to bfloat16 every step, so the two frameworks' last-bit differences in
# the f32 gradients can move a value by one bf16 ulp a step: held at two
# ulps relative (2**-6), and, where a sum cancels (an embedding row's
# gradient), at one ulp of the leaf's largest magnitude (2**-7 of it)
BF16_RTOL, BF16_ULP = 2.0 ** -6, 2.0 ** -7


def _tree(tree, requires_grad=False):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _tree(v, requires_grad)
        else:
            out[k] = torch.from_numpy(np.array(v)).requires_grad_(requires_grad)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _inputs(rcfg, params):
    """``x`` (B, S, d) and a cotangent, from the first numpy seed whose
    router probabilities have no near-tie.  The cotangent is a mean loss's,
    ``1/(B*S)`` a token, so that the gradients are at the model's scale
    where the model tests' ``ATOL`` applies."""
    router = np.asarray(params["router"], dtype=np.float64)
    for seed in range(50):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
        logits = x.reshape(-1, rcfg.d_model).astype(np.float64) @ router
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)
        if np.diff(p, axis=-1).min() > TIE_GAP:
            cot = (rng.standard_normal(x.shape) / (B * S)).astype(np.float32)
            return x, cot
    raise AssertionError("no tie-free draw in 50 seeds")


def _reference_keep(rcfg, params, x):
    """The reference's kept assignments, token-major, from its own router
    (softmax, top-k) and the position rule of ``moe_apply``: a cumsum of
    one-hots over the (N*k) order."""
    E, k = rcfg.num_experts, rcfg.experts_per_token
    xt = jnp.asarray(x).reshape(-1, rcfg.d_model)
    probs = jax.nn.softmax(xt @ params["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    eid = top_e.reshape(-1)
    onehot = jax.nn.one_hot(eid, E, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) - 1)[jnp.arange(eid.shape[0]), eid]
    C = int(math.ceil(xt.shape[0] * k / E * rcfg.moe_capacity_factor))
    return np.asarray(pos < C), np.asarray(eid)


CASES = [(arch, cf) for arch in ("deepseek-moe-16b", "grok-1-314b")
         for cf in (None, 0.5)]


@pytest.mark.parametrize("arch,cf", CASES)
def test_moe_apply_matches_reference(arch, cf):
    rcfg, cfg = rconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    if cf is not None:
        rcfg, cfg = (c.with_(moe_capacity_factor=cf) for c in (rcfg, cfg))
    params = rmoe.moe_init(jax.random.PRNGKey(1), rcfg, jnp.float32)
    x, cot = _inputs(rcfg, params)

    def f(p, xx):
        y, aux = rmoe.moe_apply(p, xx, rcfg)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (ry, raux)), (rgp, rgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    tp = _tree(jax.tree.map(np.asarray, params), requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(cot)) + aux).backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(raux), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rgx), rtol=RTOL, atol=ATOL)
    rg = _flat(jax.tree.map(np.asarray, rgp))
    got = _flat(tp)
    assert sorted(got) == sorted(rg)
    for path, t in got.items():
        np.testing.assert_allclose(t.grad.numpy(), rg[path], rtol=RTOL, atol=ATOL,
                                   err_msg=path)

    # the same assignments kept, and at cf 0.5 some dropped
    _, _, top_e, _ = moe.route(tp, tx.detach().reshape(-1, cfg.d_model), cfg)
    C = moe.capacity(cfg, B * S)
    _, keep = moe.dispatch(top_e, cfg, C)
    want_keep, want_eid = _reference_keep(rcfg, params, x)
    np.testing.assert_array_equal(top_e.reshape(-1).numpy(), want_eid)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf == 0.5:
        assert 0 < int((~keep).sum()) < keep.numel()
        assert C == math.ceil(B * S * cfg.experts_per_token / cfg.num_experts * 0.5)


def test_dispatch_order_is_token_major():
    """Earlier tokens, and within a token the higher-probability choice,
    win a full expert: with every choice on expert 0 and C = 3, the first
    three assignments in (token, choice) order are kept."""
    cfg = tconfigs.get_reduced("grok-1-314b")
    top_e = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 3]])
    slot, keep = moe.dispatch(top_e, cfg, 3)
    assert keep.tolist() == [True, True, True, True, True, True, False, True]
    E = cfg.num_experts
    assert slot.tolist() == [0, 3, 1, 6, 4, 2, E * 3, 9]


def test_router_is_f32_and_experts_ignore_mlp_act():
    """The router stays float32 under bfloat16 parameters; the routed
    experts use ``silu(g) * u`` whatever ``mlp_act`` is (only the shared
    expert follows it)."""
    cfg = tconfigs.get_reduced("grok-1-314b").with_(param_dtype="bfloat16")
    dt = {p: t.dtype for p, t in build_model(cfg, device="meta").named_leaves()}
    assert dt["stack.blocks.b0.moe.router"] == torch.float32
    assert {d for p, d in dt.items() if not p.endswith("router")} == {torch.bfloat16}
    rcfg = rconfigs.get_reduced("grok-1-314b")
    params = rmoe.moe_init(jax.random.PRNGKey(2), rcfg, jnp.float32)
    x, _ = _inputs(rcfg, params)
    tp = _tree(jax.tree.map(np.asarray, params))
    y_swiglu, _ = moe.moe_apply(tp, torch.from_numpy(x), tconfigs.get_reduced(
        "grok-1-314b"))
    y_gelu, _ = moe.moe_apply(tp, torch.from_numpy(x), tconfigs.get_reduced(
        "grok-1-314b").with_(mlp_act="gelu"))
    assert torch.equal(y_swiglu, y_gelu)


def test_grok_bf16_mixed_buckets_match_reference():
    """grok-1-314b REDUCED with bfloat16 parameters: its f32 router shares
    buckets with bf16 expert weights.  3 COVAP SGD steps against the
    reference at ``BF16_RTOL`` and ``BF16_ULP`` of each leaf's largest
    magnitude; every leaf keeps its dtype
    through the bucket scatter (params, momenta, residuals)."""
    steps = 3
    rcfg = rconfigs.get_reduced("grok-1-314b").with_(param_dtype="bfloat16")
    cfg = tconfigs.get_reduced("grok-1-314b").with_(param_dtype="bfloat16")
    tc = dict(TC, steps=steps)
    rtr = RTrainer(r_build_model(rcfg), r_sgd(1e-2, momentum=0.9), RTrainConfig(**tc))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, rstate["params"])
    rstate = rtr.run(rstate, iter(r_make_loader(RDataConfig(**DATA))), log=None)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(init, device="cpu"))
    tr = Trainer(model, sgd(1e-2, momentum=0.9), TrainConfig(**tc))
    state = tr.run(tr.init_state(), make_loader(DataConfig(**DATA), device="cpu"),
                   log=None)
    assert state["step"] == steps
    plan = tr.plan
    mixed = [b for b in plan.buckets
             if len({plan.leaf_dtypes[s.leaf_idx] for s in b.segments}) > 1]
    assert mixed, "no bucket mixes the f32 router with bf16 leaves"
    np.testing.assert_allclose([h["loss"] for h in tr.history],
                               [h["loss"] for h in rtr.history], rtol=1e-3)
    parts = {"params": (state["params"], rstate["params"]),
             "mu": (state["opt"]["mu"], rstate["opt"]["mu"]),
             "resid": (state["comp"], rstate["comp"])}
    for part, (got, want) in parts.items():
        want = {k: np.asarray(v) for k, v in _flat(want).items()} if isinstance(
            want, dict) else {
            p: np.asarray(x) for p, x in zip(plan.leaf_paths, jax.tree_util.tree_leaves(want))}
        for path, t in zip(plan.leaf_paths, got):
            assert str(t.dtype).removeprefix("torch.") == str(want[path].dtype), \
                (part, path)
            router = path.endswith("router")
            assert t.dtype == (torch.float32 if router else torch.bfloat16), (part, path)
            w = want[path].astype(np.float32)
            np.testing.assert_allclose(t.detach().float().numpy(), w, rtol=BF16_RTOL,
                                       atol=BF16_ULP * float(np.abs(w).max()),
                                       err_msg=f"{part} {path}")
