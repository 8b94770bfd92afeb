"""The port's VLM path (``models/multimodal.py`` and ``DecoderLM`` on the
VLM family) against the JAX reference on REDUCED pixtral-12b: the
projector's leaf, init rule and product, the frontend's specs and
synthetic embeddings, the loss and every gradient with ``patch_embeds``
projected and prepended and the labels padded with -1 over the patches,
``prefill`` with the patch prefix, and the text-only path, where the
projector's gradient is zero in both packages.

The reference's parameters are made once for the file, with the norm
scales set to small random values, and carried across with
``interop.params_from_jax``; inputs are made from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import build_model as r_build_model
from repro.models import multimodal as rmm

import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_jax
from repro_torch.models import DecoderLM, build_model, multimodal, param_shapes
from repro_torch.train import loss_and_grads

torch.set_num_threads(2)

ARCH = "pixtral-12b"
# loss and gradients (the families tests'); activations and logits
RTOL, ATOL = 1e-4, 1e-6
ACT_RTOL, ACT_ATOL = 1e-4, 1e-5
B, S = 2, 48


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def ref():
    rcfg = rconfigs.get_reduced(ARCH)
    rmodel = r_build_model(rcfg)
    params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "scale":
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)

    perturb(params)
    return rcfg, rmodel, params


def _port(params) -> DecoderLM:
    model = build_model(tconfigs.get_reduced(ARCH), device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return model


def _batch(cfg, seed, patches=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, -3:] = -1
    if patches:
        batch["patch_embeds"] = (0.02 * rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        if k in out:
            out[k] = out[k].long()
    return out


def test_projector_leaf_init_and_product(ref):
    """``projector.w`` is (d, d) in the parameter dtype, between ``head``
    and ``stack`` in leaf order; its init is the reference's truncated
    normal at ``1 / sqrt(d)`` (a different generator: the spread within
    15%), and ``project`` equals the reference's."""
    rcfg, _, params = ref
    cfg = tconfigs.get_reduced(ARCH)
    d = cfg.d_model
    paths = list(param_shapes(cfg))
    assert paths.index("projector.w") == paths.index("head.w") + 1
    assert param_shapes(cfg)["projector.w"] == (d, d)
    full = build_model(tconfigs.get_config(ARCH), device="meta")
    assert tuple(full.projector["w"].shape) == (5120, 5120)
    gen = torch.Generator().manual_seed(0)
    w = multimodal.projector_init(d, d, torch.float32, gen, device="cpu")["w"]
    rw = np.asarray(rmm.projector_init(jax.random.PRNGKey(3), d, d, jnp.float32)["w"])
    assert tuple(w.shape) == rw.shape and w.dtype == torch.float32
    assert abs(float(w.std()) / rw.std() - 1) < 0.15
    assert float(w.abs().max()) <= 2 / d ** 0.5 + 1e-7
    x = np.random.default_rng(1).standard_normal((B, 8, d)).astype(np.float32)
    got = multimodal.project({"w": torch.from_numpy(params["projector"]["w"])},
                             torch.from_numpy(x), torch.float32)
    want = rmm.project({"w": jnp.asarray(params["projector"]["w"])}, jnp.asarray(x),
                       jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ACT_RTOL, atol=ACT_ATOL)


@pytest.mark.parametrize("full", [False, True])
def test_frontend_specs_and_synthetic_embeds(full):
    """``frontend_embed_specs`` is the reference's ``ShapeDtypeStruct`` as
    a ``meta`` tensor; ``synth_frontend_embeds`` has its shape, dtype and
    0.02 scale, and repeats for a seed (its values differ from
    ``jax.random``'s)."""
    get = "get_config" if full else "get_reduced"
    for arch in (ARCH, "seamless-m4t-medium"):
        cfg, rcfg = getattr(tconfigs, get)(arch), getattr(rconfigs, get)(arch)
        spec = multimodal.frontend_embed_specs(cfg, 3)
        want = rmm.frontend_embed_specs(rcfg, 3)
        assert spec.device.type == "meta" and tuple(spec.shape) == want.shape
        assert str(spec.dtype).removeprefix("torch.") == np.dtype(want.dtype).name
        if full:
            continue
        x = multimodal.synth_frontend_embeds(torch.Generator().manual_seed(0), cfg, 3,
                                             device="cpu")
        y = multimodal.synth_frontend_embeds(torch.Generator().manual_seed(0), cfg, 3,
                                             device="cpu")
        r = np.asarray(rmm.synth_frontend_embeds(jax.random.PRNGKey(0), rcfg, 3))
        assert torch.equal(x, y) and tuple(x.shape) == r.shape
        assert abs(float(x.std()) / 0.02 - 1) < 0.05 and abs(r.std() / 0.02 - 1) < 0.05


def test_loss_and_grads_with_patches_match_reference(ref):
    """The patches projected and prepended, the labels padded with -1 over
    them: loss at 1e-4, every gradient (the projector's included, and
    non-zero) at rtol 1e-4, atol 1e-6."""
    rcfg, rmodel, params = ref
    batch = _batch(rcfg, 2)
    (rloss, rmet), rgrads = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port(params)
    total, met = model.loss_fn(_torch_batch(batch))
    total.backward()
    np.testing.assert_allclose(total.item(), float(rloss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(met["loss"].detach()), float(rmet["loss"]), rtol=RTOL)
    want = _flat(jax.tree.map(np.asarray, rgrads))
    assert [p for p, _ in model.named_leaves()] == list(want)
    for path, p in model.named_leaves():
        np.testing.assert_allclose(p.grad.numpy(), want[path], rtol=RTOL, atol=ATOL,
                                   err_msg=path)
    assert float(model.projector["w"].grad.abs().max()) > 0


def test_patch_positions_carry_no_label(ref):
    """The loss is the mean over the text labels only: with every text
    label -1 it is 0 (the count is clamped to 1, the patches' pad labels
    count nothing); the patches come first and attention is causal, so
    every text position sees them: moving one moves the loss."""
    rcfg, _, params = ref
    model = _port(params)
    batch = _torch_batch(_batch(rcfg, 3))
    batch["labels"][:] = -1
    total, _ = model.loss_fn(batch)
    assert float(total) == 0.0
    batch = _torch_batch(_batch(rcfg, 3))
    base, _ = model.loss_fn(batch)
    batch["patch_embeds"][:, 0] += 1.0
    moved, _ = model.loss_fn(batch)
    assert not torch.equal(moved, base)


def test_prefill_with_the_patch_prefix_matches_reference(ref):
    rcfg, rmodel, params = ref
    batch = _batch(rcfg, 4)
    del batch["labels"]
    want = rmodel.prefill(jax.tree.map(jnp.asarray, params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    got = _port(params).prefill(None, _torch_batch(batch))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ACT_RTOL, atol=ACT_ATOL)


def test_text_only_path_gives_the_projector_no_gradient(ref):
    """Without ``patch_embeds`` the batch is text only: the loss equals the
    reference's text-only loss, and the projector's gradient is zero in
    both packages (the port's ``loss_and_grads`` fills in zeros, as
    ``jax.grad`` gives them)."""
    rcfg, rmodel, params = ref
    batch = _batch(rcfg, 5, patches=False)
    (rloss, _), rgrads = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    assert not np.asarray(rgrads["projector"]["w"]).any()
    model = _port(params)
    leaves = [p for _, p in model.named_leaves()]
    grads, metrics = loss_and_grads(model, leaves, _torch_batch(batch))
    np.testing.assert_allclose(float(metrics["total_loss"]), float(rloss), rtol=RTOL,
                               atol=ATOL)
    names = [n for n, _ in model.named_leaves()]
    g = grads[names.index("projector.w")]
    assert g.shape == model.projector["w"].shape and not g.any()
    assert grads[names.index("head.w")].abs().max() > 0
