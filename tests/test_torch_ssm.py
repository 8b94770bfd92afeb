"""The port's Mamba2 (SSD) block against the JAX reference
(``repro.models.ssm``): the dims, the depthwise causal conv, ``ssm_train``
over one chunk, several chunks and a ragged length (``c = S``), every
gradient where the reference's are finite, ``ssm_decode`` stepped over a
prompt (outputs and states), and the reference's NaN gradient at a chunk
of 128, which the port does not inherit.

Parameters come from the reference's ``ssm_init`` (REDUCED zamba2, its
zero-initialised norm scale set to small random values) through numpy;
inputs from numpy's seeded generator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import build_model as r_build_model
from repro.models import ssm as rssm

import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import ssm as tssm

torch.set_num_threads(2)

# f32 on the REDUCED config; the order of summation differs between XLA
# and ATen
RTOL, ATOL = 1e-4, 1e-5
ARCH = "zamba2-2.7b"


def _cfgs():
    return rconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)


def _params(seed=0):
    rcfg, _ = _cfgs()
    p = jax.tree.map(np.asarray, rssm.ssm_init(jax.random.PRNGKey(seed), rcfg, jnp.float32))
    rng = np.random.default_rng(seed + 1)
    p["norm"]["scale"] = (0.1 * rng.standard_normal(p["norm"]["scale"].shape)).astype(np.float32)
    # a spread of decays and skips, so A_log, D and dt_bias carry weight
    for k in ("A_log", "D", "dt_bias"):
        p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def _torch_tree(params, requires_grad=False):
    flat = params_from_jax(params, device="cpu")
    if requires_grad:
        for t in flat.values():
            t.requires_grad_(True)
    return flat, {"norm": {"scale": flat["norm.scale"]},
                  **{k: v for k, v in flat.items() if "." not in k}}


def _x(B, S, d, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


@pytest.mark.parametrize("reduced", [True, False])
def test_ssm_dims_and_shapes_equal_reference(reduced):
    get = "get_reduced" if reduced else "get_config"
    rcfg, cfg = getattr(rconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    assert tssm.ssm_dims(cfg) == rssm.ssm_dims(rcfg)
    shapes = jax.eval_shape(lambda k: rssm.ssm_init(k, rcfg, jnp.float32),
                            jax.random.PRNGKey(0))
    want = {".".join(str(k.key) for k in p): tuple(l.shape)
            for p, l in jax.tree_util.tree_leaves_with_path(shapes)}
    assert tssm.ssm_param_shapes(cfg) == want


@pytest.mark.parametrize("k,ch,S", [(4, 8, 11), (4, 32, 64), (2, 5, 3), (1, 3, 4)])
def test_causal_conv_matches_reference(k, ch, S):
    """Left pad ``k - 1``, no flip of the ``(k, ch)`` weights: the
    cross-correlation ``lax.conv_general_dilated`` computes."""
    rng = np.random.default_rng(k * 100 + ch)
    x = rng.standard_normal((2, S, ch)).astype(np.float32)
    w = rng.standard_normal((k, ch)).astype(np.float32)
    b = rng.standard_normal((ch,)).astype(np.float32)
    want = np.asarray(rssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # causal: the output at t does not move with an input after t
    x2 = x.copy()
    x2[:, S - 1] += 1.0
    got2 = tssm._causal_conv(torch.from_numpy(x2), torch.from_numpy(w), torch.from_numpy(b))
    assert torch.equal(got2[:, :S - 1], got[:, :S - 1])


@pytest.mark.parametrize("S,chunk", [(64, 128), (64, 16), (40, 16), (24, 24)])
def test_ssm_train_and_grads_match_reference(S, chunk):
    """One chunk (S < chunk), four chunks (64 / 16), a ragged length that
    takes ``c = S`` (40 % 16), and c = S exactly: the output and the
    gradient of a random projection of it, for every parameter and for
    the input."""
    rcfg, cfg = _cfgs()
    params = _params()
    x = _x(2, S, cfg.d_model)
    cot = np.random.default_rng(7).standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def rloss(p, xx):
        y = rssm.ssm_train(p, xx, rcfg, chunk=chunk)
        return jnp.sum(y * cot), y

    (_, ry), (rg, rgx) = jax.value_and_grad(rloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    flat, tree = _torch_tree(params, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tssm.ssm_train(tree, xt, cfg, chunk=chunk)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rgx), rtol=RTOL, atol=ATOL)
    want = {".".join(str(k.key) for k in p): np.asarray(g)
            for p, g in jax.tree_util.tree_leaves_with_path(rg)}
    assert set(want) == set(flat)
    for path, g in want.items():
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(flat[path].grad.numpy(), g, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(g).max())),
                                   err_msg=path)


def test_ssm_decode_stepped_over_a_prompt_matches_reference():
    """24 decode steps at B = 2 from the zero state: each step's output and,
    at the end, the SSD state and the three conv buffers; and the port's
    decode reproduces its own ``ssm_train`` over the same tokens."""
    rcfg, cfg = _cfgs()
    params = _params(seed=3)
    S = 24
    x = _x(2, S, cfg.d_model, seed=3)
    rp = jax.tree.map(jnp.asarray, params)
    _, tree = _torch_tree(params)
    rstate = rssm.ssm_state_init(rcfg, 2)
    state = tssm.ssm_state_init(cfg, 2, device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in rstate.items()}
    step = jax.jit(lambda p, xx, st: rssm.ssm_decode(p, xx, st, rcfg))
    outs = []
    with torch.no_grad():
        for t in range(S):
            ry, rstate = step(rp, jnp.asarray(x[:, t:t + 1]), rstate)
            y, state = tssm.ssm_decode(tree, torch.from_numpy(x[:, t:t + 1]), state, cfg)
            np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t}")
            outs.append(y)
        for k, v in state.items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), np.asarray(rstate[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        train = tssm.ssm_train(tree, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), train.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_decode_does_not_write_its_input_state():
    """``ssm_decode`` returns a new state; the stack writes it into the
    cache rows (``transformer._block_decode``)."""
    _, cfg = _cfgs()
    _, tree = _torch_tree(_params())
    state = tssm.ssm_state_init(cfg, 2, device="cpu")
    _, new = tssm.ssm_decode(tree, torch.ones((2, 1, cfg.d_model)), state, cfg)
    assert all(not v.any() for v in state.values())
    assert new["h"].abs().sum() > 0 and new["conv_x"].abs().sum() > 0


def test_reference_nan_at_chunk_128_is_pinned_and_not_inherited():
    """REDUCED zamba2, S = 128 at the default chunk of 128: above the
    diagonal the reference's ``exp`` of the summed log-decays overflows
    and the masked ``where``'s backward multiplies 0 by inf, so its
    gradients of ``A_log``, ``dt_bias`` and ``wdt`` hold NaN.  The port
    masks before the ``exp``: the same loss to 1e-4, every gradient
    finite."""
    rcfg, cfg = _cfgs()
    rmodel = r_build_model(rcfg)
    params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    S = 128
    tokens = rng.integers(0, rcfg.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, rcfg.vocab_size, (2, S)).astype(np.int32)
    (rloss, _), rg = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params),
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    ssm_g = rg["stack"]["blocks"]["b0"]["ssm"]
    for name in ("A_log", "dt_bias", "wdt"):
        assert np.isnan(np.asarray(ssm_g[name])).any(), name
    assert np.isfinite(float(rloss))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    total, _ = model.loss_fn({"tokens": torch.from_numpy(tokens).long(),
                              "labels": torch.from_numpy(labels).long()})
    total.backward()
    np.testing.assert_allclose(total.item(), float(rloss), rtol=RTOL)
    for path, p in model.named_leaves():
        assert torch.isfinite(p.grad).all(), path

    # and the block's forward output itself, at the chunk of 128
    bp = {k: v for k, v in params["stack"]["blocks"]["b0"]["ssm"].items()}
    one = jax.tree.map(lambda a: a[0], bp)
    x = _x(2, S, cfg.d_model, seed=5)
    want = np.asarray(rssm.ssm_train(jax.tree.map(jnp.asarray, one), jnp.asarray(x), rcfg))
    _, tree = _torch_tree(one)
    got = tssm.ssm_train(tree, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
