"""The port's xLSTM blocks against the JAX reference
(``repro.models.xlstm``): the mLSTM (head dim ``2 d_model / H``) and the
sLSTM (``d_model / H``), each trained over a sequence (output and every
gradient) and decoded token by token (outputs and states), one cell step
with large gate pre-activations (the max stabiliser), and the mLSTM's
backward pass keeping one (B, H, hd, hd) state a token.

Parameters come from the reference's ``mlstm_init``/``slstm_init``
(REDUCED xlstm-125m, the zero-initialised norm scales set to small random
values) through numpy; inputs from numpy's seeded generator."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import xlstm as rx

import repro_torch.configs as tconfigs
from repro_torch.interop import params_from_jax
from repro_torch.models import xlstm as tx

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
ARCH = "xlstm-125m"
B, S = 2, 24

KINDS = {
    "mlstm": (rx.mlstm_init, rx.mlstm_train, rx.mlstm_decode, rx.mlstm_state_init,
              tx.mlstm_train, tx.mlstm_decode, tx.mlstm_state_init),
    "slstm": (rx.slstm_init, rx.slstm_train, rx.slstm_decode, rx.slstm_state_init,
              tx.slstm_train, tx.slstm_decode, tx.slstm_state_init),
}


def _cfgs():
    return rconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)


def _params(kind, seed=0):
    rcfg, _ = _cfgs()
    p = jax.tree.map(np.asarray, KINDS[kind][0](jax.random.PRNGKey(seed), rcfg, jnp.float32))
    rng = np.random.default_rng(seed + 1)
    for k in ("norm", "out_norm"):
        if k in p:
            p[k]["scale"] = (0.1 * rng.standard_normal(p[k]["scale"].shape)).astype(np.float32)
    return p


def _tree(params, requires_grad=False):
    flat = params_from_jax(params, device="cpu")
    if requires_grad:
        for t in flat.values():
            t.requires_grad_(True)
    tree: dict = {}
    for path, t in flat.items():
        *heads, last = path.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return flat, tree


def _x(d, seed=0, n=S):
    return np.random.default_rng(seed).standard_normal((B, n, d)).astype(np.float32)


@pytest.mark.parametrize("reduced", [True, False])
def test_dims_and_shapes_equal_reference(reduced):
    """The mLSTM's head dim is ``2 d_model / H`` (384 at full width), not
    ``cfg.head_dim``; the sLSTM's ``d_model / H``."""
    get = "get_reduced" if reduced else "get_config"
    rcfg, cfg = getattr(rconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    assert tx._dims(cfg) == rx._dims(rcfg)
    if not reduced:
        assert tx._dims(cfg)[3] == 384 != cfg.head_dim
    for kind, fn in (("mlstm", tx.mlstm_param_shapes), ("slstm", tx.slstm_param_shapes)):
        shapes = jax.eval_shape(lambda k: KINDS[kind][0](k, rcfg, jnp.float32),
                                jax.random.PRNGKey(0))
        want = {".".join(str(k.key) for k in p): tuple(l.shape)
                for p, l in jax.tree_util.tree_leaves_with_path(shapes)}
        assert fn(cfg) == want, kind


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_train_and_grads_match_reference(kind):
    """The output over 24 tokens and the gradient of a random projection of
    it, for every parameter and the input."""
    rcfg, cfg = _cfgs()
    _, r_train, _, _, t_train, _, _ = KINDS[kind]
    params = _params(kind)
    x = _x(cfg.d_model)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def rloss(p, xx):
        y = r_train(p, xx, rcfg)
        return jnp.sum(y * cot), y

    (_, ry), (rg, rgx) = jax.value_and_grad(rloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    flat, tree = _tree(params, requires_grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = t_train(tree, xt, cfg)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rgx), rtol=RTOL, atol=ATOL)
    want = {".".join(str(k.key) for k in p): np.asarray(g)
            for p, g in jax.tree_util.tree_leaves_with_path(rg)}
    assert set(want) == set(flat)
    for path, g in want.items():
        np.testing.assert_allclose(flat[path].grad.numpy(), g, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(g).max())),
                                   err_msg=path)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_stepped_over_a_prompt_matches_reference(kind):
    """24 decode steps from the zero state: every step's output, and the
    states at the end; the port's decode reproduces its own train path."""
    rcfg, cfg = _cfgs()
    _, _, r_decode, r_init, t_train, t_decode, t_init = KINDS[kind]
    params = _params(kind, seed=2)
    x = _x(cfg.d_model, seed=2)
    rp = jax.tree.map(jnp.asarray, params)
    _, tree = _tree(params)
    rstate, state = r_init(rcfg, B), t_init(cfg, B, device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in rstate.items()}
    step = jax.jit(lambda p, xx, st: r_decode(p, xx, st, rcfg))
    outs = []
    with torch.no_grad():
        for t in range(S):
            ry, rstate = step(rp, jnp.asarray(x[:, t:t + 1]), rstate)
            y, state = t_decode(tree, torch.from_numpy(x[:, t:t + 1]), state, cfg)
            np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t}")
            outs.append(y)
        for k, v in state.items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), np.asarray(rstate[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        train = t_train(tree, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), train.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_mlstm_cell_stabiliser_matches_reference():
    """One cell step from a non-zero state with gate pre-activations of
    +-60 (exp overflows f32 without the stabiliser m): the same C, n, m
    and h."""
    rng = np.random.default_rng(4)
    H, hd = 2, 8
    f = lambda *s: rng.standard_normal((B,) + s).astype(np.float32)
    C, n, m = f(H, hd, hd), f(H, hd), f(H)
    q, k, v = f(H, hd), f(H, hd), f(H, hd)
    ig = np.array([[60.0, -60.0], [3.0, 0.5]], np.float32)
    fg = np.array([[-60.0, 60.0], [0.5, 3.0]], np.float32)
    (rC, rn, rm), rh = rx._mlstm_cell(
        tuple(map(jnp.asarray, (C, n, m))), tuple(map(jnp.asarray, (q, k, v, ig, fg))))
    T = torch.from_numpy
    (tC, tn, tm), th = tx._mlstm_cell((T(C), T(n), T(m)), T(q), T(k), T(v), T(ig), T(fg))
    for got, want in ((tC, rC), (tn, rn), (tm, rm), (th, rh)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_mlstm_backward_keeps_one_state_a_token():
    """Autograd saves one (B, H, hd, hd) tensor a token (the state C, which
    the next token's decay and this token's read share), and at most the
    zero initial state besides; the outer product ``(i v) k^T`` is never
    saved."""
    _, cfg = _cfgs()
    _, tree = _tree(_params("mlstm"), requires_grad=True)
    _, _, H, hd = tx._dims(cfg)
    big = set()

    def pack(t):
        if tuple(t.shape) == (B, H, hd, hd):
            big.add(t.untyped_storage().data_ptr())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tx.mlstm_train(tree, torch.from_numpy(_x(cfg.d_model, n=12)), cfg)
    assert 12 <= len(big) <= 12 + 1
