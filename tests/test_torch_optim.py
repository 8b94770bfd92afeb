"""The port's AdamW: its bias corrections are float32 tensors on the
parameters' device, computed as the reference computes them, and the update
on the CPU is bitwise the one it gave with host-float divisors; one update
against the reference's ``repro.optim.adamw`` on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as r_adamw

from repro_torch.optim import adamw
from repro_torch.optim import optimizers

torch.set_num_threads(2)

SHAPES = [(3, 5), (7,), (2, 4, 6), ()]


def _leaves(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.standard_normal(s), dtype=np.float32) for s in shapes]


def _state(seed, step):
    """An AdamW state at ``step`` with random moments (v >= 0), and
    gradients and params, as numpy arrays."""
    g, m, p = _leaves(seed), _leaves(seed + 1), _leaves(seed + 2)
    v = [np.asarray(np.abs(x) * 1e-3, dtype=np.float32) for x in _leaves(seed + 3)]
    return g, m, v, p


def _host_float_update(lr, b1, b2, eps, wd, step, grads, m, v, params):
    """The update with ``bc1`` and ``bc2`` as Python floats: the CPU must
    give the same bits with the tensor divisors."""
    t = np.float32(step)
    m = [(b1 * m_.float() + (1 - b1) * g.float()) for m_, g in zip(m, grads)]
    v = [(b2 * v_.float() + (1 - b2) * torch.square(g.float())) for v_, g in zip(v, grads)]
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    out = []
    for m_, v_, p in zip(m, v, params):
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        if wd:
            u = u + wd * p.float()
        out.append(-lr * u)
    return out, m, v


@pytest.mark.parametrize("step", [1, 2, 10, 1000])
def test_bias_corrections_are_device_tensors_of_the_reference_values(step):
    for device in ("cpu", "meta"):
        bc1, bc2 = optimizers.bias_corrections(step, 0.9, 0.999, torch.device(device))
        for bc, b in ((bc1, 0.9), (bc2, 0.999)):
            assert bc.dim() == 0 and bc.dtype == torch.float32
            assert bc.device.type == device
            if device == "cpu":
                want = np.float32(1) - np.float32(b) ** np.float32(step)
                assert bc.item() == float(want)


def test_update_takes_its_divisors_on_the_parameters_device(monkeypatch):
    seen = []
    real = optimizers.bias_corrections

    def spy(step, b1, b2, device):
        seen.append((step, device))
        return real(step, b1, b2, device)

    monkeypatch.setattr(optimizers, "bias_corrections", spy)
    params = [torch.zeros(3, 4, device="meta"), torch.zeros(5, device="meta")]
    opt = adamw(1e-3)
    state = opt.init(params)
    updates, state = opt.update([torch.ones_like(p) for p in params], state, params)
    assert seen == [(1, torch.device("meta"))]
    assert all(u.device.type == "meta" for u in updates)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("step", [0, 1, 9, 999])
def test_update_is_bitwise_the_host_float_update(step, weight_decay):
    """The CPU divides by a float32 0-dim tensor exactly as by the Python
    float of the same value, so the update, m and v keep their bits."""
    g, m, v, p = (list(map(torch.from_numpy, x)) for x in _state(step, step))
    lr, b1, b2, eps = 3e-4, 0.9, 0.999, 1e-8
    opt = adamw(lr, b1, b2, eps, weight_decay)
    updates, new = opt.update(g, {"step": step, "m": m, "v": v}, p)
    want_u, want_m, want_v = _host_float_update(lr, b1, b2, eps, weight_decay,
                                                step + 1, g, m, v, p)
    assert new["step"] == step + 1
    for got, want in zip(updates + new["m"] + new["v"], want_u + want_m + want_v):
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


@pytest.mark.parametrize("step", [0, 9])
def test_update_matches_the_reference(step):
    """One update against ``repro.optim.adamw`` on the same moments,
    gradients and params: the reference's jit may contract ``b1*m +
    (1-b1)*g`` to an FMA, so the two agree at the float32 bound, not
    bitwise."""
    g, m, v, p = _state(step, step)
    lr = 3e-4
    r_opt = r_adamw(lr, weight_decay=0.01)
    r_state = {"step": jnp.asarray(step, jnp.int32), "m": list(map(jnp.asarray, m)),
               "v": list(map(jnp.asarray, v))}
    r_upd, r_new = r_opt.update(list(map(jnp.asarray, g)), r_state,
                                list(map(jnp.asarray, p)))
    opt = adamw(lr, weight_decay=0.01)
    upd, new = opt.update(list(map(torch.from_numpy, g)),
                          {"step": step, "m": list(map(torch.from_numpy, m)),
                           "v": list(map(torch.from_numpy, v))},
                          list(map(torch.from_numpy, p)))
    for got, want in zip(upd + new["m"] + new["v"],
                         list(r_upd) + list(r_new["m"]) + list(r_new["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# one bfloat16 ulp at the bottom of a binade, relative: a moment rounded to
# bfloat16 may land one ulp apart where the reference's jit contracts an FMA
BF16_RTOL = 2.0 ** -7


@pytest.mark.parametrize("param_dtype,moment_dtype", [
    ("bfloat16", None),          # the bf16 archs' default: bf16 moments
    ("float32", "bfloat16"),
    ("bfloat16", "float32"),
])
def test_moment_dtype_matches_the_reference(param_dtype, moment_dtype):
    """``adamw(moment_dtype=)``: the moments are kept in that dtype (by
    default the parameter's), the update computed in float32, as
    ``repro.optim.adamw`` does; two updates against it on the same
    inputs."""
    g, _, _, p = _state(5, 1)
    pdt = getattr(torch, param_dtype)
    params = [torch.from_numpy(x).to(pdt) for x in p]
    r_opt = r_adamw(3e-4, weight_decay=0.01, moment_dtype=moment_dtype)
    opt = adamw(3e-4, weight_decay=0.01, moment_dtype=moment_dtype)
    r_params = [jnp.asarray(x.float().numpy()).astype(param_dtype) for x in params]
    r_state, state = r_opt.init(r_params), opt.init(params)
    mdt = getattr(torch, moment_dtype or param_dtype)
    assert all(m.dtype == mdt for m in state["m"] + state["v"])
    assert all(str(m.dtype) == (moment_dtype or param_dtype)
               for m in list(r_state["m"]) + list(r_state["v"]))
    for step in range(2):
        grads = [np.asarray(x * (step + 1), dtype=np.float32) for x in g]
        r_upd, r_state = r_opt.update(list(map(jnp.asarray, grads)), r_state, r_params)
        upd, state = opt.update(list(map(torch.from_numpy, grads)), state, params)
        assert all(m.dtype == mdt for m in state["m"] + state["v"])
        for got, want in zip(upd + state["m"] + state["v"],
                             list(r_upd) + list(r_state["m"]) + list(r_state["v"])):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want).astype(np.float32),
                                       rtol=BF16_RTOL, atol=1e-7)
