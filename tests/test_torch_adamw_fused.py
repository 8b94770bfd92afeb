"""``Optimizer.apply``, the in-place step the trainer takes, and the checks of
the fused AdamW kernel's wrapper, on the CPU.

On the CPU ``apply`` is ``update`` followed by ``apply_updates`` (the path
``tests/test_torch_optim.py`` holds against the reference), bit for bit.
AdamW's ``cuda_apply`` is driven here through a plain emulation of the
kernel's arithmetic, fed the float32 scalars the wrapper passes it, so the
wiring (step, bias corrections, learning rate, the state kept in place) is
held to the same bits.  The kernel itself is held against the plain card
path in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw_fused as fused_mod
from repro_torch.models import build_model
from repro_torch.configs import get_reduced
from repro_torch.obs import counters, reset_counters
from repro_torch.optim import Optimizer, adamw, apply_updates, global_norm, sgd
from repro_torch.optim import optimizers
from repro_torch.train import build_step_fn, loss_and_grads
from repro_torch.core import build_plan, get_compressor
from repro_torch.train.trainer import make_train_state

torch.set_num_threads(2)

SHAPES = [(3, 5), (7,), (2, 4, 6), (), (37,)]
STEPS = 3


def _leaves(seed, dtype=torch.float32, shapes=SHAPES):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dtype) for s in shapes]


def _clone(xs):
    return [x.clone() for x in xs]


OPTIMIZERS = {
    "sgd": lambda: sgd(1e-2),
    "sgd-nesterov": lambda: sgd(1e-2, nesterov=True),
    "adamw": lambda: adamw(3e-4),
    "adamw-wd": lambda: adamw(3e-4, weight_decay=0.01),
    "adamw-bf16-moments": lambda: adamw(3e-4, moment_dtype="bfloat16"),
    "adamw-bf16-moments-wd": lambda: adamw(3e-4, weight_decay=0.01,
                                           moment_dtype="bfloat16"),
}


def _same_state(a, b):
    assert a.keys() == b.keys() and a["step"] == b["step"]
    for k in a:
        if k != "step":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_apply_is_update_then_apply_updates(name, param_dtype):
    """Three steps of ``apply`` against three of ``update`` +
    ``apply_updates`` from the same params: params and state bit for bit,
    and ``with_norm`` gives ``global_norm`` of the gradients."""
    opt = OPTIMIZERS[name]()
    p_apply = _leaves(0, param_dtype)
    p_plain = _clone(p_apply)
    s_apply, s_plain = opt.init(p_apply), opt.init(p_plain)
    for step in range(STEPS):
        grads = _leaves(10 + step, param_dtype)
        s_apply, norm = opt.apply(grads, s_apply, p_apply, with_norm=True)
        updates, s_plain = opt.update(grads, s_plain, p_plain)
        apply_updates(p_plain, updates)
        assert torch.equal(norm, global_norm(grads))
        _same_state(s_apply, s_plain)
        assert all(torch.equal(a, b) for a, b in zip(p_apply, p_plain))
    assert s_apply["step"] == STEPS


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_apply_keeps_the_state_structure_and_dtypes(param_dtype, moment_dtype):
    opt = adamw(1e-3, moment_dtype=moment_dtype)
    params = _leaves(1, param_dtype)
    state = opt.init(params)
    mdt = getattr(torch, moment_dtype) if moment_dtype else param_dtype
    for _ in range(2):
        state = opt.apply(_leaves(2, param_dtype), state, params)
        assert sorted(state) == ["m", "step", "v"]
        for part in ("m", "v"):
            assert [tuple(x.shape) for x in state[part]] == [tuple(p.shape) for p in params]
            assert all(x.dtype == mdt for x in state[part])
        assert all(p.dtype == param_dtype for p in params)
    assert state["step"] == 2


def _emulated_kernel(params, grads, m, v, bc1, bc2, *, lr, b1, b2, eps,
                     weight_decay, norm=False):
    """The kernel's per-element arithmetic in plain PyTorch, in place, on
    the float32 scalars the wrapper hands the launcher (ctypes rounds each
    double to float32)."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    b1_, omb1, b2_, omb2 = f32(b1), f32(1 - b1), f32(b2), f32(1 - b2)
    eps_, wd, neg_lr = f32(eps), f32(weight_decay), f32(-lr)
    for p, g, mi, vi in zip(params, grads, m, v):
        gf = g.float()
        g2 = gf * gf
        mi.copy_((b1_ * mi.float() + omb1 * gf).to(mi.dtype))
        vi.copy_((b2_ * vi.float() + omb2 * g2).to(vi.dtype))
        u = (mi.float() / bc1) / (torch.sqrt(vi.float() / bc2) + eps_)
        if weight_decay:
            u = u + wd * p.float()
        p.copy_((p.float() + neg_lr * u).to(p.dtype))
    _emulated_kernel.calls += 1
    return global_norm(grads) if norm else None


_emulated_kernel.calls = 0


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("param_dtype,moment_dtype", [
    (torch.float32, None), (torch.float32, "bfloat16"), (torch.bfloat16, None)])
def test_adamw_cuda_apply_wiring_gives_the_plain_bits(monkeypatch, param_dtype,
                                                      moment_dtype, weight_decay):
    """AdamW's ``cuda_apply`` over an emulation of the kernel: the step, its
    bias corrections and learning rate (a schedule) reach the kernel as the
    plain path uses them, the state keeps its own tensors, and three steps
    give ``update`` + ``apply_updates``'s bits."""
    monkeypatch.setattr(optimizers, "adamw_fused", _emulated_kernel)
    opt = adamw(lambda step: np.float32(1e-3) / np.float32(step),
                weight_decay=weight_decay, moment_dtype=moment_dtype)
    p_fused = _leaves(3, param_dtype)
    p_plain = _clone(p_fused)
    s_fused, s_plain = opt.init(p_fused), opt.init(p_plain)
    held = [id(x) for x in s_fused["m"] + s_fused["v"]]
    calls = _emulated_kernel.calls
    for step in range(STEPS):
        grads = _leaves(20 + step, param_dtype)
        s_fused, norm = opt.cuda_apply(grads, s_fused, p_fused, True)
        updates, s_plain = opt.update(grads, s_plain, p_plain)
        apply_updates(p_plain, updates)
        _same_state(s_fused, s_plain)
        assert all(torch.equal(a, b) for a, b in zip(p_fused, p_plain))
        assert torch.equal(norm, global_norm(grads))
    assert _emulated_kernel.calls == calls + STEPS
    assert [id(x) for x in s_fused["m"] + s_fused["v"]] == held


def test_cpu_leaves_never_reach_cuda_apply():
    def refuse(*a):
        raise AssertionError("cuda_apply called for CPU leaves")

    base = adamw(1e-3)
    opt = Optimizer(base.init, base.update, refuse)
    params = _leaves(4)
    state = opt.apply(_leaves(5), opt.init(params), params)
    assert state["step"] == 1


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_apply_counts_the_parameters_it_steps_while_recording(name):
    opt = OPTIMIZERS[name]()
    params = _leaves(6)
    state = opt.init(params)
    reset_counters()
    state = opt.apply(_leaves(7), state, params)
    assert "optim/params" not in counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        opt.apply(_leaves(8), state, params)
    n = sum(p.numel() for p in params)
    assert counters() == {"optim/params": n, "optim/fused_params": 0}
    reset_counters()


# ---- the wrapper's checks ----------------------------------------------------

def _args(n=12, **over):
    parts = {"p": torch.zeros(n), "g": torch.zeros(n), "m": torch.zeros(n),
             "v": torch.zeros(n)}
    parts.update(over)
    return ([parts["p"]], [parts["g"]], [parts["m"]], [parts["v"]],
            torch.ones(()), torch.ones(()))


def _call(args, **kw):
    fused_mod.adamw_fused(*args, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                          weight_decay=0.0, **kw)


@pytest.mark.parametrize("case,exc,words", [
    ("cpu", ValueError, ["needs CUDA tensors", "cpu"]),
    ("float16 grad", TypeError, ["g must be float32 or bfloat16", "torch.float16"]),
    ("float64 param", TypeError, ["p must be float32 or bfloat16", "torch.float64"]),
    ("moments differ", TypeError, ["m is torch.float32", "v is torch.bfloat16"]),
    ("shape", ValueError, ["m has shape (13,)", "p has (12,)"]),
    ("strided", ValueError, ["v must be contiguous", "strides (2,)"]),
    ("devices", ValueError, ["g on meta", "p on cpu"]),
    ("lists", ValueError, ["1 params, 2 grads"]),
    ("empty", ValueError, ["no leaves"]),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, exc, words):
    """Each refusal names what it got, and comes before any build or
    launch (nothing here has a card)."""
    args = {
        "cpu": _args(),
        "float16 grad": _args(g=torch.zeros(12, dtype=torch.float16)),
        "float64 param": _args(p=torch.zeros(12, dtype=torch.float64)),
        "moments differ": _args(v=torch.zeros(12, dtype=torch.bfloat16)),
        "shape": _args(m=torch.zeros(13)),
        "strided": _args(v=torch.zeros(24)[::2]),
        "devices": _args(g=torch.zeros(12, device="meta")),
        "lists": _args()[:1] + ([torch.zeros(12)] * 2,) + _args()[2:],
        "empty": ([], [], [], [], torch.ones(()), torch.ones(())),
    }[case]
    before = fused_mod.adamw_fused.launches
    with pytest.raises(exc) as info:
        _call(args, norm=True)
    for w in words:
        assert w in str(info.value)
    assert fused_mod.adamw_fused.launches == before


@pytest.mark.parametrize("n,sms,want", [
    (0, 132, 0), (1, 132, 1), (2048, 132, 1), (2049, 132, 2),
    (132 * 4 * 2048, 132, 528), (10**9, 132, 528), (10**9, 114, 456)])
def test_grid_depends_on_the_leaf_size_and_the_card_alone(n, sms, want):
    assert fused_mod.grid(n, sms) == want


# ---- the fold's gate in the trainer -------------------------------------------

@pytest.mark.parametrize("clip_norm", [0.0, 1e-3])
def test_grad_norm_is_folded_only_where_it_is_only_reported(monkeypatch, clip_norm):
    """Without clipping the step asks the optimizer for the norm of the
    gradients it steps on; with clipping it computes the norm first and
    steps on the clipped gradients (the norm reported is the one before the
    clip).  Either way the reported norm is ``global_norm`` of the synced
    gradients, bit for bit on the CPU."""
    seen = []
    real = Optimizer.apply

    def spy(self, grads, state, params, *, with_norm=False):
        seen.append((with_norm, global_norm(grads)))
        return real(self, grads, state, params, with_norm=with_norm)

    monkeypatch.setattr(Optimizer, "apply", spy)
    model = build_model(get_reduced("gpt2-paper"), device="cpu", seed=0)
    plan = build_plan(model.named_leaves(), bucket_bytes=1 << 14, max_buckets=32)
    comp = get_compressor("covap", interval=1)
    opt = adamw(1e-3)
    state = make_train_state(model, opt, comp, plan)
    fn = build_step_fn(model, opt, comp, plan, phase=0, clip_norm=clip_norm)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 512, (2, 17), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    grads, _ = loss_and_grads(model, state["params"], batch, None)
    want = global_norm(grads)
    _, norm = fn.update(state, grads)
    assert len(seen) == 1
    with_norm, stepped_norm = seen[0]
    assert with_norm is (clip_norm == 0)
    assert torch.equal(norm, want)
    if clip_norm:
        assert float(norm) > 10 * clip_norm
        assert float(stepped_norm) == pytest.approx(clip_norm, rel=1e-5)
    else:
        assert torch.equal(stepped_norm, want)
