"""The attention core's two paths (``models.attention._attend``): the
hand-written causal kernel for CUDA tensors (``kernels/causal_attn.py``
over ``kernels/csrc/causal_attn.cu``) and the plain q-chunked path for any
other.

On the CPU:

* ``_attend`` on CPU tensors is the plain path, bit for bit in the output
  and the gradients, and launches no kernel;
* the kernel's wrapper refuses bad dtypes, devices, shapes, strides, head
  widths, windows and softcaps;
* every configuration, full and REDUCED, maps to an instance of the
  kernels' widths, so no card run of them raises;
* the launch arguments: the 16-byte-copy test and the strides' layout.

Marked ``cuda`` (each skips where there is no GPU: a CUDA kernel has no
CPU mode; the file imports neither JAX nor the reference), the kernels on
the card against the plain path run on the card, at the four bench cells'
attention shapes and in every form:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_causal_attn.py
"""
from types import SimpleNamespace

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import causal_attn as ca
from repro_torch.models import attention
from repro_torch.models.attention import _attend, _attend_plain

torch.set_num_threads(2)


def _cfg(chunk=16, softcap=0.0):
    return SimpleNamespace(attn_chunk=chunk, attn_softcap=softcap)


def _qkv(B, S, K, G, hq, hv, dtype=torch.float32, device="cpu", seed=0, v_view=False):
    """q (B,S,K,G,hq), k (B,S,K,hq), v (B,S,K,hv), leaves that need grads;
    with ``v_view`` v is the tail of a wider tensor, as MLA's
    ``kv[..., nope:]``."""
    gen = torch.Generator(device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    q, k = rand(B, S, K, G, hq), rand(B, S, K, hq)
    for x in (q, k):
        x.requires_grad_(True)
    if v_view:
        kv = rand(B, S, K, hq + hv).requires_grad_(True)
        return q, k, kv[..., hq:], (q, k, kv)
    v = rand(B, S, K, hv).requires_grad_(True)
    return q, k, v, (q, k, v)


def _run(fn, q, k, v, leaves, seed=1):
    """-> (output, grads of the leaves) for a fixed upstream gradient."""
    out = fn(q, k, v)
    gen = torch.Generator(out.device.type).manual_seed(seed)
    dout = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    grads = torch.autograd.grad(out, leaves, dout)
    return out.detach(), [g.detach() for g in grads]


# --- _attend on CPU tensors: the plain path ----------------------------------

PLAIN_CASES = {
    "mha": dict(shape=(2, 32, 2, 1, 8, 8), window=0, softcap=0.0),
    "gqa-window": dict(shape=(1, 48, 2, 2, 8, 8), window=5, softcap=0.0),
    "softcap": dict(shape=(1, 32, 1, 4, 16, 16), window=0, softcap=2.0),
    "mla-widths": dict(shape=(1, 32, 2, 1, 12, 8), window=0, softcap=0.0),
    "ragged": dict(shape=(1, 19, 1, 1, 8, 8), window=3, softcap=0.5),
}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_attend_on_cpu_is_the_plain_path(case):
    c = PLAIN_CASES[case]
    cfg = _cfg(softcap=c["softcap"])
    before = ca.causal_attn.launches
    outs = []
    for fn in (_attend, _attend_plain):
        q, k, v, leaves = _qkv(*c["shape"])
        outs.append(_run(lambda q, k, v, fn=fn: fn(q, k, v, cfg, c["window"]), q, k, v,
                         leaves))
    (o1, g1), (o2, g2) = outs
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert ca.causal_attn.launches == before


# --- the wrapper's refusals ---------------------------------------------------

def _bad(**kw):
    q = torch.zeros(1, 8, 2, 1, 16)
    k = torch.zeros(1, 8, 2, 16)
    v = torch.zeros(1, 8, 2, 16)
    args = dict(q=q, k=k, v=v, window=0, softcap=0.0)
    args.update(kw)
    return args


REFUSALS = {
    "cpu-tensors": (_bad(), ValueError, "needs CUDA tensors"),
    "float64": (_bad(q=torch.zeros(1, 8, 2, 1, 16, dtype=torch.float64),
                     k=torch.zeros(1, 8, 2, 16, dtype=torch.float64),
                     v=torch.zeros(1, 8, 2, 16, dtype=torch.float64)),
                TypeError, "float32, bfloat16 or float16"),
    "int8": (_bad(q=torch.zeros(1, 8, 2, 1, 16, dtype=torch.int8),
                  k=torch.zeros(1, 8, 2, 16, dtype=torch.int8),
                  v=torch.zeros(1, 8, 2, 16, dtype=torch.int8)),
             TypeError, "float32, bfloat16 or float16"),
    "mixed-dtypes": (_bad(v=torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16)),
                     TypeError, "v is torch.bfloat16"),
    "q-4-dims": (_bad(q=torch.zeros(1, 8, 2, 16)), ValueError, "5-dim"),
    "k-width": (_bad(k=torch.zeros(1, 8, 2, 32)), ValueError, "k .* does not match"),
    "k-heads": (_bad(k=torch.zeros(1, 8, 1, 16)), ValueError, "k .* does not match"),
    "v-length": (_bad(v=torch.zeros(1, 9, 2, 16)), ValueError, "v .* does not match"),
    "width-257": (_bad(q=torch.zeros(1, 8, 2, 1, 257), k=torch.zeros(1, 8, 2, 257)),
                  ValueError, "outside 1..256"),
    "v-width-300": (_bad(v=torch.zeros(1, 8, 2, 300)), ValueError, "outside 1..256"),
    "strided-last-dim": (_bad(k=torch.zeros(1, 8, 2, 32)[..., ::2]), ValueError,
                         "unit-strided"),
    "empty": (_bad(q=torch.zeros(1, 0, 2, 1, 16), k=torch.zeros(1, 0, 2, 16),
                   v=torch.zeros(1, 0, 2, 16)), ValueError, "empty"),
    "window": (_bad(window=-1), ValueError, "must be >= 0"),
    "softcap": (_bad(softcap=-1.0), ValueError, "must be >= 0"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses(case):
    args, err, match = REFUSALS[case]
    before = ca.causal_attn.launches
    with pytest.raises(err, match=match):
        ca.causal_attn(args.pop("q"), args.pop("k"), args.pop("v"), **args)
    assert ca.causal_attn.launches == before


# --- the kernels' widths and launch arguments ----------------------------------

def _attention_widths(cfg) -> tuple[int, int]:
    if cfg.is_mla:
        return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    return cfg.head_dim, cfg.head_dim


CONFIGS = [(a, form) for a in configs.list_archs() for form in ("full", "small")]


@pytest.mark.parametrize("arch,form", CONFIGS, ids=[f"{a}-{f}" for a, f in CONFIGS])
def test_every_config_has_valid_tiles(arch, form):
    cfg = configs.get_config(arch) if form == "full" else configs.get_reduced(arch)
    hq, hv = _attention_widths(cfg)
    dtype = getattr(torch, cfg.compute_dtype)
    dq, dv = ca.widths(dtype, hq, hv)
    assert dq >= hq and dv >= hv
    if dtype == torch.float32:
        assert (dq, dv) == (hq, hv)
    else:
        assert (dq, dv) in ca.WIDTHS


@pytest.mark.parametrize("hq,hv,want", [(8, 8, (32, 32)), (12, 8, (32, 32)),
                                        (32, 32, (32, 32)), (64, 64, (64, 64)),
                                        (80, 80, (128, 128)), (128, 128, (128, 128)),
                                        (192, 128, (192, 128)), (192, 64, (192, 128)),
                                        (192, 192, (256, 256)), (64, 128, (128, 128)),
                                        (256, 256, (256, 256))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_widths(hq, hv, want, dtype):
    """The first instance that holds both widths; latent attention's
    192/128 is not padded to 256."""
    assert ca.widths(dtype, hq, hv) == want


def test_float32_widths_are_not_padded():
    assert ca.widths(torch.float32, 12, 8) == (12, 8)


def test_every_instance_is_tileable():
    """The kernels step the q/k width in 16s and give each warp half of
    each width in pairs of 8 columns; every pair fits its 256-wide cap."""
    for dq, dv in ca.WIDTHS:
        assert dq % 32 == 0 and dv % 32 == 0 and dq <= ca.MAX_HEAD and dv <= ca.MAX_HEAD
    assert ca.WIDTHS == tuple(sorted(ca.WIDTHS, key=lambda w: w[0] + w[1]))


WORDS = {
    "contiguous-bf16": (torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16), 1),
    "mla-v-view": (torch.zeros(2, 8, 2, 256, dtype=torch.bfloat16)[..., 128:], 1),
    "float32": (torch.zeros(2, 8, 2, 64), 0),
    "width-12": (torch.zeros(2, 8, 2, 12, dtype=torch.bfloat16), 0),
    "odd-offset": (torch.zeros(2, 8, 2, 72, dtype=torch.bfloat16)[..., 4:68], 0),
}


@pytest.mark.parametrize("case", list(WORDS))
def test_sixteen_byte_copies(case):
    x, want = WORDS[case]
    assert ca._words(x) == want


def test_strides_layout():
    q = torch.zeros(2, 8, 3, 2, 16)
    k = torch.zeros(2, 8, 3, 16)
    v = torch.zeros(2, 8, 3, 40)[..., 8:]
    got = list(ca._strides(q, k, v))
    assert len(got) == 28
    assert got[:4] == list(q.stride()[:4]) and got[4:7] == list(k.stride()[:3])
    assert got[7:10] == list(v.stride()[:3]) and got[10:] == [0] * 18


# --- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


# the four bench cells' attention shapes: (B, S, K, G, hq, hv), strided v
CELLS = {
    "gpt2-paper.covap.b8": ((8, 1024, 12, 1, 64, 64), False),
    "gpt2-paper.covap.b32": ((32, 1024, 12, 1, 64, 64), False),
    "deepseek-moe-16b-2L.covap.b8": ((8, 1024, 16, 1, 128, 128), False),
    "moonlight-16b-a3b-5L-e32.covap.r2s8k": ((2, 8192, 16, 1, 192, 128), True),
}
# the other forms the card serves: shape, window, softcap, strided v
FORMS = {
    "gqa-128": ((2, 1024, 2, 4, 128, 128), 0, 0.0, False),
    "mqa-256": ((2, 512, 1, 8, 256, 256), 0, 0.0, False),
    "window-gemma2": ((2, 1024, 4, 2, 128, 128), 300, 50.0, False),
    "window": ((2, 1000, 4, 1, 64, 64), 77, 0.0, False),
    "softcap": ((2, 512, 4, 1, 64, 64), 0, 5.0, False),
    "width-8": ((2, 300, 4, 1, 8, 8), 0, 0.0, False),
    "width-16": ((2, 300, 4, 1, 16, 16), 0, 0.0, False),
    "width-32": ((2, 300, 4, 1, 32, 32), 0, 0.0, False),
    "width-80": ((2, 700, 4, 1, 80, 80), 0, 0.0, False),
    "width-12-8": ((2, 77, 4, 1, 12, 8), 0, 0.0, True),
    "ragged": ((3, 77, 2, 2, 64, 64), 0, 0.0, False),
}


def _errors(got, want, truth):
    """Each part's max |got - truth| and |want - truth| (float32)."""
    out = []
    for a, b, t in zip([got[0], *got[1]], [want[0], *want[1]], [truth[0], *truth[1]]):
        out.append((float((a.float() - t).abs().max()), float((b.float() - t).abs().max()),
                    float(t.abs().max())))
    return out


def _card_case(shape, window, softcap, dtype, v_view, device):
    cfg = _cfg(chunk=256, softcap=softcap)
    q, k, v, leaves = _qkv(*shape, dtype=dtype, device=device, v_view=v_view)
    before = ca.causal_attn.launches
    got = _run(lambda q, k, v: ca.causal_attn(q, k, v, window=window, softcap=softcap),
               q, k, v, leaves)
    torch.cuda.synchronize()
    assert ca.causal_attn.launches - before == 4
    want = _run(lambda q, k, v: _attend_plain(q, k, v, cfg, window), q, k, v, leaves)
    return got, want, (q, k, v, leaves, cfg)


def _check_bf16(got, want, q, k, v, leaves, cfg, window):
    """In the working type: the kernel's distance from the float32 plain
    path (the same bf16 inputs, every product and the softmax in f32) is
    at most twice the plain bf16 path's, plus 1e-3 of the largest value
    (both round to bf16 at other places)."""
    qf, kf, base = (x.detach().float().requires_grad_(True) for x in leaves)
    vf = base[..., base.shape[-1] - v.shape[-1]:]
    truth = _run(lambda q, k, v: _attend_plain(q, k, v, cfg, window), qf, kf, vf,
                 (qf, kf, base))
    for name, (e_got, e_want, scale) in zip(("out", "dq", "dk", "dv"),
                                            _errors(got, want, truth)):
        assert e_got <= 2 * e_want + 1e-3 * scale, (name, e_got, e_want, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_card_cell_shapes_bf16(cell, card):
    shape, v_view = CELLS[cell]
    got, want, (q, k, v, leaves, cfg) = _card_case(shape, 0, 0.0, torch.bfloat16,
                                                   v_view, card)
    _check_bf16(got, want, q, k, v, leaves, cfg, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "f32"])
def test_card_forms(form, dtype, card):
    """bf16 and fp16 as ``_check_bf16``; float32 at rtol 1e-4 (atol 1e-5 of
    the largest value, for the entries near 0): both sum in full float32,
    in other orders."""
    shape, window, softcap, v_view = FORMS[form]
    got, want, (q, k, v, leaves, cfg) = _card_case(shape, window, softcap, dtype,
                                                   v_view, card)
    if dtype == torch.float32:
        for a, b in zip([got[0], *got[1]], [want[0], *want[1]]):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()))
    else:
        _check_bf16(got, want, q, k, v, leaves, cfg, window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["moonlight-16b-a3b-5L-e32.covap.r2s8k", "gqa-128"])
def test_card_runs_repeat_bit_for_bit(case, card):
    """No atomics: two runs from the same inputs give the same bits."""
    if case in CELLS:
        shape, v_view = CELLS[case]
        window = softcap = 0
    else:
        shape, window, softcap, v_view = FORMS[case]
    runs = []
    for _ in range(2):
        q, k, v, leaves = _qkv(*shape, dtype=torch.bfloat16, device=card, v_view=v_view)
        runs.append(_run(lambda q, k, v: ca.causal_attn(q, k, v, window=window,
                                                        softcap=softcap), q, k, v, leaves))
    (o1, g1), (o2, g2) = runs
    assert torch.equal(o1, o2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.cuda
def test_card_attend_takes_the_kernel_and_counts(card):
    """``_attend`` on CUDA tensors launches the kernel: one forward and
    three backward launches."""
    cfg = _cfg(chunk=256)
    q, k, v, _ = _qkv(2, 256, 2, 2, 64, 64, dtype=torch.bfloat16, device=card)
    before = ca.causal_attn.launches
    out = attention._attend(q, k, v, cfg, 0)
    out.sum().backward()
    torch.cuda.synchronize()
    assert ca.causal_attn.launches - before == 4


@pytest.mark.cuda
def test_card_forward_under_no_grad(card):
    """Prefill runs under ``no_grad``: one forward launch, the plain path's
    output within the bf16 check."""
    cfg = _cfg(chunk=256)
    q, k, v, _ = _qkv(2, 300, 2, 2, 64, 64, dtype=torch.bfloat16, device=card)
    before = ca.causal_attn.launches
    with torch.no_grad():
        out = ca.causal_attn(q, k, v)
        want = _attend_plain(q, k, v, cfg, 0)
        truth = _attend_plain(q.float(), k.float(), v.float(), cfg, 0)
    torch.cuda.synchronize()
    assert ca.causal_attn.launches - before == 1 and not out.requires_grad
    e_got = float((out.float() - truth).abs().max())
    e_want = float((want.float() - truth).abs().max())
    assert e_got <= 2 * e_want + 1e-3 * float(truth.abs().max())
