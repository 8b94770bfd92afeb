"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: each test skips where there is no GPU, since a CUDA kernel
has no CPU mode.  The file imports neither JAX nor the reference, so it runs
on a GPU machine that has neither:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.ef_covap import ef_update
from repro_torch.kernels.lowrank import matmul
from repro_torch.kernels.pack_ef_cast import pack_ef_cast, pack_ef_cast_into
from repro_torch.kernels.quantize import dequantize_fp8, quantize_fp8
from repro_torch.kernels.ref import (
    dequantize_fp8_ref,
    ef_update_ref,
    matmul_ref,
    pack_ef_cast_ref,
    quantize_fp8_ref,
    sample_threshold,
    sign_compress_partials_ref,
    threshold_filter_ref,
)
from repro_torch.kernels.sign_compress import sign_compress, sign_compress_partials
from repro_torch.kernels.topk_threshold import threshold_filter


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1_000_003, 0), (4096, 1), (6_553_344, 0)])
@pytest.mark.parametrize("selected", [True, False])
def test_cuda_kernel_matches_plain_version(n, offset, selected):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(n)
    g = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    r = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    before = ef_update.launches
    s, q = ef_update(g, r, 0.3, selected=selected)
    torch.cuda.synchronize()
    assert ef_update.launches == before + 1
    rs, rq = ef_update_ref(g, r, 0.3, selected=selected)
    assert torch.equal(s, rs) and torch.equal(q, rq)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset,wire_offset",
                         [(1_000_003, 0, 0), (4099, 1, 0), (65_537, 0, 1),
                          (6_553_344, 0, 3)])
@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("selected", [True, False])
def test_pack_ef_cast_kernel_matches_plain_version(n, offset, wire_offset, wire,
                                                   selected):
    """Bitwise, with the wire written into a plane at an element offset (the
    arena slot) and views that start off a 16-byte boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(n)
    g = torch.randn(n + offset, generator=gen, device="cuda")[offset:] * 3e4
    r = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    plane = torch.zeros(n + wire_offset, dtype=wire, device="cuda")
    r_out = torch.empty(n, device="cuda")
    before = pack_ef_cast.launches
    pack_ef_cast_into(g, r, 0.3, plane[wire_offset:] if selected else None,
                      r_out, selected=selected)
    torch.cuda.synchronize()
    assert pack_ef_cast.launches == before + 1
    w, q = pack_ef_cast_ref(g, r, 0.3, selected=selected, wire_dtype=wire)
    assert torch.equal(r_out, q)
    if selected:
        assert torch.equal(plane[wire_offset:], w)
    assert not torch.any(plane[:wire_offset] != 0)
    if not selected:
        assert not torch.any(plane != 0)


def _same_floats(a, b):
    """Bit for bit, where NaN counts as equal to NaN (the card's arithmetic
    returns one canonical NaN, but the test should not depend on it)."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _fp8_input(n, offset, gen):
    """Normals at scales from e^-8 to e^8 in a plane, viewed from element
    ``offset``."""
    x = torch.randn(n + offset, generator=gen, device="cuda")
    x = x * torch.exp(torch.rand(n + offset, generator=gen, device="cuda") * 16 - 8)
    x = x[offset:]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n,block,offset,special",
                         [(1_000_003, 8192, 0, False), (5000, 8192, 0, False),
                          (10_007, 64, 0, True), (100_003, 8192, 1, True),
                          (6_553_344, 8192, 0, False)])
def test_quantize_fp8_kernels_match_plain_version(n, block, offset, special):
    """q and scales bit for bit against ``quantize_fp8_ref``, the dequantised
    values against ``dequantize_fp8_ref``: ragged, N < block, block 64, an
    offset-1 view, the largest bucket, and blocks that are zero, hold a NaN,
    hold +-inf, or hold 448 beside values that quantize to subnormals."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(n + block)
    x = _fp8_input(n, offset, gen)
    if special:
        x[:block] = 0.0
        x[block + 3] = float("nan")
        x[2 * block + 1], x[2 * block + 2] = float("inf"), float("-inf")
        x[3 * block:4 * block] *= 1e-3 / x[3 * block:4 * block].abs().max()
        x[3 * block], x[3 * block + 1] = 448.0, -0.0
    b = (quantize_fp8.launches, dequantize_fp8.launches)
    q, s = quantize_fp8(x, block)
    d = dequantize_fp8(q, s, block)
    torch.cuda.synchronize()
    assert (quantize_fp8.launches, dequantize_fp8.launches) == (b[0] + 1, b[1] + 1)
    rq, rs = quantize_fp8_ref(x, block)
    assert torch.equal(q.view(torch.uint8), rq.view(torch.uint8))
    assert _same_floats(s, rs)
    assert _same_floats(d, dequantize_fp8_ref(rq, rs, block))
    if special:
        assert s[0] == 1e-12 and torch.isnan(s[1]) and torch.isinf(s[2])
        assert s[3] == 1.0 and d[3 * block] == 448.0
        assert bool(((q[3 * block:4 * block].view(torch.uint8) & 0x78) == 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1_000_003, 0), (4099, 1), (6_553_344, 0),
                                      (32_768, 3)])
def test_sign_compress_kernel_matches_plain_version(n, offset):
    """Signs bit for bit (+0.0 and -0.0 give +1, NaN and negative subnormals
    -1); partials and scale at rtol 1e-6 (another order of summation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(n)
    x = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    special = torch.tensor([0.0, -0.0, 1e-45, -1e-45, float("nan")], device="cuda")
    xs = x.clone()
    xs[:5] = special[:min(5, n)]
    before = sign_compress.launches
    signs, _ = sign_compress_partials(xs)
    signs2, scale = sign_compress(x)
    torch.cuda.synchronize()
    assert sign_compress.launches == before + 2
    rsigns, _ = sign_compress_partials_ref(xs)
    assert torch.equal(signs, rsigns)
    assert signs[:5].tolist() == [1, 1, 1, -1, -1]
    rs2, rpartials = sign_compress_partials_ref(x)
    assert torch.equal(signs2, rs2)
    _, partials = sign_compress_partials(x)
    torch.testing.assert_close(partials, rpartials, rtol=1e-6, atol=0)
    torch.testing.assert_close(scale, x.abs().mean(), rtol=1e-6, atol=0)


def _assert_matmul_close(got, a, b, trans_a=False, trans_b=False):
    """Within 1e-5 of ``|A| @ |B|`` elementwise of ``matmul_ref`` (cuBLAS in
    float32, TF32 off): the two sum in another order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    want = matmul_ref(a, b, trans_a=trans_a, trans_b=trans_b)
    scale = matmul_ref(a.abs(), b.abs(), trans_a=trans_a, trans_b=trans_b)
    assert got.shape == want.shape and got.is_contiguous()
    assert bool(((got - want).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,a,b", [(1, 50304, 768), (1, 768, 50304), (12, 768, 768),
                                   (12, 3072, 768), (12, 768, 3072), (1, 12, 768),
                                   (3, 1001, 517)])
def test_lowrank_matmul_kernel_matches_plain_version(B, a, b):
    """PowerSGD's three products of an (B, a, b) matrix at rank 2, each fed
    the plain version's result of the one before: P = M@Q (split-k where
    the output is small), Q' = M^T@P (M read through its transpose) and
    P@Q'^T (k = 2, write-bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(a * b)
    M = torch.randn(B, a, b, generator=gen, device="cuda")
    Q = torch.randn(B, b, 2, generator=gen, device="cuda")
    before = matmul.launches
    _assert_matmul_close(matmul(M, Q), M, Q)
    P, _ = torch.linalg.qr(matmul_ref(M, Q))
    _assert_matmul_close(matmul(M, P, trans_a=True), M, P, trans_a=True)
    Qn = matmul_ref(M, P, trans_a=True)
    _assert_matmul_close(matmul(P, Qn, trans_b=True), P, Qn, trans_b=True)
    assert matmul.launches == before + 3


def _routed(route, fn):
    """``fn()``, checking that it launched exactly one kernel, on ``route``."""
    before = dict(matmul.launches_by_route)
    out = fn()
    torch.cuda.synchronize()
    after = matmul.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}, route
    return out


@pytest.mark.cuda
def test_lowrank_matmul_zero_strided_wide_and_deterministic():
    """An all-zero M gives exact zeros; strided views read the same matrices
    as their contiguous copies; n = 3 (the skinny tile padded to 4), n = 5
    and 129 (the wide tile) with 2-D operands; each of these takes the
    tiled kernel, the contiguous full-width ones their streaming routes;
    a split-k product is the same from run to run, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(11)
    Z = torch.zeros(1, 50304, 768, device="cuda")
    q = torch.randn(1, 768, 2, generator=gen, device="cuda")
    assert not _routed("rowdot", lambda: matmul(Z, q)).any()
    pz = torch.randn(1, 50304, 2, generator=gen, device="cuda")
    assert not _routed("colacc", lambda: matmul(Z, pz, trans_a=True)).any()
    big = torch.randn(2, 700, 1802, generator=gen, device="cuda")
    view = big[:, :, ::2]
    p = torch.randn(2, 700, 2, generator=gen, device="cuda")
    got = _routed("tiled", lambda: matmul(view, p, trans_a=True))
    assert torch.equal(got, _routed("tiled", lambda: matmul(view.contiguous(), p,
                                                            trans_a=True)))
    _assert_matmul_close(got, view, p, trans_a=True)
    a = torch.randn(1001, 517, generator=gen, device="cuda")
    for n in (3, 5, 129):                 # the padded skinny tile, the wide one
        w = torch.randn(517, n, generator=gen, device="cuda")
        _assert_matmul_close(_routed("tiled", lambda: matmul(a, w)), a, w)
    M = torch.randn(1, 768, 50304, generator=gen, device="cuda")
    Q = torch.randn(1, 50304, 2, generator=gen, device="cuda")
    assert torch.equal(_routed("rowdot", lambda: matmul(M, Q)), matmul(M, Q))
    P = torch.randn(1, 768, 2, generator=gen, device="cuda")
    assert torch.equal(_routed("colacc", lambda: matmul(M, P, trans_a=True)),
                       matmul(M, P, trans_a=True))


@pytest.mark.cuda
@pytest.mark.parametrize("B,a,b", [(1, 5000, 768), (1, 768, 5000), (12, 768, 3072),
                                   (12, 3072, 768)])
@pytest.mark.parametrize("zero", [False, True])
def test_lowrank_matmul_streaming_routes_match_plain_version(B, a, b, zero):
    """Each streaming route at reduced sizes, as PowerSGD chains them (P
    from the QR, column-major): within 1e-5 (|A| @ |B|) of ``matmul_ref``,
    exact zeros from an all-zero M, and the same bits on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(a + b)
    M = torch.randn(B, a, b, generator=gen, device="cuda")
    if zero:
        M.zero_()
    Q = torch.randn(B, b, 2, generator=gen, device="cuda")
    P, _ = torch.linalg.qr(torch.randn(B, a, 2, generator=gen, device="cuda"))
    Qn = matmul_ref(M, P, trans_a=True)
    for route, x, y, ta, tb in (("rowdot", M, Q, False, False),
                                ("colacc", M, P, True, False),
                                ("outer", P, Qn, False, True)):
        got = _routed(route, lambda: matmul(x, y, trans_a=ta, trans_b=tb))
        _assert_matmul_close(got, x, y, trans_a=ta, trans_b=tb)
        assert torch.equal(got, matmul(x, y, trans_a=ta, trans_b=tb))
        if zero:
            assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 9, 999])
def test_adamw_update_on_cuda_matches_the_cpu_update(step):
    """One AdamW update (weight decay on) on the card and on the CPU from the
    same moments, gradients and params.  The bias corrections are device
    tensors, so both divide, and m, v and the divisions are bitwise equal.
    ``torch.sqrt`` in float32 differs between the two by one ulp on some
    elements (``ROADMAP.md`` queue 3): it is held at 1 ulp, and the update
    bitwise wherever the two square roots agree, elsewhere within 4 ulps of
    ``lr * m_hat / (sqrt(v_hat) + eps)`` (one ulp of the root moves the
    quotient by one ulp, and each later rounding by half of one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import bias_corrections

    gen = torch.Generator().manual_seed(step)
    shapes = [(768, 2304), (12, 768), (50304,), ()]
    g, m, p = ([torch.randn(s, generator=gen) for s in shapes] for _ in range(3))
    v = [torch.rand(s, generator=gen) * 1e-3 for s in shapes]
    lr, wd = 3e-4, 0.01
    opt = adamw(lr, weight_decay=wd)
    out = {}
    for dev in ("cpu", "cuda"):
        on = lambda xs: [x.to(dev) for x in xs]   # noqa: E731
        upd, new = opt.update(on(g), {"step": step, "m": on(m), "v": on(v)}, on(p))
        out[dev] = [[x.cpu() for x in part] for part in (upd, new["m"], new["v"])]
    (u_gpu, m_gpu, v_gpu), (u_cpu, m_cpu, v_cpu) = out["cuda"], out["cpu"]
    assert all(torch.equal(a, b) for a, b in zip(m_gpu + v_gpu, m_cpu + v_cpu))
    bc1, bc2 = bias_corrections(step + 1, 0.9, 0.999, torch.device("cpu"))
    for ug, uc, mm, vv in zip(u_gpu, u_cpu, m_cpu, v_cpu):
        vh = vv / bc2
        root_cpu, root_gpu = torch.sqrt(vh), torch.sqrt(vh.cuda()).cpu()
        ulps = (root_cpu.view(torch.int32).long() - root_gpu.view(torch.int32).long()).abs()
        assert int(ulps.max()) <= 1
        agree = ulps == 0
        assert torch.equal(ug[agree], uc[agree])
        term = (lr * (mm / bc1) / (root_cpu + 1e-8)).abs()
        assert bool(((ug - uc).abs() <= 2.0 ** -21 * term).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset,threshold,block",
                         [(1_000_003, 0, 0.01, 32768), (70_001, 0, 0.0, 32768),
                          (5000, 0, 0.0, 4096), (100_003, 1, 0.5, 32768),
                          (6_553_344, 0, 0.001, 32768)])
def test_threshold_filter_kernel_matches_plain_version(n, offset, threshold, block):
    """y and counts bit for bit against ``threshold_filter_ref`` (a
    ``sample_threshold`` ratio below 0.1, else the threshold itself): NaN
    gives 0 and is not counted, +-inf survive, -0.0 survives t = 0 as -0.0,
    the ragged last block counts its real elements only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(n)
    x = torch.randn(n + offset, generator=gen, device="cuda")[offset:]
    x[:6] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1e-45],
                         device="cuda")
    t = (sample_threshold(x, threshold) if 0 < threshold < 0.1
         else torch.tensor(threshold, device="cuda"))
    before = threshold_filter.launches
    y, c = threshold_filter(x, t, block=block)
    torch.cuda.synchronize()
    assert threshold_filter.launches == before + 1
    ry, rc = threshold_filter_ref(x, t, block)
    assert torch.equal(y.view(torch.int32), ry.view(torch.int32))
    assert torch.equal(c, rc) and c.dtype == torch.int32
    if threshold == 0.0:
        assert int(c.sum()) == n - 1 and int(c[-1]) == n - (c.numel() - 1) * block



@pytest.mark.cuda
@pytest.mark.parametrize("options,kernel", [({}, "ef_update"),
                                            ({"arena": True}, "pack_ef_cast"),
                                            ({"sync": "sharded"}, "pack_ef_cast")],
                         ids=["defaults", "arena", "sharded"])
def test_fused_step_on_cuda_equals_post_step(options, kernel):
    """Two REDUCED steps on the card with ``overlap="fused"`` and with
    ``"post"`` from the same parameters and batches: params, momenta and
    residuals equal (``torch.equal``); each run launches its EF kernel once
    a segment a step; every hook's backward ran on the stream the forward
    pass ran on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.train import TrainConfig, Trainer

    counter = {"ef_update": ef_update, "pack_ef_cast": pack_ef_cast}[kernel]
    cfg = get_reduced("gpt2-paper")
    out = {}
    for overlap in ("post", "fused"):
        model = build_model(cfg, device="cuda", seed=0)
        tr = Trainer(model, sgd(1e-2, momentum=0.9),
                     TrainConfig(overlap=overlap, bucket_bytes=1 << 13, max_buckets=64,
                                 steps=2, log_every=1, **options))
        loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                        global_batch=4, corpus_tokens=1 << 14),
                             device="cuda")
        before = counter.launches
        state = tr.run(tr.init_state(), loader, log=None)
        torch.cuda.synchronize()
        assert counter.launches - before == 2 * tr.plan.num_segments
        out[overlap] = state["params"] + state["opt"]["mu"] + state["comp"]
        if overlap == "fused":
            fwd, streams = tr.last_step_fn.hook_streams
            assert streams and all(s == fwd for s in streams)
    for a, b in zip(out["post"], out["fused"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_cuda(tmp_path):
    """A tree of card tensors (bf16 and a host int included) saved and
    restored onto the card bit for bit, and onto the CPU when the ``like``
    tree lies there: the caller's tree alone picks the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch import checkpoint

    gen = torch.Generator("cuda").manual_seed(0)
    tree = {"params": [torch.randn(300, 7, generator=gen, device="cuda"),
                       torch.randn(9, generator=gen, device="cuda").to(torch.bfloat16)],
            "opt": {"step": 3}, "comp": [None, torch.randn(9, generator=gen, device="cuda")]}
    checkpoint.save(str(tmp_path), 4, tree)
    for device in ("cuda", "cpu"):
        like = {"params": [torch.zeros(300, 7, device=device),
                           torch.zeros(9, dtype=torch.bfloat16, device=device)],
                "opt": {"step": 0}, "comp": [None, torch.zeros(9, device=device)]}
        got = checkpoint.restore(str(tmp_path), 4, like)
        assert got["opt"]["step"] == 3 and got["comp"][0] is None
        for a, b in zip(got["params"] + got["comp"][1:], tree["params"] + tree["comp"][1:]):
            assert a.device.type == device and torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4097, 1_000_003])
def test_sparsifying_stages_on_cuda_match_the_cpu(n):
    """TopK and OkTopK (no group) on the card equal the CPU's bit for bit
    on normal noise (no ties at the k-th magnitude); DGC's clip scales by a
    norm summed in another order, so it is held at rtol 1e-6; RandomK's
    draw on the card is the same for the same key and lies in range."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.core.stages import BucketKey, OkTopKRoute, RandomK, TopK

    x = torch.randn(n, generator=torch.Generator().manual_seed(n))
    for stage in (TopK(0.01), OkTopKRoute(0.01)):
        for a, b in zip(stage.execute_bucket(x.cuda(), None, None),
                        stage.execute_bucket(x, None, None)):
            assert torch.equal(a.cpu(), b)
    for a, b in zip(TopK(0.001, clip_norm=1.0).execute_bucket(x.cuda(), None, None),
                    TopK(0.001, clip_norm=1.0).execute_bucket(x, None, None)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0)
    key = BucketKey(0, 5, 2)
    i1 = RandomK(0.01).indices(key, n, torch.device("cuda"))
    i2 = RandomK(0.01).indices(BucketKey(0, 5, 2), n, torch.device("cuda"))
    assert i1.is_cuda and torch.equal(i1, i2)
    assert int(i1.min()) >= 0 and int(i1.max()) < n
    synced, sent = RandomK(0.01).execute_bucket(x.cuda(), key, None)
    assert torch.equal(synced, sent) and torch.equal(synced[i1], x.cuda()[i1])
