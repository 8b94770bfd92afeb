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


def _reduced_trainer(**options):
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_reduced("gpt2-paper")
    tr = Trainer(build_model(cfg, device="cuda", seed=0), adamw(1e-3),
                 TrainConfig(interval=2, bucket_bytes=1 << 13, max_buckets=64,
                             log_every=1, **options))
    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4, corpus_tokens=1 << 14),
                         device="cuda")
    return tr, loader


@pytest.mark.cuda
@pytest.mark.parametrize("options", [{}, {"arena": True}, {"overlap": "fused"}],
                         ids=["defaults", "arena", "fused"])
def test_phase_probe_on_cuda_leaves_the_state_bitwise(options):
    """The real probe runs the full and compute-only steps on the card from
    the live state; afterwards params, Adam's m and v and the residuals are
    ``torch.equal`` to their clones from before, and the probe launched the
    EF kernel on every segment of each of its 2 x (warmup + iters) steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    from repro_torch.runtime import PhaseProbe

    tr, loader = _reduced_trainer(**options)
    state = tr.run(tr.init_state(), iter([loader.make(s) for s in range(2)]), steps=2,
                   log=None)
    parts = state["params"] + state["opt"]["m"] + state["opt"]["v"] + state["comp"]
    before = [x.detach().clone() for x in parts]
    counter = pack_ef_cast if options.get("arena") else ef_update
    launches = counter.launches
    sample = PhaseProbe(tr, warmup=1, iters=2)(state, loader.make(2), 0)
    torch.cuda.synchronize()
    assert counter.launches - launches == 2 * 3 * tr.plan.num_segments
    assert all(torch.equal(a, b) for a, b in zip(parts, before))
    assert sample.t_comp > 0 and sample.t_full > 0 and sample.t_comm >= 0


@pytest.mark.cuda
def test_probe_due_step_synchronizes_the_card(monkeypatch):
    """``Trainer.run`` waits for the card on probe-due steps only: with a
    probe after steps 1 and 3 of 5, ``torch.cuda.synchronize`` runs twice
    in the loop (the synthetic probe reads no clock and syncs nothing);
    without ``autotune``, never."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.runtime import AutotuneConfig, synthetic_probe

    calls = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: (calls.append(device), sync(device)))
    tr, loader = _reduced_trainer()
    it = iter(loader)
    state = tr.run(tr.init_state(), it, steps=3, log=None)
    assert calls == []
    tr.run(state, it, steps=5, log=None, autotune=AutotuneConfig(
        measure_every=2, warmup_steps=1, probe=synthetic_probe(0.01, 2.0)))
    assert len(calls) == 2 and all(torch.device(d).type == "cuda" for d in calls)
    assert tr.runtime.monitor.summary()["steps_recorded"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["grad_nan", "grad_inf", "grad_bitflip"])
def test_fault_corruption_and_restore_in_place_on_cuda(kind):
    """The injector writes into the live CUDA tensors (the model's params),
    the same sites and values as on the CPU, and skip-step's restore copies
    the rollback point back into those same tensors: after a NaN at step 3
    (``sync_every=1``) the run equals the clean replay bit for bit on the
    card, and every param is still the model's tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.resilience import corrupt_tree

    tr, loader = _reduced_trainer()
    state = tr.init_state()
    cpu = [p.detach().cpu() for p in state["params"]]
    ptrs = [p.data_ptr() for p in state["params"]]
    _, sites = corrupt_tree(state["params"], kind, seed=3, step=5, count=5)
    _, cpu_sites = corrupt_tree(cpu, kind, seed=3, step=5, count=5)
    assert sites == cpu_sites and [p.data_ptr() for p in state["params"]] == ptrs
    for p, c in zip(state["params"], cpu):
        assert torch.equal(p.cpu().view(torch.int32), c.view(torch.int32))

    batches = [loader.make(s) for s in range(8)]
    tr, _ = _reduced_trainer()
    healed = tr.run(tr.init_state(), iter(batches), steps=8, log=None,
                    guards={"sync_every": 1}, faults="grad_nan@3")
    assert healed["step"] == 6
    assert all(a is b for a, b in zip(healed["params"],
                                      (p for _, p in tr.model.named_leaves())))
    tr2, _ = _reduced_trainer()
    replay = tr2.run(tr2.init_state(), iter(batches[:3] + batches[5:8]), steps=6, log=None)
    for part in ("params", "m", "v", "comp"):
        got = healed[part] if part in ("params", "comp") else healed["opt"][part]
        want = replay[part] if part in ("params", "comp") else replay["opt"][part]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), part


@pytest.mark.cuda
@pytest.mark.parametrize("options", [{}, {"arena": True}], ids=["defaults", "arena"])
def test_guarded_run_on_cuda_equals_the_unguarded_run(options):
    """Guards on the defaults (``sync_every=4``, the watchdog every 8 steps)
    leave the card's run bit for bit, with the EF kernel launched on every
    segment of every step, as unguarded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    counter = pack_ef_cast if options.get("arena") else ef_update
    runs = []
    for guards in (None, True):
        tr, loader = _reduced_trainer(**options)
        launches = counter.launches
        state = tr.run(tr.init_state(), iter([loader.make(s) for s in range(9)]), steps=9,
                       log=None, guards=guards)
        torch.cuda.synchronize()
        assert counter.launches - launches == 9 * tr.plan.num_segments
        runs.append(state["params"] + state["opt"]["m"] + state["opt"]["v"]
                    + state["comp"])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert tr.resilience.summary()["trips"] == 0


@pytest.mark.cuda
def test_plane_nonfinite_counts_on_cuda_planes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.resilience import corrupt_planes, plane_nonfinite_counts

    planes = [torch.randn(n, device="cuda") for n in (1_000_003, 4096, 65_537)]
    assert plane_nonfinite_counts(planes) == [0, 0, 0]
    _, sites = corrupt_planes(planes, "grad_nan", seed=1, step=2)
    counts = plane_nonfinite_counts(planes)
    assert sum(counts) == 1 and counts[sites[0][0]] == 1
    _, more = corrupt_planes(planes, "grad_inf", seed=1, step=3, count=3)
    assert sum(plane_nonfinite_counts(planes)) == 1 + len(set(more) - set(sites))


def _one_rank_nccl():
    """Join a one-rank NCCL default group on this process (a free local
    port), unless one exists; -> whether this call created it."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        return False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("options,kernel", [({}, "ef_update"),
                                            ({"sync": "sharded", "arena": True},
                                             "pack_ef_cast")],
                         ids=["post", "sharded-arena"])
def test_one_rank_hierarchical_step_on_cuda_equals_the_flat_step(options, kernel):
    """Hierarchical pods (``pod_interval=2``) with a one-rank intra-pod and
    cross-pod NCCL group: 4 REDUCED steps equal the flat run bit for bit
    (params, moments, residuals), the reconcile a pack -> exchange ->
    unpack round trip; the EF kernel runs once a segment a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.distributed as dist

    created = _one_rank_nccl()
    try:
        counter = {"ef_update": ef_update, "pack_ef_cast": pack_ef_cast}[kernel]
        intra, pods = dist.new_group([0]), dist.new_group([0])
        runs = []
        for pod_kw, group, pod_group in (({}, dist.group.WORLD, None),
                                         ({"pod_interval": 2}, intra, pods)):
            tr, loader = _reduced_trainer(**options, **pod_kw)
            tr = type(tr)(tr.model, tr.optimizer, tr.tc, group=group, pod_group=pod_group)
            assert tr.hierarchical == bool(pod_kw)
            launches = counter.launches
            state = tr.run(tr.init_state(), iter([loader.make(s) for s in range(4)]),
                           steps=4, log=None)
            torch.cuda.synchronize()
            assert counter.launches - launches == 4 * tr.plan.num_segments
            runs.append(state["params"] + state["opt"]["m"] + state["opt"]["v"]
                        + state["comp"])
        assert all(torch.equal(a, b) for a, b in zip(*runs))
    finally:
        if created:
            dist.destroy_process_group()


@pytest.mark.cuda
def test_launcher_under_torch_distributed_run_on_cuda(tmp_path):
    """The CLI under ``torch.distributed.run`` joins a one-rank NCCL group
    on ``cuda:0`` and commits its steps; rank 0 writes the history."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import json
    import os
    import subprocess
    import sys

    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    hist = tmp_path / "history.json"
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "repro_torch.launch.train", "--reduced",
         "--steps", "2", "--seq-len", "32", "--global-batch", "4", "--interval", "2",
         "--log-every", "1", "--history-out", str(hist)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", "")))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "[launch] 1 rank(s), 1 pod(s) x 1, backend nccl, device cuda:0" in r.stdout
    assert "[done] step 2 (2 committed)" in r.stdout
    assert [h["step"] for h in json.loads(hist.read_text())["history"]] == [1, 2]


def _adamw_leaves(param_dtype, moment_dtype, seed):
    """Leaves on the card: a 0-dim leaf, odd lengths, a matrix, and an
    unaligned view (one element into a larger buffer, for p, g, m and v
    alike); moments at a random state (v >= 0)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    shapes = [(), (7,), (1_000_003,), (768, 2304), (4099,)]

    def make(scale=1.0, nonneg=False, dtype=param_dtype):
        out = []
        for i, s in enumerate(shapes):
            n = int(torch.Size(s).numel())
            off = 1 if i == len(shapes) - 1 else 0
            x = torch.randn(n + off, generator=gen, device="cuda") * scale
            x = (x.abs() if nonneg else x).to(dtype)[off:]
            out.append(x.view(s))
        return out

    mdt = getattr(torch, moment_dtype) if moment_dtype else param_dtype
    return (make(), make(), make(0.1, dtype=mdt), make(1e-3, nonneg=True, dtype=mdt))


@pytest.mark.cuda
@pytest.mark.parametrize("step", [0, 9, 999])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("param_dtype,moment_dtype", [
    (torch.float32, None), (torch.float32, "bfloat16"), (torch.bfloat16, None)],
    ids=["f32-f32", "f32-bf16", "bf16-bf16"])
def test_adamw_fused_kernel_matches_the_plain_card_path(param_dtype, moment_dtype,
                                                        weight_decay, step):
    """``Optimizer.apply`` on the card (one ``adamw_fused`` launch a leaf,
    in place) against ``update`` + ``apply_updates`` on the card from the
    same state: p, m and v bit for bit at steps 1, 10 and 1000; the folded
    norm within 1e-6 relative of ``global_norm``'s; the state keeps its own
    tensors; no host synchronisation inside the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    from repro_torch.kernels.adamw_fused import adamw_fused
    from repro_torch.optim import adamw, apply_updates, cosine_warmup, global_norm

    p, g, m, v = _adamw_leaves(param_dtype, moment_dtype, seed=step + 1)
    opt = adamw(cosine_warmup(1e-3, 5, 2000), weight_decay=weight_decay,
                moment_dtype=moment_dtype)
    plain_p = [x.clone() for x in p]
    updates, plain = opt.update(g, {"step": step, "m": [x.clone() for x in m],
                                    "v": [x.clone() for x in v]}, plain_p)
    apply_updates(plain_p, updates)
    want_norm = global_norm(g)
    before = adamw_fused.launches
    state = {"step": step, "m": m, "v": v}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, norm = opt.apply(g, state, p, with_norm=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert adamw_fused.launches == before + len(p)
    assert new["step"] == step + 1
    assert all(a is b for a, b in zip(new["m"] + new["v"], m + v))
    for part, got, want in (("p", p, plain_p), ("m", new["m"], plain["m"]),
                            ("v", new["v"], plain["v"])):
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), f"{part}[{i}]"
    assert norm.dtype == torch.float32 and norm.dim() == 0
    assert abs(float(norm) - float(want_norm)) <= 1e-6 * float(want_norm)


@pytest.mark.cuda
def test_adamw_fused_norm_is_deterministic_and_skips_empty_leaves():
    """Two folds over the same gradients give the same bits; an empty leaf
    is not launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    from repro_torch.kernels.adamw_fused import adamw_fused
    from repro_torch.optim.optimizers import bias_corrections

    p, g, m, v = _adamw_leaves(torch.float32, None, seed=7)
    p, g, m, v = ([torch.empty(0, device="cuda")] + x for x in (p, g, m, v))
    bc1, bc2 = bias_corrections(1, 0.9, 0.999, torch.device("cuda"))
    norms = []
    for _ in range(2):
        before = adamw_fused.launches
        norms.append(adamw_fused(p, g, m, v, bc1, bc2, lr=1e-3, b1=0.9, b2=0.999,
                                 eps=1e-8, weight_decay=0.0, norm=True))
        assert adamw_fused.launches == before + len(p) - 1
    assert torch.equal(norms[0], norms[1])
