"""The port's bucket plan, coarse filter and static schedules against
``repro.core`` on the gpt2-paper parameter shapes, and each bucket's
first-use stage held, on every arch, to what the forward pass reads."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import get_compressor as r_get_compressor
from repro.models import build_model as r_build_model

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, get_compressor
from repro_torch.core.bucketing import (
    EMBED_STAGE,
    bucket_first_use,
    loop_stages,
    segment_slices,
)
from repro_torch.core.filter import compression_ratio, selected_buckets
from repro_torch.models import build_model, multimodal

FULL_WIDTH_BYTES_W8 = [203_701_248, 179_667_456, 179_982_336, 198_778_368]


def _plans(reduced, vocab=None, **kw):
    get = "get_reduced" if reduced else "get_config"
    rcfg = getattr(rconfigs, get)("gpt2-paper")
    tcfg = getattr(tconfigs, get)("gpt2-paper")
    if vocab:
        rcfg, tcfg = rcfg.with_(vocab_size=vocab), tcfg.with_(vocab_size=vocab)
    shapes = jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0))
    ref = r_build_plan(shapes, **kw)
    port = build_plan(build_model(tcfg, device="meta").named_leaves(), **kw)
    return ref, port


def _jax_path(dotted):
    return "".join(f"['{k}']" for k in dotted.split("."))


@pytest.mark.parametrize(
    "reduced,kw",
    [
        (False, {}),
        (True, {}),
        (True, {"bucket_bytes": 1 << 14, "max_buckets": 32}),
        (True, {"bucket_bytes": 1 << 12, "max_buckets": 64, "interval": 8}),
    ],
)
def test_plan_equals_reference(reduced, kw):
    ref, port = _plans(reduced, **kw)
    assert tuple(_jax_path(p) for p in port.leaf_paths) == ref.leaf_paths
    assert port.leaf_shapes == ref.leaf_shapes
    assert port.bucket_bytes_target == ref.bucket_bytes_target
    assert port.num_buckets == ref.num_buckets
    for pb, rb in zip(port.buckets, ref.buckets):
        assert (pb.index, pb.numel, pb.nbytes, pb.origin) == (
            rb.index, rb.numel, rb.nbytes, rb.origin
        )
        assert [tuple(vars(s).values()) for s in pb.segments] == [
            tuple(vars(s).values()) for s in rb.segments
        ]


def test_full_width_plan_shape():
    _, port = _plans(False)
    assert port.num_buckets == 35
    assert port.num_segments == 42
    assert port.total_numel() == 190_532_352


@pytest.mark.parametrize("phase", range(4))
def test_full_width_phase_schedule_equals_reference(phase):
    ref_plan, port_plan = _plans(False)
    r = r_get_compressor("covap", interval=4).plan_phase(ref_plan, phase, world=8)
    p = get_compressor("covap", interval=4).plan_phase(port_plan, phase, world=8)
    assert p.selected == r.selected
    assert p.bytes_per_worker == r.bytes_per_worker == FULL_WIDTH_BYTES_W8[phase]
    assert p.dense_bytes == r.dense_bytes
    assert [(c.target, c.op, c.wire_dtype, c.payload_bytes) for c in p.calls] == [
        (c.target, c.op, c.wire_dtype, c.payload_bytes) for c in r.calls
    ]
    assert p.wire_bytes() == pytest.approx(r.wire_bytes())
    assert p.summary() == {k: v for k, v in r.summary().items() if k in p.summary()}


def test_bench5_workload_bytes():
    """``BENCH_5.json``: gpt2-paper/reduced (vocab 256) covap I=4 with the
    facade's 16 KiB buckets -> 393856 bytes a step, volume ratio 4.0."""
    _, plan = _plans(True, vocab=256, bucket_bytes=1 << 14, max_buckets=32, interval=4)
    comp = get_compressor("covap", interval=4)
    scheds = [comp.plan_phase(plan, p, world=1) for p in range(4)]
    mean = sum(s.bytes_per_worker for s in scheds) / 4
    assert mean == 393856
    assert scheds[0].dense_bytes / mean == 4.0
    assert compression_ratio(plan, 4) == pytest.approx(4.0)


@pytest.mark.parametrize("interval", [1, 2, 4, 7])
def test_every_bucket_selected_once_per_cycle(interval):
    n = 35
    seen = [b for p in range(max(interval, 1)) for b in selected_buckets(n, p, interval)]
    assert sorted(seen) == list(range(n))


def test_unported_options_raise():
    """The wire cast, the arena and sharded sync are ported and accepted;
    ``interval="auto"`` still raises.  Every compressor of the reference's
    registry is ported (the sparsifiers last); an unknown name raises."""
    comp = get_compressor("covap", interval=4, wire_dtype="bfloat16",
                          use_arena=True, sync="sharded")
    assert comp.wire.wire_dtype == torch.bfloat16
    assert comp._arena_on() and comp.sync_mode == "sharded"
    assert get_compressor("fp16").wire.wire_dtype == torch.bfloat16
    assert get_compressor("none", sync="sharded").ef is None
    with pytest.raises(ValueError):
        get_compressor("covap", interval=4, sync="ring")
    with pytest.raises(NotImplementedError):
        get_compressor("covap", interval="auto")
    for name in ("topk", "dgc", "randomk", "oktopk"):
        assert get_compressor(name).name == r_get_compressor(name).name == name
    with pytest.raises(KeyError):
        get_compressor("qsgd")


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_first_use_restores_every_bucket_before_its_read(arch):
    """With every parameter NaN and each bucket restored only at its
    first-use stage (those at ``EMBED_STAGE`` before the loss, the rest at
    the first ``before_layer(i)`` with ``i`` >= the stage, as
    ``ParamGather.settle_through`` settles them), the loss equals the
    unpoisoned loss bit for bit: no bucket is read before its stage.  The
    plan's loop stages are the model's, at full width and reduced."""
    full = build_model(tconfigs.get_config(arch), device="meta")
    assert loop_stages(build_plan(full.named_leaves())) == full.num_stages
    cfg = tconfigs.get_reduced(arch)
    model = build_model(cfg, device="cpu", seed=0)
    leaves = [p for _, p in model.named_leaves()]
    plan = build_plan(model.named_leaves(), bucket_bytes=1 << 12, max_buckets=256,
                      interval=1)
    assert loop_stages(plan) == model.num_stages
    stages = bucket_first_use(plan)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.is_encdec or cfg.family == "vlm":
        key = "frames" if cfg.is_encdec else "patch_embeds"
        batch[key] = multimodal.synth_frontend_embeds(gen, cfg, 2, device="cpu")
    clean = [p.detach().clone() for p in leaves]
    restored: list[int] = []

    def restore_through(stage):
        for b, bucket in enumerate(plan.buckets):
            if b not in restored and stages[b] <= stage:
                for (_, dst), (_, src) in zip(segment_slices(plan, leaves, bucket),
                                              segment_slices(plan, clean, bucket)):
                    dst.copy_(src)
                restored.append(b)

    with torch.no_grad():
        want, _ = model.loss_fn(batch)
        for p in leaves:
            p.fill_(float("nan"))
        restore_through(EMBED_STAGE)
        got, _ = model.loss_fn(batch, before_layer=restore_through)
    assert sorted(restored) == list(range(plan.num_buckets))
    assert torch.isfinite(want) and torch.equal(got, want)
