"""Data-parallel dry run, the counterpart of ``repro.launch.dryrun``.

For every (architecture x input shape x world) combination: plan the step
and record its memory fit, its planned collectives and its roofline terms
into one JSON a combination, with no array made.

The reference compiles each step with XLA against its 16 x 16 data x model
mesh (``repro.launch.mesh``) and reads ``memory_analysis()``,
``cost_analysis()`` and the compiled HLO.  The port runs data-parallel only,
with the whole model on every card, so its dry run covers data-parallel
worlds, priced on the H100 (``core.ccr.HardwareSpec.h100_sxm``):

* ``w8``: one node of 8 cards over NVLink (the ``"ici"`` link);
* ``2x8``: two such nodes, the network between them the ``"dcn"`` link.

``--mesh`` selects ``w8``, ``2x8`` or ``both`` in place of the reference's
``pod1`` / ``pod2`` / ``both``.  What the reference reads from a compiled
module, the port takes from:

* the plan (:func:`plan_train`): the bucket plan, the compressor and this
  phase's ``CommSchedule``, built as ``Trainer._phase_fn`` builds them,
  from the model's ``meta`` parameters;
* shapes (``memory_analysis["argument_size_in_bytes"]``, exact): params,
  AdamW moments, EF residuals or the KV arena's planes, and the batch;
* a step traced on ``meta`` tensors, which carry shapes and dtypes and no
  storage (``peak_memory_in_bytes``, an estimate, as XLA's is): one
  training step (or one prefill or decode call) under ``MemTracker``, the
  gradient sync run as one worker runs it, cut in depth (and, for a
  token-loop family, in length) and extrapolated (:func:`traced_peak`);
* ``launch.analytic_costs`` for the compute and memory terms, and the plan's
  wire bytes through the reference's wire model for the collective term.

A configuration that does not fit in 80 GB a card gets ``"status":
"does_not_fit"``; one that the trace cannot follow gets ``"status":
"error"`` with its traceback, and the sweep goes on.  No array is made,
so the dry run needs no card; it still asks for one unless ``--device
cpu`` is passed, as every entry point of the port does.

Usage:
  python -m repro_torch.launch.dryrun --arch gpt2-paper --shape train_4k --mesh w8
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both --out D
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import types

import torch

from ..configs import INPUT_SHAPES, get_config, list_archs
from ..configs.base import InputShape
from ..core import build_plan, get_compressor
from ..core.ccr import HardwareSpec, analytic_ccr, select_interval
from ..core.schedule import CollectiveCall
from ..models import build_model, count_params, long_context_variant, model_flops
from ..models.transformer import dense_prefix, num_superblocks, superblock_kinds
from . import analytic_costs, hlo_analysis

HW = HardwareSpec.h100_sxm()
# one H100 SXM's device memory (NVIDIA's data sheet: 80 GB of HBM3)
DEVICE_BYTES = 80e9
# the data-parallel worlds: tag -> (pods, cards a pod)
MESHES = {"w8": (1, 8), "2x8": (2, 8)}
PAGE_SIZE = 16


def auto_interval(cfg, pods: int, intra: int, hw: HardwareSpec = HW) -> int:
    """COVAP's adaptive ``I = ceil(CCR)`` from the analytic profiler (SS
    III.B), the reference's rule with a model world of 1: every card holds
    the whole model and syncs its whole gradient.  Across pods the sync is
    the two-level decomposition: a ring all-reduce inside the pod over
    NVLink, plus a cross-pod exchange over the network of only the
    ``1/W_intra`` slice the intra ring already reduced."""
    n_chips = pods * intra
    shape = INPUT_SHAPES["train_4k"]
    tokens = shape.global_batch * shape.seq_len
    flops_per_chip = 6.0 * count_params(cfg, active_only=True) * tokens / n_chips
    grad_bytes = count_params(cfg) * getattr(torch, cfg.param_dtype).itemsize
    t_comp = (2.0 / 3.0) * flops_per_chip / (hw.peak_flops * hw.mfu)
    if pods > 1:
        calls = (
            CollectiveCall("grad-shard", "all_reduce", cfg.param_dtype, int(grad_bytes),
                           link="ici", world=intra),
            CollectiveCall("pod-shard", "all_reduce", cfg.param_dtype,
                           int(grad_bytes) // max(intra, 1), link="dcn", world=pods),
        )
        bw = {"ici": hw.ici_bw, "dcn": hw.dcn_bw}
        t_comm = sum(c.wire_bytes(0) / bw[c.link] for c in calls)
        return select_interval(t_comm / max(t_comp, 1e-12))
    return select_interval(analytic_ccr(step_flops_per_chip=flops_per_chip,
                                        grad_bytes=grad_bytes, dp_world=n_chips, hw=hw))


def input_specs(cfg, shape: InputShape, batch: int, device="meta") -> dict:
    """The batch one card feeds (``batch`` rows of ``shape``), as empty
    tensors: tokens and labels, the VLM's ``patch_embeds`` ahead of ``S -
    frontend_tokens`` text tokens, the encoder-decoder's ``frames``; a
    decode step's one token and position a row."""
    i32, cd = torch.int32, getattr(torch, cfg.compute_dtype)
    S = shape.seq_len
    if shape.kind == "decode":
        return {"tokens": torch.zeros((batch, 1), dtype=i32, device=device),
                "pos": torch.zeros((batch,), dtype=i32, device=device)}
    front = (batch, cfg.frontend_tokens, cfg.d_model)
    out = {}
    if cfg.is_encdec:
        out["frames"] = torch.zeros(front, dtype=cd, device=device)
    elif cfg.family == "vlm":
        out["patch_embeds"] = torch.zeros(front, dtype=cd, device=device)
        S -= cfg.frontend_tokens
    out["tokens"] = torch.zeros((batch, S), dtype=i32, device=device)
    if shape.kind == "train":
        out["labels"] = torch.zeros((batch, S), dtype=i32, device=device)
    return out


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def _optimizer(cfg):
    from ..optim import adamw

    # bf16 moments for bf16 parameters, as the reference's dry run plans them
    return adamw(1e-4, moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else None)


def _compressor(name: str, interval: int, sync: str):
    opts = {"interval": interval} if name == "covap" else {}
    if sync != "allreduce":
        opts["sync"] = sync
    return get_compressor(name, **opts)


def plan_train(cfg, pods: int, intra: int, compressor_name: str, interval: int,
               phase: int, pod_interval: int = 1, sync: str = "allreduce") -> dict:
    """The static plan of one training step at ``pods x intra`` cards, with
    no array made: the bucket plan of the model's ``meta`` parameters, the
    compressor and this phase's ``CommSchedule`` as ``Trainer._phase_fn``
    builds them (the sync world is the pod's under hierarchical sync, the
    whole world otherwise), and the per-link bytes one step injects: the
    gradient collectives, the head all-gather (sharded sync) and the
    cross-pod reconciliation (hierarchical).  A flat sync over two pods
    crosses the network in every collective, so its bytes are all
    ``"dcn"``.  -> the reference's meta fields."""
    from ..train.trainer import plan_pod_schedule
    from .hier_gate import planned_bytes_by_link

    model = build_model(cfg, device="meta")
    plan = build_plan(model.named_leaves(), interval=interval)
    compressor = _compressor(compressor_name, interval, sync)
    hier = pod_interval > 1 and pods > 1
    world = intra if hier else pods * intra
    sched = compressor.plan_phase(plan, phase, world=world)
    pod_sched = None
    if hier:
        pod_sched = plan_pod_schedule(plan, pod_phase=phase % pod_interval,
                                      pod_interval=pod_interval, sync=sync,
                                      intra_world=intra, n_pods=pods)
    by_link = planned_bytes_by_link(
        types.SimpleNamespace(comm_schedule=sched, pod_schedule=pod_sched))
    if not hier and pods > 1:
        by_link = {"dcn": sum(by_link.values())}
    calls = list(sched.calls) + (list(pod_sched.calls) if pod_sched else [])
    return {
        "plan_buckets": plan.num_buckets,
        "interval": interval,
        "phase": phase,
        "compressor": compressor_name,
        "sync": sync,
        "pod_interval": pod_interval,
        "comm_schedule": sched.summary(),
        "pod_schedule": pod_sched.summary() if pod_sched is not None else None,
        "planned_bytes_per_worker": sched.bytes_per_worker,
        "planned_bytes_by_link": by_link,
        "collectives": plan_collectives(calls, world),
    }


def plan_collectives(calls, world: int) -> dict:
    """The planned calls as the reference's ``collective_summary`` of a
    compiled step: ops, and count and result bytes by kind (an all-gather's
    gathered buffer, a reduce-scatter's shard, the buffer of the others),
    through the same wire model (factor 2 for an all-reduce)."""
    by_kind: dict[str, dict] = {}
    for c in calls:
        g = c.world or world
        b = c.bytes_per_worker
        result = b * g if c.op == "all_gather" else b // g if c.op == "reduce_scatter" else b
        d = by_kind.setdefault(c.op.replace("_", "-"), {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += result
    return {"ops": len(calls), "by_kind": by_kind,
            "buffer_bytes": sum(d["bytes"] for d in by_kind.values()),
            "wire_bytes_est": hlo_analysis.wire_bytes_est(
                {k: d["bytes"] for k, d in by_kind.items()})}


def plan_serve(cfg, shape: InputShape, batch: int) -> dict:
    """The KV arena one card holds for ``batch`` slots of ``shape.seq_len``
    tokens: ``serve.kv_arena.plan_kv_layout`` probed on ``meta``, sized as
    the engine sizes it (every slot can run full length)."""
    from ..serve.kv_arena import KVArena, plan_kv_layout

    model = build_model(cfg, device="meta")
    layout = plan_kv_layout(model.cache_specs, shape.seq_len, PAGE_SIZE)
    pages = KVArena.auto_pages(layout, batch)
    return {"page_size": PAGE_SIZE, "pages": pages, "page_bytes": layout.page_bytes(),
            "arena_bytes": pages * layout.page_bytes(),
            "plane_dtypes": list(layout.plane_dtypes)}


def _peak(mt) -> int:
    snap = mt.get_tracker_snapshot("peak")
    return max((int(v.get("Total", 0)) for v in snap.values()), default=0)


def _depth(cfg) -> int:
    """The depth the dry run cuts: superblocks (an encoder-decoder's
    encoder and decoder layers together, when they are equal; 0 when
    they are not, and the depth is not cut)."""
    if cfg.is_encdec:
        return cfg.num_layers if cfg.encoder_layers == cfg.num_layers else 0
    return num_superblocks(cfg)


def _cut(cfg, k: int):
    """``cfg`` at ``k`` superblocks (``k`` encoder and ``k`` decoder
    layers); a leading dense prefix is kept whole."""
    if cfg.is_encdec:
        return cfg.with_(num_layers=k, encoder_layers=k)
    return cfg.with_(num_layers=dense_prefix(cfg) + k * len(superblock_kinds(cfg)))


def _state(cfg, shape: InputShape, batch: int, *, compressor_name, interval, sync,
           track: bool, arena_bytes: int = 0) -> tuple[int, int, int, int]:
    """The model on the ``meta`` device (shapes and dtypes, no storage),
    this card's batch and, for training, the trainer's fresh state; with
    ``track`` one training step (prefill or decode call) runs on them under
    ``MemTracker``.  -> ``(argument bytes, batch bytes, state bytes, traced
    peak bytes)``; the peak of a decode call counts the arena's bytes."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from ..train.trainer import TrainConfig, Trainer

    model = build_model(cfg, device="meta")
    batch_t = input_specs(cfg, shape, batch)
    batch_bytes = tree_bytes(batch_t)
    mt = MemTracker()
    mt.track_external(model)
    state_bytes = peak = 0
    if shape.kind == "train":
        tc = TrainConfig(compressor=compressor_name, interval=interval, sync=sync,
                         log_every=10 ** 9)
        tr = Trainer(model, _optimizer(cfg), tc)
        with mt:
            state = tr.init_state()
            state_bytes = tree_bytes([state["params"], state["opt"], state["comp"]])
            if track:
                tr.step(state, batch_t)
        args = state_bytes + batch_bytes
    else:
        args = tree_bytes([p for _, p in model.named_leaves()]) + arena_bytes + batch_bytes
        if track:
            with mt:
                if shape.kind == "prefill":
                    model.prefill(None, batch_t)
                else:
                    caches = model.init_caches(batch, shape.seq_len)
                    model.decode_step(None, caches, batch_t)
    if track:
        peak = _peak(mt) + (arena_bytes if shape.kind == "decode" else 0)
    return args, batch_bytes, state_bytes, peak


# the families whose layers loop over the tokens one at a time (xlstm's
# mLSTM and sLSTM recurrences): their traces are cut in length too
TOKEN_LOOP_FAMILIES = ("ssm",)
TRACE_TOKENS = (16, 32)


def _linear(x: float, x1: float, x2: float, y1: float, y2: float) -> float:
    return y1 + (x - x1) * (y2 - y1) / (x2 - x1)


def traced_peak(cfg, shape: InputShape, batch: int, **kw) -> tuple[int, dict]:
    """``MemTracker``'s peak over one step of ``cfg`` at ``batch`` rows of
    ``shape``, traced on ``meta`` tensors.  A model deeper than two
    superblocks is traced at one and two and extrapolated linearly to its
    depth (parameters, their gradients and moments, and the activations a
    checkpointed superblock keeps all grow by one superblock's worth a
    superblock); a token-loop family's training step or prefill is traced
    at ``TRACE_TOKENS`` positions and extrapolated linearly in the length
    too (its saved states grow by one a token).  -> ``(peak, {"depths",
    "tokens"})``, the depths and lengths that ran."""
    n = _depth(cfg)
    depths = [1, 2] if n > 2 else [n]
    S = shape.seq_len
    cut_len = cfg.family in TOKEN_LOOP_FAMILIES and shape.kind != "decode"
    lengths = list(TRACE_TOKENS) if cut_len and S > TRACE_TOKENS[-1] else [S]
    peaks = {}
    for k in depths:
        c = _cut(cfg, k) if k != n else cfg
        for t in lengths:
            sh = InputShape(shape.name, t, shape.global_batch, shape.kind)
            arena = plan_serve(c, sh, batch)["arena_bytes"] if shape.kind == "decode" else 0
            peaks[k, t] = _state(c, sh, batch, track=True, arena_bytes=arena, **kw)[3]

    def along_length(k):
        if len(lengths) == 1:
            return peaks[k, lengths[0]]
        return _linear(S, *lengths, peaks[k, lengths[0]], peaks[k, lengths[1]])

    if len(depths) == 1:
        peak = along_length(depths[0])
    else:
        peak = _linear(n, *depths, along_length(depths[0]), along_length(depths[1]))
    return int(round(peak)), {"depths": depths, "tokens": lengths}


def memory_analysis(cfg, shape: InputShape, batch: int, *, compressor_name="covap",
                    interval: int = 1, sync: str = "allreduce",
                    arena_bytes: int = 0) -> dict:
    """The reference's ``memory_analysis`` keys for one card.
    ``argument_size_in_bytes`` is exact from shapes at full depth: params,
    AdamW moments and EF residuals (``state_size_in_bytes``), or the KV
    arena's planes, and the batch.  ``peak_memory_in_bytes`` is an
    estimate, :func:`traced_peak` (``peak_traced`` says what ran).
    ``fits`` compares the larger of the two with 80 GB."""
    kw = dict(compressor_name=compressor_name, interval=interval, sync=sync)
    args, batch_bytes, state_bytes, _ = _state(cfg, shape, batch, track=False,
                                               arena_bytes=arena_bytes, **kw)
    peak, traced = traced_peak(cfg, shape, batch, **kw)
    out = {"argument_size_in_bytes": args, "peak_memory_in_bytes": peak,
           "batch_size_in_bytes": batch_bytes, "peak_traced": traced,
           "device_bytes": int(DEVICE_BYTES)}
    if shape.kind == "train":
        out["state_size_in_bytes"] = state_bytes
    out["fits"] = max(args, peak) <= DEVICE_BYTES
    return out


def roofline(cfg, shape: InputShape, n_devices: int, wire_bytes: float) -> dict:
    """The reference's roofline keys: the analytic compute and memory terms
    (``model_shard=1``, ``data_shard=n_devices``) and the plan's wire bytes,
    priced on the H100."""
    flops_global = analytic_costs.step_flops(cfg, shape)
    flops = flops_global / n_devices
    hbm = analytic_costs.step_hbm_bytes(cfg, shape, model_shard=1, data_shard=n_devices)
    terms = hlo_analysis.roofline_terms(
        flops_per_device=flops, hbm_bytes_per_device=hbm,
        wire_bytes_per_device=wire_bytes,
        peak_flops=HW.peak_flops, hbm_bw=HW.hbm_bw, ici_bw=HW.ici_bw)
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    mf = model_flops(cfg, tokens, "train" if shape.kind == "train" else "serve")
    return {
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm,
        "wire_bytes_per_device": wire_bytes,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_devices,
        "useful_flops_ratio": mf / flops_global if flops_global else None,
    }


def run_one(arch: str, shape_name: str, mesh: str, *, compressor: str = "covap",
            interval: int | None = None, phase: int = 0, kv_cache_dtype: str = "",
            pod_interval: int = 1, sync: str = "allreduce") -> dict:
    """One combination's record; a failure is caught into it, with its
    traceback."""
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    variant = "exact"
    if shape_name == "long_500k":
        new_cfg = long_context_variant(cfg)
        variant = "native" if new_cfg is cfg else "sliding_window"
        cfg = new_cfg
    if kv_cache_dtype:
        cfg = cfg.with_(kv_cache_dtype=kv_cache_dtype)
    pods, intra = MESHES[mesh]
    n_devices = pods * intra
    batch = max(shape.global_batch // n_devices, 1)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "n_devices": n_devices,
           "kind": shape.kind, "variant": variant, "local_batch": batch, "status": "ok",
           "hardware": "NVIDIA H100 SXM5 (data sheet)"}
    if kv_cache_dtype:
        rec["kv_cache_dtype"] = kv_cache_dtype
    t0 = time.perf_counter()
    try:
        wire = 0.0
        if shape.kind == "train":
            if interval is None and compressor == "covap":
                interval = auto_interval(cfg, pods, intra)
            meta = plan_train(cfg, pods, intra, compressor, interval or 1, phase,
                              pod_interval=pod_interval, sync=sync)
            wire = meta["collectives"]["wire_bytes_est"]
            arena = 0
        else:
            meta = plan_serve(cfg, shape, batch)
            arena = meta["arena_bytes"]
        rec.update(meta)
        rec["memory_analysis"] = memory_analysis(
            cfg, shape, batch, compressor_name=compressor, interval=interval or 1,
            sync=sync, arena_bytes=arena)
        # the seconds to plan and trace the step: the counterpart of XLA's
        # lower + compile, under the reference's key
        rec["compile_s"] = round(time.perf_counter() - t0, 2)
        rec["roofline"] = roofline(cfg, shape, n_devices, wire)
        if not rec["memory_analysis"]["fits"]:
            rec["status"] = "does_not_fit"
    except Exception as e:  # a sweep records the failure and goes on
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def record_line(tag: str, rec: dict) -> str:
    if rec["status"] == "error":
        return f"FAIL {tag:60s} {rec['error'][:120]}"
    r, ma = rec["roofline"], rec["memory_analysis"]
    return (f"OK   {tag:60s} {rec['status']:12s} compile={rec['compile_s']:7.1f}s "
            f"peak={ma['peak_memory_in_bytes'] / 1e9:8.2f}GB "
            f"dom={r['dominant']:10s} comp={r['compute_s'] * 1e3:8.2f}ms "
            f"mem={r['memory_s'] * 1e3:8.2f}ms coll={r['collective_s'] * 1e3:8.2f}ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="w8", choices=["w8", "2x8", "both"])
    ap.add_argument("--compressor", default="covap")
    ap.add_argument("--interval", type=int, default=None)
    ap.add_argument("--phase", type=int, default=0)
    ap.add_argument("--kv-cache-dtype", default="")
    ap.add_argument("--pod-interval", type=int, default=1)
    ap.add_argument("--sync", default="allreduce", choices=["allreduce", "sharded"])
    ap.add_argument("--device", default="cuda",
                    help="the dry run makes no array; the card is still asked for "
                         "unless --device cpu")
    ap.add_argument("--tag", default="", help="suffix for the output JSON")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        from ..device import resolve_device

        resolve_device(args.device)
    archs = list_archs(assigned_only=True) if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                tag = f"{arch}__{shape}__{mesh}__{args.compressor}"
                if args.sync != "allreduce":
                    tag += f"__{args.sync}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"skip {tag}")
                    continue
                rec = run_one(arch, shape, mesh, compressor=args.compressor,
                              interval=args.interval, phase=args.phase,
                              kv_cache_dtype=args.kv_cache_dtype,
                              pod_interval=args.pod_interval, sync=args.sync)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(record_line(tag, rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
