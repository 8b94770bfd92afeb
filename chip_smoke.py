"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Each phase prints one line; any failure raises and the script exits non-zero.

  device   needs ``torch.cuda``; prints the card and its power limit, turns
           TF32 off for float32 matrix products and convolutions
  build    compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``,
           one ``nvcc`` per source, all started together
  kernels  holds ``ef_update`` and ``pack_ef_cast`` (all four
           specialisations) against their plain PyTorch versions on the card
           (ragged, unaligned, an odd slot offset in a bf16 plane, largest
           segment, whole embedding table, an f16 overflow) and times them
           over one full-width step's segments with CUDA events; then
           ``quantize_fp8`` / ``dequantize_fp8`` bit for bit (ragged, N <
           block, block 64, an offset-1 view, zero, NaN and +-inf blocks,
           448 beside subnormal codes, the largest bucket) and
           ``sign_compress`` (signs bit for bit with +-0, subnormals and NaN;
           partials and scale at rtol 1e-6), each timed over one full-width
           step's buckets; ``lowrank.matmul`` within 1e-5 (|A|@|B|) of
           ``matmul_ref`` (every full-width leaf's three PowerSGD products,
           each on its streaming route and the same bits twice, an
           all-zero M, odd sizes and strided views on the tiled kernel) and
           timed over one step's 33 products, in all and by product kind,
           beside ``torch.bmm`` and the tiled kernel; ``threshold_filter`` bit
           for bit in y and counts (ragged, t = 0, NaN and +-inf, offset 1,
           the largest bucket) and timed over one step's buckets at
           ``sample_threshold`` ratios 0.01 and 0.001; ``adamw_fused`` (one
           AdamW step in place, the norm folded) at every leaf of
           deepseek-moe-16b cut to 2 layers (bf16 moments) and of
           gpt2-paper: p, m, v bit for bit and the norm within 1e-6 of the
           plain card path, timed beside its bound, the plain path and
           ``torch._fused_adamw_`` where that takes the same dtypes;
           ``causal_attn`` at moonlight's and gpt2-paper b32's attention;
           ``moe_dispatch`` (the MoE slot map, permute and unpermute,
           forward and backward) at deepseek's and moonlight's MoE layers:
           slot, keep, src and the buffer bit for bit against the plain
           path, y and the gradients within the tests' ulps, each kernel
           timed beside its bound and the plain path, whose one-hot scan
           and indexing backward are timed apart
  adamw    one AdamW update on the card against the CPU: moments and
           divisions bit for bit, ``torch.sqrt`` at 1 ulp, the update bit
           for bit where the roots agree; and ``Optimizer.apply`` (the
           fused kernel) against ``update`` + ``apply_updates`` on the
           card, bit for bit
  train    full-width gpt2-paper (190,532,352 parameters), AdamW, seq 1024,
           global batch 8, 5 steps in a one-rank NCCL process group, seven
           times: COVAP I=4 on the ``TrainConfig`` defaults (every loss
           finite, ``ef_update.launches`` == segments x steps; in every
           ``[train]`` run on the card, here and in later phases,
           ``adamw_fused`` launches once a leaf a step), then
           ``arena=True``, ``arena=True`` with a bf16 wire, and
           ``sync="sharded"`` (``pack_ef_cast.launches`` == segments x
           steps and ``ef_update.launches`` == 0 on each; sharded prints
           the order of its head all-gather's issues and waits against the
           layers, and checks it); then the
           flat-bucket path, ``fp8wire`` (``quantize_fp8.launches`` ==
           buckets x steps, ``dequantize_fp8.launches`` == 2 x buckets x
           steps) and ``efsignsgd`` (``sign_compress.launches`` == buckets x
           steps); then the leaf path, ``powersgd`` (rank 2,
           ``lowrank.matmul.launches`` == 33 x steps, 11 x steps on each
           streaming route); then the fused overlap (``overlap="fused"``:
           each bucket's collective started inside the backward pass) on
           the defaults (``ef_update.launches`` == segments x steps), with
           ``arena=True`` and with ``sync="sharded"``
           (``pack_ef_cast.launches`` == segments x steps), each printed
           beside its post run (step ms, tok/s, peak memory), with every
           hook's backward on the forward's stream and the hooks fired in
           ``ReadyOrder``; every other kernel's count must be 0 on each run
           (``threshold_filter``, which no path runs, on all of them).  Each
           run's peak memory is taken after a garbage collection, so that
           it counts the run's own memory
  parity   one step from the trained state on the same gradients: each
           kernel against its plain version, arena against per-segment
           (f32 and bf16 wires) and sharded against allreduce, bit for bit;
           for each flat wire, the kernels against ``use_wire_kernel=False``
           (fp8wire bit for bit; efsignsgd signs bit for bit, values at rtol
           1e-6) and the arena against the per-bucket form, bit for bit;
           for powersgd, the matmul kernel against ``use_wire_kernel=False``:
           approx and residuals at allclose, Q up to QR's column signs;
           ``[parity] fused``: from one state and one batch, each fused
           form (defaults, arena, sharded) against its post form, in synced
           gradients, residuals, and the params, Adam moments and residuals
           after the step, by ``torch.equal`` (a difference is printed with
           its ulps and held at ``FUSED_PARITY_ULPS``)
  ckpt     full width, on the defaults and on ``powersgd``: 2 steps,
           ``checkpoint.save_train_state`` into a temporary directory, 3
           more steps; a fresh trainer restored from it and fed the same 3
           batches equals that run bit for bit (params, Adam's m and v, the
           residuals, PowerSGD's Q, both steps, the losses); prints the
           bytes on disk and the save, verify and restore seconds, and a
           copy with one byte flipped must raise ``CheckpointCorruptError``
           (``ef_update.launches`` == 8 x segments, ``lowrank.matmul`` 8 x
           33)
  replan   on the defaults, 2 steps at I=4, ``Trainer.replan(2)``: the
           residual norm bit for bit the same (``carry``), the old and new
           plan's buckets, segments and phases, 3 more steps with finite
           losses and ``ef_update.launches`` == 3 x the new plan's segments
  sparse   ``[train] topk``, ``dgc``, ``randomk`` and ``oktopk`` (5 steps
           each on the flat-bucket path, no kernel launched), each with its
           plan's bytes per worker per step; ``[parity] oktopk``: on the
           same gradients, ``oktopk`` in the one-rank group (its all-to-all
           and all-gather run) equals ``topk`` bit for bit
  adaptive the adaptive runtime at full width on the defaults (COVAP I=4,
           ``ef_update``): after 2 steps one ``PhaseProbe`` call leaves
           params, m, v and residuals ``torch.equal`` (its times, the
           call's seconds and peak memory printed); 6 steps under the real
           probe (``ADAPTIVE_CONFIG``) with a ``Telemetry``, each probe's
           ``t_full``, ``t_comp``, ``t_comm``, ``t_comm_direct`` and CCR,
           each decision and re-plan printed, the measured CCRs replayed
           through a fresh ``ReplanController`` to the same decisions,
           ``ef_update.launches`` equal to the count worked out from the
           plans the run went through, the events valid against the schema
           and the trace's measured, planned and control rows; the
           synthetic probe (CCR 1.6) re-planning I 4 -> 2 after step 1
           with the residual norm carried bit for bit; and
           ``api.tune(measured=True)`` at full width (each row's analytic
           speedup on the paper's V100 spec beside the CCR measured on
           the card)
  resilience  the resilience runtime at full width: ``guards=True`` (no
           faults) for 5 steps on the defaults equals the unguarded run on
           the same batches by ``torch.equal`` (steps 1-4 ms of both, peak
           memory, the rollback copies' bytes, one copy's and one residual
           norm's device ms); the chaos gate's scenario
           (``launch/chaos_gate.run_chaos``: covap I=2,
           ``grad_nan@6,ef_blowup@10,grad_inf@14x3,kill@17``) takes every
           rung and the kill -> restore -> resume, ends at step 20 with a
           finite loss and events valid and 1:1 with the counters (the
           save, restore and verify seconds printed); and on one
           full-width step's arena planes one ``grad_nan`` gives
           ``plane_nonfinite_counts`` exactly one non-finite element.
           ``ef_update.launches`` == segments x the steps each run executed
           (replays and the chaos run's loss step included),
           ``pack_ef_cast.launches`` == segments in the plane step
  overlap  last of the card runs (the steps after a profiled one run
           slower), after a fresh fused run of 5 steps: one post and one
           fused step under ``torch.profiler``: the host
           order of the ``covap_bucket_*`` spans follows ``ReadyOrder`` up
           to ties, and under fused at least one bucket's ``ef_update``
           kernels start on the device before layer 0's last backward GEMM,
           under post none (``launch/hlo_analysis.ef_kernel_overlap`` on the
           step's trace; one card shows where each bucket is issued, not
           overlap across cards)
  gates    after ``[overlap]``, full width in the one-rank NCCL group, one
           profiled step each (``record_shapes``, read by
           ``launch/hlo_analysis``): the overlap gate on ``[overlap]``'s
           fused trainer (``interleaved=True``, and at least one bucket's
           first kernel on the device before layer 0's last backward GEMM),
           a post trainer on the same model and state
           (``before_final_grad=0``) and the sharded gate on a fresh fused
           sharded trainer (``placed=True``; the plan's exposed ratio at
           W=8); ``ef_update`` 2 x segments and ``pack_ef_cast`` segments
  dryrun   ``launch/dryrun`` for gpt2-paper at ``[train]``'s shape (seq
           1024, batch 8, W=1): its argument bytes less the batch equal the
           bytes of a ``[train]`` state built on the card and lie within 2%
           of the allocator's growth while it is built; its traced peak
           beside ``[train]``'s measured peak, ``model_flops`` beside
           ``analytic_costs.step_flops``, the defaults run's MFU (of 989.4
           TFLOP/s); then ``launch/dryrun_sweep`` of every assigned arch at
           ``train_4k`` on ``w8`` (8 at once) and ``dryrun_summary``'s
           table.  ``[gates]`` and ``[dryrun]`` print their seconds
  launch   ``python -m torch.distributed.run --standalone --nproc-per-node 1
           -m repro_torch.launch.train`` at full width (seq 1024, global
           batch 8, I=4, 5 steps) in a one-rank NCCL group with
           ``--history-out``: exit code 0, its history's losses equal an
           in-process run on the same seed and batches bit for bit, its own
           ``[kernels]`` launches ``ef_update`` once per segment a step and
           ``adamw_fused`` once a leaf a step; prints its step ms and tok/s
  pods     hierarchical pods at full width (``pod_interval=2``, a one-rank
           intra-pod and a one-rank cross-pod group), on the post form and
           on sharded+arena: 5 steps equal the flat run of the form bit for
           bit (params, m, v, residuals, losses), ``ef_update`` /
           ``pack_ef_cast`` once per segment a step; one reconcile's device
           ms and bytes; the full-width plan's bytes per link for each phase
           at 2 pods x 8 workers
           (``[launch]`` and ``[pods]`` run after ``[sparse]``, before
           ``[adaptive]``)
  families the dense, MoE, SSM, hybrid, audio and VLM archs at full width
           (``FAMILY_RUNS``; after ``[resilience]``, before ``[overlap]``):
           qwen1.5-0.5b's full
           config 5 steps (``ef_update`` 114 a step; one step on the same
           gradients against ``use_ef_kernel=False`` within ``ef_close``),
           then with ``arena=True, sync="sharded"`` (``pack_ef_cast`` 114 a
           step; == the post run bit for bit); deepseek-moe-16b cut to 2
           layers (77 a step; ``moe_dispatch`` 10 a layer a step under
           remat; the aux loss and each MoE layer's share of
           assignments dropped at capacity), gemma-2b cut to 2 layers (135
           a step; MQA, head_dim 256, a 256,000 vocab) and
           mistral-large-123b cut to 1 layer (bf16 params and moments,
           ``ef_update`` 0: the EF kernel takes f32 operands; a falling
           loss), xlstm-125m at its full config (77 a step; seq 1024 x
           global batch 7, ``FAMILY_SHAPES``), zamba2-2.7b cut to 12 layers
           (209 a step; two superblocks, the weight-shared block applied
           twice), then with ``arena=True, sync="sharded"``
           (``pack_ef_cast`` 209 a step) and with ``overlap="fused"``
           (the shared block's bucket hooks fire once a step, after both
           applications' gradients), each == the post run bit for bit, 3
           steps each; seamless-m4t-medium at its full config (12 + 12
           layers, 1024 frames (std-0.02 normals, numpy seed 0) + 1024
           tokens a row; 181 a step) on post, ``arena=True,
           sync="sharded"`` and ``overlap="fused"``, each == post bit for
           bit; pixtral-12b cut to 1 layer (256 patch embeddings + 768
           tokens a row, f32 params with bf16 moments, 129 a step; a
           falling loss, the projector's gradient norm > 0); each run's
           state bytes, COVAP bytes per worker at W=8, step ms, tok/s and
           peak memory
  serve    serving at full width (after ``[families]``, before ``[overlap]``;
           ``SERVE_CONFIG``: 8 slots, max_len 1024, page 16, prefill chunk
           16, 64 new tokens): gpt2-paper with a bf16 KV cache, then with
           ``kv_cache_dtype="int8"``.  Each first holds paged == dense bit
           for bit: 8 requests (the first 8 prompts, cut to 32 tokens)
           admitted at once beside a dense batch-8 cache built from their
           own batch-1 ``ChunkedPrefill`` caches; the prefill logits, 4
           generate steps' logits against ``decode_step`` on the dense cache,
           and after each step the ``gather_caches`` of the arena against it;
           one more generate call under ``set_sync_debug_mode("error")`` (no
           host synchronisation), and a generate call's and a prefill
           token's device ms beside their host ms.  Then 16 requests of
           16-128 prompt tokens (numpy seed 0) to completion: the arena
           (pages x page bytes, planes), ``prefill_tok_us``,
           ``generate_tok_us``, ``insert_us``, tok/s, engine steps, finish
           reasons, peak GiB and wall s, and the int8 arena's bytes beside
           the bf16 one's; a ``page_starve`` run (``starve_pages`` holds the
           whole real pool, the head is shed after ``starve_patience``
           ticks, ``release_pages``, a request runs again); qwen1.5-0.5b at
           its full config (24 L, q/k/v biases; 4 requests of 16-64 tokens,
           32 new); xlstm-125m and zamba2-2.7b at their full configs
           (``SERVE_RECURRENT``: paged == dense on 8 prompts cut to 32 and
           16 tokens, then 4 requests of 16-64 tokens, 32 new; the arena's
           rows beside the one resident state a slot holds);
           seamless-m4t-medium and pixtral-12b at their full configs
           (``SERVE_FRONTEND``: seamless's requests each with frames of
           their own, encoded at prefill into the resident
           ``mem_k``/``mem_v``; pixtral text only; paged == dense, then 4
           requests); ``python -m
           repro_torch.launch.serve --full --arch gpt2-paper`` in a
           subprocess.  No kernel launches in the phase
  small    REDUCED gpt2-paper trained 5 steps on the card and on the CPU
           from the same parameters and batches, on the defaults, with
           ``arena=True`` and with ``powersgd`` (the CPU run is the path the
           tests hold against the JAX reference); then the ten families'
           archs' REDUCED configs (pixtral's and seamless's batches with
           their frontend embeddings) and grok-1-314b's with bf16
           parameters (an f32 router in bf16 buckets) on the defaults, the
           bf16 one at 2 bf16 ulps; last, the eleven archs' REDUCED configs
           served on the card and on the CPU (``SMALL_SERVE_*``): the same
           tokens, finish reasons and page tables, logits within 1e-4

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import math
import socket
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
EF_COEFF = 0.3           # EFSchedule().coefficient(step) for step < 200
EF_BYTES_PER_ELEM = 16   # read g and r, write send and r' (float32 each)
# pack_ef_cast: read g and r, write r' (12 B), plus the wire value of a
# selected element (4 B in float32, 2 B with a bf16/f16 cast)
PACK_BYTES_UNSELECTED = 12
# quantize_fp8 reads 4 B and writes 1 B an element, dequantize_fp8 reads 1 B
# and writes 4 B, sign_compress reads 4 B and writes 1 B; each also moves
# 4 B of scale or partial per block
WIRE_BYTES_PER_ELEM = 5
FP8_BLOCK = 8192
SIGN_BLOCK = 32768
STEPS = 5
# float32 FMA rate outside the tensor cores (H100 SXM data sheet)
F32_FLOPS_PER_S = 67e12
THRESHOLD_BLOCK = 32768
KERNELS = ("ef_covap", "pack_ef_cast", "quantize_fp8", "sign_compress",
           "lowrank_matmul", "threshold_filter", "adamw_fused", "causal_attn",
           "moe_dispatch")
MATMUL = "lowrank.matmul"      # the counter and record name of lowrank.matmul
# the flat-bucket path: each one full-width run
FLAT_RUNS = (
    ("fp8wire", {"compressor": "fp8wire"}),
    ("efsignsgd", {"compressor": "efsignsgd"}),
)
# the arena and sharded paths beside the TrainConfig defaults, each one
# full-width run
PACK_RUNS = (
    ("arena", {"arena": True}),
    ("arena+bf16", {"arena": True,
                    "compressor_options": {"wire_dtype": "bfloat16"}}),
    ("sharded", {"sync": "sharded"}),
)
# the fused overlap on the three segmented forms, each one full-width run:
# (label, options, the post run it is held against, the EF kernel it runs)
FUSED_RUNS = (
    ("fused", {"overlap": "fused"}, "defaults", "ef_update"),
    ("fused+arena", {"overlap": "fused", "arena": True}, "arena", "pack_ef_cast"),
    ("fused+sharded", {"overlap": "fused", "sync": "sharded"}, "sharded",
     "pack_ef_cast"),
)
# [ckpt]: save after 2 steps, resume 3; each a full-width run
CKPT_RUNS = (
    ("defaults", {}),
    ("powersgd", {"compressor": "powersgd"}),
)
# the sparsifying baselines on the flat-bucket path, each one full-width run
SPARSE_RUNS = ("topk", "dgc", "randomk", "oktopk")
# [parity] fused: the largest float32 ulp distance allowed between a fused
# form and its post form on one step from one state (PERF.md states it)
FUSED_PARITY_ULPS = 0


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def ef_close(got: torch.Tensor, want: torch.Tensor, r: torch.Tensor,
             coeff: float) -> bool:
    """The tests' tolerance: rtol 1e-6, atol 1e-6 * max|c r|; zeros exact."""
    atol = 1e-6 * float((coeff * r).abs().max()) if r.numel() else 0.0
    return (torch.allclose(got, want, rtol=1e-6, atol=atol)
            and torch.equal(got == 0, want == 0))


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in float32, 0 where the two are equal (inf == inf)."""
    g, w = got.float(), want.float()
    diff = torch.where(g == w, torch.zeros_like(g), (g - w).abs())
    return float(diff.max()) if diff.numel() else 0.0


def same_floats(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, where a NaN counts as equal to a NaN."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def finite_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``abs_err`` over the elements where ``want`` is finite."""
    keep = torch.isfinite(want)
    return abs_err(got[keep], want[keep])


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name; each carries a
    ``launches`` count."""
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.lowrank import matmul
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast
    from repro_torch.kernels.quantize import dequantize_fp8, quantize_fp8
    from repro_torch.kernels.sign_compress import sign_compress
    from repro_torch.kernels.topk_threshold import threshold_filter

    counters = {f.__name__: f for f in (ef_update, pack_ef_cast, quantize_fp8,
                                        dequantize_fp8, sign_compress,
                                        threshold_filter, moe_dispatch)}
    counters[MATMUL] = matmul
    return counters


def launch_counts(**nonzero) -> dict:
    """The expected launch counts of a run: 0 for every kernel but those
    named (``**{MATMUL: n}`` for the matmul)."""
    return {name: nonzero.get(name, 0) for name in kernel_counters()}


def moe_launches(cfg, steps: int) -> int:
    """``moe_dispatch``'s launches in ``steps`` training steps of ``cfg``
    on the card: a MoE layer's forward launches 4 (the slot map's 2,
    permute, unpermute), again in the remat recompute, and its backward 2."""
    from repro_torch.models.transformer import dense_prefix

    layers = cfg.num_layers - dense_prefix(cfg) if cfg.is_moe else 0
    return steps * layers * (4 * (2 if cfg.remat else 1) + 2)


def lowrank_leaves(plan) -> list[int]:
    """The leaves PowerSGD factorises (two or more dimensions); each runs
    three ``lowrank.matmul`` products a step."""
    return [i for i, s in enumerate(plan.leaf_shapes) if len(s) >= 2]


def device_timed(fn, reps: int = 25, warmup: int = 3,
                 sleep_cycles: int = 20_000_000) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` runs (CUDA
    events).  A sleep kernel of ``sleep_cycles`` ahead of the start event
    keeps the stream busy while the host enqueues ``fn``'s launches, so the
    events time the launches back to back and not the Python that issues
    them (while the sleep outlasts the enqueue)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_timed(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median host milliseconds of ``fn()`` ending in a synchronise: what a
    caller waits, the Python that issues the launches included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is False: this script "
                         "needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"[device] {name}, {torch.cuda.device_count()} visible, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, tf32 off", flush=True)
    return name, smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(_build.build, KERNELS))
    for name, (path, log, secs) in zip(KERNELS, built):
        ptxas = "; ".join(
            " ".join(line.split()) for line in log.splitlines()
            if "Used" in line or "spill" in line
        )
        print(f"[build] {name}.cu -> {path.relative_to(ROOT)} in {secs:.2f} s "
              f"(nvcc sm_90a; ptxas: {ptxas or 'cached'})", flush=True)


def full_width_segments(device="cuda"):
    """One flat (g, r) pair per segment of the full-width plan, with the
    phase-0 selection, cut from one buffer the way the main path's segments
    are row slices of the gradient leaves."""
    from repro_torch.configs import get_config
    from repro_torch.core import build_plan, get_compressor
    from repro_torch.models import build_model

    model = build_model(get_config("gpt2-paper"), device="meta")
    plan = build_plan(model.named_leaves())
    selected = set(get_compressor("covap", interval=4).plan_phase(plan, 0).selected)
    numels = [
        (s.numel(plan.leaf_shapes[s.leaf_idx]), b.index in selected, b.index, si)
        for b in plan.buckets for si, s in enumerate(b.segments)
    ]
    total = sum(n for n, *_ in numels)
    gen = torch.Generator(device).manual_seed(1)
    g_all = torch.randn(total, generator=gen, device=device)
    r_all = torch.randn(total, generator=gen, device=device)
    segs, off = [], 0
    for n, sel, b, si in numels:
        segs.append((g_all[off:off + n], r_all[off:off + n], sel, b, si))
        off += n
    return plan, segs, total


def phase_kernels() -> dict:
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.ref import ef_update_ref

    gen = torch.Generator("cuda").manual_seed(0)
    cases = [
        ("ragged", 1_000_003, 0),
        ("offset-1", 1_000_003, 1),
        ("largest-segment", 6_553_344, 0),
        ("embed-table", 50304 * 768, 0),
    ]
    max_err, bitwise = 0.0, True
    for name, n, off in cases:
        g = torch.randn(n + off, generator=gen, device="cuda")[off:]
        r = torch.randn(n + off, generator=gen, device="cuda")[off:]
        for sel in (True, False):
            s, q = ef_update(g, r, EF_COEFF, selected=sel)
            ps, pq = ef_update_ref(g, r, EF_COEFF, selected=sel)
            torch.cuda.synchronize()
            zero = q if sel else s
            check(int(torch.count_nonzero(zero)) == 0,
                  f"ef_update {name} selected={sel}: the zero output is not 0")
            for got, want in ((s, ps), (q, pq)):
                check(ef_close(got, want, r, EF_COEFF),
                      f"ef_update {name} n={n} selected={sel} disagrees with "
                      f"ef_update_ref: max |diff| "
                      f"{float((got - want).abs().max())}")
                max_err = max(max_err, float((got - want).abs().max()))
                bitwise &= torch.equal(got, want)

    plan, segs, total = full_width_segments()
    c = EF_COEFF

    def run_kernel():
        for g, r, sel, *_ in segs:
            ef_update(g, r, c, selected=sel)

    def run_plain():
        for g, r, sel, *_ in segs:
            ef_update_ref(g, r, c, selected=sel)

    def run_library():
        for g, r, *_ in segs:
            torch.add(g, r, alpha=c)

    kernel_ms = device_timed(run_kernel)
    plain_ms = device_timed(run_plain)
    library_ms = device_timed(run_library)
    kernel_wall_ms = wall_timed(run_kernel)
    bound_ms = EF_BYTES_PER_ELEM * total / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] ef_update agrees with ef_update_ref on {len(cases)} "
          f"shapes x 2 (max |err| {max_err:.3g}, bitwise {bitwise}); one "
          f"full-width step = {len(segs)} segments, {total} elements: "
          f"kernel_ms {kernel_ms:.4f}  bound_ms {bound_ms:.4f} "
          f"({EF_BYTES_PER_ELEM} B/elem at 3.35 TB/s)  plain_ms {plain_ms:.4f}  "
          f"library_ms {library_ms:.4f} (torch.add(g, r, alpha=c), computes t "
          f"only)  kernel wall ms with host dispatch {kernel_wall_ms:.4f}",
          flush=True)
    return {
        "name": "ef_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ef_covap.cu",
        "replaces": "src/repro/kernels/ef_covap.py:51",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "library_call": "torch.add(g, r, alpha=c): computes t only",
        "timed_work": f"{len(segs)} segments, {total} elements (one step)",
        "wall_ms": kernel_wall_ms,
    }


def phase_pack_kernels() -> dict:
    """``pack_ef_cast`` against ``pack_ef_cast_ref`` on the card, bit for
    bit, for selected x {f32, bf16, f16} and unselected, then timed over one
    full-width step's 42 segments with the phase-0 selection, the wire
    written into the arena planes as the arena path writes it."""
    from repro_torch.core.arena import build_layout
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast_into
    from repro_torch.kernels.ref import pack_ef_cast_ref

    gen = torch.Generator("cuda").manual_seed(2)
    # (name, n, view offset of g and r, element offset of the wire slot,
    #  scale of g)
    cases = [
        ("ragged", 1_000_003, 0, 0, 1.0),
        ("offset-1", 1_000_003, 1, 0, 1.0),
        ("odd-slot", 1_000_003, 0, 1, 1.0),
        ("largest-segment", 6_553_344, 0, 0, 1.0),
        ("embed-table", 50304 * 768, 0, 0, 1.0),
        ("f16-overflow", 65_537, 0, 0, 1e5),
    ]
    specs = [(True, torch.float32), (True, torch.bfloat16),
             (True, torch.float16), (False, torch.float32)]
    max_err, checks = 0.0, 0
    for name, n, off, woff, scale in cases:
        g = (torch.randn(n + off, generator=gen, device="cuda") * scale)[off:]
        r = torch.randn(n + off, generator=gen, device="cuda")[off:]
        if name == "f16-overflow":
            check(bool((g.abs() > 65504).any()), "f16-overflow case has no value "
                  "above 65504")
        for sel, wd in specs:
            plane = torch.zeros(n + woff, dtype=wd, device="cuda")
            r_out = torch.empty(n, device="cuda")
            pack_ef_cast_into(g, r, EF_COEFF, plane[woff:] if sel else None,
                              r_out, selected=sel)
            w, q = pack_ef_cast_ref(g, r, EF_COEFF, selected=sel, wire_dtype=wd)
            torch.cuda.synchronize()
            wire = plane[woff:]
            for got, want, what in ((r_out, q, "r'"), (wire, w, "wire")):
                err = abs_err(got, want)
                max_err = max(max_err, err)
                check(torch.equal(got, want),
                      f"pack_ef_cast {name} n={n} selected={sel} wire={wd}: "
                      f"{what} not bitwise equal to pack_ef_cast_ref "
                      f"(max |diff| {err})")
            check(not bool(plane[:woff].any()),
                  f"pack_ef_cast {name}: wrote outside its slot")
            checks += 1

    plan, segs, total = full_width_segments()
    c = EF_COEFF
    sel_elems = sum(g.numel() for g, _, sel, *_ in segs if sel)
    unsel_elems = total - sel_elems
    sel_buckets = sorted({b for _, _, sel, b, _ in segs if sel})
    r_out = torch.empty(total, device="cuda")
    outs, o = [], 0
    for g, *_ in segs:
        outs.append(r_out[o:o + g.numel()])
        o += g.numel()

    def kernel_fn(wd):
        layout = build_layout(plan, sel_buckets, wire_dtype=wd)
        planes = layout.empty_planes("cuda")
        views = [layout.segment_view(planes, b, si) if sel else None
                 for _, _, sel, b, si in segs]

        def run():
            for (g, r, sel, *_), wv, ro in zip(segs, views, outs):
                pack_ef_cast_into(g, r, c, wv, ro, selected=sel)
        return run

    def run_plain():
        for g, r, sel, *_ in segs:
            pack_ef_cast_ref(g, r, c, selected=sel)

    def run_plain_bf16():
        for g, r, sel, *_ in segs:
            pack_ef_cast_ref(g, r, c, selected=sel, wire_dtype=torch.bfloat16)

    def run_library():
        for g, r, *_ in segs:
            torch.add(g, r, alpha=c)

    run_kernel = kernel_fn(None)
    kernel_ms = device_timed(run_kernel)
    kernel_bf16_ms = device_timed(kernel_fn(torch.bfloat16))
    plain_ms = device_timed(run_plain)
    plain_bf16_ms = device_timed(run_plain_bf16)
    library_ms = device_timed(run_library)
    kernel_wall_ms = wall_timed(run_kernel)
    bytes_f32 = (EF_BYTES_PER_ELEM * sel_elems + PACK_BYTES_UNSELECTED * unsel_elems)
    bytes_bf16 = ((EF_BYTES_PER_ELEM - 2) * sel_elems
                  + PACK_BYTES_UNSELECTED * unsel_elems)
    bound_ms = bytes_f32 / HBM_BYTES_PER_S * 1e3
    bound_bf16_ms = bytes_bf16 / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] pack_ef_cast bitwise equal to pack_ef_cast_ref on "
          f"{len(cases)} cases x {len(specs)} specialisations (max |err| "
          f"{max_err:.3g}); one full-width step = {len(segs)} segments, "
          f"{sel_elems} selected + {unsel_elems} unselected elements: "
          f"kernel_ms {kernel_ms:.4f}  bound_ms {bound_ms:.4f} "
          f"({bytes_f32} B at 3.35 TB/s, {bound_ms / kernel_ms:.1%} of the "
          f"HBM rate)  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f} "
          f"(torch.add(g, r, alpha=c), computes t only)  bf16 wire: "
          f"kernel_ms {kernel_bf16_ms:.4f}  bound_ms {bound_bf16_ms:.4f}  "
          f"plain_ms {plain_bf16_ms:.4f}  library: no single call (EF, a cast "
          f"and a subtraction)  kernel wall ms with host dispatch {kernel_wall_ms:.4f}",
          flush=True)
    check(checks == len(cases) * len(specs), "pack_ef_cast: checks skipped")
    return {
        "name": "pack_ef_cast",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pack_ef_cast.cu",
        "replaces": "src/repro/kernels/pack_ef_cast.py:69",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "library_call": "torch.add(g, r, alpha=c): computes t only",
        "timed_work": f"{len(segs)} segments, {sel_elems} selected + "
                      f"{unsel_elems} unselected elements (one phase-0 step, "
                      f"f32 wire into the arena planes)",
        "wall_ms": kernel_wall_ms,
        "bf16_wire_ms": kernel_bf16_ms,
        "bf16_wire_bound_ms": bound_bf16_ms,
        "bf16_wire_plain_ms": plain_bf16_ms,
    }


def full_width_buckets(device="cuda"):
    """One flat float32 vector per bucket of the full-width plan (every
    bucket is synced every step on the flat-bucket path), cut from one
    buffer the way an arena plane holds them."""
    from repro_torch.configs import get_config
    from repro_torch.core import build_plan
    from repro_torch.models import build_model

    model = build_model(get_config("gpt2-paper"), device="meta")
    plan = build_plan(model.named_leaves())
    numels = [b.numel for b in plan.buckets]
    total = sum(numels)
    gen = torch.Generator(device).manual_seed(4)
    buf = torch.randn(total, generator=gen, device=device)
    views, off = [], 0
    for n in numels:
        views.append(buf[off:off + n])
        off += n
    return plan, views, total


def _fp8_case(n, block, offset, special, gen):
    """Normals at scales from e^-8 to e^8, viewed at element ``offset`` of
    a plane.  ``special``: block 0 zero, a NaN in block 1, +inf and -inf in
    block 2, and in block 3 448 beside values that quantize to subnormal
    codes (scale 1)."""
    x = torch.randn(n + offset, generator=gen, device="cuda")
    x = (x * torch.exp(torch.rand(n + offset, generator=gen, device="cuda") * 16 - 8))
    x = x[offset:]
    if special:
        x[:block] = 0.0
        x[block + 3] = float("nan")
        x[2 * block + 1], x[2 * block + 2] = float("inf"), float("-inf")
        blk = x[3 * block:4 * block]
        blk *= 1e-3 / blk.abs().max()
        x[3 * block], x[3 * block + 1] = 448.0, -0.0
    return x


def phase_wire_kernels() -> list[dict]:
    """``quantize_fp8`` and ``dequantize_fp8`` against their plain versions
    bit for bit, ``sign_compress`` with its signs bit for bit and its
    partials and scale at rtol 1e-6; then each timed over one full-width
    step's 35 buckets (one call per bucket, outputs preallocated, as the
    flat-bucket path calls them)."""
    from repro_torch.kernels.quantize import dequantize_fp8, quantize_fp8
    from repro_torch.kernels.ref import (
        dequantize_fp8_ref,
        quantize_fp8_ref,
        sign_compress_partials_ref,
    )
    from repro_torch.kernels.sign_compress import sign_compress, sign_compress_partials

    plan, bufs, total = full_width_buckets()
    largest = max(x.numel() for x in bufs)
    gen = torch.Generator("cuda").manual_seed(5)
    # (name, n, block, view offset, special blocks)
    cases = [
        ("ragged", 1_000_003, FP8_BLOCK, 0, False),
        ("below-block", 5000, FP8_BLOCK, 0, False),
        ("block-64", 10_007, 64, 0, True),
        ("offset-1", 100_003, FP8_BLOCK, 1, True),
        ("zero-nan-inf", 5 * FP8_BLOCK + 7, FP8_BLOCK, 0, True),
        ("largest-bucket", largest, FP8_BLOCK, 0, False),
    ]
    q_err = dq_err = 0.0
    for name, n, block, off, special in cases:
        x = _fp8_case(n, block, off, special, gen)
        q, sc = quantize_fp8(x, block)
        d = dequantize_fp8(q, sc, block)
        rq, rs = quantize_fp8_ref(x, block)
        rd = dequantize_fp8_ref(rq, rs, block)
        torch.cuda.synchronize()
        q_err = max(q_err, finite_err(q.float(), rq.float()), finite_err(sc, rs))
        dq_err = max(dq_err, finite_err(d, rd))
        check(torch.equal(q.view(torch.uint8), rq.view(torch.uint8)),
              f"quantize_fp8 {name} n={n} block={block}: q not bitwise equal to "
              f"quantize_fp8_ref ({int((q.view(torch.uint8) != rq.view(torch.uint8)).sum())}"
              f" codes differ)")
        check(same_floats(sc, rs), f"quantize_fp8 {name}: scales not bitwise equal "
              f"(max |diff| {finite_err(sc, rs)})")
        check(same_floats(d, rd), f"dequantize_fp8 {name}: not bitwise equal to "
              f"dequantize_fp8_ref (max |diff| {finite_err(d, rd)})")
        if special:
            check(float(sc[0]) == float(torch.tensor(1e-12)) and bool(torch.isnan(sc[1]))
                  and float(sc[2]) == float("inf") and float(sc[3]) == 1.0
                  and bool(((q[3 * block:4 * block].view(torch.uint8) & 0x78) == 0).any()),
                  f"quantize_fp8 {name}: special blocks gave scales {sc[:4].tolist()}")

    sign_cases = [("ragged", 1_000_003, 0), ("offset-3", 32_771, 3),
                  ("largest-bucket", largest, 0)]
    signs_err = partial_err = 0.0
    for name, n, off in sign_cases:
        x = torch.randn(n + off, generator=gen, device="cuda")[off:]
        xs = x.clone()
        xs[:7] = torch.tensor([0.0, -0.0, 1e-45, -1e-45, float("nan"),
                               float("inf"), float("-inf")], device="cuda")
        signs, partials = sign_compress_partials(xs)
        signs2, scale = sign_compress(x)
        rsigns, rpartials = sign_compress_partials_ref(xs)
        rsigns2, _ = sign_compress_partials_ref(x)
        torch.cuda.synchronize()
        check(torch.equal(signs, rsigns) and torch.equal(signs2, rsigns2),
              f"sign_compress {name}: signs not bitwise equal to the plain version")
        check(signs[:7].tolist() == [1, 1, 1, -1, -1, 1, -1],
              f"sign_compress {name}: special signs {signs[:7].tolist()}")
        _, p_clean = sign_compress_partials(x)
        _, rp_clean = sign_compress_partials_ref(x)
        want_scale = x.abs().mean()
        torch.cuda.synchronize()
        for got, want, what in ((p_clean, rp_clean, "partials"),
                                (scale, want_scale, "scale")):
            err = float(((got - want).abs() / want.abs()).max())
            partial_err = max(partial_err, abs_err(got, want))
            check(err <= 1e-6, f"sign_compress {name}: {what} off by {err:.3g} "
                  "relative (rtol 1e-6)")
        check(bool(torch.isnan(partials[0])) and bool(torch.isnan(rpartials[0]))
              and bool(torch.allclose(partials[1:], rpartials[1:], rtol=1e-6, atol=0)),
              f"sign_compress {name}: partials with a NaN and infs differ")
        signs_err = max(signs_err, abs_err(signs.float(), rsigns.float()))

    # ---- one full-width step's buckets -----------------------------------
    nbs = [-(-x.numel() // FP8_BLOCK) for x in bufs]
    qs = [torch.empty(x.numel(), dtype=torch.float8_e4m3fn, device="cuda") for x in bufs]
    ss = [torch.empty(nb, device="cuda") for nb in nbs]
    outs = [torch.empty(x.numel(), device="cuda") for x in bufs]
    sgs = [torch.empty(x.numel(), dtype=torch.int8, device="cuda") for x in bufs]

    def run_quant():
        for x, q, sc in zip(bufs, qs, ss):
            quantize_fp8(x, FP8_BLOCK, q_out=q, scales_out=sc)

    def run_quant_plain():
        for x in bufs:
            quantize_fp8_ref(x, FP8_BLOCK)

    def run_dequant():
        for q, sc, o in zip(qs, ss, outs):
            dequantize_fp8(q, sc, FP8_BLOCK, out=o)

    def run_dequant_plain():
        for q, sc in zip(qs, ss):
            dequantize_fp8_ref(q, sc, FP8_BLOCK)

    def run_sign():
        for x, sg in zip(bufs, sgs):
            sign_compress_partials(x, SIGN_BLOCK, signs_out=sg)

    def run_sign_plain():
        for x in bufs:
            sign_compress_partials_ref(x, SIGN_BLOCK)

    run_quant()
    times = {}
    for key, fn in (("quant", run_quant), ("quant_plain", run_quant_plain),
                    ("dequant", run_dequant), ("dequant_plain", run_dequant_plain),
                    ("sign", run_sign), ("sign_plain", run_sign_plain)):
        times[key] = device_timed(fn)
    walls = {k: wall_timed(fn) for k, fn in (("quant", run_quant),
                                              ("dequant", run_dequant),
                                              ("sign", run_sign))}
    fp8_blocks = sum(nbs)
    sign_blocks = sum(-(-x.numel() // SIGN_BLOCK) for x in bufs)
    bytes_fp8 = WIRE_BYTES_PER_ELEM * total + 4 * fp8_blocks
    bytes_sign = WIRE_BYTES_PER_ELEM * total + 4 * sign_blocks
    bound_fp8 = bytes_fp8 / HBM_BYTES_PER_S * 1e3
    bound_sign = bytes_sign / HBM_BYTES_PER_S * 1e3
    work = f"{len(bufs)} buckets, {total} elements (one full-width step)"
    for key, label, bound in (("quant", "quantize_fp8", bound_fp8),
                              ("dequant", "dequantize_fp8", bound_fp8),
                              ("sign", "sign_compress", bound_sign)):
        print(f"[kernels] {label}: {work}: kernel_ms "
              f"{times[key]:.4f}  bound_ms {bound:.4f} ({bound / times[key]:.1%} of "
              f"the HBM rate)  plain_ms {times[key + '_plain']:.4f}  library_ms "
              f"none (no single PyTorch call computes it)  kernel wall ms with "
              f"host dispatch {walls[key]:.4f}", flush=True)
    print(f"[kernels] quantize_fp8 and dequantize_fp8 bitwise equal to their "
          f"plain versions on {len(cases)} cases; sign_compress signs bitwise "
          f"equal on {len(sign_cases)} cases, partials and scale within rtol "
          f"1e-6 (max |err| {partial_err:.3g})", flush=True)
    common = {"route": "cuda", "bound_by": "bytes", "library_ms": None,
              "library_call": "none: no single PyTorch call computes it",
              "timed_work": work, "launches": None}
    return [
        dict(common, name="quantize_fp8",
             source="src/repro_torch/kernels/csrc/quantize_fp8.cu",
             replaces="src/repro/kernels/quantize.py:36", max_abs_err=q_err,
             ms=times["quant"], plain_ms=times["quant_plain"], bound_ms=bound_fp8,
             wall_ms=walls["quant"]),
        dict(common, name="dequantize_fp8",
             source="src/repro_torch/kernels/csrc/quantize_fp8.cu",
             replaces="src/repro/kernels/quantize.py:60", max_abs_err=dq_err,
             ms=times["dequant"], plain_ms=times["dequant_plain"], bound_ms=bound_fp8,
             wall_ms=walls["dequant"]),
        dict(common, name="sign_compress",
             source="src/repro_torch/kernels/csrc/sign_compress.cu",
             replaces="src/repro/kernels/sign_compress.py:22",
             max_abs_err=max(signs_err, partial_err),
             ms=times["sign"], plain_ms=times["sign_plain"], bound_ms=bound_sign,
             wall_ms=walls["sign"]),
    ]


def leaf_products(seed: int, device="cuda"):
    """PowerSGD's three products for every full-width leaf of two or more
    dimensions, on normal M and Q, as ``execute_leaf`` chains them: ``(name,
    A, B, trans_a, trans_b)`` for ``P = M@Q``, ``Q' = M^T@P`` and ``P@Q'^T``,
    with P orthonormalised by ``torch.linalg.qr`` and each product fed the
    plain version's result of the one before."""
    from repro_torch.configs import get_config
    from repro_torch.core import build_plan
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.models import build_model

    plan = build_plan(build_model(get_config("gpt2-paper"), device="meta").named_leaves())
    gen = torch.Generator(device).manual_seed(seed)
    products = []
    for i in lowrank_leaves(plan):
        shape = plan.leaf_shapes[i]
        M = torch.randn(shape, generator=gen, device=device)
        M = M.unsqueeze(0) if M.dim() == 2 else M
        Q = torch.randn((M.shape[0], M.shape[-1], 2), generator=gen, device=device)
        P, _ = torch.linalg.qr(matmul_ref(M, Q))
        Qn = matmul_ref(M, P, trans_a=True)
        name = plan.leaf_paths[i]
        products += [(f"{name} P=M@Q", M, Q, False, False),
                     (f"{name} Q'=M^T@P", M, P, True, False),
                     (f"{name} P@Q'^T", P, Qn, False, True)]
    return products


def matmul_within_bound(got, want, a, b, trans_a, trans_b) -> float:
    """The largest ``|got - want| / (|A| @ |B|)`` over the elements (0 where
    both are 0); the check is that it stays within 1e-5."""
    from repro_torch.kernels.ref import matmul_ref

    scale = matmul_ref(a.abs(), b.abs(), trans_a=trans_a, trans_b=trans_b)
    diff = (got - want).abs()
    check(bool((diff <= 1e-5 * scale).all()),
          f"lowrank.matmul: |got - want| above 1e-5 (|A|@|B|): largest ratio "
          f"{float((diff / scale.clamp_min(1e-30)).max()):.3g}")
    return float((diff / scale.clamp_min(1e-30)).max())


def product_bytes(a, b, trans_a, trans_b) -> tuple[int, int]:
    """Bytes a product must move (each operand read once, C written once)
    and its flops."""
    B, m, kk = a.shape[0], a.shape[2 if trans_a else 1], a.shape[1 if trans_a else 2]
    n = b.shape[1 if trans_b else 2]
    return 4 * (a.numel() + b.numel() + B * m * n), 2 * B * m * n * kk


def launch_fit(products, matmul, launches: int = 10) -> tuple[float, float]:
    """Each product's device time, over ``launches`` back-to-back launches
    of it, fitted by least squares as ``fixed + bytes / rate`` over the
    products: -> (rate in TB/s, fixed microseconds a launch).  The rate is
    what a kernel streams at once running; the fixed part is what a launch
    costs besides (ramp-up, tail, a split's second pass)."""
    xs, ys = [], []
    for _, a, b, ta, tb in products:
        t = device_timed(lambda: [matmul(a, b, trans_a=ta, trans_b=tb)
                                  for _ in range(launches)], reps=10) / launches
        xs.append(product_bytes(a, b, ta, tb)[0])
        ys.append(t * 1e-3)
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
             / sum((x - mx) ** 2 for x in xs))
    return 1 / slope / 1e12, (my - slope * mx) * 1e6


def tiled_matmul(a, b, trans_a, trans_b):
    """The same product through the general tiled kernel of
    ``csrc/lowrank_matmul.cu``, launched directly, for its time beside the
    streaming routes'."""
    from repro_torch.kernels import lowrank

    Ba, m, n, k, sa, sb = lowrank._operands(a, b, trans_a, trans_b)
    workspace, launch = lowrank._launchers()["tiled"]
    need = workspace(Ba, m, n, k)
    out = torch.empty((Ba, m, n), device=a.device)
    ws = torch.empty(max(need, 1), device=a.device)
    err = launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), need,
                 Ba, m, n, k, *sa, *sb, torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"tiled lowrank kernel launch failed: cudaError {err}")
    return out


def phase_lowrank_kernels() -> dict:
    """``lowrank.matmul`` against ``matmul_ref`` on the card, within
    ``1e-5 (|A| @ |B|)`` elementwise: every full-width leaf's three products
    (each must take its streaming route, and give the same bits twice), an
    all-zero M, odd sizes on both tile shapes, and operands that are
    strided views (the tiled kernel); an all-zero leaf through
    ``LowRank.execute_leaf`` stays finite.  Then the 33 products of one
    full-width step, timed, in all and by product kind, beside the tiled
    kernel on the same products."""
    from repro_torch.core.stages import LowRank
    from repro_torch.kernels.lowrank import ROUTES, matmul
    from repro_torch.kernels.ref import matmul_ref

    products = leaf_products(6)
    gen = torch.Generator("cuda").manual_seed(7)
    Z = torch.zeros(1, 50304, 768, device="cuda")
    Zq = torch.randn(1, 768, 2, generator=gen, device="cuda")
    Zp, _ = torch.linalg.qr(matmul_ref(Z, Zq))
    odd_a = torch.randn(3, 1001, 517, generator=gen, device="cuda")
    odd_b = torch.randn(3, 517, 3, generator=gen, device="cuda")
    odd_w = torch.randn(3, 517, 129, generator=gen, device="cuda")
    big = torch.randn(2, 700, 2 * 901, generator=gen, device="cuda")
    view = big[:, :, ::2]                        # strides (1261400, 1802, 2)
    cases = products + [
        ("zero M P=M@Q", Z, Zq, False, False),
        ("zero M Q'=M^T@P", Z, Zp, True, False),
        ("odd 1001x517@517x3", odd_a, odd_b, False, False),
        ("odd 1001x517@517x129", odd_a, odd_w, False, False),
        ("odd, B in column-major strides", odd_a,
         odd_b.transpose(1, 2).contiguous().transpose(1, 2), False, False),
        ("strided view M^T@P", view, torch.randn(2, 700, 2, generator=gen, device="cuda"),
         True, False),
        ("strided view P@Q'^T", torch.randn(2, 700, 2, generator=gen, device="cuda"),
         view.transpose(1, 2)[:, :, :2], False, True),
    ]
    worst = max_err = 0.0
    taken = []
    for name, a, b, ta, tb in cases:
        before = dict(matmul.launches_by_route)
        got = matmul(a, b, trans_a=ta, trans_b=tb)
        want = matmul_ref(a, b, trans_a=ta, trans_b=tb)
        torch.cuda.synchronize()
        moved = [r for r in ROUTES if matmul.launches_by_route[r] != before[r]]
        check(len(moved) == 1 and matmul.launches_by_route[moved[0]] == before[moved[0]] + 1,
              f"lowrank.matmul {name}: launches by route moved {moved}")
        taken.append(moved[0])
        worst = max(worst, matmul_within_bound(got, want, a, b, ta, tb))
        max_err = max(max_err, abs_err(got, want))
        if len(taken) <= len(products):
            check(torch.equal(got, matmul(a, b, trans_a=ta, trans_b=tb)),
                  f"lowrank.matmul {name}: two runs gave other bits")
    kinds = {"P=M@Q": "rowdot", "Q'=M^T@P": "colacc", "P@Q'^T": "outer"}
    for (name, *_), r in zip(products, taken):
        check(r == kinds[name.rsplit(" ", 1)[1]],
              f"lowrank.matmul {name} took the {r} route, not its streaming one")
    check(taken[len(products):len(products) + 2] == ["rowdot", "colacc"],
          f"lowrank.matmul: the all-zero M took {taken[len(products):len(products) + 2]}")
    check(all(r == "tiled" for r in taken[len(products) + 2:]),
          f"lowrank.matmul: odd and strided cases took {taken[len(products) + 2:]}")
    print(f"[kernels] lowrank.matmul routes of the {len(products)} full-width "
          f"products: " + "; ".join(f"{name}: {r}" for (name, *_), r
                                    in zip(products, taken)), flush=True)
    check(not matmul(Z, Zq).any(), "lowrank.matmul: an all-zero M gave nonzero P")
    approx, qn = LowRank(2).execute_leaf(Z[0], Zq, None, use_kernel=True)
    torch.cuda.synchronize()
    check(not approx.any() and bool(torch.isfinite(qn).all()),
          "LowRank.execute_leaf on an all-zero leaf: approx not 0 or Q not finite")
    del Z, Zp, odd_a, odd_b, odd_w, big, view, approx, qn

    # ---- one full-width step's 33 products -------------------------------
    def runner(fn):
        def run():
            for _, a, b, ta, tb in products:
                fn(a, b, ta, tb)
        return run

    def library(a, b, ta, tb):
        torch.bmm(a.transpose(1, 2) if ta else a, b.transpose(1, 2) if tb else b)

    run_kernel = runner(lambda a, b, ta, tb: matmul(a, b, trans_a=ta, trans_b=tb))
    kernel_ms = device_timed(run_kernel)
    plain_ms = device_timed(runner(
        lambda a, b, ta, tb: matmul_ref(a, b, trans_a=ta, trans_b=tb)))
    library_ms = device_timed(runner(library))
    tiled_ms = device_timed(runner(tiled_matmul))
    kernel_wall_ms = wall_timed(run_kernel)
    by_kind, tiled_by_kind, kind_lines, fits = {}, {}, [], {}
    for k, (kind, r) in enumerate(kinds.items()):
        sub = products[k::3]
        by_kind[kind] = device_timed(lambda sub=sub: [
            matmul(a, b, trans_a=ta, trans_b=tb) for _, a, b, ta, tb in sub])
        tiled_by_kind[kind] = device_timed(lambda sub=sub: [
            tiled_matmul(a, b, ta, tb) for _, a, b, ta, tb in sub])
        kb = sum(product_bytes(a, b, ta, tb)[0] for _, a, b, ta, tb in sub)
        kbound = kb / HBM_BYTES_PER_S * 1e3
        rate, fixed = launch_fit(sub, matmul)
        fits[r] = {"rate_tb_s": rate, "fixed_us": fixed}
        kind_lines.append(
            f"{kind} ({r}, {len(sub)} products, {kb} B): {by_kind[kind]:.4f} ms, "
            f"{kb / by_kind[kind] / 1e6:.1f} GB/s, {kbound / by_kind[kind]:.1%} of its "
            f"bound {kbound:.4f} ms (tiled kernel {tiled_by_kind[kind]:.4f} ms); "
            f"per product, least squares: {rate:.3f} TB/s + {fixed:.2f} us a launch")
    nbytes = sum(product_bytes(a, b, ta, tb)[0] for _, a, b, ta, tb in products)
    flops = sum(product_bytes(a, b, ta, tb)[1] for _, a, b, ta, tb in products)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    print("[kernels] lowrank.matmul by product kind: " + "; ".join(kind_lines),
          flush=True)
    print(f"[kernels] lowrank.matmul within 1e-5 (|A|@|B|) of matmul_ref on "
          f"{len(cases)} cases (largest ratio {worst:.3g}, max |err| {max_err:.3g}); "
          f"an all-zero leaf through execute_leaf gives 0 and a finite Q; one "
          f"full-width step = {len(products)} products, {nbytes} B, {flops} flop: "
          f"kernel_ms {kernel_ms:.4f}  bound_ms {bound_ms:.4f} (bytes at 3.35 "
          f"TB/s; flops at 67 TFLOP/s f32 {flops_ms:.4f}; {bound_ms / kernel_ms:.1%} "
          f"of the HBM rate)  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f} "
          f"(torch.bmm, TF32 off)  tiled kernel {tiled_ms:.4f}  kernel wall ms "
          f"with host dispatch {kernel_wall_ms:.4f}", flush=True)
    return {
        "name": MATMUL,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lowrank_matmul.cu",
        "replaces": "src/repro/kernels/lowrank.py:40",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms,
        "library_call": "torch.bmm on the same (transposed) views, TF32 off",
        "timed_work": f"{len(products)} products of one full-width PowerSGD step",
        "wall_ms": kernel_wall_ms,
        "ms_by_product": by_kind,
        "ms_by_route": {r: by_kind[kind] for kind, r in kinds.items()},
        "tiled_ms": tiled_ms,
        "launch_fit_by_route": fits,
        "tiled_ms_by_product": tiled_by_kind,
        "max_err_over_abs_product": worst,
    }


def phase_threshold_kernels() -> dict:
    """``threshold_filter`` against ``threshold_filter_ref`` bit for bit in y
    and the counts: ragged, t = 0 (padding never counted), NaN and +-inf,
    an offset-1 view, the largest bucket; then over one full-width step's 35
    buckets at ``sample_threshold`` ratios 0.01 and 0.001, timed."""
    from repro_torch.kernels.ref import sample_threshold, threshold_filter_ref
    from repro_torch.kernels.topk_threshold import threshold_filter

    plan, bufs, total = full_width_buckets()
    largest = max(bufs, key=lambda x: x.numel())
    gen = torch.Generator("cuda").manual_seed(8)
    # (name, n, view offset, threshold: a ratio for sample_threshold or a value,
    #  block, special values)
    cases = [
        ("ragged", 1_000_003, 0, 0.01, THRESHOLD_BLOCK, False),
        ("zero-threshold-ragged", 70_001, 0, 0.0, THRESHOLD_BLOCK, True),
        ("zero-threshold-block-4096", 5000, 0, 0.0, 4096, True),
        ("nan-inf", 100_003, 0, 0.5, THRESHOLD_BLOCK, True),
        ("offset-1", 100_003, 1, 0.01, THRESHOLD_BLOCK, True),
        ("largest-bucket", largest.numel(), 0, 0.001, THRESHOLD_BLOCK, False),
    ]
    for name, n, off, thr, block, special in cases:
        x = (largest.clone() if name == "largest-bucket"
             else torch.randn(n + off, generator=gen, device="cuda")[off:])
        if special:
            x[:6] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0,
                                  0.0, 1e-45], device="cuda")
        t = (sample_threshold(x, thr) if 0 < thr < 0.1
             else torch.tensor(thr, device="cuda"))
        y, c = threshold_filter(x, t, block=block)
        ry, rc = threshold_filter_ref(x, t, block)
        torch.cuda.synchronize()
        check(torch.equal(y.view(torch.int32), ry.view(torch.int32)),
              f"threshold_filter {name}: y not bitwise equal to threshold_filter_ref")
        check(torch.equal(c, rc), f"threshold_filter {name}: counts {c[:4].tolist()} "
              f"vs {rc[:4].tolist()}")
        if thr == 0.0:
            want_last = n - (c.numel() - 1) * block
            check(int(c[-1]) == want_last and int(c.sum()) == n - 1,
                  f"threshold_filter {name}: counts {c.tolist()[-3:]} at t = 0 "
                  f"(padding counted, or the NaN)")

    times, bounds, kept = {}, {}, {}
    nb_total = sum(-(-x.numel() // THRESHOLD_BLOCK) for x in bufs)
    bound_ms = (8 * total + 4 * nb_total + 4 * len(bufs)) / HBM_BYTES_PER_S * 1e3
    for ratio in (0.01, 0.001):
        ts = [sample_threshold(x, ratio) for x in bufs]
        times[ratio] = device_timed(lambda ts=ts: [
            threshold_filter(x, t) for x, t in zip(bufs, ts)])
        times[f"{ratio}_plain"] = device_timed(lambda ts=ts: [
            threshold_filter_ref(x, t, THRESHOLD_BLOCK) for x, t in zip(bufs, ts)])
        kept[ratio] = sum(int(threshold_filter(x, t)[1].sum())
                          for x, t in zip(bufs, ts)) / total
    wall = wall_timed(lambda: [threshold_filter(x, t) for x, t in zip(bufs, ts)])
    work = f"{len(bufs)} buckets, {total} elements (one full-width step)"
    for ratio in (0.01, 0.001):
        print(f"[kernels] threshold_filter at sample_threshold ratio {ratio} "
              f"(kept {kept[ratio]:.5f} of the elements): {work}: kernel_ms "
              f"{times[ratio]:.4f}  bound_ms {bound_ms:.4f} ({bound_ms / times[ratio]:.1%} "
              f"of the HBM rate)  plain_ms {times[f'{ratio}_plain']:.4f}  library_ms "
              f"none (no single PyTorch call gives y and the counts)", flush=True)
    print(f"[kernels] threshold_filter bitwise equal to threshold_filter_ref in y "
          f"and counts on {len(cases)} cases; kernel wall ms with host dispatch "
          f"(ratio 0.001) {wall:.4f}", flush=True)
    return {
        "name": "threshold_filter",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threshold_filter.cu",
        "replaces": "src/repro/kernels/topk_threshold.py:27",
        "launches": 0,
        "path": None,
        "path_note": "on no train path: behind repro_torch.kernels.ops only, as the "
                     "reference's kernel is behind repro.kernels.ops",
        "max_abs_err": 0.0,
        "ms": times[0.01],
        "plain_ms": times["0.01_plain"],
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "library_call": "none: no single PyTorch call gives y and the counts",
        "timed_work": work + ", sample_threshold ratio 0.01",
        "ms_ratio_0.001": times[0.001],
        "plain_ms_ratio_0.001": times["0.001_plain"],
        "wall_ms": wall,
    }


# [kernels] row 8: the configurations whose leaves the fused AdamW is timed at
# (label, arch, layers, moment dtype)
ADAMW_CONFIGS = (
    ("deepseek-moe-16b-2L", "deepseek-moe-16b", 2, "bfloat16"),
    ("gpt2-paper", "gpt2-paper", None, None),
)


def adamw_bytes(params, moments) -> int:
    """The fused step's least device-memory traffic: read g, p, m, v and
    write p, m, v once (grads in the params' dtype)."""
    return sum(x.numel() * (3 * x.element_size() + 4 * m.element_size())
               for x, m in zip(params, moments))


def phase_adamw_kernel() -> dict:
    """``adamw_fused`` at every leaf of deepseek-moe-16b cut to 2 layers
    (f32 params, bf16 moments) and of gpt2-paper (f32 moments), as the
    trainer calls it (``Optimizer.apply`` with the norm folded: the bias
    corrections' fills, a launch a leaf, the partials' sum and root): p, m,
    v bit for bit and the norm within 1e-6 of the plain card path
    (``global_norm``, ``update``, ``apply_updates``), then both timed beside
    the bound (bytes over 3.35 TB/s) and, as a yardstick the port never
    calls, ``torch._fused_adamw_`` where it takes the same dtypes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.adamw_fused import adamw_fused
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, apply_updates, global_norm

    rows = {}
    for label, arch, layers, moments in ADAMW_CONFIGS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.with_(num_layers=layers)
        shapes = [tuple(p.shape) for _, p in build_model(cfg, device="meta").named_leaves()]
        gen = torch.Generator("cuda").manual_seed(8)
        mdt = getattr(torch, moments) if moments else torch.float32
        p = [torch.randn(s, generator=gen, device="cuda") * 0.02 for s in shapes]
        g = [torch.randn(s, generator=gen, device="cuda") * 1e-3 for s in shapes]
        m = [(torch.randn(s, generator=gen, device="cuda") * 1e-4).to(mdt) for s in shapes]
        v = [(torch.rand(s, generator=gen, device="cuda") * 1e-6).to(mdt) for s in shapes]
        opt = adamw(1.5e-4, moment_dtype=moments)
        state = {"step": 2, "m": m, "v": v}
        n = sum(x.numel() for x in p)

        plain_p = [x.clone() for x in p]
        upd, plain = opt.update(g, {"step": 2, "m": [x.clone() for x in m],
                                    "v": [x.clone() for x in v]}, plain_p)
        apply_updates(plain_p, upd)
        want_norm = float(global_norm(g))
        del upd
        before = adamw_fused.launches
        new, norm = opt.apply(g, state, p, with_norm=True)
        torch.cuda.synchronize()
        check(adamw_fused.launches - before == len(shapes),
              f"adamw_fused {label}: {adamw_fused.launches - before} launches for "
              f"{len(shapes)} leaves")
        for part, got, want in (("p", p, plain_p), ("m", new["m"], plain["m"]),
                                ("v", new["v"], plain["v"])):
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"adamw_fused {label}: {part} differs from the plain card path")
        rel = abs(float(norm) - want_norm) / want_norm
        check(rel <= 1e-6, f"adamw_fused {label}: folded norm {float(norm)} vs "
              f"global_norm {want_norm} ({rel:.3g} relative)")
        del plain_p, plain, new
        torch.cuda.empty_cache()

        def run_kernel():
            opt.apply(g, state, p, with_norm=True)

        def run_plain():
            global_norm(g)
            u, _ = opt.update(g, state, p)
            apply_updates(p, u)

        kernel_ms = device_timed(run_kernel)
        plain_ms = device_timed(run_plain, reps=9)
        lib_ms, lib_note = None, None
        steps = [torch.full((), 3.0, device="cuda") for _ in shapes]
        try:
            torch._fused_adamw_(p, g, m, v, [], steps, amsgrad=False, lr=1.5e-4,
                                beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
                                maximize=False)
            torch.cuda.synchronize()
            lib_ms = device_timed(lambda: torch._fused_adamw_(
                p, g, m, v, [], steps, amsgrad=False, lr=1.5e-4, beta1=0.9,
                beta2=0.999, weight_decay=0.0, eps=1e-8, maximize=False))
            lib_note = "torch._fused_adamw_ (no norm, no bias corrections as tensors)"
        except (RuntimeError, TypeError) as e:
            lib_note = (f"torch._fused_adamw_ refuses these dtypes: "
                        f"{str(e).splitlines()[0][:160]}")
        nbytes = adamw_bytes(p, m)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[label] = {"params": n, "leaves": len(shapes), "bytes": nbytes,
                       "ms": kernel_ms, "bound_ms": bound_ms, "plain_ms": plain_ms,
                       "library_ms": lib_ms, "library_call": lib_note,
                       "norm_rel_err": rel}
        print(f"[kernels] adamw_fused {label}: {n} params in {len(shapes)} leaves, "
              f"f32 params, {mdt} moments, one launch a leaf: p, m, v bitwise == the "
              f"plain card path, folded norm within {rel:.2g} relative; apply "
              f"(norm folded) kernel_ms {kernel_ms:.4f}  bound_ms {bound_ms:.4f} "
              f"({nbytes / n:.0f} B/param at 3.35 TB/s, {bound_ms / kernel_ms:.1%} "
              f"of it)  plain_ms {plain_ms:.4f} (global_norm + update + "
              f"apply_updates)  library_ms "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f}'} ({lib_note})",
              flush=True)
        del p, g, m, v, state, steps
    torch.cuda.empty_cache()
    first = rows[ADAMW_CONFIGS[0][0]]
    return {
        "name": "adamw_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/adamw_fused.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel: the reference leaves AdamW to XLA",
        "launches": None,
        "max_abs_err": 0.0,
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"],
        "bound_by": "bytes",
        "library_ms": first["library_ms"],
        "library_call": first["library_call"],
        "timed_work": f"one AdamW step over {ADAMW_CONFIGS[0][0]}'s leaves, norm folded",
        "by_config": rows,
    }


# [kernels] row 9: the bench cells whose attention the causal kernel is timed
# at: (label, B, S, K, G, hq, hv, v a strided view as MLA's kv[..., nope:])
ATTN_SHAPES = (
    ("moonlight-16b-a3b-5L-e32.covap.r2s8k", 2, 8192, 16, 1, 192, 128, True),
    ("gpt2-paper.covap.b32", 32, 1024, 12, 1, 64, 64, False),
)
BF16_FLOPS_PER_S = 989.4e12   # H100 SXM dense bf16, the data sheet's


def attn_flops(B: int, S: int, H: int, hq: int, hv: int) -> float:
    """The causal forward's products, q·kᵀ and P·V over the S(S+1)/2 pairs
    a head keeps; the backward's four (dV, dP, dQ, dK) are twice these."""
    return B * H * S * (S + 1) * (hq + hv)


def attn_inputs(B, S, K, G, hq, hv, v_view, dtype, seed=9):
    """q, k, v, the leaves their gradients go to, and an upstream gradient."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k = rand(B, S, K, G, hq), rand(B, S, K, hq)
    base = rand(B, S, K, hq + hv) if v_view else rand(B, S, K, hv)
    leaves = [x.requires_grad_(True) for x in (q, k, base)]
    v = base[..., base.shape[-1] - hv:]
    return q, k, v, leaves, rand(B, S, K, G, hv)


def phase_causal_attn_kernel() -> dict:
    """``causal_attn`` (bf16, as the cells run it) at moonlight's and
    gpt2-paper b32's attention shapes: output and q/k/v gradients against
    the float32 plain path from the same bf16 inputs, each within twice the
    plain bf16 path's distance (plus 1e-3 of the largest value); two runs
    bit for bit; four launches a forward and backward.  Then forward and
    backward device ms beside the bound (causal FLOPs over 989.4 TFLOP/s),
    the plain path (``_attend_plain``, chunks of 256) and, as a yardstick
    the port never calls, ``scaled_dot_product_attention``."""
    from types import SimpleNamespace

    import torch.nn.functional as F

    from repro_torch.kernels.causal_attn import causal_attn
    from repro_torch.models.attention import _attend_plain

    cfg = SimpleNamespace(attn_chunk=256, attn_softcap=0.0)
    rows = {}
    for label, B, S, K, G, hq, hv, v_view in ATTN_SHAPES:
        gc.collect()
        torch.cuda.empty_cache()
        q, k, v, leaves, dout = attn_inputs(B, S, K, G, hq, hv, v_view, torch.bfloat16)

        def kernel(q=q, k=k, v=v):
            return causal_attn(q, k, v)

        def plain(q=q, k=k, v=v):
            return _attend_plain(q, k, v, cfg, 0)

        def fwd_bwd(fn, leaves=leaves, dout=dout):
            out = fn()
            return out.detach(), torch.autograd.grad(out, leaves, dout)

        before = causal_attn.launches
        got = fwd_bwd(kernel)
        torch.cuda.synchronize()
        check(causal_attn.launches - before == 4,
              f"causal_attn {label}: {causal_attn.launches - before} launches for a "
              f"forward and backward")
        again = fwd_bwd(kernel)
        same = torch.equal(got[0], again[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], again[1]))
        check(same, f"causal_attn {label}: two runs differ")
        del again
        want = fwd_bwd(plain)
        f32 = [x.detach().float().requires_grad_(True) for x in leaves]
        vf = f32[2][..., f32[2].shape[-1] - hv:]
        out = _attend_plain(f32[0], f32[1], vf, cfg, 0)
        truth = (out.detach(), torch.autograd.grad(out, f32, dout.float()))
        del out, f32, vf
        errs = {}
        for name, a, b, t in zip(("out", "dq", "dk", "dv"), [got[0], *got[1]],
                                 [want[0], *want[1]], [truth[0], *truth[1]]):
            e_k = float((a.float() - t).abs().max())
            e_p = float((b.float() - t).abs().max())
            scale = float(t.abs().max())
            errs[name] = (e_k, e_p)
            check(e_k <= 2 * e_p + 1e-3 * scale,
                  f"causal_attn {label}: {name} max |kernel - f32| {e_k:.3g}, plain "
                  f"bf16 {e_p:.3g}, largest {scale:.3g}")
        del got, want, truth
        torch.cuda.empty_cache()

        with torch.no_grad():
            fwd_ms = device_timed(kernel)
            plain_fwd_ms = device_timed(plain, reps=5)
        total_ms = device_timed(lambda: fwd_bwd(kernel))
        plain_total_ms = device_timed(lambda: fwd_bwd(plain), reps=5)
        lib_fwd = lib_total = None
        lib_note = "scaled_dot_product_attention(is_causal=True), (B, H, S, d) views"
        try:
            qh = q.reshape(B, S, K * G, hq).transpose(1, 2)
            kh, vh = k.transpose(1, 2), v.transpose(1, 2)
            doh = dout.reshape(B, S, K * G, hv).transpose(1, 2)

            def lib():
                return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

            with torch.no_grad():
                lib_fwd = device_timed(lib)
            lib_total = device_timed(lambda: fwd_bwd(lib, dout=doh))
        except RuntimeError as e:
            lib_note += f" refuses: {str(e).splitlines()[0][:160]}"
        torch.cuda.synchronize()
        flops = attn_flops(B, S, K * G, hq, hv)
        bound_fwd = flops / BF16_FLOPS_PER_S * 1e3
        bwd_ms, plain_bwd_ms = total_ms - fwd_ms, plain_total_ms - plain_fwd_ms
        rows[label] = {"shape": [B, S, K, G, hq, hv], "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                       "bound_fwd_ms": bound_fwd, "bound_bwd_ms": 2 * bound_fwd,
                       "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
                       "library_fwd_ms": lib_fwd,
                       "library_bwd_ms": None if lib_total is None else lib_total - lib_fwd,
                       "library_call": lib_note, "max_err_vs_f32": errs}
        lib = ("none" if lib_fwd is None
               else f"{lib_fwd:.3f} / {lib_total - lib_fwd:.3f}")
        print(f"[kernels] causal_attn {label}: (B,S,K,G,hq,hv) {(B, S, K, G, hq, hv)} "
              f"bf16; out/dq/dk/dv max |diff| from the f32 plain path, kernel vs plain "
              f"bf16: {json.dumps({n: [float(f'{a:.3g}'), float(f'{b:.3g}')] for n, (a, b) in errs.items()})}; "
              f"two runs bitwise equal; fwd / bwd kernel_ms {fwd_ms:.3f} / {bwd_ms:.3f}  "
              f"bound_ms {bound_fwd:.3f} / {2 * bound_fwd:.3f} ({flops / 1e12:.2f} "
              f"TFLOP causal forward at 989.4 TFLOP/s; {bound_fwd / fwd_ms:.1%} / "
              f"{2 * bound_fwd / bwd_ms:.1%} of it)  plain_ms {plain_fwd_ms:.3f} / "
              f"{plain_bwd_ms:.3f}  library_ms {lib} ({lib_note})", flush=True)
        del q, k, v, leaves, dout
    torch.cuda.empty_cache()
    first = rows[ATTN_SHAPES[0][0]]
    return {
        "name": "causal_attn",
        "route": "cuda",
        "source": "src/repro_torch/kernels/causal_attn.py",
        "replaces": None,
        "replaces_note": "no TPU kernel: the reference leaves attention to XLA",
        "launches": None,
        "ms": first["fwd_ms"] + first["bwd_ms"],
        "plain_ms": first["plain_fwd_ms"] + first["plain_bwd_ms"],
        "bound_ms": 3 * first["bound_fwd_ms"],
        "bound_by": "flops",
        "library_ms": (None if first["library_fwd_ms"] is None
                       else first["library_fwd_ms"] + first["library_bwd_ms"]),
        "library_call": first["library_call"],
        "timed_work": f"one causal attention forward and backward at "
                      f"{ATTN_SHAPES[0][0]}'s shapes",
        "by_config": rows,
    }


# [kernels] row 10: the MoE cells' layers the dispatch kernels are timed at:
# (label, tokens N, routed experts, held E, first held, top-k, d)
MOE_SHAPES = (
    ("deepseek-moe-16b-2L.covap.b8", 8192, 64, 64, 0, 6, 2048),
    ("moonlight-16b-a3b-5L-e32.covap.r2s8k", 16384, 64, 32, 0, 6, 2048),
)


def moe_dispatch_bytes(nk: int, n_slots: int, kept: int, N: int, d: int,
                       esize: int) -> dict:
    """Each move's least device-memory bytes, every input byte read once
    and every output byte written once: the slot map reads top_e and
    writes slot, keep and src; the permute reads the kept rows and writes
    the buffer; its backward reads the kept slots' gradients and writes N
    rows; the unpermute reads the kept rows and w and writes N rows; its
    backward reads dy, w and the kept rows and writes the buffer's
    gradient and dw."""
    row = d * esize
    return {"slots": 8 * nk + 8 * nk + nk + 4 * n_slots,
            "permute": kept * row + n_slots * row + 4 * n_slots,
            "permute_bwd": kept * row + N * row + 8 * nk,
            "unpermute": kept * row + N * row + (8 + esize) * nk,
            "unpermute_bwd": (N * row + kept * row + n_slots * row + 4 * n_slots
                              + (8 + 2 * esize) * nk)}


def phase_moe_dispatch_kernel() -> dict:
    """``moe_dispatch`` (bf16, as the cells run it) at deepseek's and
    moonlight's MoE layers from router-like assignments (the top k of
    random scores): slot, keep, src and the permuted buffer bit for bit
    against the plain path on the card (``dispatch``, ``slot_sources``,
    ``permute_plain``), the unpermute's y and the gradients within the
    tests' ulps; two runs bit for bit; 6 launches a forward and backward.
    Then each move's device ms, forward and backward, beside its bound
    (bytes over 3.35 TB/s) and the plain path, whose one-hot scan
    (``cumsum``) and indexing backward (``index_put_(accumulate=True)``
    of the combine's gather) are timed apart."""
    from types import SimpleNamespace

    import torch.nn.functional as F

    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.models import moe

    rows = {}
    for label, N, routed, E, first, k, d in MOE_SHAPES:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = SimpleNamespace(num_experts=E, first_expert=first, routed_experts=routed,
                              experts_per_token=k, moe_capacity_factor=1.25)
        C = moe.capacity(cfg, N)
        n_slots, nk = E * C, N * k
        gen = torch.Generator("cuda").manual_seed(11)
        top_e = torch.topk(torch.rand((N, routed), generator=gen, device="cuda"), k,
                           dim=-1).indices
        x = torch.randn((N, d), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.rand(nk, generator=gen, device="cuda").to(torch.bfloat16)
        out_buf = torch.randn((n_slots, d), generator=gen, device="cuda").to(torch.bfloat16)
        dy = torch.randn((N, d), generator=gen, device="cuda").to(torch.bfloat16)
        dbuf = torch.randn((E, C, d), generator=gen, device="cuda").to(torch.bfloat16)

        def kernel_map():
            return md.moe_dispatch(top_e, first, E, C)

        def plain_map():
            return moe.dispatch(top_e, cfg, C)

        slot, keep, src = kernel_map()
        p_slot, p_keep = plain_map()
        p_src = moe.slot_sources(p_slot, p_keep, n_slots)
        check(torch.equal(slot, p_slot) and torch.equal(keep, p_keep)
              and torch.equal(src, p_src), f"moe_dispatch {label}: slot map differs")
        kept = int(keep.sum())

        def moves(kernels: bool):
            xs = x.detach().requires_grad_(True)
            ob = out_buf.detach().requires_grad_(True)
            ws = w.detach().requires_grad_(True)
            if kernels:
                buf = md.permute(xs, slot, src, k, E, C)
                y = md.unpermute(ob, ws, slot, src, k)
            else:
                buf = moe.permute_plain(xs, slot, k, E, C)
                y = moe.unpermute_plain(ob, slot, keep, ws, k)
            gx, = torch.autograd.grad(buf, xs, dbuf)
            gob, gw = torch.autograd.grad(y, (ob, ws), dy)
            return buf.detach(), y.detach(), gx, gob, gw

        before = md.moe_dispatch.launches
        slot2, keep2, src2 = kernel_map()
        got = moves(True)
        torch.cuda.synchronize()
        check(md.moe_dispatch.launches - before == 6,
              f"moe_dispatch {label}: {md.moe_dispatch.launches - before} launches for a "
              f"slot map and both moves forward and backward")
        again = moves(True)
        check(torch.equal(slot2, slot) and torch.equal(src2, src)
              and all(torch.equal(a, b) for a, b in zip(got, again)),
              f"moe_dispatch {label}: two runs differ")
        want = moves(False)
        check(torch.equal(got[0], want[0]) and torch.equal(got[3], want[3]),
              f"moe_dispatch {label}: the buffer or the rows' gradient differs from the "
              f"plain path")
        # dw, a dot product over d, within one bf16 ulp plus the bound on
        # two orders of one f32 sum of d terms, d * 2^-24 * sum |terms|,
        # as the card tests hold it; y and dx within one ulp
        dw_order = d * 2.0**-24 * keep * (out_buf[slot.clamp(max=n_slots - 1)].float()
                                          * dy.float().repeat_interleave(k, 0)).abs().sum(1)
        ulps, dw_beyond = {}, 0
        for name, a, b in (("y", got[1], want[1]), ("dx", got[2], want[2]),
                           ("dw", got[4], want[4])):
            a, b = a.float(), b.float()
            _, e = torch.frexp(torch.maximum(a.abs(), b.abs()).clamp(min=2.0**-126))
            ulp = torch.ldexp(torch.ones_like(a), e - 8)
            ulps[name] = float(((a - b).abs() / ulp).max())
            if name == "dw":
                dw_beyond = int(((a - b).abs() > ulp + dw_order).sum())
        check(ulps["y"] <= 1 and ulps["dx"] <= 1,
              f"moe_dispatch {label}: y / dx beyond one bf16 ulp: {ulps}")
        check(dw_beyond == 0,
              f"moe_dispatch {label}: {dw_beyond} of dw's elements beyond one bf16 ulp plus "
              f"the f32 order bound (max ulps {ulps['dw']})")
        check(not bool(got[4][~keep].any()),
              f"moe_dispatch {label}: dw is not 0 where an assignment is not kept")
        del again, want

        # the one-hot plain ``dispatch`` scans: a spare column under a share
        eid = top_e.reshape(-1)
        share = moe.is_share(cfg)
        if share:
            eid = torch.where(moe.held(eid, cfg), eid - first, torch.full_like(eid, E))
        onehot = F.one_hot(eid, E + share)
        gather_idx = torch.where(keep, slot, torch.full_like(slot, n_slots - 1))
        gathered_grad = torch.randn((nk, d), generator=gen, device="cuda").to(torch.bfloat16)

        def timed_pair(run_fwd, run_all, reps=25):
            fwd = device_timed(run_fwd, reps=reps)
            return fwd, device_timed(run_all, reps=reps) - fwd

        def perm_fwd(kernels):
            return (lambda: md.permute(x, slot, src, k, E, C)) if kernels else (
                lambda: moe.permute_plain(x, slot, k, E, C))

        def perm_all(kernels):
            def run():
                xs = x.detach().requires_grad_(True)
                buf = (md.permute(xs, slot, src, k, E, C) if kernels
                       else moe.permute_plain(xs, slot, k, E, C))
                return torch.autograd.grad(buf, xs, dbuf)
            return run

        def unperm_fwd(kernels):
            return (lambda: md.unpermute(out_buf, w, slot, src, k)) if kernels else (
                lambda: moe.unpermute_plain(out_buf, slot, keep, w, k))

        def unperm_all(kernels):
            def run():
                ob = out_buf.detach().requires_grad_(True)
                ws = w.detach().requires_grad_(True)
                y = (md.unpermute(ob, ws, slot, src, k) if kernels
                     else moe.unpermute_plain(ob, slot, keep, ws, k))
                return torch.autograd.grad(y, (ob, ws), dy)
            return run

        ms = {"slots": device_timed(kernel_map)}
        plain = {"slots": device_timed(plain_map)}
        with torch.no_grad():
            ms["permute"] = device_timed(perm_fwd(True))
            plain["permute"] = device_timed(perm_fwd(False))
            ms["unpermute"] = device_timed(unperm_fwd(True))
            plain["unpermute"] = device_timed(unperm_fwd(False))
        ms["permute_bwd"] = device_timed(perm_all(True)) - ms["permute"]
        plain["permute_bwd"] = device_timed(perm_all(False)) - plain["permute"]
        ms["unpermute_bwd"] = device_timed(unperm_all(True)) - ms["unpermute"]
        plain["unpermute_bwd"] = device_timed(unperm_all(False)) - plain["unpermute"]
        acc = torch.zeros((n_slots, d), dtype=torch.bfloat16, device="cuda")
        with torch.no_grad():
            scan_ms = device_timed(lambda: torch.cumsum(onehot, dim=0))
            index_bwd_ms = device_timed(
                lambda: acc.index_put_((gather_idx,), gathered_grad, accumulate=True))
        nbytes = moe_dispatch_bytes(nk, n_slots, kept, N, d, 2)
        bound = {name: b / HBM_BYTES_PER_S * 1e3 for name, b in nbytes.items()}
        rows[label] = {"shape": {"N": N, "k": k, "routed": routed, "E": E, "first": first,
                                 "C": C, "d": d, "kept": kept},
                       "ms": ms, "plain_ms": plain, "bound_ms": bound,
                       "plain_scan_ms": scan_ms, "plain_index_backward_ms": index_bwd_ms,
                       "max_ulps_vs_plain": ulps}
        parts = "; ".join(f"{n} {ms[n]:.4f} (bound {bound[n]:.4f}, plain {plain[n]:.3f})"
                          for n in ms)
        print(f"[kernels] moe_dispatch {label}: N {N} x k {k}, {E} of {routed} experts "
              f"held from {first}, C {C}, d {d} bf16, {kept} of {nk} kept; slot, keep, src "
              f"and the buffer bit for bit, the rows' gradient too, y / dx / dw max ulps "
              f"{json.dumps({n: round(v, 3) for n, v in ulps.items()})}; two runs bitwise; "
              f"device ms: {parts}; in all {sum(ms.values()):.4f} against "
              f"{sum(bound.values()):.4f} bound, plain {sum(plain.values()):.3f} (its "
              f"one-hot cumsum {scan_ms:.3f}, the combine's indexing backward "
              f"{index_bwd_ms:.3f})", flush=True)
        del x, w, out_buf, dy, dbuf, onehot, gathered_grad, acc, got
    torch.cuda.empty_cache()
    last = rows[MOE_SHAPES[-1][0]]
    return {
        "name": "moe_dispatch",
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe_dispatch.py",
        "replaces": None,
        "replaces_note": "no TPU kernel: the reference leaves the MoE dispatch to XLA",
        "launches": None,
        "ms": sum(last["ms"].values()),
        "plain_ms": sum(last["plain_ms"].values()),
        "bound_ms": sum(last["bound_ms"].values()),
        "bound_by": "bytes",
        "library_ms": None,
        "library_call": None,
        "timed_work": f"one MoE layer's slot map, permute and unpermute, forward and "
                      f"backward, at {MOE_SHAPES[-1][0]}'s shapes",
        "by_config": rows,
    }


def phase_adamw() -> None:
    """One AdamW update, as the main path's optimizer makes it, on the card
    and on the CPU from the same moments, gradients and params (leaves of
    full-width shapes): m, v and the bias-corrected divisions bit for bit;
    ``torch.sqrt`` in float32, which may differ by one ulp between the two
    (``ROADMAP.md`` queue 3), held at 1 ulp, each against the correctly
    rounded root; the update bit for bit where the roots agree, elsewhere
    within 4 ulps of ``lr * m_hat / (sqrt(v_hat) + eps)``."""
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.optim.optimizers import bias_corrections

    gen = torch.Generator().manual_seed(9)
    shapes = [(12, 768, 3072), (768, 50304), (12, 768), (768,)]
    g, m, p = ([torch.randn(s, generator=gen) for s in shapes] for _ in range(3))
    v = [torch.rand(s, generator=gen) * 1e-3 for s in shapes]
    step, lr_fn = 3, cosine_warmup(1.5e-4, STEPS // 10 + 1, STEPS)
    opt = adamw(lr_fn)
    out = {}
    for dev in ("cpu", "cuda"):
        on = lambda xs: [x.to(dev) for x in xs]   # noqa: E731
        upd, new = opt.update(on(g), {"step": step, "m": on(m), "v": on(v)}, on(p))
        out[dev] = [[x.cpu() for x in part] for part in (upd, new["m"], new["v"])]
    (u_gpu, m_gpu, v_gpu), (u_cpu, m_cpu, v_cpu) = out["cuda"], out["cpu"]
    check(all(torch.equal(a, b) for a, b in zip(m_gpu + v_gpu, m_cpu + v_cpu)),
          "adamw: m or v differ between the card and the CPU")
    bc1, bc2 = bias_corrections(step + 1, 0.9, 0.999, torch.device("cpu"))
    lr = float(lr_fn(step + 1))
    n = off = off_cpu = off_gpu = bitwise = 0
    worst = 0.0
    for ug, uc, mm, vv in zip(u_gpu, u_cpu, m_cpu, v_cpu):
        vh = vv / bc2
        check(torch.equal((mm / bc1), (mm.cuda() / bc1.cuda()).cpu()),
              "adamw: m / bc1 differs between the card and the CPU")
        root_cpu, root_gpu = torch.sqrt(vh), torch.sqrt(vh.cuda()).cpu()
        exact = torch.sqrt(vh.double()).float()
        ulps = (root_cpu.view(torch.int32).long() - root_gpu.view(torch.int32).long()).abs()
        check(int(ulps.max()) <= 1, f"adamw: sqrt differs by {int(ulps.max())} ulps")
        agree = ulps == 0
        check(torch.equal(ug[agree], uc[agree]),
              "adamw: the update differs where the square roots agree")
        term = (lr * (mm / bc1) / (root_cpu + 1e-8)).abs()
        diff = (ug - uc).abs()
        check(bool((diff <= 2.0 ** -21 * term).all()),
              "adamw: the update differs by more than 4 ulps of lr * m_hat / denominator")
        n += vh.numel()
        off += int((~agree).sum())
        off_cpu += int((root_cpu != exact).sum())
        off_gpu += int((root_gpu != exact).sum())
        bitwise += int((ug == uc).sum())
        worst = max(worst, float((diff / term.clamp_min(1e-30)).max()))
    from repro_torch.kernels.adamw_fused import adamw_fused
    from repro_torch.optim import apply_updates

    on = lambda xs: [x.cuda() for x in xs]   # noqa: E731
    plain_p, fused_p = on(p), on(p)
    upd, plain = opt.update(on(g), {"step": step, "m": on(m), "v": on(v)}, plain_p)
    apply_updates(plain_p, upd)
    before = adamw_fused.launches
    fused = opt.apply(on(g), {"step": step, "m": on(m), "v": on(v)}, fused_p)
    torch.cuda.synchronize()
    check(adamw_fused.launches - before == len(shapes),
          f"adamw: {adamw_fused.launches - before} fused launches for {len(shapes)} leaves")
    for part, a, b in (("p", fused_p, plain_p), ("m", fused["m"], plain["m"]),
                       ("v", fused["v"], plain["v"])):
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"adamw: the fused kernel's {part} differs from the plain card path")
    print(f"[adamw] one update (step {step + 1}, lr {lr:.6g}) of {n} elements on the "
          f"card vs the CPU: m, v and m / bc1 bitwise; torch.sqrt differs by 1 ulp on "
          f"{off} elements ({off / n:.4%}; the CPU's root is not the correctly rounded "
          f"one on {off_cpu}, the card's on {off_gpu}); the update bitwise on {bitwise} "
          f"elements ({bitwise / n:.4%}), elsewhere within {worst * 2 ** 23:.3g} ulps of "
          f"lr * m_hat / denominator (held at 4); the fused kernel (Optimizer.apply, "
          f"{len(shapes)} launches) == update + apply_updates on the card in p, m and v, "
          f"bit for bit", flush=True)


def gather_order(tr) -> str:
    """The last sharded step's head all-gather, from the trainer's events:
    the issue order, then the buckets settled before each stage (``E`` the
    embedding, ``L<i>`` superblock i, ``H`` the final norm and head).  Checks
    that every issue precedes layer 0, issues follow the first use, and each
    bucket is settled just before the stage that first reads it."""
    from repro_torch.core.bucketing import EMBED_STAGE, bucket_first_use

    L = tr.model.num_stages
    stages = bucket_first_use(tr.plan)
    events = tr.gather_events
    issues = [i for k, i in events if k == "issue"]
    check(issues == sorted(range(len(stages)), key=lambda b: (stages[b], b)),
          f"sharded: gathers issued in the order {issues}")
    check(events[:len(issues)] == [("issue", b) for b in issues],
          "sharded: a gather was issued after the forward pass began")
    parts, pending, seen = [], [], []
    for k, i in events[len(issues):]:
        if k == "settle":
            pending.append(i)
            continue
        want = sorted(b for b, f in enumerate(stages)
                      if f == i or (i == 0 and f == EMBED_STAGE))
        check(sorted(pending) == want, f"sharded: settled {pending} before stage "
              f"{i}, want {want}")
        if i == 0:
            embed = [b for b in pending if stages[b] == EMBED_STAGE]
            check(pending[:len(embed)] == embed, "sharded: the embedding's buckets "
                  "were not settled first")
            parts.append(f"E<-{embed}")
            pending = pending[len(embed):]
        parts.append(f"{'H' if i == L else f'L{i}'}<-{pending}")
        seen.append(i)
        pending = []
    check(seen == list(range(L + 1)) and not pending,
          f"sharded: stages {seen}, buckets left {pending}")
    return f"issue {issues}; settle " + " ".join(parts)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    return x


# the key of a frontend family's stub embeddings in its batches
FRONTEND_KEY = {"vlm": "patch_embeds", "audio": "frames"}


def frontend_embeds(cfg, batch: int, device="cuda", seed: int = 0) -> torch.Tensor:
    """``batch`` rows of ``cfg``'s stub frontend output, (batch,
    frontend_tokens, d_model) f32 std-0.02 normals from numpy's
    ``default_rng(seed)``: pixtral's patch embeddings, seamless's frames."""
    rng = np.random.default_rng(seed)
    x = 0.02 * rng.standard_normal((batch, cfg.frontend_tokens, cfg.d_model))
    return torch.from_numpy(x.astype(np.float32)).to(device)


class FrontendLoader:
    """A loader whose every batch also carries the same frontend
    embeddings (:func:`frontend_embeds`, numpy seed 0) under its family's
    key: the reference's loader yields tokens and labels only, and its
    tests and serving feed these families embeddings of their own."""

    def __init__(self, loader, cfg, global_batch: int, device="cuda"):
        self.loader = loader
        self.key = FRONTEND_KEY[cfg.family]
        self.embeds = frontend_embeds(cfg, global_batch, device)

    def make(self, step: int) -> dict:
        return dict(self.loader.make(step), **{self.key: self.embeds})

    def __iter__(self):
        step = 0
        while True:
            yield self.make(step)
            step += 1


def train_loader(cfg, *, seq_len: int, global_batch: int, device="cuda", **data):
    """The synthetic loader of ``cfg`` (``seq_len`` text tokens a row),
    wrapped in a :class:`FrontendLoader` for a frontend family."""
    from repro_torch.data import DataConfig, make_loader

    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                    global_batch=global_batch, **data), device=device)
    if cfg.family in FRONTEND_KEY:
        return FrontendLoader(loader, cfg, global_batch, device)
    return loader


def ckpt_batches(cfg, seq_len=1024, global_batch=8, device="cuda") -> list[dict]:
    """The first 5 batches of :func:`phase_train`'s loader: the checkpoint
    and re-plan phases feed each run the same list."""
    from repro_torch.data import DataConfig, make_loader

    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                    global_batch=global_batch), device=device)
    return [loader.make(s) for s in range(STEPS)]


def phase_train(cfg, *, device="cuda", seq_len=1024, global_batch=8,
                group=None, label="defaults", options=None, steps=STEPS,
                moment_dtype=None):
    """Full-width training through ``Trainer.run`` on the ``TrainConfig``
    defaults updated with ``options``.  Returns the trainer, its state and
    the loader, and the launches of each kernel in the run
    (``{"ef_update": n, "pack_ef_cast": m, ...}``, every kernel) over
    ``steps`` steps, AdamW's moments in ``moment_dtype`` (the parameters'
    dtype when ``None``).  The trainer's ``run_stats`` holds the ms of
    steps 1 on, tok/s after step 0 and the peak GiB.  A frontend family's
    batches carry its stub embeddings (:class:`FrontendLoader`); tok/s
    counts the ``seq_len`` text tokens of a row."""
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import TrainConfig, Trainer

    base = 0.0
    if device != "cpu":
        # earlier runs' trainers sit in reference cycles until a collection:
        # free them, so that each run's peak counts its own memory
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated() / 2**30
    model = build_model(cfg, device=device, seed=0)
    opt = adamw(cosine_warmup(1.5e-4, steps // 10 + 1, steps),
                moment_dtype=moment_dtype)
    tc = TrainConfig(steps=steps, log_every=1)
    check((tc.compressor, tc.interval, tc.overlap, tc.arena, tc.sync)
          == ("covap", 4, "post", False, "allreduce"),
          f"TrainConfig defaults moved: {tc}")
    tc = TrainConfig(steps=steps, log_every=1, **(options or {}))
    tr = Trainer(model, opt, tc, group=group)
    state = tr.init_state()
    n_params = sum(p.numel() for p in state["params"])
    loader = train_loader(cfg, seq_len=seq_len, global_batch=global_batch, device=device)
    lines: list[str] = []
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    by_route = counters[MATMUL].launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    from repro_torch.kernels.adamw_fused import adamw_fused

    from repro_torch.kernels.causal_attn import causal_attn

    adamw_before, attn_before = adamw_fused.launches, causal_attn.launches
    state = tr.run(state, loader, steps=steps, log=lines.append)
    launches = {name: fn.launches for name, fn in counters.items()}
    adamw_launches = adamw_fused.launches - adamw_before
    attn_launches = causal_attn.launches - attn_before
    if device != "cpu":
        torch.cuda.synchronize()
    want_adamw = steps * len(state["params"]) if device != "cpu" else 0
    check(adamw_launches == want_adamw,
          f"{label}: adamw_fused launched {adamw_launches} times in {steps} steps of "
          f"{len(state['params'])} leaves (want {want_adamw})")
    tr.adamw_launches = adamw_launches
    # every attention layer's forward, remat recompute and backward on the
    # card goes through the causal kernel; the SSM family has none
    want_attn = device != "cpu" and cfg.family != "ssm"
    check((attn_launches > 0) == want_attn,
          f"{label}: causal_attn launched {attn_launches} times in {steps} steps")
    tr.attn_launches = attn_launches
    # every MoE layer's dispatch and combine on the card go through the
    # moe_dispatch kernels
    want_moe = moe_launches(cfg, steps) if device != "cpu" else 0
    check(launches["moe_dispatch"] == want_moe,
          f"{label}: moe_dispatch launched {launches['moe_dispatch']} times in {steps} "
          f"steps (want {want_moe})")

    hist = tr.history
    losses = [h["loss"] for h in hist]
    check(len(hist) == steps, f"expected {steps} logged steps, got {len(hist)}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in state["params"]),
          "non-finite parameters after training")
    step_ms = [1e3 * (b["wall_s"] - a["wall_s"]) for a, b in zip(hist, hist[1:])]
    tok_s = (steps - 1) * global_batch * seq_len / (hist[-1]["wall_s"] - hist[0]["wall_s"])
    peak = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else 0.0
    wire = tc.compressor_options.get("wire_dtype") or "f32"
    tr.run_stats = (step_ms, tok_s, peak)
    tr.run_base = base
    print(f"[train] {label}: {cfg.name} {n_params} params, {tr.plan.num_buckets} "
          f"buckets / {tr.plan.num_segments} segments, {tc.compressor} "
          f"{tr.num_phases} phase(s) {tc.overlap} {tc.sync} "
          f"arena={'on' if tc.arena else 'off'} "
          f"wire={wire}, adamw{f' ({moment_dtype} moments)' if moment_dtype else ''}, "
          f"seq {seq_len} x batch {global_batch}, world "
          f"{tr.dp_world}: losses {[round(v, 4) for v in losses]}  step 0 "
          f"{1e3 * hist[0]['wall_s']:.1f} ms, steps 1-{steps - 1} ms "
          f"{[round(v, 2) for v in step_ms]}  {tok_s:.0f} tok/s after step 0  "
          f"peak {peak:.2f} GiB (of which {base:.2f} GiB held before the "
          f"run)  launches {launches}, adamw_fused {adamw_launches}, causal_attn "
          f"{attn_launches}", flush=True)
    if tr.gather_events:
        print(f"[train] {label}: head all-gather of step {steps}, by bucket: "
              f"{gather_order(tr)}", flush=True)
    return tr, state, loader, launches


def phase_parity(tr, state, loader, group) -> None:
    """One step from the trained state on the same gradients, through
    ``build_step_fn(...).update`` for each execution form."""
    from repro_torch.core import get_compressor
    from repro_torch.core.overlap import sharded_param_allgather
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast
    from repro_torch.train import build_step_fn, loss_and_grads

    batch = loader.make(state["step"])
    phase = state["step"] % tr.num_phases
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    bf16 = {"wire_dtype": "bfloat16"}
    forms = {
        "ef-kernel": {},
        "ef-plain": {"use_ef_kernel": False},
        "arena": {"use_arena": True},
        "arena-plain": {"use_arena": True, "use_pack_kernel": False},
        "bf16": bf16,
        "arena-bf16": {"use_arena": True, **bf16},
        "arena-bf16-plain": {"use_arena": True, "use_pack_kernel": False, **bf16},
        "sharded": {"sync": "sharded"},
    }
    out, launches = {}, {}
    for name, opts in forms.items():
        comp = get_compressor("covap", interval=tr.tc.interval, **opts)
        fn = build_step_fn(tr.model, tr.optimizer, comp, tr.plan, phase=phase,
                           group=group)
        new_state = clone_tree(state)
        if name == "sharded":
            # the head all-gather of a one-rank group: launched, and an
            # identity on the values
            before = [p.clone() for p in new_state["params"]]
            sharded_param_allgather(comp, fn.comm_schedule, new_state["params"],
                                    group=group)
            check(all(torch.equal(a, b) for a, b in zip(before, new_state["params"])),
                  "parity: the one-rank head all-gather changed the params")
            del before
        e0, p0 = ef_update.launches, pack_ef_cast.launches
        new_state, _ = fn.update(new_state, grads)
        torch.cuda.synchronize()
        launches[name] = (ef_update.launches - e0, pack_ef_cast.launches - p0)
        out[name] = new_state["params"] + new_state["comp"]
        del new_state
    n = tr.plan.num_segments
    want = {"ef-kernel": (n, 0), "arena": (0, n), "arena-bf16": (0, n),
            "sharded": (0, n)}
    for name, got in launches.items():
        check(got == want.get(name, (0, 0)),
              f"parity: {name} launched (ef_update, pack_ef_cast) = {got}")
    c = get_compressor("covap", interval=tr.tc.interval).ef_coefficient(state["step"])
    worst = 0.0
    for a, b, r in zip(out["ef-kernel"], out["ef-plain"],
                       state["comp"] + state["comp"]):
        check(ef_close(a, b, r, c), "parity: ef_update kernel and plain disagree")
        worst = max(worst, abs_err(a, b))
    pairs = [("arena", "ef-kernel"), ("arena-plain", "arena"),
             ("arena-bf16", "bf16"), ("arena-bf16-plain", "arena-bf16"),
             ("sharded", "ef-kernel")]
    for a, b in pairs:
        diff = max(abs_err(x, y) for x, y in zip(out[a], out[b]))
        check(all(torch.equal(x, y) for x, y in zip(out[a], out[b])),
              f"parity: {a} != {b} in params or EF residuals (max |diff| {diff})")
    print(f"[parity] step {state['step']} (phase {phase}), same gradients: "
          f"ef_update kernel vs use_ef_kernel=False agree (max |diff| "
          f"{worst:.3g}); bitwise equal in params and EF residuals: "
          f"{', '.join(f'{a} == {b}' for a, b in pairs)}; launches "
          f"(ef_update, pack_ef_cast) {launches}", flush=True)


def phase_flat_parity(tr, state, loader, group) -> None:
    """One step of the flat-bucket path from the trained state on the same
    gradients, through ``SyncPipeline.execute``: the CUDA kernels against
    ``use_wire_kernel=False`` and the arena against the per-bucket form."""
    from repro_torch.core import get_compressor
    from repro_torch.core.comm import world_size
    from repro_torch.train import loss_and_grads

    name = tr.tc.compressor
    batch = loader.make(state["step"])
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    forms = {
        "kernel": {},
        "plain": {"use_wire_kernel": False},
        "arena": {"use_arena": True},
        "arena-plain": {"use_arena": True, "use_wire_kernel": False},
    }
    counters = kernel_counters()
    out, launches = {}, {}
    for form, opts in forms.items():
        comp = get_compressor(name, **opts)
        sched = comp.plan_phase(tr.plan, 0, world=world_size(group))
        before = {k: f.launches for k, f in counters.items()}
        synced, resid, _ = comp.execute(sched, grads, state["comp"],
                                        step=state["step"], group=group)
        torch.cuda.synchronize()
        launches[form] = {k: f.launches - before[k] for k, f in counters.items()
                          if f.launches != before[k]}
        out[form] = (synced, resid)
    nb = tr.plan.num_buckets
    kernel = ({"quantize_fp8": nb, "dequantize_fp8": 2 * nb} if name == "fp8wire"
              else {"sign_compress": nb})
    want = {"kernel": kernel, "arena": kernel, "plain": {}, "arena-plain": {}}
    check(launches == want, f"flat parity {name}: launches {launches}, want {want}")
    for a, b in (("arena", "kernel"), ("arena-plain", "plain")):
        diff = max(abs_err(x, y) for x, y in zip(out[a][0] + out[a][1],
                                                 out[b][0] + out[b][1]))
        check(all(torch.equal(x, y) for x, y in zip(out[a][0] + out[a][1],
                                                    out[b][0] + out[b][1])),
              f"flat parity {name}: {a} != {b} (max |diff| {diff})")
    (ks, kr), (ps, pr) = out["kernel"], out["plain"]
    worst = max(abs_err(x, y) for x, y in zip(ks + kr, ps + pr))
    if name == "fp8wire":
        check(all(torch.equal(x, y) for x, y in zip(ks + kr, ps + pr)),
              f"flat parity fp8wire: kernels != plain (max |diff| {worst})")
        how = "bit for bit in synced grads and EF residuals"
    else:
        check(all(torch.equal(torch.sign(x), torch.sign(y)) for x, y in zip(ks, ps)),
              "flat parity efsignsgd: the kernel's signs differ from the plain ones")
        for x, y in zip(ks, ps):
            check(torch.allclose(x, y, rtol=1e-6, atol=0),
                  "flat parity efsignsgd: synced values beyond rtol 1e-6")
        for x, y, o in zip(kr, pr, ps):
            atol = 1e-6 * float(o.abs().max())
            check(torch.allclose(x, y, rtol=1e-6, atol=atol),
                  "flat parity efsignsgd: residuals beyond rtol 1e-6, atol 1e-6 "
                  f"of the scale (max |diff| {abs_err(x, y)})")
        how = ("signs bit for bit, synced values at rtol 1e-6, residuals at rtol "
               "1e-6 and atol 1e-6 of the leaf's largest synced value")
    print(f"[parity] {name} step {state['step']}, same gradients: kernels vs "
          f"use_wire_kernel=False {how} (max |diff| {worst:.3g}); arena == "
          f"per-bucket and arena-plain == plain bit for bit; launches {launches}",
          flush=True)


def sign_aligned(q: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``q`` with each column (last axis) of each batch multiplied by the
    sign that best matches ``ref``'s: QR's column signs may differ between
    two runs whose P differ in their last bits."""
    s = torch.sign((q * ref).sum(dim=-2, keepdim=True))
    return q * torch.where(s == 0, torch.ones_like(s), s)


def leaf_close(got: torch.Tensor, want: torch.Tensor, scale: float) -> bool:
    """rtol 1e-4, atol 1e-5 of ``scale``."""
    return torch.allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def phase_powersgd_parity(tr, state, loader, group) -> None:
    """One PowerSGD step from the trained state on the same gradients,
    through ``SyncPipeline.execute``: the ``lowrank.matmul`` kernel against
    ``use_wire_kernel=False`` (``torch.matmul``).  Synced values (``approx``)
    at rtol 1e-4, atol 1e-5 of the leaf's largest; residuals likewise,
    against the leaf's largest ``approx``; Q up to the sign of each column,
    at rtol 1e-4, atol 1e-5 of its largest."""
    from repro_torch.core import get_compressor
    from repro_torch.core.comm import world_size
    from repro_torch.train import loss_and_grads

    batch = loader.make(state["step"])
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    counters = kernel_counters()
    out, launches = {}, {}
    for form, opts in (("kernel", {}), ("plain", {"use_wire_kernel": False})):
        comp = get_compressor("powersgd", **opts)
        sched = comp.plan_phase(tr.plan, 0, world=world_size(group))
        before = {k: f.launches for k, f in counters.items()}
        synced, new, _ = comp.execute(sched, grads, state["comp"], step=state["step"],
                                      group=group)
        torch.cuda.synchronize()
        launches[form] = {k: f.launches - before[k] for k, f in counters.items()
                          if f.launches != before[k]}
        out[form] = (synced, new)
    n = 3 * len(lowrank_leaves(tr.plan))
    check(launches == {"kernel": {MATMUL: n}, "plain": {}},
          f"powersgd parity: launches {launches}, want {MATMUL} {n} and 0")
    (ks, kn), (ps, pn) = out["kernel"], out["plain"]
    worst = {"approx": 0.0, "residual": 0.0, "q": 0.0}
    for i, (a, b) in enumerate(zip(ks, ps)):
        scale = float(b.abs().max())
        worst["approx"] = max(worst["approx"], abs_err(a, b) / max(scale, 1e-30))
        check(bool(torch.isfinite(a).all()) and leaf_close(a, b, scale),
              f"powersgd parity: leaf {i} approx, kernel vs plain, max |diff| "
              f"{abs_err(a, b):.3g} of {scale:.3g}")
        ra, rb = kn["residual"][i], pn["residual"][i]
        worst["residual"] = max(worst["residual"], abs_err(ra, rb) / max(scale, 1e-30))
        check(leaf_close(ra, rb, scale), f"powersgd parity: leaf {i} residual, max "
              f"|diff| {abs_err(ra, rb):.3g} against approx's {scale:.3g}")
        qa, qb = kn["q"][i], pn["q"][i]
        if qb is None:
            check(qa is None, f"powersgd parity: leaf {i} has a Q in one form only")
            continue
        qa = sign_aligned(qa, qb)
        qscale = float(qb.abs().max())
        worst["q"] = max(worst["q"], abs_err(qa, qb) / max(qscale, 1e-30))
        check(leaf_close(qa, qb, qscale), f"powersgd parity: leaf {i} Q up to column "
              f"sign, max |diff| {abs_err(qa, qb):.3g} of {qscale:.3g}")
    print(f"[parity] powersgd step {state['step']}, same gradients: lowrank.matmul "
          f"kernel vs use_wire_kernel=False: approx, residuals and Q (up to column "
          f"sign) within rtol 1e-4, atol 1e-5 of the leaf's largest (largest "
          f"|diff| / scale: { {k: float(f'{v:.3g}') for k, v in worst.items()} }); "
          f"launches {launches}", flush=True)


def ordered_ints(x: torch.Tensor) -> torch.Tensor:
    """float32 bits as integers in the order of the values (-0 and +0 both
    0), so that a difference counts ulps."""
    i = x.float().contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def check_same_leaves(what: str, got, want) -> int:
    """``torch.equal`` leaf by leaf; where a leaf differs, print it and its
    largest ulp distance, held at ``FUSED_PARITY_ULPS``.  -> the largest."""
    worst = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if torch.equal(a, b):
            continue
        ulps = int((ordered_ints(a) - ordered_ints(b)).abs().max())
        print(f"[parity] fused: {what} leaf {i} differs by up to {ulps} ulp(s)",
              flush=True)
        check(ulps <= FUSED_PARITY_ULPS, f"parity fused: {what} leaf {i}: {ulps} "
              f"ulps beyond the bound of {FUSED_PARITY_ULPS}")
        worst = max(worst, ulps)
    check(len(got) == len(want), f"parity fused: {what}: {len(got)} leaves, "
          f"want {len(want)}")
    return worst


def check_fused_run(tr, label: str) -> str:
    """The last fused step's records: every hook's backward ran on the
    stream the forward pass ran on, and the hooks fired in
    ``ReadyOrder.order()`` up to ties of equal ``bucket_layer``."""
    from repro_torch.core import build_ready_order

    fwd, streams = tr.last_step_fn.hook_streams
    check(streams and all(x == fwd for x in streams),
          f"{label}: hook streams {sorted(set(streams))}, forward stream {fwd}")
    fired = list(tr.last_step_fn.fired)
    check_ready_order(fired, tr.plan, label)
    return (f"{len(fired)} hooks on the forward's stream {fwd}; fired in "
            f"ReadyOrder up to ties (first {fired[:6]}, last {fired[-3:]}), "
            f"ReadyOrder {list(build_ready_order(tr.plan).order[:6])}...")


def check_ready_order(order, plan, what: str) -> None:
    from repro_torch.core import build_ready_order

    ready = build_ready_order(plan)
    check(sorted(order) == list(range(plan.num_buckets)),
          f"{what}: buckets {order} are not each bucket once")
    layers = [ready.bucket_layer[b] for b in order]
    check(layers == sorted(layers, reverse=True),
          f"{what}: bucket layers {layers} not in ReadyOrder")


def phase_fused_parity(tr, state, loader, group) -> None:
    """From one state and one batch, each fused form against its post form
    (``torch.equal``): the synced gradients and residuals of
    ``overlapped_loss_and_grads`` against ``loss_and_grads`` +
    ``execute``, then the params, Adam moments and residuals after one step
    of ``build_overlapped_step`` against ``build_step_fn(...).update``."""
    from repro_torch.core import get_compressor
    from repro_torch.core.overlap import overlapped_loss_and_grads
    from repro_torch.kernels.ef_covap import ef_update
    from repro_torch.kernels.pack_ef_cast import pack_ef_cast
    from repro_torch.train import build_overlapped_step, build_step_fn, loss_and_grads

    batch = loader.make(state["step"])
    phase = state["step"] % tr.num_phases
    forms = {"defaults": {}, "arena": {"use_arena": True},
             "sharded": {"sync": "sharded"}}
    n = tr.plan.num_segments
    notes = []
    worst = 0
    for name, opts in forms.items():
        comp = get_compressor("covap", interval=tr.tc.interval, **opts)
        post = build_step_fn(tr.model, tr.optimizer, comp, tr.plan, phase=phase,
                             group=group)
        fused = build_overlapped_step(tr.model, tr.optimizer, comp, tr.plan,
                                      phase=phase, group=group)
        sched = post.comm_schedule
        grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
        want = comp.execute(sched, grads, state["comp"], step=state["step"],
                            group=group)[:2]
        del grads
        e0, p0 = ef_update.launches, pack_ef_cast.launches
        got = overlapped_loss_and_grads(tr.model, comp, sched, state["params"],
                                        state["comp"], batch, state["step"],
                                        group=group)[2:4]
        torch.cuda.synchronize()
        launched = (ef_update.launches - e0, pack_ef_cast.launches - p0)
        check(launched == ((n, 0) if name == "defaults" else (0, n)),
              f"parity fused {name}: launched (ef_update, pack_ef_cast) {launched}")
        worst = max(worst, check_same_leaves(f"{name} synced", got[0], want[0]),
                    check_same_leaves(f"{name} residuals", got[1], want[1]))
        del got, want
        grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
        sp, _ = post.update(clone_tree(state), grads)
        del grads
        sf, _ = fused(clone_tree(state), batch)
        torch.cuda.synchronize()
        for part, a, b in (("params", sf["params"], sp["params"]),
                           ("adam m", sf["opt"]["m"], sp["opt"]["m"]),
                           ("adam v", sf["opt"]["v"], sp["opt"]["v"]),
                           ("residuals", sf["comp"], sp["comp"])):
            worst = max(worst, check_same_leaves(f"{name} updated {part}", a, b))
        notes.append(name)
        del sp, sf
        torch.cuda.empty_cache()
    print(f"[parity] fused step {state['step']} (phase {phase}), one state and one "
          f"batch: {', '.join(notes)}: fused == post in synced gradients, "
          f"residuals, and the params, Adam moments and residuals after the step "
          f"(largest ulp distance {worst}, bound {FUSED_PARITY_ULPS})", flush=True)


def overlap_counts(trace, plan, issue_order) -> tuple[list[int], int, int]:
    """From one profiled step's trace (``hlo_analysis.load_trace``): the
    host order of the ``covap_bucket_*`` spans, and how many buckets'
    ``ef_update`` kernels start on the device before the step's last GEMM
    (layer 0's last backward GEMM), out of how many
    (``hlo_analysis.ef_kernel_overlap``).  ``issue_order`` is the order the
    buckets' kernels were launched in."""
    from repro_torch.launch import hlo_analysis

    try:
        early, total = hlo_analysis.ef_kernel_overlap(trace, plan, issue_order)
    except ValueError as e:
        raise PhaseError(f"overlap: {e}") from e
    return hlo_analysis.bucket_spans(trace), early, total


def phase_overlap(tr, state, loader, group) -> None:
    """One post step and one fused step of the defaults form under
    ``torch.profiler``: the fused step's host order of its
    ``covap_bucket_*`` spans must follow ``ReadyOrder`` up to ties, and at
    least one bucket's ``ef_update`` kernels must start on the device before
    layer 0's last backward GEMM; under post none may.  With one card this
    shows where each bucket is issued, not overlap across cards."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import build_ready_order
    from repro_torch.launch.hlo_analysis import load_trace
    from repro_torch.train import build_step_fn

    phase = state["step"] % tr.num_phases
    post = build_step_fn(tr.model, tr.optimizer, tr.compressor, tr.plan, phase=phase,
                         group=group)
    out = {}
    for overlap in ("post", "fused"):
        batch = loader.make(state["step"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if overlap == "post":
                state, _ = post(state, batch)
            else:
                state, _ = tr.step(state, batch)
            torch.cuda.synchronize()
        order = (list(range(tr.plan.num_buckets)) if overlap == "post"
                 else list(tr.last_step_fn.fired))
        out[overlap] = overlap_counts(load_trace(prof), tr.plan, order)
    host, early, total = out["fused"]
    check(host == list(tr.last_step_fn.fired), "overlap: the covap_bucket spans "
          f"{host} differ from the hooks' firing order {tr.last_step_fn.fired}")
    check_ready_order(host, tr.plan, "overlap: covap_bucket spans")
    check(not out["post"][0], "overlap: the post step recorded covap_bucket spans")
    check(early >= 1, f"overlap: no fused bucket started before layer 0's last GEMM")
    check(out["post"][1] == 0, f"overlap: {out['post'][1]} post buckets started "
          "before layer 0's last GEMM")
    ready = build_ready_order(tr.plan)
    print(f"[overlap] one full-width step each, one card: fused covap_bucket spans "
          f"in host order {host} (ReadyOrder {list(ready.order)}, equal up to ties "
          f"of equal bucket_layer); buckets whose ef_update kernels start on the "
          f"device before layer 0's last backward GEMM: fused {early} of {total}, "
          f"post {out['post'][1]} of {out['post'][2]}.  One card and a one-rank "
          f"group: this shows where each bucket is issued, not overlap across "
          f"cards", flush=True)
    return state


def phase_gates(cfg, group, tr, state, loader) -> dict:
    """The overlap gate and the sharded gate (``launch/overlap_gate``,
    ``launch/sharded_gate``) at full width in the one-rank NCCL group, one
    profiled step each, read by ``launch/hlo_analysis``: ``tr`` (the
    fused trainer of ``[overlap]``) must be interleaved with at least one
    bucket's first kernel on the device before layer 0's last backward
    GEMM; a post trainer on the same model and state must issue no
    collective before the final backward product; a fresh fused sharded
    trainer must be placed.  Returns the ``ef_update`` and
    ``pack_ef_cast`` launches of the three steps."""
    import dataclasses

    from repro_torch.launch import overlap_gate, sharded_gate
    from repro_torch.train import Trainer

    counters = zero_counters()
    t0 = time.perf_counter()
    phase = state["step"] % tr.num_phases
    batch = loader.make(state["step"])
    fused = overlap_gate.profile_and_check(tr, state, batch, phase=phase)
    check(fused.interleaved, f"gates: the fused step is not interleaved: {fused}")
    check(fused.device_early >= 1, "gates: no fused bucket's first kernel started "
          f"on the device before layer 0's last backward GEMM: {fused}")
    post_tr = Trainer(tr.model, tr.optimizer, dataclasses.replace(tr.tc, overlap="post"),
                      group=group)
    post = overlap_gate.profile_and_check(post_tr, state, batch, phase=phase)
    check(post.num_collectives > 0 and post.before_final_grad == 0
          and not post.interleaved, f"gates: the post step is interleaved: {post}")
    ef = counters["ef_update"].launches
    del post_tr
    str_, sstate = fresh_trainer(cfg, group, {"overlap": "fused", "sync": "sharded"})
    placed = sharded_gate.profile_and_check(str_, sstate, loader.make(0))
    ratio = sharded_gate.exposed_ratio(str_, world=8)
    check(placed.placed, f"gates: the sharded step is not placed: {placed}")
    launches = {name: fn.launches for name, fn in counters.items()}
    segs = tr.plan.num_segments
    check(launches == launch_counts(ef_update=2 * segs, pack_ef_cast=segs),
          f"gates: launches {launches}; the plan has {segs} segments")
    print(f"[gates] full width, one card, one profiled step each: "
          f"{overlap_gate.overlap_line(fused)} device_early={fused.device_early} of "
          f"{fused.device_buckets} buckets; post: {overlap_gate.overlap_line(post)}; "
          f"{sharded_gate.sharded_line(placed, ratio)} (plan at W=8); "
          f"ef_update {ef}, pack_ef_cast {launches['pack_ef_cast']} launches; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del str_, sstate
    return {"ef_update": ef, "pack_ef_cast": launches["pack_ef_cast"]}


def phase_dryrun(cfg, group, stats: dict, base_gib: float) -> None:
    """``launch/dryrun`` against the card: ``plan_train`` and
    ``memory_analysis`` for gpt2-paper at ``[train]``'s shape (seq 1024,
    global batch 8, W = 1).  The argument bytes less the batch must equal
    the bytes of a ``[train]`` state built on the card (params, Adam's
    moments, the residuals: numel x element size) and lie within 2% of the
    allocator's growth while it is built; the traced peak is printed beside
    ``[train]``'s measured ``max_memory_allocated`` (an estimate, not
    checked), and the defaults run's MFU (model FLOPs over step seconds x
    989.4 TFLOP/s, the data sheet's dense bf16 peak) beside
    ``analytic_costs.step_flops``.  Then the dry run of every assigned arch
    at ``train_4k`` on ``w8`` (``launch/dryrun_sweep``, 8 at once) and
    ``dryrun_summary``'s table."""
    import os
    import tempfile

    from repro_torch.configs import InputShape
    from repro_torch.launch import analytic_costs, dryrun, dryrun_summary
    from repro_torch.models import model_flops

    t0 = time.perf_counter()
    shape = InputShape("chip_smoke", 1024, 8, "train")
    meta = dryrun.plan_train(cfg, 1, 1, "covap", 4, 0)
    ma = dryrun.memory_analysis(cfg, shape, 8, interval=4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    tr, state = fresh_trainer(cfg, group)
    torch.cuda.synchronize()
    growth = torch.cuda.memory_allocated() - m0
    held = dryrun.tree_bytes([state["params"], state["opt"], state["comp"]])
    args = ma["argument_size_in_bytes"] - ma["batch_size_in_bytes"]
    check(args == held, f"dryrun: argument bytes less the batch {args}, the card's "
          f"state {held}")
    check(abs(growth - held) <= 0.02 * held, f"dryrun: the allocator grew {growth} B "
          f"building a state of {held} B")
    check(meta["plan_buckets"] == tr.plan.num_buckets, f"dryrun: {meta['plan_buckets']} "
          f"buckets planned, the trainer has {tr.plan.num_buckets}")
    del tr, state
    torch.cuda.empty_cache()
    step_ms, _, peak_gib = stats["defaults"]
    step_s = statistics.median(step_ms) / 1e3
    mf = model_flops(cfg, 8 * 1024, "train")
    print(f"[dryrun] gpt2-paper seq 1024 x batch 8, W=1: {meta['plan_buckets']} buckets, "
          f"phase 0 plans {meta['planned_bytes_per_worker']} B a worker; argument "
          f"bytes {ma['argument_size_in_bytes']} (state {args} == the card's {held}; "
          f"the allocator grew {growth}, {100 * (growth - held) / held:+.3f}%); traced "
          f"peak {ma['peak_memory_in_bytes'] / 2**30:.2f} GiB (traced at "
          f"{ma['peak_traced']}) vs [train] defaults measured {peak_gib:.2f} GiB (of "
          f"which {base_gib:.2f} held before it), ratio "
          f"{ma['peak_memory_in_bytes'] / 2**30 / peak_gib:.3f}; model_flops "
          f"{mf:.4e} vs analytic step_flops {analytic_costs.step_flops(cfg, shape):.4e}; "
          f"[train] defaults median step {1e3 * step_s:.1f} ms -> MFU "
          f"{mf / (step_s * 989.4e12):.4f} (of 989.4 TFLOP/s)", flush=True)
    with tempfile.TemporaryDirectory() as td:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun_sweep",
                            "--arch", "all", "--shape", "train_4k", "--mesh", "w8",
                            "--out", td, "--jobs", "8", "--timeout", "150"],
                           capture_output=True, text=True, env=env, timeout=600)
        check(r.returncode == 0, f"dryrun: the sweep failed: {r.stderr[-2000:]}")
        recs = dryrun_summary.load(td)
    from repro_torch.configs import list_archs

    got = {rec["arch"]: rec["status"] for rec in recs}
    check(sorted(got) == sorted(list_archs(assigned_only=True))
          and set(got.values()) <= {"ok", "does_not_fit", "error"},
          f"dryrun: the sweep's records {got}")
    print("[dryrun] launch.dryrun --arch all --shape train_4k --mesh w8 (dryrun_sweep, "
          f"8 at once; statuses {got}):\n{dryrun_summary.table(recs)}", flush=True)
    print(f"[dryrun] {time.perf_counter() - t0:.1f} s", flush=True)


def comp_parts(comp) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """A compressor state as ``(residual-like leaves, PowerSGD's Qs)``: the
    residual list of the segmented and flat paths (no Q), or PowerSGD's
    residuals and Qs without the ``None`` entries."""
    if isinstance(comp, dict):
        return ([r for r in comp["residual"] if r is not None],
                [q for q in comp["q"] if q is not None])
    return list(comp), []


def fresh_trainer(cfg, group, options=None, device="cuda", pod_group=None):
    """A trainer as :func:`phase_train` builds it (the model from seed 0,
    AdamW on the same schedule), and its fresh state; ``pod_group`` makes it
    hierarchical with ``options["pod_interval"] > 1``."""
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import TrainConfig, Trainer

    model = build_model(cfg, device=device, seed=0)
    opt = adamw(cosine_warmup(1.5e-4, STEPS // 10 + 1, STEPS))
    tr = Trainer(model, opt, TrainConfig(steps=STEPS, log_every=1, **(options or {})),
                 group=group, pod_group=pod_group)
    return tr, tr.init_state()


def zero_counters() -> dict:
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    by_route = counters[MATMUL].launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    return counters


def state_parts(state, clone: bool = True) -> dict:
    """A train state's tensors by part, cloned (or the state's own with
    ``clone=False``): params, Adam's m and v, the residuals (PowerSGD's
    without its ``None`` holes) and PowerSGD's Qs."""
    resid, qs = comp_parts(state["comp"])
    return {part: [x.detach().clone() if clone else x.detach() for x in leaves]
            for part, leaves in (
                ("params", state["params"]), ("m", state["opt"]["m"]),
                ("v", state["opt"]["v"]), ("residual", resid), ("q", qs))}


def host_parts(state) -> dict:
    """:func:`state_parts` copied to the host."""
    return {part: [x.cpu() for x in leaves]
            for part, leaves in state_parts(state, clone=False).items()}


def phase_ckpt(cfg, group, label: str, options: dict, batches) -> dict:
    """Save and resume at full width: 2 steps, ``save_train_state`` into a
    temporary directory, 3 more steps (state A); a fresh trainer, then
    ``restore_train_state`` and the same 3 batches (state B).  A equals B
    bit for bit in params, Adam's m and v, the residuals (and PowerSGD's
    Q), both steps and the losses.  Prints the bytes on disk and the save,
    digest and restore seconds; a copy of the checkpoint with one byte
    flipped must raise ``CheckpointCorruptError``.  The directory is
    deleted afterwards.  -> the launches of the run's 8 steps."""
    import os
    import shutil
    import tempfile

    from repro_torch import checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    counters = zero_counters()
    device = batches[0]["tokens"].device
    tr, state = fresh_trainer(cfg, group, options, device)
    state = tr.run(state, iter(batches[:2]), steps=2, log=None)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = checkpoint.save_train_state(tmp, state, interval=tr.tc.interval,
                                        names=tr.leaf_names, group=group)
        save_s = time.perf_counter() - t0
        nbytes = {f: os.path.getsize(os.path.join(d, f)) for f in sorted(os.listdir(d))}
        t0 = time.perf_counter()
        digest = checkpoint.verify(tmp, 2)
        digest_s = time.perf_counter() - t0
        state = tr.run(state, iter(batches[2:]), steps=3, log=None)
        want, want_steps = state_parts(state), (state["step"], state["opt"]["step"])
        want_losses = [h["loss"] for h in tr.history[2:]]
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()

        tr, state = fresh_trainer(cfg, group, options, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, extra = checkpoint.restore_train_state(tmp, state, names=tr.leaf_names,
                                                      group=group)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(extra["comp_restored"] and extra["world"] == 1 and state["step"] == 2,
              f"ckpt {label}: restore gave step {state['step']}, extra {extra}")
        state = tr.run(state, iter(batches[2:]), steps=3, log=None)
        got, got_steps = state_parts(state), (state["step"], state["opt"]["step"])
        losses = [h["loss"] for h in tr.history]
        check(got_steps == want_steps == (5, 5),
              f"ckpt {label}: steps {got_steps} after resume, {want_steps} uninterrupted")
        check(losses == want_losses and all(math.isfinite(v) for v in losses),
              f"ckpt {label}: losses {losses} after resume, {want_losses} uninterrupted")
        for part in want:
            check(len(got[part]) == len(want[part])
                  and all(torch.equal(a, b) for a, b in zip(got[part], want[part])),
                  f"ckpt {label}: {part} differs between the resumed and the "
                  "uninterrupted run")
        check(any(bool(r.any()) for r in want["residual"]),
              f"ckpt {label}: every residual is zero; the check shows nothing")
        counts = {k: fn.launches for k, fn in counters.items()}

        bad = os.path.join(tmp, "corrupt")
        shutil.copytree(d, os.path.join(bad, os.path.basename(d)))
        npz = os.path.join(bad, os.path.basename(d), "arrays.npz")
        with open(npz, "r+b") as f:
            f.seek(nbytes["arrays.npz"] // 2)
            b = f.read(1)
            f.seek(nbytes["arrays.npz"] // 2)
            f.write(bytes([b[0] ^ 0x01]))
        try:
            checkpoint.verify(bad, 2)
            raised = False
        except checkpoint.CheckpointCorruptError:
            raised = True
        check(raised, f"ckpt {label}: a flipped byte was not caught")
    n = {part: len(v) for part, v in want.items()}
    print(f"[ckpt] {label}: {cfg.name}, 2 steps, save, 3 steps == restore into a "
          f"fresh trainer, 3 steps, bit for bit in {n} leaves (params, m, v, "
          f"residual, q), both steps {got_steps} and losses "
          f"{[round(v, 4) for v in losses]}; on disk {sum(nbytes.values())} B "
          f"{nbytes}; save {save_s:.3f} s (digest included), verify {digest_s:.3f} "
          f"s ({digest[:23]}...), restore {restore_s:.3f} s (verify included); a "
          f"flipped byte raises CheckpointCorruptError; launches {counts}",
          flush=True)
    return counts


def phase_replan(cfg, group, batches) -> int:
    """On the defaults, 2 steps at I = 4, then ``Trainer.replan(2)``: the
    residual norm is the same bit for bit (``carry``), and 3 more steps
    run the new plan with finite losses and ``ef_update`` once per new
    segment a step.  -> ``ef_update``'s launches in those 3 steps."""
    from repro_torch.runtime import residual_norm

    gc.collect()
    torch.cuda.empty_cache()
    tr, state = fresh_trainer(cfg, group, device=batches[0]["tokens"].device)
    state = tr.run(state, iter(batches[:2]), steps=2, log=None)
    old = (tr.plan.num_buckets, tr.plan.num_segments, tr.num_phases)
    before = residual_norm(state["comp"])
    state, rep = tr.replan(2, state, step=state["step"])
    after = residual_norm(state["comp"])
    check(rep.policy == "carry" and before == after == rep.norm_before == rep.norm_after,
          f"replan: residual norm {before} -> {after}, report {rep}")
    new = (tr.plan.num_buckets, tr.plan.num_segments, tr.num_phases)
    counters = zero_counters()
    state = tr.run(state, iter(batches[2:]), steps=3, log=None)
    counts = {k: fn.launches for k, fn in counters.items()}
    losses = [h["loss"] for h in tr.history[2:]]
    check(len(losses) == 3 and all(math.isfinite(v) for v in losses),
          f"replan: losses {losses}")
    check(counts == launch_counts(ef_update=3 * new[1]),
          f"replan: launches {counts} in 3 steps; the new plan has {new[1]} segments")
    print(f"[replan] defaults, after 2 steps at I=4: replan(2) carries the residual "
          f"(norm {before!r} before, {after!r} after, bit for bit); plan (buckets, "
          f"segments, phases) {old} -> {new}; 3 more steps, losses "
          f"{[round(v, 4) for v in losses]}; launches {counts}", flush=True)
    return counts["ef_update"]


# [adaptive]: the runtime's settings and the synthetic probe's.  From I = 4
# with this config the synthetic probe (CCR 1.6) re-plans to I = 2 after
# step ADAPTIVE_REPLAN_STEP: the step that the "chip_smoke" case of
# tests/test_torch_runtime.py::test_synthetic_probe_runs_replan_like_the_reference
# finds for the reference's controller, on the same settings.
ADAPTIVE_STEPS = 6
ADAPTIVE_CONFIG = dict(measure_every=2, warmup_steps=1, window=1, patience=1,
                       cooldown_steps=0, probe_warmup=1, probe_iters=2)
ADAPTIVE_SYNTHETIC = (0.01, 1.6)
ADAPTIVE_REPLAN_STEP = 1


def adaptive_batches(cfg, n: int, seq_len=1024, global_batch=8) -> list[dict]:
    from repro_torch.data import DataConfig, make_loader

    loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                    global_batch=global_batch), device="cuda")
    return [loader.make(s) for s in range(n)]


def ef_launches_of(plan_segments: dict, intervals: list[int], probes: dict,
                   per_probe: int) -> int:
    """``ef_update``'s launches in a run: each step runs EF on every segment
    of its plan while the plan keeps EF (I > 1), and each probe runs
    ``per_probe`` steps (full and compute-only) on the plan it found.
    ``intervals[s]`` is step s's interval, ``probes`` maps a probed step to
    the interval its probe ran under."""
    def segs(i):
        return plan_segments[i] if i > 1 else 0
    return (sum(segs(i) for i in intervals)
            + sum(per_probe * segs(i) for i in probes.values()))


def phase_adaptive(cfg, group, smi: str) -> int:
    """The adaptive runtime at full width on the defaults (COVAP I = 4,
    post, ``ef_update``), in the one-rank NCCL group:

    1. after 2 steps, one ``PhaseProbe`` call leaves params, Adam's m and v
       and the residuals ``torch.equal`` to their clones;
    2. 6 steps with the real probe (``ADAPTIVE_CONFIG``) and a
       ``Telemetry``: every probe's times, every decision and re-plan are
       printed; the measured CCRs replayed through a fresh
       ``ReplanController`` give the same decisions; ``ef_update``'s
       launches equal the count worked out from the plans the run went
       through; the events validate against the schema and the trace has
       its measured, planned and control rows;
    3. the synthetic probe from I = 4 re-plans to 2 after step
       ``ADAPTIVE_REPLAN_STEP`` and carries the residual norm bit for bit;
    4. ``api.tune(measured=True)`` on the card.
    -> ``ef_update``'s launches in 1-3."""
    import os
    import tempfile

    import repro_torch.api as api
    from repro_torch.core import build_plan
    from repro_torch.obs import Telemetry, validate_event
    from repro_torch.runtime import (AdaptiveRuntime, AutotuneConfig, PhaseProbe,
                                     ReplanController, synthetic_probe)

    gc.collect()
    torch.cuda.empty_cache()
    batches = adaptive_batches(cfg, ADAPTIVE_STEPS)
    per_probe = 2 * (ADAPTIVE_CONFIG["probe_warmup"] + ADAPTIVE_CONFIG["probe_iters"])
    total = 0

    # 1. the probe leaves the state alone
    counters = zero_counters()
    tr, state = fresh_trainer(cfg, group)
    model = tr.model
    plan_segments = {i: build_plan(model.named_leaves(), bucket_bytes=tr.tc.bucket_bytes,
                                   max_buckets=tr.tc.max_buckets, interval=i).num_segments
                     for i in (1, 2, 4)}
    state = tr.run(state, iter(batches[:2]), steps=2, log=None)
    before = state_parts(state)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    probe = PhaseProbe(tr, warmup=ADAPTIVE_CONFIG["probe_warmup"],
                       iters=ADAPTIVE_CONFIG["probe_iters"])
    t0 = time.perf_counter()
    sample = probe(state, batches[2], state["step"] % tr.num_phases)
    probe_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = state_parts(state)
    for part in before:
        check(all(torch.equal(a, b) for a, b in zip(after[part], before[part])),
              f"adaptive: the probe changed the live {part}")
    counts = {k: fn.launches for k, fn in counters.items()}
    want = (2 + per_probe) * plan_segments[4]
    check(counts == launch_counts(ef_update=want),
          f"adaptive: launches {counts} in 2 steps and one probe, want ef_update {want}")
    total += counts["ef_update"]
    res = probe.last
    print(f"[adaptive] probe state: after 2 steps, one PhaseProbe call (phase "
          f"{res['phase']}, warmup 1, iters 2) leaves params, m, v and residuals "
          f"torch.equal; t_full {res['t_full'] * 1e3:.2f} ms, t_comp "
          f"{res['t_comp'] * 1e3:.2f} ms, t_comm {res['t_comm'] * 1e3:.3f} ms, "
          f"t_comm_direct {res['t_comm_direct'] * 1e3:.3f} ms, CCR {sample.ccr:.5f}, "
          f"achieved overlap {sample.achieved_overlap}; the call took {probe_s:.2f} s; "
          f"peak {peak:.2f} GiB against {base:.2f} GiB held before it; launches "
          f"{counts} ({smi})", flush=True)
    del tr, state, before, after, probe, model
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the real probe through Trainer.run, with telemetry
    counters = zero_counters()
    tr, state = fresh_trainer(cfg, group)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_telemetry_") as tmp:
        tel = Telemetry(tmp)
        rt = AdaptiveRuntime(tr, AutotuneConfig(**ADAPTIVE_CONFIG))
        print(f"[adaptive] prediction: one rank, so the probe's comm term is the "
              f"one-rank NCCL floor and CCR << 0.75; the first probe (after step "
              f"1) leaves I=4's band and re-plans to I=1 (EF off, residual "
              f"dropped), so ef_update launches (2 + {per_probe}) x "
              f"{plan_segments[4]} = {(2 + per_probe) * plan_segments[4]}", flush=True)
        intervals, probes, probe_lines = [], {}, []
        for s in range(ADAPTIVE_STEPS):
            intervals.append(tr.tc.interval)
            last = rt.phase_probe.last
            state = tr.run(state, iter(batches[s:s + 1]), steps=1, log=None,
                           autotune=rt, telemetry=tel)
            res = rt.phase_probe.last
            if res is not last and res is not None:
                probes[s] = intervals[-1]
                probe_lines.append(
                    f"after step {s} (phase {res['phase']}, I={intervals[-1]}): t_full "
                    f"{res['t_full'] * 1e3:.2f} ms, t_comp {res['t_comp'] * 1e3:.2f} ms, "
                    f"t_comm {res['t_comm'] * 1e3:.3f} ms, t_comm_direct "
                    f"{res['t_comm_direct'] * 1e3:.3f} ms, CCR {res['ccr']:.5f}")
        tel.save()
        tel.close()
        with open(os.path.join(tmp, "events.jsonl")) as f:
            events = [json.loads(line) for line in f]
        with open(os.path.join(tmp, "trace.json")) as f:
            trace = json.load(f)
    counts = {k: fn.launches for k, fn in counters.items()}
    ctrl = rt.controller
    decisions = ctrl.decisions
    check(len(decisions) == len(probes) == 3, f"adaptive: {len(decisions)} decisions, "
          f"probes after steps {sorted(probes)}")
    replay = ReplanController(AutotuneConfig(**ADAPTIVE_CONFIG), interval=4)
    steps_probed = sorted(probes)
    replayed = [replay.observe(s, d.measured_ccr) for s, d in zip(steps_probed, decisions)]
    check(replayed == decisions, f"adaptive: replayed decisions {replayed} != {decisions}")
    want = ef_launches_of(plan_segments, intervals, probes, per_probe)
    check(counts == launch_counts(ef_update=want),
          f"adaptive: launches {counts}; from the plans (intervals by step "
          f"{intervals}, probes {probes}) ef_update {want}")
    total += counts["ef_update"]
    kinds = [e["kind"] for e in events]
    bad = [(e["kind"], validate_event(e)) for e in events if validate_event(e)]
    check(not bad, f"adaptive: events that do not validate: {bad[:3]}")
    check(kinds.count("probe") == kinds.count("replan_decision") == 3
          and kinds.count("replan") == ctrl.replans and kinds[0] == "manifest",
          f"adaptive: event kinds {kinds}")
    cats = {c for e in trace["traceEvents"] for c in e.get("cat", "").split(",") if c}
    check({"measured", "planned"} <= cats and ("control" in cats) == (ctrl.replans > 0),
          f"adaptive: trace categories {cats} with {ctrl.replans} re-plan(s)")
    for line in probe_lines:
        print(f"[adaptive] real probe {line} ({smi})", flush=True)
    for s, d in zip(steps_probed, decisions):
        print(f"[adaptive] decision after step {s}: replan={d.replan} I={d.interval} "
              f"measured CCR {d.measured_ccr!r} ({d.reason})", flush=True)
    for rep in rt.transitions:
        print(f"[adaptive] re-plan at step {rep.step}: I {rep.old_interval} -> "
              f"{rep.new_interval}, {rep.policy}, residual norm {rep.norm_before!r} -> "
              f"{rep.norm_after!r}", flush=True)
    s = rt.summary()
    print(f"[adaptive] real probe run: {ADAPTIVE_STEPS} steps, intervals by step "
          f"{intervals}, {ctrl.replans} re-plan(s), final I={tr.tc.interval}; losses "
          f"{[round(h['loss'], 4) for h in tr.history]}; replayed decisions equal; "
          f"{len(events)} events valid ({sorted(set(kinds))}), trace rows "
          f"{sorted(cats)}; mean timed step {s['monitor']['mean_step_s'] * 1e3:.1f} ms; "
          f"launches {counts} ({smi})", flush=True)
    del tr, state, rt
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the synthetic probe: no clock, a re-plan to I = 2 with the norm carried
    counters = zero_counters()
    tr, state = fresh_trainer(cfg, group)
    cfg_syn = AutotuneConfig(**ADAPTIVE_CONFIG, probe=synthetic_probe(*ADAPTIVE_SYNTHETIC))
    state = tr.run(state, iter(batches), steps=ADAPTIVE_STEPS, log=None, autotune=cfg_syn)
    counts = {k: fn.launches for k, fn in counters.items()}
    (rep,) = tr.transitions
    check(tr.runtime.controller.replan_steps == [ADAPTIVE_REPLAN_STEP]
          and tr.tc.interval == 2 and rep.policy == "carry"
          and rep.norm_before == rep.norm_after,
          f"adaptive: synthetic re-plans {tr.runtime.controller.replan_steps} to "
          f"I={tr.tc.interval}, {rep}")
    intervals = [4] * (ADAPTIVE_REPLAN_STEP + 1) + [2] * (ADAPTIVE_STEPS
                                                          - ADAPTIVE_REPLAN_STEP - 1)
    want = ef_launches_of(plan_segments, intervals, {}, per_probe)
    check(counts == launch_counts(ef_update=want),
          f"adaptive: synthetic launches {counts}, want ef_update {want}")
    check(all(math.isfinite(h["loss"]) for h in tr.history), "adaptive: synthetic loss")
    total += counts["ef_update"]
    print(f"[adaptive] synthetic probe (t_comp {ADAPTIVE_SYNTHETIC[0]}, CCR "
          f"{ADAPTIVE_SYNTHETIC[1]}): re-plan after step {ADAPTIVE_REPLAN_STEP}, I 4 -> 2, "
          f"carry, residual norm {rep.norm_before!r} -> {rep.norm_after!r} (bit for "
          f"bit); launches {counts}", flush=True)
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()

    # 4. api.tune with the measured column, on the card
    counters = zero_counters()
    t0 = time.perf_counter()
    rows = api.tune("gpt2-paper", reduced=False, seq_len=1024, global_batch=8,
                    bucket_bytes=25 << 20, max_buckets=128, dp_workers=8,
                    measured=True, measure_steps=1, device="cuda")
    tune_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    check(counts == launch_counts(), f"adaptive: tune launches {counts}")
    check(all(math.isfinite(r["measured_ccr"]) and r["measured_interval"] >= 1
              for r in rows), f"adaptive: tune rows {rows}")
    for r in rows:
        print(f"[adaptive] tune {r['compressor']}: analytic speedup {r['speedup']:.3f} "
              f"of 8 on the paper's V100 + 30 Gbps spec (HardwareSpec."
              f"cloud_v100_30gbps), modelled overlap {r['overlap_frac_modeled']:.3f}; "
              f"measured CCR on the card {r['measured_ccr']:.5f} -> I="
              f"{r['measured_interval']}, achieved overlap {r['overlap_frac_achieved']} "
              f"({smi})", flush=True)
    print(f"[adaptive] api.tune(measured=True) at full width took {tune_s:.1f} s",
          flush=True)
    return total


def state_bytes(state) -> int:
    parts = state_parts(state)
    return sum(x.numel() * x.element_size() for leaves in parts.values() for x in leaves)


def phase_resilience(cfg, group, smi: str) -> tuple[dict, int]:
    """The resilience runtime at full width in the one-rank NCCL group:

    1. guards armed, no faults (``guards=True``: ``sync_every=4``, the
       residual watchdog every 8 steps), 5 steps on the defaults over the
       batches of an unguarded run: params, m, v and residuals
       ``torch.equal``; steps 1-4 in ms beside the unguarded run's, peak
       memory, the rollback copies' bytes, and one copy's and one
       residual norm's device ms;
    2. the chaos gate's scenario (``launch.chaos_gate.run_chaos``: covap
       I=2, ``FAULT_SPEC``, the gate's ``GuardConfig``) at full width: every
       rung taken, ``kill`` -> restore -> resume once, ``final_step`` 20, a
       finite loss, events valid and 1:1 with the counters, the gate's pass
       rule; ``ef_update`` launched on every segment of each step run,
       replays and the loss step included;
    3. the plane guard: one full-width step's arena planes (``arena=True``,
       ``pack_ef_cast``), one ``grad_nan`` from ``corrupt_planes``, and
       ``plane_nonfinite_counts`` finds exactly one non-finite element.
    -> (``ef_update``'s launches by run, ``pack_ef_cast``'s launches)."""
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.core.stages import StepSync
    from repro_torch.launch import chaos_gate
    from repro_torch.resilience import (ResilienceRuntime, corrupt_planes,
                                        plane_nonfinite_counts)
    from repro_torch.resilience.guards import residual_leaves, residual_norm_async
    from repro_torch.train import loss_and_grads

    t_phase = time.perf_counter()
    batches = ckpt_batches(cfg)
    launches = {}

    # 1. guards without faults: the run is unchanged
    runs = {}
    for label in ("unguarded", "guarded"):
        gc.collect()
        torch.cuda.empty_cache()
        counters = zero_counters()
        tr, state = fresh_trainer(cfg, group)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        rt = ResilienceRuntime(tr, guards=True) if label == "guarded" else None
        state = tr.run(state, iter(batches), steps=STEPS, log=None, guards=rt)
        torch.cuda.synchronize()
        hist = tr.history
        runs[label] = dict(
            parts=state_parts(state), losses=[h["loss"] for h in hist],
            ms=[1e3 * (b["wall_s"] - a["wall_s"]) for a, b in zip(hist, hist[1:])],
            peak=torch.cuda.max_memory_allocated() / 2**30, base=base,
            counts={k: fn.launches for k, fn in counters.items()})
        segs = tr.plan.num_segments
        check(runs[label]["counts"] == launch_counts(ef_update=STEPS * segs),
              f"resilience {label}: launches {runs[label]['counts']}, want ef_update "
              f"{STEPS * segs}")
        if rt is not None:
            check(rt.summary()["trips"] == 0 and rt._win.step == 4
                  and rt._prev_win.step == 0,
                  f"resilience guarded: summary {rt.summary()}, windows "
                  f"{rt._win.step}, {rt._prev_win.step}")
            snap_bytes, one = rt.snapshot_bytes, state_bytes(state)
            check(snap_bytes == 2 * one, f"resilience: rollback copies hold {snap_bytes} "
                  f"B, the state {one} B")
            copy_ms = device_timed(lambda: rt._slots[0].fill(state, tr), reps=5, warmup=1)
            leaves = residual_leaves(state["comp"])
            norm_ms = device_timed(lambda: residual_norm_async(leaves), reps=10)
        launches[f"resilience {label}"] = runs[label]["counts"]["ef_update"]
        del tr, state, rt
    got, want = runs["guarded"], runs["unguarded"]
    for part in want["parts"]:
        check(all(torch.equal(a, b) for a, b in zip(got["parts"][part], want["parts"][part])),
              f"resilience: guards changed the {part}")
    check(got["losses"] == want["losses"], f"resilience: losses {got['losses']} "
          f"guarded, {want['losses']} unguarded")
    print(f"[resilience] guards=True (sync_every 4, residual watchdog every 8 steps), "
          f"no faults, {STEPS} steps on the defaults: params, m, v, residuals "
          f"torch.equal to the unguarded run; steps 1-{STEPS - 1} ms "
          f"{[round(v, 2) for v in got['ms']]} guarded vs "
          f"{[round(v, 2) for v in want['ms']]} unguarded; peak {got['peak']:.2f} GiB "
          f"({got['base']:.2f} held before the run, the unguarded run's clones "
          f"included) vs {want['peak']:.2f} GiB ({want['base']:.2f} held before): "
          f"{got['peak'] - got['base']:.2f} vs {want['peak'] - want['base']:.2f} GiB "
          f"above the run's start; rollback "
          f"copies {snap_bytes} B (2 x {one} B); one copy {copy_ms:.3f} device ms, one "
          f"residual norm {norm_ms:.3f} device ms ({smi})", flush=True)
    runs.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the chaos gate's scenario at full width
    counters = zero_counters()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as td:
        t0 = time.perf_counter()
        out = chaos_gate.run_chaos(td, cfg, device="cuda", group=group)
        torch.cuda.synchronize()
        chaos_s = time.perf_counter() - t0
        ck = f"{td}/ck"
        last = checkpoint.latest_step(ck)
        t0 = time.perf_counter()
        checkpoint.verify(ck, last)
        verify_s = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in counters.items()}
    tr = out.pop("trainer")
    segs2 = tr.plan.num_segments
    want_ef = (out["steps_run"] + 1) * segs2            # the loss step included
    s = out["summary"]
    ok = chaos_gate.passed(out)
    check(ok, f"resilience chaos: the gate failed: {chaos_gate.chaos_line(out, ok)}, "
          f"{s}, events {out['events']}, counters {out['counters']}")
    check(counts == launch_counts(ef_update=want_ef),
          f"resilience chaos: launches {counts}; {out['steps_run']} steps run + the loss "
          f"step on {segs2} segments: ef_update {want_ef}")
    launches["resilience chaos"] = counts["ef_update"]
    timings = out["timings"]
    print(f"[resilience] chaos gate at full width ({cfg.name}, covap I={tr.tc.interval}, "
          f"{segs2} segments, seq 1024 x batch 8, spec {chaos_gate.FAULT_SPEC}): "
          f"{chaos_gate.chaos_line(out, ok)}; final step {out['final_step']}, "
          f"{out['steps_run']} steps run; trips {s['trips_by_guard']} at "
          f"{out['trips']}; actions {[(a['step'], a['action']) for a in out['actions']]}; "
          f"faults fired {s['faults']['by_kind']}; guard-owned saves "
          f"{[round(v, 3) for v in timings['save']]} s, rewind restores "
          f"{[round(v, 3) for v in timings['restore']]} s, kill restore "
          f"{out['resume_s']:.3f} s, verify of step {last} {verify_s:.3f} s; the "
          f"scenario took {chaos_s:.1f} s; launches {counts} ({smi})", flush=True)
    del tr, out
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the plane guard on one full-width step's arena planes
    counters = zero_counters()
    tr, state = fresh_trainer(cfg, group, {"arena": True})
    grads, _ = loss_and_grads(tr.model, state["params"], batches[0], group)
    sync = StepSync(tr.compressor, tr._phase_fn(0).comm_schedule, grads, state["comp"],
                    step=0, group=group)
    for b in sync.todo():
        sync.start(b, sync.grad_slices(b, grads))
        sync.finish(b)
    planes = sync.planes
    clean = plane_nonfinite_counts(planes)
    _, sites = corrupt_planes(planes, "grad_nan", seed=0, step=0)
    counts_nf = plane_nonfinite_counts(planes)
    plane_ms = device_timed(lambda: plane_nonfinite_counts(planes), reps=10)
    pack = {k: fn.launches for k, fn in counters.items()}
    check(sum(clean) == 0 and sum(counts_nf) == 1 and counts_nf[sites[0][0]] == 1,
          f"resilience plane guard: counts {clean} clean, {counts_nf} after one NaN at "
          f"{sites}")
    check(pack == launch_counts(pack_ef_cast=tr.plan.num_segments),
          f"resilience plane guard: launches {pack}")
    print(f"[resilience] plane guard: one full-width step's arena planes "
          f"({[p.numel() for p in planes]} elements, {[str(p.dtype) for p in planes]}); "
          f"one grad_nan at (plane, index) {sites[0]} -> plane_nonfinite_counts "
          f"{counts_nf}; the call (one reduction per plane, one transfer) "
          f"{plane_ms:.3f} device ms; launches {pack} ({smi})", flush=True)
    del tr, state, grads, sync, planes
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[resilience] phase took {time.perf_counter() - t_phase:.1f} s ({smi})",
          flush=True)
    return launches, pack["pack_ef_cast"]


# [families]: (label, arch, depth cut or None for the full config, steps,
# TrainConfig options, AdamW's moment dtype, segments a step in the
# reference's plan).  deepseek's 2 layers hold 1.6 B f32 parameters: the
# functional AdamW keeps the old and the new m and v beside the params,
# the old and new residuals, the synced gradients and the updates.  With
# f32 moments a card run ran out of memory in the update (72.75 GiB
# allocated, 1.38 more asked, of 79.18); bf16 moments (the
# ``moment_dtype`` option) take 12.8 GB off
FAMILY_RUNS = (
    ("qwen", "qwen1.5-0.5b", None, 5, {}, None, 114),
    ("qwen arena+sharded", "qwen1.5-0.5b", None, 5,
     {"arena": True, "sync": "sharded"}, None, 114),
    ("deepseek 2L", "deepseek-moe-16b", 2, 3, {}, "bfloat16", 77),
    ("gemma 2L", "gemma-2b", 2, 3, {}, None, 135),
    ("mistral 1L", "mistral-large-123b", 1, 3, {}, None, 74),
    ("xlstm", "xlstm-125m", None, 3, {}, None, 77),
    ("zamba2 12L", "zamba2-2.7b", 12, 3, {}, None, 209),
    ("zamba2 12L arena+sharded", "zamba2-2.7b", 12, 3,
     {"arena": True, "sync": "sharded"}, None, 209),
    ("zamba2 12L fused", "zamba2-2.7b", 12, 3, {"overlap": "fused"}, None, 209),
    ("seamless", "seamless-m4t-medium", None, 3, {}, None, 181),
    ("seamless arena+sharded", "seamless-m4t-medium", None, 3,
     {"arena": True, "sync": "sharded"}, None, 181),
    ("seamless fused", "seamless-m4t-medium", None, 3, {"overlap": "fused"}, None, 181),
    ("pixtral 1L", "pixtral-12b", 1, 3, {}, "bfloat16", 129),
)
# a run's (seq_len, global_batch) where it is not (1024, 8): the mLSTM's
# backward pass keeps its (B, 4, 384, 384) f32 state for every token (2.4
# MB a sequence a token), and a checkpointed xlstm superblock recomputes
# three mLSTM layers at once.  On an NVIDIA H100 80GB HBM3 (700 W) batch 8
# ran out of memory at 76.52 GiB allocated; batch 7 peaked at 71.65 GiB,
# batch 6 at 62.74.  pixtral's rows are 256 patch embeddings and 768 text
# tokens (1024 positions); seamless's 1024 frames and 1024 text tokens
FAMILY_SHAPES = {"xlstm": (1024, 7), "pixtral 1L": (768, 8)}
# a run held bit for bit against an earlier run of the list
FAMILY_PARITY = {"qwen arena+sharded": "qwen", "zamba2 12L arena+sharded": "zamba2 12L",
                 "zamba2 12L fused": "zamba2 12L", "seamless arena+sharded": "seamless",
                 "seamless fused": "seamless"}


def f32_segments(plan) -> int:
    """The segments whose gradient is float32: where the EF kernels engage
    (``core.stages`` ``_use_ef_kernel``/``_use_pack_kernel`` take f32
    operands, the reference's own dtype rule)."""
    return sum(1 for b in plan.buckets for seg in b.segments
               if plan.leaf_dtypes[seg.leaf_idx] == torch.float32)


def moe_drops(tr, batch) -> list[tuple[int, int, int]]:
    """One no-grad forward of ``batch`` with the card's slot map
    (``moe.moe_dispatch``) observed: ``(kept, assignments, capacity)`` for
    each MoE block, in order."""
    from repro_torch.models import moe

    seen, slot_map = [], moe.moe_dispatch

    def observe(top_e, first_expert, num_experts, C):
        slot, keep, src = slot_map(top_e, first_expert, num_experts, C)
        seen.append((int(keep.sum()), keep.numel(), C))
        return slot, keep, src

    moe.moe_dispatch = observe
    try:
        with torch.no_grad():
            tr.model.loss_fn(batch)
    finally:
        moe.moe_dispatch = slot_map
    return seen


def family_ef_parity(tr, state, loader, group) -> float:
    """One step from the trained state on the same gradients, the
    ``ef_update`` kernel against ``use_ef_kernel=False``: params and
    residuals within ``ef_close``.  Returns the max |diff|."""
    from repro_torch.core import get_compressor
    from repro_torch.train import build_step_fn, loss_and_grads

    batch = loader.make(state["step"])
    phase = state["step"] % tr.num_phases
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    out = {}
    for name, opts in (("kernel", {}), ("plain", {"use_ef_kernel": False})):
        comp = get_compressor("covap", interval=tr.tc.interval, **opts)
        fn = build_step_fn(tr.model, tr.optimizer, comp, tr.plan, phase=phase,
                           group=group)
        new_state, _ = fn.update(clone_tree(state), grads)
        out[name] = new_state["params"] + new_state["comp"]
        del new_state
    del grads
    c = get_compressor("covap", interval=tr.tc.interval).ef_coefficient(state["step"])
    worst = 0.0
    for a, b, r in zip(out["kernel"], out["plain"], state["comp"] + state["comp"]):
        check(ef_close(a, b, r, c), "families: ef_update kernel and plain disagree")
        worst = max(worst, abs_err(a, b))
    return worst


def projector_grad_norm(tr, batch) -> float:
    """One forward and backward of ``batch`` with only ``projector.w``
    requiring a gradient (no other leaf's gradient is made): the norm of
    the projector's gradient."""
    leaves = dict(tr.model.named_leaves())
    proj = leaves["projector.w"]
    flags = {n: p.requires_grad for n, p in leaves.items()}
    for n, p in leaves.items():
        p.requires_grad_(n == "projector.w")
    try:
        total, _ = tr.model.loss_fn(batch)
        total.backward()
        return float(proj.grad.float().norm())
    finally:
        proj.grad = None
        for n, p in leaves.items():
            p.requires_grad_(flags[n])


def phase_families(group, smi: str) -> dict:
    """The dense, MoE, SSM, hybrid, audio (encoder-decoder) and VLM
    families at full width (``FAMILY_RUNS``, one-rank NCCL group, seq 1024,
    global batch 8 unless ``FAMILY_SHAPES`` cuts it, COVAP I=4 with
    AdamW; the frontend families' batches carry their stub embeddings):
    each run's EF kernel launches equal its plan's f32 segments x steps,
    the plan's segments equal the reference's, its losses are finite; each
    run of ``FAMILY_PARITY`` equals its post run bit for bit.  Returns the
    EF kernel's launches by run label, and ``moe_dispatch``'s by MoE run."""
    from repro_torch.configs import get_config
    from repro_torch.core import get_compressor
    from repro_torch.models import moe, padded_vocab
    from repro_torch.models.transformer import has_shared_block, superblock_kinds

    t_phase = time.perf_counter()
    launches_by_run, moe_by_run, post = {}, {}, {}
    for i, (label, arch, layers, steps, options, moments, want_segs) in enumerate(
            FAMILY_RUNS):
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.with_(num_layers=layers)
        seq_len, batch = FAMILY_SHAPES.get(label, (1024, 8))
        tr, state, loader, launches = phase_train(cfg, group=group, label=label,
                                                  options=options, steps=steps,
                                                  moment_dtype=moments,
                                                  seq_len=seq_len, global_batch=batch)
        plan = tr.plan
        check(plan.num_segments == want_segs,
              f"{label}: {plan.num_segments} segments, the reference's plan has "
              f"{want_segs}")
        kernel = "pack_ef_cast" if options.get("arena") else "ef_update"
        n = f32_segments(plan)
        check(launches == launch_counts(**{kernel: steps * n},
                                        moe_dispatch=moe_launches(cfg, steps)),
              f"{label}: launches {launches} in {steps} steps; {n} f32 segments")
        launches_by_run[label] = launches[kernel]
        if cfg.is_moe:
            moe_by_run[label] = launches["moe_dispatch"]
        bytes_w8 = [get_compressor("covap", interval=4).plan_phase(plan, p, world=8)
                    .bytes_per_worker for p in range(4)]
        ms, tok_s, peak = tr.run_stats
        full = get_config(arch)
        cut = (f"{cfg.num_layers} of {full.num_layers} layers"
               if cfg.num_layers != full.num_layers else "its full config")
        if cfg.family == "vlm":
            cut += (f", {cfg.frontend_tokens} patch embeddings + {seq_len} text tokens a "
                    f"row x global batch {batch}")
        elif cfg.is_encdec:
            cut += (f" ({cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers), "
                    f"{cfg.frontend_tokens} frames + {seq_len} text tokens a row x global "
                    f"batch {batch}")
        elif (seq_len, batch) != (1024, 8):
            cut += f", seq {seq_len} x global batch {batch} (cut from 1024 x 8)"
        print(f"[families] {label}: {arch} at full width, {cut}, "
              f"{sum(p.numel() for p in state['params'])} params, state "
              f"{state_bytes(state)} B (params, m, v, residuals); COVAP bytes per "
              f"worker at W=8, phases 0-3: {bytes_w8}; step ms {[round(v, 2) for v in ms]}, "
              f"{tok_s:.0f} tok/s, peak {peak:.2f} GiB; {kernel} {launches[kernel]} "
              f"launches ({n} f32 segments x {steps} steps) ({smi})", flush=True)
        losses = [h["loss"] for h in tr.history]
        if label == "qwen":
            worst = family_ef_parity(tr, state, loader, group)
            print(f"[families] qwen: one step on the same gradients, ef_update "
                  f"kernel vs use_ef_kernel=False within ef_close (max |diff| "
                  f"{worst:.3g})", flush=True)
        if label in FAMILY_PARITY.values():
            # held on the host: zamba2's four f32 parts take 12 GB
            post[label] = (tr.history, host_parts(state))
        elif label in FAMILY_PARITY:
            base = FAMILY_PARITY[label]
            hist, want = post[base]
            if base not in (FAMILY_PARITY.get(r[0]) for r in FAMILY_RUNS[i + 1:]):
                del post[base]
            check([h["total_loss"] for h in tr.history] == [h["total_loss"] for h in hist],
                  f"{label}: losses {losses} differ from the post run's")
            got = state_parts(state, clone=False)
            for part in ("params", "m", "v", "residual"):
                same = [torch.equal(a.cpu(), b) for a, b in zip(got[part], want[part])]
                diff = 0.0 if all(same) else max(
                    abs_err(a.cpu(), b) for a, b in zip(got[part], want[part]))
                check(all(same), f"{label}: {part} differ from the post run's "
                      f"(max |diff| {diff})")
            fused = (f"; {check_fused_run(tr, label)}"
                     if options.get("overlap") == "fused" else "")
            print(f"[families] {label} == {base} (post, ef_update) after {steps} "
                  f"steps on the same batches, bit for bit in losses, params, m, v "
                  f"and residuals{fused}", flush=True)
            del got, want
        if label == "xlstm":
            kinds = [k for k, _ in superblock_kinds(cfg)]
            print(f"[families] {label}: superblock {kinds} x {tr.model.num_stages}, "
                  f"mLSTM head dim {2 * cfg.d_model // cfg.num_heads}; losses "
                  f"{losses}", flush=True)
        elif label == "zamba2 12L":
            check(has_shared_block(cfg) and tr.model.num_stages == 2,
                  f"{label}: {tr.model.num_stages} superblocks")
            print(f"[families] {label}: {cfg.attn_every} Mamba2 blocks a superblock x "
                  f"{tr.model.num_stages}, the weight-shared attention block applied "
                  f"after each ({tr.model.num_stages} applications, one set of "
                  f"weights); losses {losses}", flush=True)
        elif label.startswith("deepseek"):
            drops = moe_drops(tr, loader.make(steps))
            k, E = cfg.experts_per_token, cfg.num_experts
            C = moe.capacity(cfg, 8 * 1024)
            check(all(c == C for *_, c in drops) and len(drops) == cfg.num_layers,
                  f"{label}: capacities {drops}")
            share = [round(1 - kept / total, 6) for kept, total, _ in drops]
            aux = [round(h["aux_loss"], 6) for h in tr.history]
            check(all(math.isfinite(a) and a > 0 for a in aux), f"{label}: aux {aux}")
            print(f"[families] {label}: aux_loss {aux}; C = {C} at N = 8192, k = {k}, "
                  f"E = {E}, cf {cfg.moe_capacity_factor}; dropped share by layer "
                  f"on batch {steps}: {share}", flush=True)
        elif label.startswith("gemma"):
            print(f"[families] {label}: MQA kv heads {cfg.num_kv_heads} of "
                  f"{cfg.num_heads}, head_dim {cfg.head_dim}, {cfg.mlp_act}, vocab "
                  f"{cfg.vocab_size} (padded {padded_vocab(cfg)}) in "
                  f"{1024 // cfg.xent_chunk} xent chunks; losses {losses}", flush=True)
        elif label == "seamless":
            check(tr.model.num_stages == cfg.encoder_layers + cfg.num_layers,
                  f"{label}: {tr.model.num_stages} stages")
            print(f"[families] {label}: encoder {cfg.encoder_layers} L (bidirectional) + "
                  f"decoder {cfg.num_layers} L (causal, cross-attention to the memory, "
                  f"its K/V projected in every layer), {cfg.mlp_act}, vocab "
                  f"{cfg.vocab_size} (padded {padded_vocab(cfg)}), frames std-0.02 "
                  f"normals from numpy seed 0; {tr.model.num_stages} stages; losses "
                  f"{losses}", flush=True)
        elif label.startswith("pixtral"):
            dts = {p.dtype for p in state["params"]}
            mdts = {m.dtype for m in state["opt"]["m"] + state["opt"]["v"]}
            check(dts == {torch.float32} and mdts == {torch.bfloat16},
                  f"{label}: params {dts}, moments {mdts}")
            check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
            gnorm = projector_grad_norm(tr, loader.make(steps))
            check(math.isfinite(gnorm) and gnorm > 0,
                  f"{label}: projector gradient norm {gnorm}")
            print(f"[families] {label}: f32 params, bf16 Adam moments; the "
                  f"{cfg.frontend_tokens} patch embeddings (std-0.02 normals from numpy "
                  f"seed 0) projected by projector.w ({cfg.d_model} x {cfg.d_model}) and "
                  f"prepended, labels padded with -1 over them; losses {losses} finite "
                  f"and falling; projector gradient norm on batch {steps}: {gnorm:.6g}",
                  flush=True)
        elif label.startswith("mistral"):
            dts = {p.dtype for p in state["params"]}
            mdts = {m.dtype for m in state["opt"]["m"] + state["opt"]["v"]}
            check(dts == mdts == {torch.bfloat16}, f"{label}: params {dts}, moments {mdts}")
            check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
            print(f"[families] {label}: bf16 params and moments; ef_update 0 "
                  f"launches: the gradients are bf16 and the EF kernel takes f32 "
                  f"operands (the reference's rule, core/stages.py _use_ef_kernel); "
                  f"losses {losses} finite and falling", flush=True)
        del tr, state, loader
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[families] phase took {time.perf_counter() - t_phase:.1f} s ({smi})",
          flush=True)
    return launches_by_run, moe_by_run


def phase_oktopk_parity(tr, state, loader, group) -> None:
    """On the same gradients and residuals, ``oktopk`` in the one-rank
    group against ``topk``: the synced values and the new residuals bit for
    bit, on every bucket whose compensated values hold at least k non-zero
    elements (the regional top-k of a one-rank group then keeps exactly the
    local top-k)."""
    from repro_torch.core import bucketing as bk
    from repro_torch.core import get_compressor
    from repro_torch.core.comm import world_size
    from repro_torch.train import loss_and_grads

    batch = loader.make(state["step"])
    grads, _ = loss_and_grads(tr.model, state["params"], batch, group)
    out = {}
    for name in ("topk", "oktopk"):
        comp = get_compressor(name)
        sched = comp.plan_phase(tr.plan, 0, world=world_size(group))
        synced, resid, _ = comp.execute(sched, grads, state["comp"], step=state["step"],
                                        group=group)
        out[name] = (synced, resid)
    torch.cuda.synchronize()
    t = [g + r for g, r in zip(grads, state["comp"])]
    eligible, diff = [], 0
    for b, bucket in enumerate(tr.plan.buckets):
        k = max(1, math.ceil(bucket.numel * 0.01))
        nz = sum(int((bk._slice_segment(t[s.leaf_idx], s) != 0).sum())
                 for s in bucket.segments)
        if nz < k:
            continue
        eligible.append(b)
        for part in (0, 1):
            for s in bucket.segments:
                a = bk._slice_segment(out["oktopk"][part][s.leaf_idx], s)
                w = bk._slice_segment(out["topk"][part][s.leaf_idx], s)
                if not torch.equal(a, w):
                    diff += 1
    check(diff == 0, f"parity oktopk: {diff} segments differ from topk")
    check(len(eligible) == tr.plan.num_buckets,
          f"parity oktopk: only buckets {eligible} hold k non-zero values")
    print(f"[parity] oktopk step {state['step']}, same gradients, one-rank NCCL group "
          f"(all-to-all and all-gather run): synced values and residuals == topk's "
          f"bit for bit on all {len(eligible)} buckets (each holds >= k non-zero "
          f"values)", flush=True)


def launch_cli_args(history_out: str) -> list[str]:
    """The ``[launch]`` CLI arguments: full-width gpt2-paper as
    :func:`phase_train` runs it (seq 1024, global batch 8, I = 4, AdamW's
    default schedule over ``STEPS`` steps, seed 0)."""
    return ["--arch", "gpt2-paper", "--steps", str(STEPS), "--seq-len", "1024",
            "--global-batch", "8", "--interval", "4", "--log-every", "1",
            "--history-out", history_out]


def phase_launch(cfg, group) -> int:
    """``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
    repro_torch.launch.train`` at full width in a one-rank NCCL group (the
    CLI joins it from the launcher's environment): its exit code, its
    ``[launch]`` and ``[done]`` lines, and its ``--history-out`` losses
    against an in-process run on the same seed and batches, bit for bit.
    The subprocess's own launch counts (its ``[kernels]`` line, counted from
    0 in a fresh process) must be ``ef_update`` once per segment a step.
    -> those launches."""
    import os
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as td:
        hist_path = os.path.join(td, "history.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
               *launch_cli_args(hist_path)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT,
                           timeout=600)
        secs = time.perf_counter() - t0
        check(r.returncode == 0, f"[launch] the launcher exited {r.returncode}: "
              f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        with open(hist_path) as f:
            hist = json.load(f)
    lines = {line.split("]")[0] + "]": line for line in r.stdout.splitlines()
             if line.startswith("[")}
    check("[launch] 1 rank(s), 1 pod(s) x 1, backend nccl" in lines.get("[launch]", ""),
          f"[launch] no one-rank NCCL group: {lines.get('[launch]')}")
    check(lines.get("[done]", "").startswith(f"[done] step {STEPS} ({STEPS} committed)"),
          f"[launch] {lines.get('[done]')}")
    counts = json.loads(lines["[kernels]"].split("launches ", 1)[1])
    tr, state = fresh_trainer(cfg, group, {"interval": 4})
    segs = tr.plan.num_segments
    leaves = len(state["params"])
    adamw = counts.pop("adamw_fused")
    check(adamw == STEPS * leaves, f"[launch] the launched run's adamw_fused launches "
          f"{adamw}; {leaves} leaves x {STEPS} steps")
    attn = counts.pop("causal_attn")
    check(attn == 5 * STEPS * cfg.num_layers, f"[launch] the launched run's causal_attn "
          f"launches {attn}; {cfg.num_layers} layers x {STEPS} steps x 5")
    check(counts == launch_counts(ef_update=STEPS * segs),
          f"[launch] the launched run's launches {counts}; the plan has {segs} segments")
    state = tr.run(state, iter(ckpt_batches(cfg)), steps=STEPS, log=None)
    want = [h["loss"] for h in tr.history]
    got = [h["loss"] for h in hist["history"]]
    check(got == want, f"[launch] history losses {got} != in-process {want}")
    check(hist["interval"] == 4 and sorted(hist) == ["config", "history", "interval"],
          f"[launch] history keys {sorted(hist)}, interval {hist['interval']}")
    walls = [h["wall_s"] for h in hist["history"]]
    step_ms = [round(1e3 * (b - a), 2) for a, b in zip(walls, walls[1:])]
    print(f"[launch] torch.distributed.run, 1 process, one-rank NCCL group: "
          f"{lines['[done]']}; steps 1-{STEPS - 1} ms {step_ms}; "
          f"{(STEPS - 1) * 8 * 1024 / (walls[-1] - walls[0]):.0f} tok/s after step 0; "
          f"losses {got} == the in-process run's, bit for bit; launches {counts}, "
          f"adamw_fused {adamw}, causal_attn {attn}; "
          f"the command took {secs:.1f} s", flush=True)
    del tr, state
    torch.cuda.empty_cache()
    return counts["ef_update"]


# [pods]: the hierarchical step's forms, each beside its flat run, and the
# pod interval (phases: lcm(4, 2) = 4)
POD_INTERVAL = 2
POD_RUNS = (
    ("post", {}, "ef_update"),
    ("sharded+arena", {"sync": "sharded", "arena": True}, "pack_ef_cast"),
)


def phase_pods(cfg, group) -> dict:
    """Hierarchical pods at full width (``pod_interval=2``) with a one-rank
    intra-pod and a one-rank cross-pod NCCL group, on the post form and on
    sharded+arena: 5 steps each equal the flat run of the same form on the
    same batches bit for bit (params, Adam's m and v, residuals, losses):
    with one pod the reconcile is a pack -> slice -> exchange -> unpack
    round trip.  One reconcile's device ms and bytes are timed, and the
    full-width plan's bytes per link are printed for every phase at 2 pods
    x 8 workers.  -> each form's kernel launches."""
    import torch.distributed as dist

    from repro_torch.core import get_compressor
    from repro_torch.train import hierarchical_schedules, pod_reconcile

    intra, pods = dist.new_group([0]), dist.new_group([0])
    batches = ckpt_batches(cfg)
    out = {}
    for label, options, kernel in POD_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        tr, state = fresh_trainer(cfg, group, options)
        state = tr.run(state, iter(batches), steps=STEPS, log=None)
        want, want_losses = state_parts(state), [h["loss"] for h in tr.history]
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
        tr, state = fresh_trainer(cfg, intra, dict(options, pod_interval=POD_INTERVAL),
                                  pod_group=pods)
        check(tr.hierarchical and tr.num_phases == 4 and tr.n_pods == 1,
              f"pods {label}: hierarchical {tr.hierarchical}, {tr.num_phases} phases")
        counters = zero_counters()
        state = tr.run(state, iter(batches), steps=STEPS, log=None)
        counts = {k: fn.launches for k, fn in counters.items()}
        segs = tr.plan.num_segments
        check(counts == launch_counts(**{kernel: STEPS * segs}),
              f"pods {label}: launches {counts}; the plan has {segs} segments")
        got, losses = state_parts(state), [h["loss"] for h in tr.history]
        check(losses == want_losses, f"pods {label}: losses {losses} != flat {want_losses}")
        for part in ("params", "m", "v", "residual"):
            check(len(got[part]) == len(want[part]) and all(
                torch.equal(a, b) for a, b in zip(got[part], want[part])),
                f"pods {label}: {part} differs from the flat run")
        fn = tr._phase_fn(0)
        sched = fn.pod_schedule
        ms = device_timed(lambda: pod_reconcile(state["params"], sched, group=intra,
                                                pod_group=pods, owned_only=tr.sharded,
                                                layout=fn.pod_layout))
        check(all(torch.equal(a, b) for a, b in zip(state["params"], got["params"])),
              f"pods {label}: the timed reconciles changed the params")
        nbytes = sched.bytes_per_worker
        # pack reads the params and writes the planes, the exchange reads and
        # writes them, the unpack reads them and writes the params
        print(f"[pods] {label}: pod_interval {POD_INTERVAL}, 1 pod x 1, "
              f"{tr.num_phases} phases; 5 steps == the flat run bit for bit (params, "
              f"m, v, residuals, losses {[round(v, 4) for v in losses]}); launches "
              f"{counts}; one reconcile (phase 0, {len(sched.selected)} of "
              f"{tr.plan.num_buckets} buckets, {nbytes} B exchanged) {ms:.3f} device ms, "
              f"{6 * nbytes / (ms * 1e-3) / 1e12:.2f} TB/s of pack + exchange + "
              f"unpack traffic", flush=True)
        out[f"pods {label}"] = counts[kernel]
        plan = tr.plan
        del tr, state, got, want
        torch.cuda.empty_cache()
    for sync in ("allreduce", "sharded"):
        comp = get_compressor("covap", interval=4, **({"sync": sync} if sync != "allreduce"
                                                      else {}))
        scheds = hierarchical_schedules(comp, plan, pod_interval=POD_INTERVAL, sync=sync,
                                        intra_world=8, n_pods=2)
        rows = [f"phase {s.phase}: exposed {s.exposed_bytes_by_link()}"
                + (f" deferred {s.deferred_bytes_by_link()}" if s.deferred_calls else "")
                for s in scheds]
        print(f"[pods] full-width plan at 2 pods x 8, {sync}, bytes per worker by "
              f"link: {'; '.join(rows)}", flush=True)
    return out


def phase_small() -> None:
    """REDUCED gpt2-paper on the card against the port on the CPU, on the
    defaults, with ``arena=True`` and with ``powersgd`` (whose Q is drawn on
    the CPU for both, and held up to QR's column signs)."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import DataConfig, make_loader
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_reduced("gpt2-paper")
    init = build_model(cfg, device="cpu", seed=3).state_dict()
    counters = kernel_counters()
    for label, opts, kernel in (("defaults", {}, "ef_update"),
                                ("arena", {"arena": True}, "pack_ef_cast"),
                                ("powersgd", {"compressor": "powersgd"}, MATMUL)):
        out = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            model.load_state_dict(init)
            tr = Trainer(model, sgd(1e-2, momentum=0.9),
                         TrainConfig(bucket_bytes=1 << 14, max_buckets=32,
                                     steps=STEPS, log_every=1, **opts))
            loader = make_loader(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                            global_batch=4, corpus_tokens=1 << 14),
                                 device=dev)
            before = {k: f.launches for k, f in counters.items()}
            state = tr.run(tr.init_state(), loader, log=None)
            resid, qs = comp_parts(state["comp"])
            out[dev] = ([h["loss"] for h in tr.history],
                        [p.detach().cpu() for p in state["params"]],
                        [r.cpu() for r in resid], [q.cpu() for q in qs],
                        {k: f.launches - before[k] for k, f in counters.items()})
        (l_cpu, p_cpu, r_cpu, q_cpu, n_cpu) = out["cpu"]
        (l_gpu, p_gpu, r_gpu, q_gpu, n_gpu) = out["cuda"]
        per_step = (3 * len(lowrank_leaves(tr.plan)) if kernel == MATMUL
                    else tr.plan.num_segments)
        check(n_cpu == launch_counts() and n_gpu == launch_counts(**{kernel: STEPS * per_step}),
              f"small {label}: launches cpu {n_cpu}, cuda {n_gpu}")
        check(all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(l_gpu, l_cpu)),
              f"small {label}: losses cuda {l_gpu} vs cpu {l_cpu}")
        worst = 0.0
        for a, b in zip(p_gpu, p_cpu):
            check(torch.allclose(a, b, rtol=1e-4, atol=1e-6),
                  f"small {label}: params differ between cuda and cpu (max |diff| "
                  f"{abs_err(a, b):.3g})")
            worst = max(worst, abs_err(a, b))
        if label != "powersgd":
            for a, b in zip(r_gpu, r_cpu):
                check(torch.allclose(a, b, rtol=1e-4, atol=1e-6),
                      f"small {label}: EF residuals differ between cuda and cpu")
                worst = max(worst, abs_err(a, b))
            how = "params and EF residuals at rtol 1e-4, atol 1e-6"
        else:
            # the warm-started Q carries last-bit differences from step to
            # step: residuals and Q (up to QR's column signs) are held as the
            # tests hold the port against the reference, rtol 1e-4 and atol
            # 1e-4 of the part's largest value
            for part, (got, want) in (("residual", (r_gpu, r_cpu)),
                                      ("Q", ([sign_aligned(a, b) for a, b in zip(q_gpu, q_cpu)],
                                             q_cpu))):
                scale = max(float(b.abs().max()) for b in want)
                rel = max(abs_err(a, b) for a, b in zip(got, want)) / scale
                check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-4 * scale)
                          for a, b in zip(got, want)),
                      f"small powersgd: {part} differs between cuda and cpu "
                      f"(max |diff| {rel:.3g} of the largest)")
                worst = max(worst, rel)
            how = ("params at rtol 1e-4, atol 1e-6; residuals and Q (up to column "
                   "signs) at rtol 1e-4, atol 1e-4 of the part's largest; max |diff| "
                   "of params, or relative to the part's largest")
        print(f"[small] {label}: REDUCED, sgd, 5 steps: cuda losses "
              f"{[round(v, 5) for v in l_gpu]} match the cpu run (rtol 1e-4); "
              f"{how}: {worst:.3g}; {kernel} launches {n_gpu[kernel]}", flush=True)


# bfloat16 parameters round every step: the card's and the CPU's last-bit
# gradient differences can move a value one bf16 ulp a step (the tests'
# bound against the reference): 2 ulps relative, 1 ulp of the leaf's
# largest magnitude absolute
BF16_RTOL, BF16_ULP = 2.0 ** -6, 2.0 ** -7


def phase_small_families() -> None:
    """The eleven assigned archs' REDUCED configs (moonlight-16b-a3b's among
    them; and grok-1-314b's with bfloat16 parameters, whose f32 router
    shares buckets with bf16 experts) on the card against the port on the
    CPU: 5 SGD steps on the defaults from the same parameters and batches
    (pixtral's with patch embeddings, seamless's with frames); ``ef_update``
    once per f32 segment a step on the card, never on the CPU."""
    from repro_torch.configs import get_reduced, list_archs
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.train import TrainConfig, Trainer

    counters = kernel_counters()
    cases = [(a, get_reduced(a)) for a in list_archs(assigned_only=True)]
    cases.append(("grok-1-314b bf16",
                  get_reduced("grok-1-314b").with_(param_dtype="bfloat16")))
    for label, cfg in cases:
        bf16 = cfg.param_dtype == "bfloat16"
        init = build_model(cfg, device="cpu", seed=3).state_dict()
        out = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            model.load_state_dict(init)
            tr = Trainer(model, sgd(1e-2, momentum=0.9),
                         TrainConfig(bucket_bytes=1 << 14, max_buckets=32,
                                     steps=STEPS, log_every=1))
            loader = train_loader(cfg, seq_len=32, global_batch=4, device=dev,
                                  corpus_tokens=1 << 14)
            before = {k: f.launches for k, f in counters.items()}
            state = tr.run(tr.init_state(), loader, log=None)
            out[dev] = ([h["total_loss"] for h in tr.history],
                        [p.detach().cpu() for p in state["params"]]
                        + [r.cpu() for r in state["comp"]],
                        {k: f.launches - before[k] for k, f in counters.items()})
        (l_cpu, x_cpu, n_cpu), (l_gpu, x_gpu, n_gpu) = out["cpu"], out["cuda"]
        n, m = STEPS * f32_segments(tr.plan), moe_launches(cfg, STEPS)
        check(n_cpu == launch_counts() and n_gpu == launch_counts(ef_update=n,
                                                                  moe_dispatch=m),
              f"small {label}: launches cpu {n_cpu}, cuda {n_gpu}, want ef_update {n}, "
              f"moe_dispatch {m}")
        check(all(math.isclose(a, b, rel_tol=1e-3 if bf16 else 1e-4)
                  for a, b in zip(l_gpu, l_cpu)),
              f"small {label}: losses cuda {l_gpu} vs cpu {l_cpu}")
        worst = 0.0
        for a, b in zip(x_gpu, x_cpu):
            check(a.dtype == b.dtype, f"small {label}: dtypes {a.dtype} vs {b.dtype}")
            if bf16:
                a, b = a.float(), b.float()
                ok = torch.allclose(a, b, rtol=BF16_RTOL,
                                    atol=BF16_ULP * float(b.abs().max()))
            else:
                ok = torch.allclose(a, b, rtol=1e-4, atol=1e-6)
            check(ok, f"small {label}: params or residuals differ between cuda and "
                  f"cpu (max |diff| {abs_err(a, b):.3g})")
            worst = max(worst, abs_err(a, b))
        how = ("losses at rtol 1e-3; params and residuals at rtol 2^-6, atol 2^-7 "
               "of the leaf's largest" if bf16 else
               "losses at rtol 1e-4; params and residuals at rtol 1e-4, atol 1e-6")
        print(f"[small] {label}: REDUCED, sgd, {STEPS} steps: cuda losses "
              f"{[round(v, 5) for v in l_gpu]} match the cpu run, {how}: max "
              f"|diff| {worst:.3g}; ef_update launches {n_gpu['ef_update']}, "
              f"moe_dispatch {n_gpu['moe_dispatch']}", flush=True)


# [serve]: continuous batching at full width (no kernel lies on this path)
SERVE_CONFIG = dict(batch_slots=8, max_len=1024, page_size=16, prefill_chunk=16,
                    max_new_tokens=64)
SERVE_CHECK_STEPS = 3
SERVE_CHECK_PROMPT = 32          # the paged == dense check's prompts: at most 2 pages
SERVE_SLEEP_CYCLES = 100_000_000  # outlasts the enqueue of a full-width decode step
SMALL_SERVE_PROMPTS = [[5, 17, 3, 9], [88, 2], [1, 1, 1, 1, 1, 1, 1], [4, 40, 14]]
SMALL_SERVE_CONFIG = dict(batch_slots=3, max_len=48, max_new_tokens=4, page_size=8,
                          prefill_chunk=4)
SMALL_SERVE_ATOL = 1e-4   # REDUCED logits, f32, card against the CPU
# the recurrent archs served at their full configs, the prompt length of
# their paged == dense check, and the sleep ahead of a timed call: a
# full-width zamba2 decode step takes 54-58 host ms to enqueue (54 Mamba2
# blocks and 9 shared-block applications), longer than
# SERVE_SLEEP_CYCLES
SERVE_RECURRENT = (("xlstm-125m", SERVE_CHECK_PROMPT, SERVE_SLEEP_CYCLES),
                   ("zamba2-2.7b", 16, 5 * SERVE_SLEEP_CYCLES))
# the frontend families served at their full configs, the prompt length of
# their paged == dense check and the sleep ahead of a timed call (a
# full-width pixtral prefill token is one batch-1 decode step over 49.1 GB
# of f32 weights, 40 layers to enqueue)
SERVE_FRONTEND = (("seamless-m4t-medium", SERVE_CHECK_PROMPT, SERVE_SLEEP_CYCLES),
                  ("pixtral-12b", 16, 5 * SERVE_SLEEP_CYCLES))


def serve_prompts(n: int, lo: int, hi: int, vocab: int, seed: int = 0) -> list[list[int]]:
    """``n`` prompts of ``lo``-``hi`` tokens from numpy's ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def recording_sampler(log: list):
    """A greedy sampler that also appends every logits tensor it samples."""
    from repro_torch.serve import greedy_sample

    def sample(logits, generator=None, temperature=0.0):
        log.append(logits)
        return greedy_sample(logits, generator, temperature)

    return sample


def serve_paged_equals_dense(model, prompts: list[list[int]], label: str,
                             sleep_cycles: int = SERVE_SLEEP_CYCLES,
                             frames: list | None = None) -> None:
    """All ``batch_slots`` slots admitted at once, then ``SERVE_CHECK_STEPS``
    generate steps, beside a dense batch-8 cache built from the same
    prefills (each request's own batch-1 ``ChunkedPrefill``, concatenated
    on the batch axis) and stepped with ``decode_step``: the prefill
    logits, every generate step's logits and, after each step, the caches
    ``gather_caches`` reads through the page tables equal the dense ones,
    bit for bit.  An encoder-decoder model's requests carry ``frames``, one
    (1, T, d) tensor each; the dense prefill starts from their
    ``memory_kv`` as the engine's does, and the resident ``mem_k``/``mem_v``
    are held with the rest."""
    from repro_torch.serve import ChunkedPrefill, Engine, ServeConfig, gather_caches
    from repro_torch.serve.kv_arena import tree_flatten, tree_unflatten

    sc = ServeConfig(**SERVE_CONFIG)
    log: list = []
    eng = Engine(model, None, sc, sample=recording_sampler(log))
    check(len(prompts) == sc.batch_slots, f"[serve] {label}: {len(prompts)} prompts")
    prefill = ChunkedPrefill(model, sc.prefill_chunk)
    frames = frames or [None] * len(prompts)
    want_logits, parts = [], []
    for p, f in zip(prompts, frames):
        pc = model.init_caches(1, eng.layout.tokens)
        if f is not None:
            pc["mem_k"], pc["mem_v"] = model.memory_kv(None, f)
        logits, pc, _ = prefill(None, pc, p)
        want_logits.append(logits)
        parts.append(tree_flatten(pc))
    paths = parts[0][1]
    dense = tree_unflatten(paths, [torch.cat(leaves, dim=1)
                                   for leaves in zip(*(v for v, _ in parts))])
    for p, f in zip(prompts, frames):
        eng.submit(p, f)
    tokens = torch.tensor([[int(torch.argmax(l[0, 0]))] for l in want_logits], device="cuda")
    pos = torch.tensor([len(p) for p in prompts], device="cuda")
    for step in range(1 + SERVE_CHECK_STEPS):
        if step:
            tokens = torch.tensor([[s.tokens[-1]] for s in eng.sched.slots], device="cuda")
            pos = torch.tensor([s.pos for s in eng.sched.slots], device="cuda")
        check(len(eng.sched.active_slots) == len(prompts) or not step,
              f"[serve] {label}: {len(eng.sched.active_slots)} active slots")
        want, dense = model.decode_step(None, dense, {"tokens": tokens, "pos": pos})
        eng.step()
        if step == 0:
            prefills, log[:] = log[:len(prompts)], log[len(prompts):]
            check(all(torch.equal(a, b) for a, b in zip(prefills, want_logits)),
                  f"[serve] {label}: the engine's prefill logits differ from ChunkedPrefill's")
        check(len(log) == 1 and torch.equal(log.pop(), want),
              f"[serve] {label}: generate step {step} logits differ from decode_step "
              f"on the dense cache")
        got = gather_caches(eng.layout, eng.arena.planes, *eng.arena.device_tables())
        for a, b, path in zip(tree_flatten(got)[0], tree_flatten(dense)[0], paths):
            check(torch.equal(a, b), f"[serve] {label}: gathered {'/'.join(path)} "
                  f"differs from the dense cache after generate step {step}")
    check(all(not plane[-1].any() for plane in eng.arena.planes),
          f"[serve] {label}: the null row is not zero")
    # one more generate call, its inputs' transfer included, under CUDA's
    # sync debug mode: any host synchronisation in it raises (the step's
    # one read, the sampled tokens, comes after it)
    active = eng.sched.active_slots
    check(all(eng.arena.page_for(s.index, s.pos) for s in active),
          f"[serve] {label}: no page for the next position")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = eng._generate(None, eng.arena.planes, *eng._step_inputs(active))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(logits).all()), f"[serve] {label}: nonfinite logits")
    # where a token's time goes: device ms (launches back to back behind a
    # sleep longer than their enqueue) against host ms of the same call
    inputs = eng._step_inputs(active)
    one = model.init_caches(1, eng.layout.tokens)
    tok1 = {"tokens": torch.zeros((1, 1), dtype=torch.long, device="cuda"),
            "pos": torch.zeros((1,), dtype=torch.long, device="cuda")}
    times = {}
    for what, fn in (("generate", lambda: eng._generate(None, eng.arena.planes, *inputs)),
                     ("prefill token", lambda: model.decode_step(None, one, tok1))):
        times[what] = (device_timed(fn, reps=10, warmup=2, sleep_cycles=sleep_cycles),
                       wall_timed(fn, reps=10, warmup=2))
    print(f"[serve] {label}: paged == dense bit for bit: {len(prompts)} prefills' "
          f"logits, {1 + SERVE_CHECK_STEPS} generate steps' logits and the gathered "
          f"caches ({', '.join('/'.join(p) for p in paths)}) after each, all "
          f"{len(prompts)} slots active; a generate call under "
          f"set_sync_debug_mode('error') made no host synchronisation", flush=True)
    print(f"[serve] {label}: " + "; ".join(
        f"a {what} call device {d:.3f} ms, host {w:.3f} ms (device busy {d / w:.1%})"
        for what, (d, w) in times.items()), flush=True)
    del eng, dense, got, one
    gc.collect()
    torch.cuda.empty_cache()


def serve_run(model, prompts: list[list[int]], sc, label: str, smi: str,
              frames: list | None = None):
    """Serve ``prompts`` (all submitted at once, each with its ``frames``
    when given) to completion; print the
    arena, the stage unit costs, tok/s, engine steps, finish reasons, peak
    memory and wall seconds.  A short warm-up request runs first on the
    same engine (reset after).  -> (engine, its metrics)."""
    from repro_torch.serve import Engine

    eng = Engine(model, None, sc)
    eng.submit(prompts[0][:8])
    eng.run_until_done()
    eng.reset()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rids = [eng.submit(p, f) for p, f in zip(prompts, frames or [None] * len(prompts))]
    t0 = time.perf_counter()
    steps = 0
    while eng.busy:
        eng.step()
        steps += 1
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res = eng.results
    check(sorted(res) == sorted(rids), f"[serve] {label}: lost requests")
    new = sum(len(res[r].tokens) for r in rids)
    reasons: dict[str, int] = {}
    for r in rids:
        reasons[res[r].finish_reason] = reasons.get(res[r].finish_reason, 0) + 1
    check(reasons == {"length": len(rids)} and new == len(rids) * sc.max_new_tokens,
          f"[serve] {label}: finish reasons {reasons}, {new} tokens")
    check(all(0 <= t < model.cfg.vocab_size for r in rids for t in res[r].tokens),
          f"[serve] {label}: a token outside the vocab")
    m = eng.metrics()
    st = eng.stats
    lay = eng.layout
    print(f"[serve] {label}: {smi}; arena {eng.arena.num_pages} pages x "
          f"{lay.page_bytes()} B = {eng.arena.nbytes()} B, planes "
          f"{list(lay.plane_dtypes)}; {len(rids)} requests, prompts "
          f"{min(len(p) for p in prompts)}-{max(len(p) for p in prompts)} tokens "
          f"({st['prefill_tokens']} in all, {st['prefill_calls']} prefill calls), "
          f"{new} generated in {steps} engine steps ({st['generate_calls']} generate "
          f"calls); prefill_tok_us {m['prefill_tok_us']:.1f}, generate_tok_us "
          f"{m['generate_tok_us']:.1f}, insert_us {m['insert_us']:.1f}; "
          f"{new / wall:.1f} tok/s; finish reasons {reasons}; peak {peak:.2f} GiB; "
          f"wall {wall:.2f} s", flush=True)
    return eng, dict(m, tok_s=new / wall, peak_gib=peak, wall_s=wall, steps=steps,
                     arena_bytes=eng.arena.nbytes())


def serve_starve(model, prompt: list[int]) -> None:
    """A ``page_starve`` fault on the engine's real ``PagePool``:
    ``resilience.starve_pages`` holds every page, the queued request is
    shed after ``starve_patience`` ticks, ``release_pages`` gives the pool
    back and the next request runs to its length."""
    from repro_torch.resilience import release_pages, starve_pages
    from repro_torch.serve import Engine, ServeConfig

    patience = 3
    eng = Engine(model, None, ServeConfig(**dict(SERVE_CONFIG, max_new_tokens=4,
                                                 starve_patience=patience)))
    held = starve_pages(eng.arena.pool)
    check(len(held) == eng.arena.num_pages and eng.arena.pool.available == 0,
          f"[serve] starve: held {len(held)} of {eng.arena.num_pages} pages")
    rid = eng.submit(prompt)
    ticks = 0
    while rid not in eng.results:
        eng.step()
        ticks += 1
    comp = eng.results[rid]
    check(comp.finish_reason == "rejected" and comp.tokens == []
          and ticks == patience + 1 and eng.stats["starved_shed"] == 1,
          f"[serve] starve: {comp.finish_reason} after {ticks} ticks, "
          f"{eng.stats['starved_shed']} shed")
    release_pages(eng.arena.pool, held)
    rid2 = eng.submit(prompt)
    comp2 = eng.run_until_done()[rid2]
    check(comp2.finish_reason == "length" and len(comp2.tokens) == 4
          and eng.arena.pool.available == eng.arena.num_pages,
          f"[serve] starve: after the release {comp2.finish_reason}, "
          f"{len(comp2.tokens)} tokens, {eng.arena.pool.available} pages free")
    print(f"[serve] page_starve: starve_pages held all {len(held)} pages of the real "
          f"PagePool; the queued request was shed as rejected after {ticks} ticks "
          f"(starve_patience {patience}); release_pages, then a request ran to "
          f"length ({comp2.tokens})", flush=True)


def serve_cli() -> None:
    """``python -m repro_torch.launch.serve --full --arch gpt2-paper`` (its
    defaults: 8 requests, 4 slots, max_len 128) in a subprocess on the
    card."""
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--full",
                        "--arch", "gpt2-paper"], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=600)
    secs = time.perf_counter() - t0
    check(r.returncode == 0, f"[serve] the CLI exited {r.returncode}: "
          f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    lines = [l for l in r.stdout.splitlines() if l.startswith("[serve]")]
    check(len(lines) == 3 and lines[0].startswith("[serve] arena: 32 pages x 589824 B")
          and "8 requests" in lines[1] and r.stdout.count("[length]") == 4,
          f"[serve] the CLI printed {r.stdout[-2000:]}")
    print(f"[serve] CLI --full --arch gpt2-paper on the card: {' | '.join(lines)}; "
          f"the command took {secs:.1f} s", flush=True)


def phase_serve(smi: str) -> None:
    """Serving at full width (``SERVE_CONFIG``: 8 slots, max_len 1024, page
    16, prefill chunk 16, 64 new tokens): gpt2-paper with a bf16 KV cache
    and with ``kv_cache_dtype="int8"`` (paged == dense bit for bit, then 16
    requests of 16-128 prompt tokens from numpy seed 0), qwen1.5-0.5b at
    its full config (4 requests of 16-64), the recurrent archs
    (:func:`serve_recurrent`), the frontend archs (:func:`serve_frontend`),
    a ``page_starve`` run and the CLI; no kernel launches on the way."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig

    counters = kernel_counters()
    before = {k: f.launches for k, f in counters.items()}
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gpt2-paper")
    model = build_model(cfg, device="cuda", seed=0)
    prompts = serve_prompts(16, 16, 128, cfg.vocab_size)
    check_prompts = [p[:SERVE_CHECK_PROMPT] for p in prompts[:8]]
    serve_paged_equals_dense(model, check_prompts, "gpt2-paper bf16 KV")
    _, bf16 = serve_run(model, prompts, ServeConfig(**SERVE_CONFIG), "gpt2-paper bf16 KV",
                        smi)
    q = build_model(cfg.with_(kv_cache_dtype="int8"), device="cuda", seed=0)
    del model
    serve_paged_equals_dense(q, check_prompts, "gpt2-paper int8 KV")
    _, int8 = serve_run(q, prompts, ServeConfig(**SERVE_CONFIG), "gpt2-paper int8 KV", smi)
    print(f"[serve] int8 KV arena {int8['arena_bytes']} B beside bf16's "
          f"{bf16['arena_bytes']} B ({int8['arena_bytes'] / bf16['arena_bytes']:.4f}x)",
          flush=True)
    serve_starve(q, prompts[0])
    del q
    gc.collect()
    torch.cuda.empty_cache()
    qcfg = get_config("qwen1.5-0.5b")
    qwen = build_model(qcfg, device="cuda", seed=0)
    serve_run(qwen, serve_prompts(4, 16, 64, qcfg.vocab_size),
              ServeConfig(**dict(SERVE_CONFIG, max_new_tokens=32)), "qwen1.5-0.5b full", smi)
    del qwen
    gc.collect()
    torch.cuda.empty_cache()
    serve_recurrent(smi)
    serve_frontend(smi)
    serve_cli()
    counts = {k: f.launches - before[k] for k, f in counters.items()}
    check(counts == launch_counts(), f"[serve] kernel launches {counts}: no kernel "
          f"lies on the serving path")
    print(f"[serve] phase {time.perf_counter() - t0:.1f} s; kernel launches {counts}",
          flush=True)


def serve_recurrent(smi: str) -> None:
    """The recurrent archs at their full configs (``SERVE_RECURRENT``):
    paged == dense bit for bit on 8 prompts cut short, then 4 requests of
    16-64 prompt tokens, 32 new; each arena's rows against the one
    resident state a slot holds."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig

    for arch, check_len, sleep_cycles in SERVE_RECURRENT:
        rcfg = get_config(arch)
        model = build_model(rcfg, device="cuda", seed=0)
        prompts = serve_prompts(8, 16, 64, rcfg.vocab_size)
        label = f"{arch} full"
        serve_paged_equals_dense(model, [p[:check_len] for p in prompts], label,
                                 sleep_cycles)
        eng, _ = serve_run(model, prompts[:4],
                           ServeConfig(**dict(SERVE_CONFIG, max_new_tokens=32)), label, smi)
        lay = eng.layout
        res = sum(l.numel * getattr(torch, l.dtype).itemsize
                  for l in lay.leaves if not l.paged)
        # a page id indexes every plane, so each row is as wide as the wider
        # of a token page and one slot's whole resident state (the
        # reference's layout): only one row a slot holds that state
        print(f"[serve] {label}: plane rows of {list(lay.plane_elems)} elements "
              f"({list(lay.plane_dtypes)}); one slot's resident state {res} B, held "
              f"in {SERVE_CONFIG['batch_slots']} of the {eng.arena.num_pages} pages of "
              f"{lay.page_bytes()} B ({eng.arena.nbytes()} B in all)", flush=True)
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()


def serve_frontend(smi: str) -> None:
    """The frontend families at their full configs (``SERVE_FRONTEND``):
    seamless-m4t-medium, each request with frames of its own (numpy seed
    ``i`` for request ``i``), encoded at prefill into the resident
    ``mem_k``/``mem_v``; pixtral-12b text only, as the reference decodes.
    Paged == dense bit for bit on 8 prompts cut short, then 4 requests of
    16-64 prompt tokens, 32 new; the arena's rows beside what a slot holds
    in them."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeConfig

    for arch, check_len, sleep_cycles in SERVE_FRONTEND:
        cfg = get_config(arch)
        model = build_model(cfg, device="cuda", seed=0)
        prompts = serve_prompts(8, 16, 64, cfg.vocab_size)
        frames = ([frontend_embeds(cfg, 1, seed=i) for i in range(8)] if cfg.is_encdec
                  else None)
        label = f"{arch} full"
        serve_paged_equals_dense(model, [p[:check_len] for p in prompts], label,
                                 sleep_cycles, frames=frames)
        eng, _ = serve_run(model, prompts[:4],
                           ServeConfig(**dict(SERVE_CONFIG, max_new_tokens=32)), label,
                           smi, frames=frames[:4] if frames else None)
        lay = eng.layout
        res = sum(l.numel * getattr(torch, l.dtype).itemsize
                  for l in lay.leaves if not l.paged)
        tok = sum(l.numel * getattr(torch, l.dtype).itemsize for l in lay.leaves if l.paged)
        params = sum(p.numel() * p.element_size() for p in model.parameters())
        print(f"[serve] {label}: {sum(p.numel() for p in model.parameters())} params "
              f"({params} B, {next(model.parameters()).dtype}); plane rows of "
              f"{list(lay.plane_elems)} elements ({list(lay.plane_dtypes)}): a token "
              f"page's KV {tok} B, one slot's resident memory K/V {res} B "
              f"({[l.name for l in lay.leaves if not l.paged]}); "
              f"{eng.arena.num_pages} pages of {lay.page_bytes()} B = "
              f"{eng.arena.nbytes()} B", flush=True)
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()


def phase_serve_small() -> None:
    """The eleven archs' REDUCED configs served on the card and on the CPU
    from the same parameters and prompts (``SMALL_SERVE_*``; MoE at the
    drop-free capacity ``cf = E``; seamless's requests with frames of their
    own): the same tokens, finish reasons and page tables, every sampled
    logits row within ``SMALL_SERVE_ATOL``."""
    from repro_torch.configs import get_reduced, list_archs
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    worst = {}
    # latent attention has no decode path (the port has no latent cache)
    for arch in [a for a in list_archs() if not get_reduced(a).is_mla]:
        cfg = get_reduced(arch)
        if cfg.num_experts:
            cfg = cfg.with_(moe_capacity_factor=float(cfg.num_experts))
        init = build_model(cfg, device="cpu", seed=3).state_dict()
        out = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            model.load_state_dict(init)
            log: list = []
            eng = Engine(model, None, ServeConfig(**SMALL_SERVE_CONFIG),
                         sample=recording_sampler(log))
            frames = ([frontend_embeds(cfg, 1, dev, seed=i)
                       for i in range(len(SMALL_SERVE_PROMPTS))] if cfg.is_encdec
                      else [None] * len(SMALL_SERVE_PROMPTS))
            rids = [eng.submit(p, f) for p, f in zip(SMALL_SERVE_PROMPTS, frames)]
            tables = []
            while eng.busy:
                eng.step()
                tables.append(eng.arena.page_tbl.copy())
            res = eng.run_until_done()
            out[dev] = ([(res[r].tokens, res[r].finish_reason) for r in rids],
                        [l.float().cpu() for l in log], tables)
        (c_tok, c_log, c_tab), (g_tok, g_log, g_tab) = out["cpu"], out["cuda"]
        check(g_tok == c_tok, f"[small] serve {arch}: cuda {g_tok} vs cpu {c_tok}")
        check(len(g_tab) == len(c_tab) and all(np.array_equal(a, b)
                                               for a, b in zip(g_tab, c_tab)),
              f"[small] serve {arch}: page tables differ")
        check(len(g_log) == len(c_log), f"[small] serve {arch}: sampler calls")
        worst[arch] = max(abs_err(a, b) for a, b in zip(g_log, c_log))
        check(worst[arch] <= SMALL_SERVE_ATOL,
              f"[small] serve {arch}: logits max |diff| {worst[arch]:.3g}")
    print(f"[small] serve: the {len(worst)} REDUCED archs on the card == the CPU in tokens, "
          f"finish reasons and page tables; logits max |diff| (atol "
          f"{SMALL_SERVE_ATOL:g}) {json.dumps({a: float(f'{w:.3g}') for a, w in worst.items()})}",
          flush=True)


def main() -> int:
    _, smi = phase_device()
    import torch.distributed as dist

    from repro_torch.configs import get_config

    phase_build()
    records = [phase_kernels(), phase_pack_kernels(), *phase_wire_kernels(),
               phase_lowrank_kernels(), phase_threshold_kernels(),
               phase_adamw_kernel(), phase_causal_attn_kernel(),
               phase_moe_dispatch_kernel()]
    phase_adamw()
    by_name = {r["name"]: r for r in records}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        cfg = get_config("gpt2-paper")
        tr, state, loader, launches = phase_train(cfg, group=group)
        stats = {"defaults": tr.run_stats}
        stats_base = tr.run_base
        segs = tr.plan.num_segments
        check(launches == launch_counts(ef_update=STEPS * segs),
              f"defaults: launches {launches} in {STEPS} steps; the plan has "
              f"{segs} segments")
        records[0]["launches"] = launches["ef_update"]
        by_name["adamw_fused"]["launches"] = tr.adamw_launches
        # a layer a step: forward, recompute, then prep, dK/dV and dQ
        check(tr.attn_launches == 5 * STEPS * cfg.num_layers,
              f"defaults: causal_attn launches {tr.attn_launches} in {STEPS} steps of "
              f"{cfg.num_layers} layers")
        by_name["causal_attn"]["launches"] = tr.attn_launches
        phase_parity(tr, state, loader, group)
        del tr, state, loader
        torch.cuda.empty_cache()
        pack_launches = {}
        for label, options in PACK_RUNS:
            tr, state, _, launches = phase_train(cfg, group=group, label=label,
                                                 options=options)
            stats[label] = tr.run_stats
            check(launches == launch_counts(pack_ef_cast=STEPS * segs),
                  f"{label}: launches {launches} in {STEPS} steps; the plan has "
                  f"{segs} segments")
            pack_launches[label] = launches["pack_ef_cast"]
            del tr, state
            torch.cuda.empty_cache()
        for label, options, post_label, kernel in FUSED_RUNS:
            tr, state, loader, launches = phase_train(cfg, group=group, label=label,
                                                      options=options)
            check(launches == launch_counts(**{kernel: STEPS * segs}),
                  f"{label}: launches {launches} in {STEPS} steps; the plan has "
                  f"{segs} segments")
            if kernel == "ef_update":
                records[0]["launches"] += launches[kernel]
                records[0]["launches_by_run"] = {"defaults": STEPS * segs,
                                                 label: launches[kernel]}
            else:
                pack_launches[label] = launches[kernel]
            (ms_p, tok_p, peak_p), (ms_f, tok_f, peak_f) = (stats[post_label],
                                                            tr.run_stats)
            print(f"[train] {label} vs {post_label}: steps 1-{STEPS - 1} ms "
                  f"{[round(v, 2) for v in ms_f]} vs {[round(v, 2) for v in ms_p]}; "
                  f"{tok_f:.0f} vs {tok_p:.0f} tok/s; peak {peak_f:.2f} vs "
                  f"{peak_p:.2f} GiB; {check_fused_run(tr, label)}", flush=True)
            if label == "fused":
                phase_fused_parity(tr, state, loader, group)
            del tr, state, loader
            torch.cuda.empty_cache()
        records[1]["launches"] = sum(pack_launches.values())
        records[1]["launches_by_run"] = pack_launches
        for label, options in FLAT_RUNS:
            tr, state, loader, launches = phase_train(cfg, group=group, label=label,
                                                      options=options)
            nb = tr.plan.num_buckets
            want = (launch_counts(quantize_fp8=STEPS * nb,
                                  dequantize_fp8=2 * STEPS * nb)
                    if label == "fp8wire" else launch_counts(sign_compress=STEPS * nb))
            check(launches == want, f"{label}: launches {launches} in {STEPS} "
                  f"steps; the plan has {nb} buckets")
            for k, n in launches.items():
                if n and k in by_name:
                    by_name[k]["launches"] = n
            phase_flat_parity(tr, state, loader, group)
            del tr, state, loader
            torch.cuda.empty_cache()
        tr, state, loader, launches = phase_train(cfg, group=group, label="powersgd",
                                                  options={"compressor": "powersgd"})
        n = 3 * len(lowrank_leaves(tr.plan))
        check(launches == launch_counts(**{MATMUL: STEPS * n}),
              f"powersgd: launches {launches} in {STEPS} steps; {n} products a step")
        by_name[MATMUL]["launches"] = launches[MATMUL]
        from repro_torch.kernels.lowrank import matmul
        per_route = STEPS * len(lowrank_leaves(tr.plan))
        check(matmul.launches_by_route == {"rowdot": per_route, "colacc": per_route,
                                           "outer": per_route, "tiled": 0},
              f"powersgd: launches by route {matmul.launches_by_route}")
        by_name[MATMUL]["launches_by_route"] = dict(matmul.launches_by_route)
        print(f"[train] powersgd: lowrank.matmul launches by route "
              f"{matmul.launches_by_route}", flush=True)
        phase_powersgd_parity(tr, state, loader, group)
        del tr, state, loader
        torch.cuda.empty_cache()
        batches = ckpt_batches(cfg)
        for label, options in CKPT_RUNS:
            counts = phase_ckpt(cfg, group, label, options, batches)
            if label == "defaults":
                want = launch_counts(ef_update=8 * segs)
                records[0]["launches_by_run"]["ckpt defaults"] = counts["ef_update"]
            else:
                want = launch_counts(**{MATMUL: 8 * n})
                by_name[MATMUL]["launches_by_run"] = {"powersgd": by_name[MATMUL]["launches"],
                                                      "ckpt powersgd": counts[MATMUL]}
            check(counts == want, f"ckpt {label}: launches {counts}, want {want}")
        records[0]["launches_by_run"]["replan"] = phase_replan(cfg, group, batches)
        del batches
        for sparse in SPARSE_RUNS:
            tr, state, loader, launches = phase_train(cfg, group=group, label=sparse,
                                                      options={"compressor": sparse})
            check(launches == launch_counts(),
                  f"{sparse}: launches {launches}; the sparsifiers run no kernel")
            sr = tr.schedule_report()
            print(f"[train] {sparse}: plan {sr['mean_bytes_per_step']:.0f} B per worker "
                  f"per step at W={tr.dp_world} (dense {sr['dense_bytes']} B, volume "
                  f"ratio {sr['volume_ratio']:.2f}), "
                  f"{len(tr.schedules()[0].calls)} collectives a step", flush=True)
            if sparse == "topk":
                phase_oktopk_parity(tr, state, loader, group)
            del tr, state, loader
            torch.cuda.empty_cache()
        records[0]["launches_by_run"]["launch"] = phase_launch(cfg, group)
        pods = phase_pods(cfg, group)
        records[0]["launches_by_run"]["pods post"] = pods["pods post"]
        records[1]["launches_by_run"]["pods sharded+arena"] = pods["pods sharded+arena"]
        records[0]["launches_by_run"]["adaptive"] = phase_adaptive(cfg, group, smi)
        by_run, plane_pack = phase_resilience(cfg, group, smi)
        records[0]["launches_by_run"].update(by_run)
        records[1]["launches_by_run"]["resilience plane guard"] = plane_pack
        ef_by_run, moe_by_run = phase_families(group, smi)
        for label, n in ef_by_run.items():
            rec = records[1] if "arena" in label else records[0]
            rec["launches_by_run"][f"families {label}"] = n
        by_name["moe_dispatch"]["launches"] = sum(moe_by_run.values())
        by_name["moe_dispatch"]["launches_by_run"] = {f"families {label}": n
                                                      for label, n in moe_by_run.items()}
        phase_serve(smi)
        # last, since the steps that follow a profiled one run slower: a
        # fresh fused run, then one profiled post and fused step
        tr, state, loader, launches = phase_train(
            cfg, group=group, label="fused, for [overlap]", options={"overlap": "fused"})
        check(launches == launch_counts(ef_update=STEPS * segs),
              f"fused, for [overlap]: launches {launches}")
        state = phase_overlap(tr, state, loader, group)
        t_added = time.perf_counter()
        gates = phase_gates(cfg, group, tr, state, loader)
        records[0]["launches_by_run"]["gates fused+post"] = gates["ef_update"]
        records[1]["launches_by_run"]["gates sharded"] = gates["pack_ef_cast"]
        del tr, state, loader
        torch.cuda.empty_cache()
        phase_dryrun(cfg, group, stats, stats_base)
        print(f"[gates] + [dryrun]: {time.perf_counter() - t_added:.1f} s", flush=True)
    finally:
        dist.destroy_process_group()
    phase_small()
    phase_small_families()
    phase_serve_small()
    idle = [r["name"] for r in records if r.get("path", "") is not None
            and not r["launches"]]
    check(not idle, f"kernels never launched on their path: {idle}")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
