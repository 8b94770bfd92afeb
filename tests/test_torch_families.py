"""The families beyond gpt2-paper (qwen1.5-0.5b, gemma-2b, gemma2-27b,
mistral-large-123b, deepseek-moe-16b, grok-1-314b, the recurrent
xlstm-125m and zamba2-2.7b, the VLM pixtral-12b and the encoder-decoder
seamless-m4t-medium) in the port against the JAX reference:
configs, parameter paths, leaf order and dtypes,
loss, aux loss and every gradient on the REDUCED configs, and the
full-config bucket plans and COVAP bytes, built from ``meta`` tensors
without allocating; the registry; ``api.fit``, ``api.plan_report`` and
the training CLI on each arch (seamless's frames come in the batches;
the CLI has no frames and fails naming them, as the reference's does)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import build_ready_order as r_build_ready_order
from repro.core import get_compressor as r_get_compressor
from repro.models import build_model as r_build_model
from repro.models import build_param_specs as r_build_param_specs
from repro.models import count_params as r_count_params
from repro.models import long_context_variant as r_long_context_variant
from repro.models import model_flops as r_model_flops

import _torch_reference_runs as ref_runs
import repro_torch.api as api
import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, build_ready_order, get_compressor
from repro_torch.core.bucketing import EMBED_STAGE, bucket_first_use
from repro_torch.interop import (
    caches_from_jax,
    caches_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.launch import train as cli
from repro_torch.models import (
    build_model,
    build_param_specs,
    count_params,
    long_context_variant,
    model_flops,
    param_shapes,
)
from repro_torch.models.transformer import num_superblocks

torch.set_num_threads(2)

# loss and gradients: the order of summation differs between XLA and ATen
RTOL, ATOL = 1e-4, 1e-6
ARCHS = tconfigs.reference_archs(assigned_only=True)
SEQ = 64     # two attention chunks, two xent chunks, gemma2's window 16 active

# the depth cuts that fit one 80 GB card at full width, and the reference's
# COVAP (I=4) bytes per worker per step at W=8 for phases 0..3
CUTS = {
    ("qwen1.5-0.5b", None): (100, 114, [622365696, 611183616, 622365696, 622365696]),
    ("gemma-2b", 2): (128, 135, [1260740608, 1233821696, 1296687104, 1283899392]),
    ("deepseek-moe-16b", 2): (66, 77, [1611038720, 1584627712, 1584627712,
                                       1600331776]),
    ("mistral-large-123b", 1): (71, 74, [1115160576, 1083703296, 1090019328,
                                         1090043904]),
    ("xlstm-125m", None): (32, 77, [182449248, 179818080, 184771680, 187276800]),
    ("zamba2-2.7b", 12): (126, 209, [772638720, 734515840, 746475520, 735826560]),
    ("pixtral-12b", 1): (124, 129, [1683128320, 1577586688, 1620287488, 1683144704]),
    ("seamless-m4t-medium", None): (162, 181, [991327232, 960775168, 979977216,
                                               979362816]),
}
FULL = [(a, None) for a in ARCHS] + [k for k in CUTS if k[1] is not None]


def _configs(arch, reduced=False, layers=None):
    get = "get_reduced" if reduced else "get_config"
    rcfg, cfg = getattr(rconfigs, get)(arch), getattr(tconfigs, get)(arch)
    if layers is not None:
        rcfg, cfg = rcfg.with_(num_layers=layers), cfg.with_(num_layers=layers)
    return rcfg, cfg


def _tree_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_paths(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_registry_lists_the_ported_archs_in_the_reference_s_order():
    names = tconfigs.list_archs()
    # the port's own archs (``PORT_ONLY``) come after the reference's
    shared = tconfigs.reference_archs()
    assert names == shared + list(tconfigs.PORT_ONLY)
    assert shared == [a for a in rconfigs.list_archs() if a in shared]
    assert set(ARCHS) == {"qwen1.5-0.5b", "gemma-2b", "gemma2-27b",
                          "mistral-large-123b", "deepseek-moe-16b", "grok-1-314b",
                          "xlstm-125m", "zamba2-2.7b", "pixtral-12b",
                          "seamless-m4t-medium"}
    assert tconfigs.list_archs(assigned_only=True) == [a for a in names
                                                       if a != "gpt2-paper"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch, reduced):
    """Every field the reference's config has is equal; the fields only the
    port has (latent attention, the sigmoid router, the dense prefix, the
    expert share) are at their defaults, which leave the path unchanged."""
    rcfg, cfg = _configs(arch, reduced)
    ref_fields = {f.name for f in dataclasses.fields(rcfg)}
    for f in dataclasses.fields(cfg):
        if f.name in ref_fields:
            assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
        else:
            assert getattr(cfg, f.name) == f.default, f.name
    assert cfg.is_moe == rcfg.is_moe
    assert not cfg.is_mla and cfg.routed_experts == cfg.num_experts


@pytest.mark.parametrize("assigned_only", [False, True])
def test_registry_equals_reference_and_refuses_unknown_archs(assigned_only):
    """``list_archs`` is the reference's, in its order, with and without
    ``gpt2-paper``, then the port's own; every listed arch builds on
    ``meta`` as the model its family calls for; an unknown arch raises
    ``KeyError`` in both packages."""
    names = tconfigs.list_archs(assigned_only=assigned_only)
    assert tconfigs.reference_archs(assigned_only) == rconfigs.list_archs(
        assigned_only=assigned_only)
    assert names == tconfigs.reference_archs(assigned_only) + list(tconfigs.PORT_ONLY)
    for arch in names:
        model = build_model(tconfigs.get_reduced(arch), device="meta")
        assert type(model).__name__ == ("EncDecLM" if model.cfg.is_encdec
                                        else "DecoderLM")
    for get in (tconfigs.get_config, tconfigs.get_reduced, rconfigs.get_config):
        with pytest.raises(KeyError):
            get("llama-7b")


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_interop_round_trips_the_recurrent_trees(arch):
    """``params_from_jax``/``params_to_numpy`` over the recurrent trees
    (``stack.shared.*``, the f32 gate and decay leaves among f32 or bf16
    matrices), and ``caches_from_jax``/``caches_to_numpy`` over their
    state caches: the same paths, dtypes and values both ways."""
    for dtype in ("float32", "bfloat16"):
        rcfg, cfg = _configs(arch, reduced=True)
        rcfg, cfg = rcfg.with_(param_dtype=dtype), cfg.with_(param_dtype=dtype)
        rmodel = r_build_model(rcfg)
        want = _tree_paths(jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(1))))
        model = build_model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(_unflat(want), device="cpu"))
        back = _tree_paths(params_to_numpy(model))
        assert sorted(back) == sorted(want)
        for path, w in want.items():
            assert back[path].dtype == w.dtype, path
            np.testing.assert_array_equal(back[path].astype(np.float32),
                                          w.astype(np.float32), err_msg=path)
        rc = jax.tree.map(np.asarray, rmodel.init_caches(2, 16))
        rc = jax.tree.map(lambda a: (np.arange(a.size) % 7).reshape(a.shape).astype(a.dtype), rc)
        caches = caches_from_jax(rc, device="cpu")
        specs = _tree_paths(model.cache_specs(2, 16))
        got = _tree_paths(caches)
        assert sorted(got) == sorted(specs)
        for path, t in got.items():
            assert t.shape == specs[path].shape and t.dtype == specs[path].dtype, path
        for path, a in _tree_paths(caches_to_numpy(caches)).items():
            np.testing.assert_array_equal(a, _tree_paths(rc)[path], err_msg=path)


def _unflat(flat):
    tree: dict = {}
    for path, v in flat.items():
        *heads, last = path.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
def test_recurrent_init_follows_reference_rules(arch):
    """The port's own init of the recurrent leaves against the reference's
    (different generators, the same rules), leaf by leaf on the REDUCED
    config: the same dtype (the gate and decay leaves stay f32), the same
    constants (``A_log`` 0, ``D`` 1, ``dt_bias`` 0, conv biases 0, forget
    biases 3), and spreads within 15% (30% under 1,000 elements)."""
    rcfg, cfg = _configs(arch, reduced=True)
    want = _tree_paths(jax.tree.map(np.asarray,
                                    r_build_model(rcfg).init(jax.random.PRNGKey(0))))
    got = dict(build_model(cfg, device="cpu", seed=5).named_leaves())
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path].detach()
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        g = g.float().numpy()
        if np.all(w == w.flat[0]):
            assert np.all(g == w.flat[0]), path
            continue
        tol = 0.15 if w.size >= 1000 else 0.3
        assert abs(g.std() / w.std() - 1) < tol, (path, g.std(), w.std())


# the reference's gradients of the loss test go to this many processes at
# once
REFERENCE_PROCESSES = 3


@pytest.fixture(scope="module", autouse=True)
def reference_grads():
    """Each arch's reference loss and gradients
    (``_torch_reference_runs.family_grads``), all started when the module
    starts: ``arch -> future``."""
    calls = {arch: (ref_runs.family_grads, (arch, SEQ)) for arch in ARCHS}
    with ref_runs.reference_pool(calls, REFERENCE_PROCESSES) as futures:
        yield futures


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match_reference(arch, reference_grads):
    """The encoder-decoder arch's batch carries frames; pixtral's is text
    only here (its projector's gradient is zero in both packages;
    ``test_torch_multimodal.py`` holds the patch path).  The reference's
    eager ``jax.value_and_grad`` runs in ``reference_grads``'s processes,
    on the parameters and batch it returns."""
    _, cfg = _configs(arch, reduced=True)
    ref = reference_grads[arch].result(timeout=900)
    params, batch = ref["params"], ref["batch"]
    rloss, rmet = ref["loss"], ref["metrics"]

    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    total, met = model.loss_fn(tb)
    total.backward()
    np.testing.assert_allclose(total.item(), float(rloss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(met["loss"].detach()), float(rmet["loss"]), rtol=RTOL)
    np.testing.assert_allclose(float(met["aux_loss"].detach()), float(rmet["aux_loss"]),
                               rtol=RTOL, atol=ATOL)
    assert (float(met["aux_loss"].detach()) > 0) == cfg.is_moe
    ref_grads = ref["grads"]
    assert [p for p, _ in model.named_leaves()] == list(ref_grads)
    for path, p in model.named_leaves():
        # a text-only batch does not reach the projector: jax.grad's zeros
        # against no gradient at all (the trainer's loss_and_grads fills in
        # zeros)
        grad = p.grad if path != "projector.w" else torch.zeros_like(p)
        assert (p.grad is None) == (path == "projector.w"), path
        np.testing.assert_allclose(grad.numpy(), ref_grads[path], rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_gemma2_local_layer_masks_outside_its_window():
    """gemma2's superblock is a (local, global) pair: only ``b0`` sees the
    window, and the softcaps bound the logits; a token's loss at position
    t does not move with a token outside the local window when the global
    layer is switched off (its output projection zeroed)."""
    cfg = tconfigs.get_reduced("gemma2-27b")
    assert num_superblocks(cfg) == cfg.num_layers // 2 == 1
    model = build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model.stack["blocks"]["b1"]["attn"]["wo"].zero_()
        model.stack["blocks"]["b1"]["mlp"]["w_down"].zero_()
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, SEQ))).long()
    labels = torch.full_like(tokens, -1)
    labels[0, SEQ - 1] = 7
    base, _ = model.loss_fn({"tokens": tokens, "labels": labels})
    far = tokens.clone()
    far[0, SEQ - 1 - cfg.sliding_window] = (far[0, SEQ - 1 - cfg.sliding_window] + 1) % 512
    near = tokens.clone()
    near[0, SEQ - cfg.sliding_window] = (near[0, SEQ - cfg.sliding_window] + 1) % 512
    assert torch.equal(model.loss_fn({"tokens": far, "labels": labels})[0], base)
    assert not torch.equal(model.loss_fn({"tokens": near, "labels": labels})[0], base)


@pytest.mark.parametrize("arch,layers", FULL)
def test_full_config_plans_equal_reference(arch, layers):
    """Built from ``meta`` tensors (nothing allocated) against the
    reference's plan of its ``jax.eval_shape`` tree: leaf paths, order,
    shapes and dtypes, every bucket's segments, the four phases' COVAP
    bytes per worker at W=8, the parameter counts and MODEL_FLOPS."""
    rcfg, cfg = _configs(arch, layers=layers)
    shapes = jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0))
    rplan = r_build_plan(shapes)
    plan = build_plan(build_model(cfg, device="meta").named_leaves())
    rpaths = [".".join(k.key for k in p)
              for p, _ in jax.tree_util.tree_leaves_with_path(shapes)]
    assert list(plan.leaf_paths) == rpaths
    assert list(param_shapes(cfg)) == rpaths
    assert plan.leaf_shapes == rplan.leaf_shapes
    assert [str(d).removeprefix("torch.") for d in plan.leaf_dtypes] == \
        [str(d) for d in rplan.leaf_dtypes]
    assert plan.bucket_bytes_target == rplan.bucket_bytes_target
    assert [[dataclasses.astuple(s) for s in b.segments] for b in plan.buckets] == \
        [[dataclasses.astuple(s) for s in b.segments] for b in rplan.buckets]
    assert [(b.numel, b.nbytes, b.origin) for b in plan.buckets] == \
        [(b.numel, b.nbytes, b.origin) for b in rplan.buckets]
    got = [get_compressor("covap", interval=4).plan_phase(plan, p, world=8)
           .bytes_per_worker for p in range(4)]
    want = [r_get_compressor("covap", interval=4).plan_phase(rplan, p, world=8)
            .bytes_per_worker for p in range(4)]
    assert got == want
    if (arch, layers) in CUTS:
        nb, ns, table = CUTS[(arch, layers)]
        assert (plan.num_buckets, plan.num_segments, got) == (nb, ns, table)
    for active in (False, True):
        assert count_params(cfg, active_only=active) == \
            r_count_params(rcfg, active_only=active)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()
    assert model_flops(cfg, 8 * 1024) == r_model_flops(rcfg, 8 * 1024)
    if cfg.is_moe:
        assert count_params(cfg, active_only=True) < count_params(cfg)


@pytest.mark.parametrize("arch,layers", FULL)
def test_ready_order_and_first_use_on_the_new_plans(arch, layers):
    """``ReadyOrder`` equals the reference's on the full-config plans, and
    each bucket's first-use stage is its shallowest superblock row (0 for
    zamba2's shared block), the head's the superblock count: the stage the
    decoder's last
    ``before_layer`` call reaches (gemma2 has half as many as layers).
    The encoder-decoder's stages are its encoder rows, then ``enc_norm``
    with decoder row 0 at ``E``, decoder row ``r`` at ``E + r``, and the
    head at ``E + L``; pixtral's projector is read with the embedding."""
    rcfg, cfg = _configs(arch, layers=layers)
    shapes = jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0))
    rplan = r_build_plan(shapes)
    model = build_model(cfg, device="meta")
    plan = build_plan(model.named_leaves())
    want, got = r_build_ready_order(rplan), build_ready_order(plan)
    assert (got.bucket_layer, got.ranks, got.num_layers) == \
        (want.bucket_layer, want.ranks, want.num_layers)
    n = model.num_stages
    if cfg.is_encdec:
        E = cfg.encoder_layers
        assert n == E + cfg.num_layers == sum(
            jax.tree_util.tree_leaves(shapes["encdec"][k])[0].shape[0]
            for k in ("encoder", "decoder"))
        base = {"encdec.encoder.": 0, "encdec.decoder.": E}
        fixed = {"encdec.enc_norm.": E}
        tails = ("head.", "encdec.final_norm.")
    else:
        assert n == num_superblocks(cfg) == jax.tree_util.tree_leaves(
            shapes["stack"]["blocks"])[0].shape[0]
        # zamba2's weight-shared block is read once, before superblock 0
        base, fixed = {"stack.blocks.": 0}, {"stack.shared.": 0}
        tails = ("head.", "stack.final_norm.")
    stages = bucket_first_use(plan)
    for b, stage in enumerate(stages):
        segs = [(plan.leaf_paths[s.leaf_idx], s) for s in plan.buckets[b].segments]
        rows = [off + s.row_lo for path, s in segs for pre, off in base.items()
                if path.startswith(pre)]
        rows += [v for path, _ in segs for pre, v in fixed.items() if path.startswith(pre)]
        tail = any(path.startswith(tails) for path, _ in segs)
        embed = any(path.startswith(("embed.", "projector.")) for path, _ in segs)
        assert stage == (EMBED_STAGE if embed else min(rows + [n] if tail else rows))
    # every stage is one the layer loop calls before_layer for
    assert set(stages) <= set(range(EMBED_STAGE, n + 1))


@pytest.mark.parametrize("model_axis", [1, 16])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-moe-16b", "grok-1-314b",
                                  "gemma2-27b", "xlstm-125m", "zamba2-2.7b",
                                  "pixtral-12b", "seamless-m4t-medium"])
def test_build_param_specs_equals_reference(arch, model_axis):
    """The MoE rule (expert-parallel on E when it divides, else the ff
    dim), the bias and router leaves, and the recurrent blocks' names
    (``wz``, ``wx``, ``up_x``, ``up_z``, ``conv_x`` on their last axis;
    ``down``, ``out_proj`` on their input axis), at full width."""
    rcfg, cfg = _configs(arch)
    want = r_build_param_specs(rcfg, r_build_model(rcfg).init, model_axis, "model")
    flat = {".".join(str(k.key) for k in path): tuple(spec) for path, spec in
            jax.tree_util.tree_leaves_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    got = build_param_specs(cfg, model_axis, "model")
    assert list(got) == list(flat)
    assert got == flat


@pytest.mark.parametrize("arch", ARCHS + ["gpt2-paper"])
def test_long_context_variant_equals_reference(arch):
    rcfg, cfg = _configs(arch)
    got, want = long_context_variant(cfg), r_long_context_variant(rcfg)
    assert (got.sliding_window, got.local_global) == (want.sliding_window,
                                                      want.local_global)
    build_model(got, device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_report_equals_reference(arch):
    kw = dict(reduced=False, interval="auto", seq_len=1024, global_batch=8)
    got, want = api.plan_report(arch, **kw), rapi.plan_report(arch, **kw)
    assert got == want


def _with_frames(cfg, batches):
    """The loader's batches, each with std-0.02 frames of its own."""
    for i, batch in enumerate(batches):
        yield dict(batch, frames=torch.from_numpy(ref_runs.frames(cfg, 4, seed=i)))


@pytest.mark.parametrize("arch", ARCHS)
def test_fit_returns_finite_losses(arch):
    """The encoder-decoder arch trains on ``batches`` that carry frames
    (the synthetic loader has none, in both packages)."""
    batches = None
    cfg = tconfigs.get_reduced(arch)
    if cfg.is_encdec:
        from repro_torch.data import DataConfig, make_loader

        batches = _with_frames(cfg, make_loader(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=16, global_batch=4), device="cpu"))
    res = api.fit(arch, reduced=True, device="cpu", interval=2, steps=3,
                  seq_len=16, global_batch=4, batches=batches)
    assert len(res.history) >= 1 and res.state["step"] == 3
    for h in res.history:
        assert np.isfinite(h["loss"]) and np.isfinite(h["total_loss"])
        assert (h["aux_loss"] > 0) == tconfigs.get_reduced(arch).is_moe


@pytest.mark.parametrize("arch", tconfigs.reference_archs(assigned_only=True))
def test_cli_trains_each_arch_on_cpu(arch, capsys):
    """The encoder-decoder arch has no frames on the CLI, in either
    package: its first step raises ``KeyError: 'frames'``."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "4",
            "--seq-len", "16", "--global-batch", "4", "--interval", "2",
            "--log-every", "2"]
    if tconfigs.get_reduced(arch).is_encdec:
        with pytest.raises(KeyError, match="frames"):
            cli.main(argv)
        return
    cli.main(argv)
    out = capsys.readouterr().out
    for tag in (f"[model] {arch}", "step     2  loss", "step     4  loss",
                "[done] step 4 (4 committed)"):
        assert tag in out, out
    done = next(line for line in out.splitlines() if line.startswith("[done]"))
    assert ("aux_loss" in done) == tconfigs.get_reduced(arch).is_moe, done


@pytest.mark.parametrize("arch", ARCHS)
def test_tune_equals_reference(arch):
    """The analytic ranking at REDUCED: the same compressors in the same
    order, the same planned bytes, the modelled speedups to 1e-9."""
    kw = dict(reduced=True, dp_workers=8)
    want, got = rapi.tune(arch, **kw), api.tune(arch, **kw)
    assert [r["compressor"] for r in got] == [r["compressor"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("mean_bytes_per_step", "volume_ratio", "num_phases", "analytic_ccr"):
            assert g[k] == w[k], (g["compressor"], k)
        for k in ("speedup", "overlap_frac_modeled", "pack_overhead_us"):
            assert g[k] == pytest.approx(w[k], rel=1e-9, abs=0), (g["compressor"], k)
