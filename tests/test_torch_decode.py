"""The decode half of the port's models against the JAX reference: the KV
caches' trees, shapes and dtypes (REDUCED and full config), ``decode_step``
token by token against the reference's (logits and every cache leaf), the
port's decode against its own ``prefill``, int8 quantisation bit for bit,
and the int8 cache against the float one.

Parameters come from the reference's ``jax.random`` init through
``interop.params_from_jax``, with the zero-initialised norm scales and
q/k/v biases set to small random values so that their paths carry weight.
MoE archs run at the drop-free capacity ``cf = E``, as the reference's
``test_decode_parity.py`` does: capacity depends on how many tokens route
together, so prefill and decode drop different assignments otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import attention as rattn
from repro.models import build_model as r_build_model

import repro_torch.configs as tconfigs
from repro_torch.interop import caches_from_jax, caches_to_numpy, params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, transformer

torch.set_num_threads(2)

ARCHS = tconfigs.reference_archs()
# decode against the reference: f32 on the REDUCED configs; the order of
# summation differs between XLA and ATen
DECODE_RTOL, DECODE_ATOL = 1e-4, 1e-5
# decode against the teacher-forced prefill: the reference's own tolerance
PREFILL_TOL = 2e-2
B, S = 2, 24


def _configs(arch, kv=""):
    rcfg = rconfigs.get_reduced(arch).with_(kv_cache_dtype=kv)
    cfg = tconfigs.get_reduced(arch).with_(kv_cache_dtype=kv)
    if cfg.num_experts:
        E = float(cfg.num_experts)
        rcfg, cfg = rcfg.with_(moe_capacity_factor=E), cfg.with_(moe_capacity_factor=E)
    return rcfg, cfg


def _perturbed_init(rcfg, seed=0):
    params = jax.tree.map(np.asarray, r_build_model(rcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("scale", "bq", "bk", "bv"):
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)

    perturb(params)
    return params


def _models(arch, kv=""):
    rcfg, cfg = _configs(arch, kv)
    params = _perturbed_init(rcfg)
    rmodel = r_build_model(rcfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return rmodel, jax.tree.map(jnp.asarray, params), model


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaves(tree, prefix=()):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_trees_match_reference(arch, full, kv):
    """Paths, shapes and dtypes of ``cache_specs`` (``meta``) against the
    reference's ``ShapeDtypeStruct`` tree: stacked over superblocks, batch
    axis 1, rolling caches at the window; ``init_caches`` is zeros of the
    same."""
    get = "get_config" if full else "get_reduced"
    rcfg = getattr(rconfigs, get)(arch).with_(kv_cache_dtype=kv)
    cfg = getattr(tconfigs, get)(arch).with_(kv_cache_dtype=kv)
    want = _leaves(r_build_model(rcfg).cache_specs(3, 1000))
    got = _leaves(build_model(cfg, device="meta").cache_specs(3, 1000))
    assert list(got) == list(want)
    for path, spec in want.items():
        assert tuple(got[path].shape) == tuple(spec.shape), path
        assert str(got[path].dtype).removeprefix("torch.") == np.dtype(spec.dtype).name, path
        assert got[path].device.type == "meta"
    if not full:
        caches = _leaves(build_model(cfg, device="cpu").init_caches(3, 40))
        for path, spec in _leaves(r_build_model(rcfg).cache_specs(3, 40)).items():
            assert tuple(caches[path].shape) == tuple(spec.shape)
            assert not caches[path].any()


@pytest.mark.parametrize("arch,kv", [(a, "") for a in ARCHS]
                         + [("gpt2-paper", "int8"), ("gemma2-27b", "int8")])
def test_decode_step_matches_reference(arch, kv):
    """24 steps at B=2 from zero caches (gemma2's local layer rolls over
    its 16-slot window): every step's logits and, at the end, every cache
    leaf (int8 payloads and bf16 scales included) against the
    reference's."""
    rmodel, params, model = _models(arch, kv)
    tokens = _tokens(model.cfg)
    rcaches = rmodel.init_caches(B, S + 4)
    caches = model.init_caches(B, S + 4)
    step = jax.jit(rmodel.decode_step)
    for t in range(S):
        rlogits, rcaches = step(params, rcaches, {
            "tokens": jnp.asarray(tokens[:, t:t + 1]), "pos": jnp.full((B,), t, jnp.int32)})
        logits, caches = model.decode_step(None, caches, {
            "tokens": torch.from_numpy(tokens[:, t:t + 1]).long(),
            "pos": torch.full((B,), t)})
        assert logits.dtype == torch.float32 and not logits.requires_grad
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   rtol=DECODE_RTOL, atol=DECODE_ATOL, err_msg=f"step {t}")
    want = _leaves(jax.tree.map(np.asarray, rcaches))
    got = _leaves(caches_to_numpy(caches))
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype, path
        g, w = g.astype(np.float32), w.astype(np.float32)
        if kv == "int8":
            # a key or value that differs within the tolerance may land on
            # the neighbouring int8 code or bf16 scale
            near = 1.0 if path[-1] in ("k", "v") else 2.0 ** -7 * np.abs(w)
            assert np.all(np.abs(g - w) <= near), path
            assert np.mean(g != w) <= 0.01, path
        else:
            np.testing.assert_allclose(g, w, rtol=DECODE_RTOL, atol=DECODE_ATOL,
                                       err_msg=str(path))


def test_decode_step_continues_from_the_reference_caches():
    """The caches cross over through ``interop``: the port resumes from
    the reference's caches after 12 steps and its next steps' logits
    equal the reference's at the decode tolerance."""
    rmodel, params, model = _models("gemma2-27b", "int8")
    tokens = _tokens(model.cfg, seed=1)
    rcaches = rmodel.init_caches(B, S + 4)
    step = jax.jit(rmodel.decode_step)
    for t in range(12):
        _, rcaches = step(params, rcaches, {
            "tokens": jnp.asarray(tokens[:, t:t + 1]), "pos": jnp.full((B,), t, jnp.int32)})
    caches = caches_from_jax(jax.tree.map(np.asarray, rcaches), device="cpu")
    for t in range(12, S):
        rlogits, rcaches = step(params, rcaches, {
            "tokens": jnp.asarray(tokens[:, t:t + 1]), "pos": jnp.full((B,), t, jnp.int32)})
        logits, caches = model.decode_step(None, caches, {
            "tokens": torch.from_numpy(tokens[:, t:t + 1]).long(),
            "pos": torch.full((B,), t)})
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   rtol=DECODE_RTOL, atol=DECODE_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_own_prefill(arch):
    """Token-by-token decode reproduces the teacher-forced ``prefill``
    logits (the last ``xent_chunk`` positions) at the reference's
    tolerance; ``prefill`` itself equals the reference's.  An
    encoder-decoder arch prefills on frames and decodes against their
    memory keys and values (``memory_kv``) in its caches."""
    rmodel, params, model = _models(arch)
    cfg = model.cfg
    tokens = _tokens(cfg, seed=2)
    batch = {"tokens": tokens}
    if cfg.is_encdec:
        batch["frames"] = (0.02 * np.random.default_rng(3).standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    ref = model.prefill(None, tb)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(rmodel.prefill(params, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})),
        rtol=DECODE_RTOL, atol=DECODE_ATOL)
    caches = model.init_caches(B, S + 4)
    if cfg.is_encdec:
        caches["mem_k"], caches["mem_v"] = model.memory_kv(None, tb["frames"])
    got = []
    for t in range(S):
        logits, caches = model.decode_step(None, caches, {
            "tokens": torch.from_numpy(tokens[:, t:t + 1]).long(),
            "pos": torch.full((B,), t)})
        got.append(logits[:, 0])
    got = torch.stack(got, dim=1)
    c = ref.shape[1]
    np.testing.assert_allclose(got[:, -c:].numpy(), ref.numpy(),
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)


def test_quantize_kv_bitwise_equals_reference():
    """``_quantize_kv`` against the reference's bit for bit: payload codes
    and bf16 scale bits, on normals, on rows whose quotients land on .5
    (round half to even in both), on an all-zero row (scale 1e-8) and on
    large values."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 4, 32)).astype(np.float32)
    x[1] = np.round(rng.standard_normal((4, 32)) * 4) / 2   # halves
    x[1, :, 0] = 63.5                                         # amax: /scale = 127
    x[2, 0] = 0.0
    x[3] *= 1e4
    x[4, :, 0] = -np.abs(x[4, :, 0]) - 10.0                  # a negative amax
    rq, rs = rattn._quantize_kv(jnp.asarray(x))
    q, s = tattn._quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.view(torch.int16).numpy(),
                                  np.asarray(rs).view(np.int16))
    assert not q[2, 0].any()
    # and for bf16 inputs (the full-width compute dtype)
    xb = jnp.asarray(x[:3] / 100, jnp.bfloat16)
    rq, rs = rattn._quantize_kv(xb)
    q, s = tattn._quantize_kv(caches_from_jax(np.asarray(xb), device="cpu"))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.view(torch.int16).numpy(), np.asarray(rs).view(np.int16))
    np.testing.assert_array_equal(
        tattn._dequantize_kv(q, s, torch.float32).numpy(),
        np.asarray(rattn._dequantize_kv(rq, rs, jnp.float32)))


def test_int8_kv_cache_close_to_float():
    """The counterpart of ``test_int8_kv_cache_close_to_bf16``: the int8
    cache tracks the float one over 16 decode steps (the reference's
    bound, 0.2)."""
    cfg = tconfigs.get_reduced("gpt2-paper")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, 16))

    def decode_all(model):
        caches = model.init_caches(B, 32)
        outs = []
        for t in range(16):
            logits, caches = model.decode_step(None, caches, {
                "tokens": torch.from_numpy(tokens[:, t:t + 1]).long(),
                "pos": torch.full((B,), t)})
            outs.append(logits[:, 0])
        return torch.stack(outs, 1)

    fp = build_model(cfg, device="cpu", seed=0)
    q = build_model(cfg.with_(kv_cache_dtype="int8"), device="cpu", seed=0)
    err = float((decode_all(q) - decode_all(fp)).abs().max())
    assert 0 < err < 0.2, err


def test_embed_scale_is_rounded_to_the_compute_dtype():
    """The embedding's ``sqrt(d_model)`` is the compute dtype's rounding,
    as the reference multiplies by it: bf16's 27.75 for d_model 768, not
    27.7128...; it is a buffer, not a parameter, and not in the state."""
    model = build_model(tconfigs.get_config("gpt2-paper"), device="meta")
    assert model._embed_scale.dtype == torch.bfloat16
    cpu = torch.tensor(768 ** 0.5, dtype=torch.bfloat16)
    assert float(cpu) == float(jnp.asarray(768 ** 0.5, jnp.bfloat16)) == 27.75
    assert "_embed_scale" not in model.state_dict()
    assert all("_embed_scale" not in n for n, _ in model.named_parameters())


def test_unported_block_kinds_raise_naming_the_family():
    """A decoder stack of a family with no block kind (the audio family is
    encoder-decoder only; ``diffusion`` is no family) raises naming it, as
    the reference's ``superblock_kinds`` refuses it; the VLM family's
    stack is dense attention, with the projector beside it."""
    cfg = tconfigs.get_reduced("gpt2-paper")
    for fam in ("audio", "diffusion"):
        with pytest.raises(NotImplementedError, match=repr(fam)):
            transformer.init_caches(cfg.with_(family=fam), 1, 8, device="meta")
        with pytest.raises(NotImplementedError, match=repr(fam)):
            build_model(cfg.with_(family=fam), device="meta")
        with pytest.raises(ValueError):
            rconfigs.get_reduced("gpt2-paper").with_(family=fam).param_count()
    vlm = build_model(cfg.with_(family="vlm"), device="meta")
    assert transformer.superblock_kinds(vlm.cfg) == [("attn", 0)]
    assert tuple(vlm.projector["w"].shape) == (cfg.d_model, cfg.d_model)
