"""The port's encoder-decoder (``models/encdec.py``, ``EncDecLM``) against
the JAX reference's ``repro.models.encdec`` on REDUCED
seamless-m4t-medium: the encoder, the memory's keys and values, the
cross-attention, the teacher-forced decoder, the loss and every gradient
(with and without the per-layer checkpoint), ``precompute_memory_kv``, the
decode caches' trees, shapes and dtypes, decode token by token against
the reference's and against the port's own prefill; the bucket plan's
``ReadyOrder`` and first-use stages, and the stages ``loss_fn`` calls
``before_layer`` for; ``interop`` over the parameter and cache trees.

The reference's parameters are made once for the file (``jax.random``),
with the zero-initialised norm scales set to small random values so that
their paths carry weight, and carried across with
``interop.params_from_jax``; inputs are made from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core import build_plan as r_build_plan
from repro.core import build_ready_order as r_build_ready_order
from repro.models import build_model as r_build_model
from repro.models import encdec as red

import repro_torch.configs as tconfigs
from repro_torch.core import build_plan, build_ready_order
from repro_torch.core.bucketing import EMBED_STAGE, bucket_first_use
from repro_torch.interop import (
    caches_from_jax,
    caches_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from repro_torch.models import EncDecLM, build_model
from repro_torch.models import encdec as ted

torch.set_num_threads(2)

ARCH = "seamless-m4t-medium"
# the families tests' tolerances: loss and gradients
RTOL, ATOL = 1e-4, 1e-6
# activations (memory, keys, values, hidden states) and decode logits
# against the reference: the decode tests' tolerance
DECODE_RTOL, DECODE_ATOL = 1e-4, 1e-5
PREFILL_TOL = 2e-2
B, S = 2, 24


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def ref():
    """``(rcfg, rmodel, params)``: the reference's REDUCED seamless and
    its parameters (numpy), norm scales perturbed."""
    rcfg = rconfigs.get_reduced(ARCH)
    rmodel = r_build_model(rcfg)
    params = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "scale":
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)

    perturb(params)
    return rcfg, rmodel, params


def _port(params, **overrides) -> EncDecLM:
    model = build_model(tconfigs.get_reduced(ARCH).with_(**overrides), device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return model


def _frames(cfg, batch=B, seed=0):
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal((batch, cfg.frontend_tokens, cfg.d_model))
            ).astype(np.float32)


def _close(got: torch.Tensor, want, rtol=DECODE_RTOL, atol=DECODE_ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_config_and_model_kind(ref):
    rcfg, _, _ = ref
    for get in ("get_config", "get_reduced"):
        cfg, want = getattr(tconfigs, get)(ARCH), getattr(rconfigs, get)(ARCH)
        # the fields only the port has are at their defaults
        ref_fields = {f.name for f in dataclasses.fields(want)}
        for f in dataclasses.fields(cfg):
            expected = getattr(want, f.name) if f.name in ref_fields else f.default
            assert getattr(cfg, f.name) == expected, f.name
        assert (cfg.is_encdec, cfg.modality, cfg.family) == (True, "audio", "audio")
    model = build_model(tconfigs.get_config(ARCH), device="meta")
    assert isinstance(model, EncDecLM)
    assert model.num_stages == 24
    assert sum(p.numel() for p in model.parameters()) == 977_860_608


def test_encode_matches_reference(ref):
    rcfg, _, params = ref
    model = _port(params)
    frames = _frames(rcfg)
    want = red.encode(jax.tree.map(jnp.asarray, params["encdec"]), jnp.asarray(frames), rcfg)
    got = ted.encode(model.encdec, torch.from_numpy(frames), model.cfg)
    _close(got, want)
    # the encoder attends both ways: a change at the last frame moves the
    # first frame's memory
    moved = frames.copy()
    moved[:, -1] += 1.0
    assert not torch.equal(ted.encode(model.encdec, torch.from_numpy(moved), model.cfg)[:, 0],
                           got[:, 0])


def test_memory_kv_and_cross_attn_match_reference(ref):
    """``_memory_kv`` of decoder row 1's ``xattn`` and the cross-attention
    (no mask: every query sees every memory position) at S = 5 queries
    against 16 memory positions."""
    rcfg, _, params = ref
    model = _port(params)
    rng = np.random.default_rng(1)
    memory = rng.standard_normal((B, rcfg.frontend_tokens, rcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 5, rcfg.d_model)).astype(np.float32)
    rx = jax.tree.map(lambda a: jnp.asarray(a[1]), params["encdec"]["decoder"]["xattn"])
    tx = {k: v[1] for k, v in model.encdec["decoder"]["xattn"].items()}
    rk, rv = red._memory_kv(rx, jnp.asarray(memory), rcfg)
    k, v = ted._memory_kv(tx, torch.from_numpy(memory), model.cfg)
    assert tuple(k.shape) == (B, rcfg.frontend_tokens, rcfg.num_kv_heads, rcfg.head_dim)
    _close(k, rk)
    _close(v, rv)
    _close(ted.cross_attn(tx, torch.from_numpy(x), k, v, model.cfg),
           red.cross_attn(rx, jnp.asarray(x), rk, rv, rcfg))
    ra = jax.tree.map(lambda a: jnp.asarray(a[0]), params["encdec"]["encoder"]["attn"])
    ta = {n: t[0] for n, t in model.encdec["encoder"]["attn"].items()}
    _close(ted._bidir_attn(ta, torch.from_numpy(memory), model.cfg),
           red._bidir_attn(ra, jnp.asarray(memory), rcfg))


def test_decode_train_matches_reference(ref):
    rcfg, _, params = ref
    model = _port(params)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 32, rcfg.d_model)).astype(np.float32)
    memory = rng.standard_normal((B, rcfg.frontend_tokens, rcfg.d_model)).astype(np.float32)
    want = red.decode_train(jax.tree.map(jnp.asarray, params["encdec"]), jnp.asarray(x),
                            jnp.asarray(memory), rcfg)
    _close(ted.decode_train(model.encdec, torch.from_numpy(x), torch.from_numpy(memory),
                            model.cfg), want)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(ref, remat):
    """Loss at 1e-4, every gradient at rtol 1e-4, atol 1e-6; the per-layer
    checkpoint (``remat``) changes memory, not values; ``aux_loss`` is 0;
    a label of -1 is ignored."""
    rcfg, rmodel, params = ref
    rng = np.random.default_rng(3)
    T = 64
    tokens = rng.integers(0, rcfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, rcfg.vocab_size, (B, T)).astype(np.int32)
    labels[1, :7] = -1
    frames = _frames(rcfg, seed=4)
    batch = {"tokens": tokens, "labels": labels, "frames": frames}
    (rloss, rmet), rgrads = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port(params, remat=remat)
    total, met = model.loss_fn({"tokens": torch.from_numpy(tokens).long(),
                                "labels": torch.from_numpy(labels).long(),
                                "frames": torch.from_numpy(frames)})
    total.backward()
    np.testing.assert_allclose(total.item(), float(rloss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(met["loss"].detach()), float(rmet["loss"]), rtol=RTOL)
    assert float(met["aux_loss"]) == float(rmet["aux_loss"]) == 0.0
    want = _flat(jax.tree.map(np.asarray, rgrads))
    assert [p for p, _ in model.named_leaves()] == list(want)
    for path, p in model.named_leaves():
        _close(p.grad, want[path], RTOL, ATOL, msg=path)


def test_precompute_memory_kv_and_cache_trees(ref):
    """``precompute_memory_kv`` against the reference's (L, B, T, K, hd);
    ``dec_caches``: the ``self`` cache stacked over the decoder rows and
    ``mem_k``/``mem_v`` in the compute dtype, at REDUCED and full config,
    float and int8 KV, against the reference's ``ShapeDtypeStruct``s;
    ``init_caches`` zeros of the same."""
    rcfg, _, params = ref
    model = _port(params)
    memory = np.random.default_rng(5).standard_normal(
        (B, rcfg.frontend_tokens, rcfg.d_model)).astype(np.float32)
    rk, rv = red.precompute_memory_kv(jax.tree.map(jnp.asarray, params["encdec"]),
                                      jnp.asarray(memory), rcfg)
    k, v = ted.precompute_memory_kv(model.encdec, torch.from_numpy(memory), model.cfg)
    _close(k, rk)
    _close(v, rv)
    for full in (False, True):
        for kv in ("", "int8"):
            get = "get_config" if full else "get_reduced"
            rc = getattr(rconfigs, get)(ARCH).with_(kv_cache_dtype=kv)
            tc = getattr(tconfigs, get)(ARCH).with_(kv_cache_dtype=kv)
            want = _flat(r_build_model(rc).cache_specs(3, 40))
            got = _flat(build_model(tc, device="meta").cache_specs(3, 40))
            assert sorted(got) == sorted(want)
            for path, spec in want.items():
                assert tuple(got[path].shape) == tuple(spec.shape), path
                assert str(got[path].dtype).removeprefix("torch.") == \
                    np.dtype(spec.dtype).name, path
            L, T = tc.num_layers, tc.frontend_tokens
            assert tuple(got["mem_k"].shape) == (L, 3, T, tc.num_kv_heads, tc.head_dim)
            assert got["mem_v"].dtype == getattr(torch, tc.compute_dtype)
    caches = _flat(model.init_caches(3, 40))
    for path, spec in _flat(r_build_model(rcfg).cache_specs(3, 40)).items():
        assert tuple(caches[path].shape) == tuple(spec.shape) and not caches[path].any()


def _decode_all(step, model_params, caches, tokens):
    out = []
    for t in range(tokens.shape[1]):
        logits, caches = step(model_params, caches, t)
        out.append(logits)
    return out, caches


def test_decode_matches_reference_and_own_prefill(ref):
    """The counterpart of ``tests/test_decode_parity.py``: decode token by
    token from the request's memory keys and values reproduces the
    teacher-forced ``prefill`` (the last ``xent_chunk`` positions) at the
    reference's 2e-2, and every step's logits and, at the end, every cache
    leaf equal the reference's decode at 1e-4/1e-5; ``prefill`` equals the
    reference's."""
    rcfg, rmodel, params = ref
    model = _port(params)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(rcfg, seed=7)
    jparams = jax.tree.map(jnp.asarray, params)
    tframes = torch.from_numpy(frames)
    pre = model.prefill(None, {"tokens": torch.from_numpy(tokens).long(), "frames": tframes})
    _close(pre, rmodel.prefill(jparams, {"tokens": jnp.asarray(tokens),
                                         "frames": jnp.asarray(frames)}),
           DECODE_RTOL, DECODE_ATOL)

    memory = red.encode(jparams["encdec"], jnp.asarray(frames), rcfg)
    rcaches = dict(rmodel.init_caches(B, S + 4))
    rcaches["mem_k"], rcaches["mem_v"] = red.precompute_memory_kv(
        jparams["encdec"], memory, rcfg)
    caches = model.init_caches(B, S + 4)
    caches["mem_k"], caches["mem_v"] = model.memory_kv(None, tframes)
    _close(caches["mem_k"], rcaches["mem_k"], DECODE_RTOL, DECODE_ATOL)
    rstep = jax.jit(rmodel.decode_step)
    got = []
    for t in range(S):
        rlogits, rcaches = rstep(jparams, rcaches, {
            "tokens": jnp.asarray(tokens[:, t:t + 1]), "pos": jnp.full((B,), t, jnp.int32)})
        logits, caches = model.decode_step(None, caches, {
            "tokens": torch.from_numpy(tokens[:, t:t + 1]).long(),
            "pos": torch.full((B,), t)})
        assert logits.dtype == torch.float32 and not logits.requires_grad
        _close(logits, rlogits, DECODE_RTOL, DECODE_ATOL, f"step {t}")
        got.append(logits[:, 0])
    want = _flat(jax.tree.map(np.asarray, rcaches))
    have = _flat(caches_to_numpy(caches))
    assert sorted(have) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(have[path], w, rtol=DECODE_RTOL, atol=DECODE_ATOL,
                                   err_msg=path)
    got = torch.stack(got, dim=1)
    c = pre.shape[1]
    _close(got[:, -c:], pre.numpy(), PREFILL_TOL, PREFILL_TOL)


def test_ready_order_and_first_use_on_the_reduced_plan():
    """The plan of ``tests/test_overlap.py``'s ``_arch_plan`` (bucket
    bytes 8 KiB, at most 64 buckets, I=4): ``ReadyOrder`` equals the
    reference's, head buckets first and embedding buckets last; each
    bucket's first-use stage is the earliest of its segments' (encoder row
    ``r`` at ``r``, ``enc_norm`` at ``E``, decoder row ``r`` at ``E + r``,
    the final norm and head at ``E + L``, the embedding before them all)."""
    rcfg, cfg = rconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    kw = dict(bucket_bytes=1 << 13, max_buckets=64, interval=4)
    rplan = r_build_plan(jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0)), **kw)
    model = build_model(cfg, device="meta")
    plan = build_plan(model.named_leaves(), **kw)
    assert plan.num_buckets == rplan.num_buckets > 8
    want, got = r_build_ready_order(rplan), build_ready_order(plan)
    assert (got.bucket_layer, got.ranks, got.num_layers, got.order) == \
        (want.bucket_layer, want.ranks, want.num_layers, want.order)
    E, L = cfg.encoder_layers, cfg.num_layers
    stages = bucket_first_use(plan)

    def stage(path, seg):
        if path.startswith("encdec.encoder."):
            return seg.row_lo
        if path.startswith("encdec.enc_norm."):
            return E
        if path.startswith("encdec.decoder."):
            return E + seg.row_lo
        if path.startswith(("encdec.final_norm.", "head.")):
            return E + L
        assert path.startswith("embed.")
        return EMBED_STAGE

    for b, bucket in enumerate(plan.buckets):
        assert stages[b] == min(stage(plan.leaf_paths[s.leaf_idx], s)
                                for s in bucket.segments)
    assert set(stages) <= set(range(EMBED_STAGE, E + L + 1))
    assert {EMBED_STAGE, 0, E, E + L} <= set(stages)

    def only(prefix):
        return [b for b, bucket in enumerate(plan.buckets)
                if all(plan.leaf_paths[s.leaf_idx].startswith(prefix)
                       for s in bucket.segments)]

    # the head's backward runs first, the embedding's last
    head, embed = only("head."), only("embed.")
    assert head and embed
    assert max(got.ranks[b] for b in head) < min(got.ranks[b] for b in embed)
    assert all(stages[b] == E + L for b in head)


def test_loss_fn_calls_before_layer_once_a_stage_in_order(ref):
    """``before_layer`` runs before every stage, each once and in order
    (``0 .. E + L``), and before the rows of that stage are read: each
    decoder row is read after the call for its stage (a row's read is
    observed through a deferred row of the replacement tree)."""
    _, _, params = ref
    model = _port(params, remat=True)
    cfg = model.cfg
    E, L = cfg.encoder_layers, cfg.num_layers
    events = []
    tree = {"embed": model.embed, "head": model.head, "encdec": {
        k: v for k, v in model.encdec.items()}}
    dec = dict(model.encdec["decoder"].items())
    tree["encdec"]["decoder"] = {
        k: ({n: [_Read(events, f"dec{r}", t[r]) for r in range(L)] for n, t in v.items()}
            if hasattr(v, "items") else v)
        for k, v in dec.items()}
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.long),
             "labels": torch.zeros((1, 8), dtype=torch.long),
             "frames": torch.from_numpy(_frames(cfg, 1))}
    base, _ = model.loss_fn(batch)
    total, _ = model.loss_fn(batch, before_layer=lambda i: events.append(i), params=tree)
    assert torch.equal(total, base)
    calls = [e for e in events if isinstance(e, int)]
    assert calls == list(range(E + L + 1)) == list(range(model.num_stages + 1))
    for r in range(L):
        first = events.index(f"dec{r}")
        assert events.index(E + r) < first
        assert r == L - 1 or first < events.index(E + r + 1)


class _Read:
    """A deferred row (``transformer.resolve``) that logs its first read."""

    def __init__(self, log, name, value):
        self.log, self.name, self.value = log, name, value

    def __call__(self, dtype=None):
        if self.name not in self.log:
            self.log.append(self.name)
        return self.value if dtype is None else self.value.to(dtype)


def test_interop_round_trips_the_encdec_trees(ref):
    """``params_from_jax``/``params_to_numpy`` over the ``encdec.*`` paths
    (f32 and bf16), and ``caches_from_jax``/``caches_to_numpy`` over the
    ``self`` cache and ``mem_k``/``mem_v``: the same paths, dtypes and
    values both ways."""
    rcfg, _, params = ref
    for dtype in ("float32", "bfloat16"):
        rc = rcfg.with_(param_dtype=dtype, compute_dtype=dtype)
        rmodel = r_build_model(rc)
        want = _flat(jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(1))))
        model = build_model(tconfigs.get_reduced(ARCH).with_(param_dtype=dtype,
                                                              compute_dtype=dtype),
                            device="cpu")
        model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, rmodel.init(
            jax.random.PRNGKey(1))), device="cpu"))
        back = _flat(params_to_numpy(model))
        assert sorted(back) == sorted(want)
        for path, w in want.items():
            assert back[path].dtype == w.dtype, path
            np.testing.assert_array_equal(back[path].astype(np.float32),
                                          w.astype(np.float32), err_msg=path)
        rc_caches = jax.tree.map(
            lambda a: (np.arange(a.size) % 7).reshape(a.shape).astype(a.dtype),
            jax.tree.map(np.asarray, rmodel.init_caches(2, 16)))
        caches = caches_from_jax(rc_caches, device="cpu")
        specs = _flat(model.cache_specs(2, 16))
        got = _flat(caches)
        assert sorted(got) == sorted(specs) and "mem_k" in got
        for path, t in got.items():
            assert t.shape == specs[path].shape and t.dtype == specs[path].dtype, path
        for path, a in _flat(caches_to_numpy(caches)).items():
            np.testing.assert_array_equal(a, _flat(rc_caches)[path], err_msg=path)
