"""The port's configs, data loader and gpt2-paper model against the JAX
reference on the REDUCED config (f32 compute), from the same parameters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.data import DataConfig as RDataConfig
from repro.data import make_loader as r_make_loader
from repro.models import build_model as r_build_model

import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import build_model, param_shapes

torch.set_num_threads(2)

# loss and gradients: the order of summation differs between XLA and ATen
RTOL, ATOL = 1e-4, 1e-6


def _tree_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_paths(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(reduced):
    get = "get_reduced" if reduced else "get_config"
    ref = getattr(rconfigs, get)("gpt2-paper")
    port = getattr(tconfigs, get)("gpt2-paper")
    # the fields only the port has are at their defaults
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        expected = getattr(ref, f.name) if f.name in ref_fields else f.default
        assert getattr(port, f.name) == expected, f.name


@pytest.mark.parametrize("reduced", [False, True])
def test_param_paths_shapes_and_leaf_order_match_reference(reduced):
    get = "get_reduced" if reduced else "get_config"
    rcfg = getattr(rconfigs, get)("gpt2-paper")
    shapes = jax.eval_shape(r_build_model(rcfg).init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    ref = [(".".join(k.key for k in p), tuple(l.shape)) for p, l in leaves]
    port = list(param_shapes(getattr(tconfigs, get)("gpt2-paper")).items())
    assert port == ref
    model = build_model(getattr(tconfigs, get)("gpt2-paper"), device="meta")
    assert [(n, tuple(p.shape)) for n, p in model.named_leaves()] == ref
    if not reduced:
        assert sum(np.prod(s) for _, s in ref) == 190_532_352


@pytest.mark.parametrize("worker", [0, 1])
def test_loader_yields_reference_batches(worker):
    kw = dict(vocab_size=512, seq_len=16, global_batch=4, corpus_tokens=1 << 12)
    ref = r_make_loader(RDataConfig(**kw), num_workers=2, worker=worker)
    port = make_loader(DataConfig(**kw), num_workers=2, worker=worker, device="cpu")
    it = iter(port)
    for step in range(3):
        rb = ref._make(step)
        pb = next(it)
        for k in ("tokens", "labels"):
            assert pb[k].dtype == torch.int64 and pb[k].device.type == "cpu"
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(rb[k]))


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tconfigs.get_reduced("gpt2-paper")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        make_loader(DataConfig(vocab_size=512, seq_len=8, global_batch=2,
                               corpus_tokens=1 << 10))


def test_interop_round_trip():
    rcfg = rconfigs.get_reduced("gpt2-paper")
    tree = jax.tree.map(np.asarray, r_build_model(rcfg).init(jax.random.PRNGKey(3)))
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(params_from_jax(tree, device="cpu"))
    back = params_to_numpy(model)
    flat_a, flat_b = _tree_paths(tree), _tree_paths(back)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


def test_port_init_follows_reference_rules():
    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu", seed=1)
    p = dict(model.named_leaves())
    assert torch.count_nonzero(p["stack.blocks.b0.ln1.scale"]) == 0
    assert abs(float(p["embed.table"].detach().std()) - 0.02) < 0.002
    wq = p["stack.blocks.b0.attn.wq"]
    assert float(wq.detach().abs().max()) <= 2.0 / np.sqrt(wq.shape[-2]) + 1e-6
    other = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu", seed=1)
    assert torch.equal(other.embed["table"], p["embed.table"])


@pytest.mark.parametrize("seq_len", [64, 24])
def test_loss_and_grads_match_reference(seq_len):
    """seq 64 runs two attention chunks and two xent chunks; seq 24 falls
    back to one unchunked pass, as the reference does."""
    rcfg = rconfigs.get_reduced("gpt2-paper")
    rmodel = r_build_model(rcfg)
    params = rmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, rcfg.vocab_size, size=(2, seq_len)).astype(np.int32)
    labels = rng.integers(0, rcfg.vocab_size, size=(2, seq_len)).astype(np.int32)
    labels[0, :3] = -1   # ignored positions
    (rloss, rmet), rgrads = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(
        params, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    )

    model = build_model(tconfigs.get_reduced("gpt2-paper"), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    total, met = model.loss_fn({
        "tokens": torch.from_numpy(tokens).long(),
        "labels": torch.from_numpy(labels).long(),
    })
    total.backward()
    np.testing.assert_allclose(total.item(), float(rloss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]), rtol=RTOL)
    ref_grads = _tree_paths(jax.tree.map(np.asarray, rgrads))
    for path, p in model.named_leaves():
        np.testing.assert_allclose(
            p.grad.numpy(), ref_grads[path], rtol=RTOL, atol=ATOL, err_msg=path
        )


def test_remat_changes_memory_not_values():
    cfg = tconfigs.get_reduced("gpt2-paper")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, 512, size=(2, 32))).long()
             for k in ("tokens", "labels")}
    grads = []
    for remat in (False, True):
        model = build_model(cfg.with_(remat=remat), device="cpu", seed=2)
        total, _ = model.loss_fn(batch)
        total.backward()
        grads.append([p.grad.clone() for _, p in model.named_leaves()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
