"""The port's ``Trainer.run`` on the two frontend families' REDUCED
configs, fed batches that carry their frontend embeddings (``frames`` for
seamless-m4t-medium, ``patch_embeds`` for pixtral-12b): COVAP I=4 with
AdamW over a full cycle plus one step against ``repro.train.Trainer.run``
on the same batches; seamless's arena+sharded and fused forms against the
port's own post path bit for bit in a one-rank gloo group; and
``api.fit`` on seamless without batches failing on the missing frames in
both packages, as the reference's synthetic loader has none."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.api as rapi
import repro.configs as rconfigs
from repro.models import build_model as r_build_model
from repro.optim import adamw as r_adamw
from repro.optim import cosine_warmup as r_cosine_warmup
from repro.train.trainer import TrainConfig as RTrainConfig
from repro.train.trainer import Trainer as RTrainer

import repro_torch.api as api
import repro_torch.configs as tconfigs
from repro_torch.core import build_ready_order
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train import TrainConfig, Trainer

torch.set_num_threads(2)

STEPS = 5                       # a full COVAP cycle (I = 4) + 1
TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=1, steps=STEPS)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
LR = 1e-3
FRONTEND = {"seamless-m4t-medium": "frames", "pixtral-12b": "patch_embeds"}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batches(arch):
    """The synthetic loader's first ``STEPS`` batches, each with std-0.02
    frontend embeddings of its own (numpy seed ``(7, step)``)."""
    cfg = tconfigs.get_reduced(arch)
    loader = make_loader(DataConfig(**DATA), device="cpu")
    out = []
    for s in range(STEPS):
        batch = loader.make(s)
        rng = np.random.default_rng((7, s))
        batch[FRONTEND[arch]] = torch.from_numpy((0.02 * rng.standard_normal(
            (DATA["global_batch"], cfg.frontend_tokens, cfg.d_model))).astype(np.float32))
        out.append(batch)
    return out


def _run(cfg, batches, init=None, group=None, **tc):
    model = build_model(cfg, device="cpu")
    if init is not None:
        model.load_state_dict(params_from_jax(init, device="cpu"))
    tr = Trainer(model, adamw(cosine_warmup(LR, 1, STEPS)),
                 TrainConfig(**dict(TC, **tc)), group=group)
    return tr, tr.run(tr.init_state(), iter(batches), log=None)


@pytest.mark.parametrize("arch", sorted(FRONTEND))
def test_trainer_with_frontend_batches_matches_reference(arch):
    """The tolerances of ``test_torch_family_trainer.py``'s AdamW runs:
    losses at rtol 1e-5, params and residuals at rtol 1e-4 and ``atol = 2
    * lr * steps``, and 99.9% of param elements at rtol 1e-4, atol 1e-6;
    the frontend's own leaves move (pixtral's projector)."""
    batches = _batches(arch)
    rtr = RTrainer(r_build_model(rconfigs.get_reduced(arch)),
                   r_adamw(r_cosine_warmup(LR, 1, STEPS)), RTrainConfig(**TC))
    rstate = rtr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, rstate["params"])
    rbatches = [{k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.long
                                else v.numpy()) for k, v in b.items()} for b in batches]
    rstate = rtr.run(rstate, iter(rbatches), log=None)
    tr, state = _run(tconfigs.get_reduced(arch), batches, init)
    assert state["step"] == rstate["step"] == STEPS
    assert tr.schedule_report() == rtr.schedule_report()
    for key in ("loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose([h[key] for h in tr.history],
                                   [h[key] for h in rtr.history], rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    rparams, rresid = _flat(rstate["params"]), _flat(rstate["comp"])
    close = total = 0
    for (path, _), p, r in zip(tr.model.named_leaves(), state["params"], state["comp"]):
        np.testing.assert_allclose(p.detach().numpy(), rparams[path], rtol=1e-4,
                                   atol=2 * LR * STEPS, err_msg=path)
        np.testing.assert_allclose(r.numpy(), rresid[path], rtol=1e-4,
                                   atol=2 * LR * STEPS, err_msg=path)
        ok = np.isclose(p.detach().numpy(), rparams[path], rtol=1e-4, atol=1e-6)
        close += int(ok.sum())
        total += ok.size
    assert close / total > 0.999
    if arch == "pixtral-12b":
        names = [n for n, _ in tr.model.named_leaves()]
        w = state["params"][names.index("projector.w")]
        assert not np.array_equal(w.detach().numpy(), init["projector"]["w"])


@pytest.fixture
def one_rank_gloo(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


FORMS = {"arena+sharded": dict(arena=True, sync="sharded"),
         "fused": dict(overlap="fused")}


def test_encdec_forms_equal_post_bitwise(one_rank_gloo):
    """seamless on arena+sharded and on fused (with the per-layer
    checkpoint) against the post path over a full cycle plus one step on
    the same batches, in a one-rank gloo group: losses, params, Adam
    moments and residuals by ``torch.equal``; the fused hooks fire in
    ``ReadyOrder``, the embedding's after the encoder's.  The sharded run's head
    all-gather settles every bucket at its stage: the encoder rows, then
    ``enc_norm`` with decoder row 0, the decoder rows and the head, one
    ``before_layer`` call each."""
    arch = "seamless-m4t-medium"
    cfg = tconfigs.get_reduced(arch)
    batches = _batches(arch)
    tp, sp = _run(cfg, batches, group=one_rank_gloo)
    for name, opts in FORMS.items():
        tf, sf = _run(cfg.with_(remat=True) if "fused" in name else cfg, batches,
                      group=one_rank_gloo, **opts)
        assert [h["total_loss"] for h in tf.history] == \
            [h["total_loss"] for h in tp.history], name
        for part in ("params", "comp"):
            for a, b in zip(sf[part], sp[part]):
                assert torch.equal(a, b), (name, part)
        for key in ("m", "v"):
            for a, b in zip(sf["opt"][key], sp["opt"][key]):
                assert torch.equal(a, b), (name, key)
        if "sharded" in name:
            layers = [i for kind, i in tf.gather_events if kind == "layer"]
            assert layers == list(range(cfg.encoder_layers + cfg.num_layers + 1))
            settled = [i for kind, i in tf.gather_events if kind == "settle"]
            assert sorted(settled) == list(range(tf.plan.num_buckets))
        else:
            # the hooks fire in ReadyOrder: the head's first, the decoder's,
            # enc_norm's, the encoder's, the embedding's last
            fired = tf.last_step_fn.fired
            assert sorted(fired) == list(range(tf.plan.num_buckets))
            ready = build_ready_order(tf.plan)
            layers = [ready.bucket_layer[b] for b in fired]
            assert layers == sorted(layers, reverse=True)


def test_fit_without_frames_fails_naming_them_in_both_packages():
    """The synthetic loader yields ``tokens`` and ``labels`` only: the
    encoder-decoder's loss reads ``batch["frames"]`` and raises
    ``KeyError: 'frames'``, in the reference and in the port."""
    kw = dict(reduced=True, steps=1, seq_len=16, global_batch=4, interval=1)
    with pytest.raises(KeyError, match="frames"):
        rapi.fit("seamless-m4t-medium", log=None, **kw)
    with pytest.raises(KeyError, match="frames"):
        api.fit("seamless-m4t-medium", device="cpu", **kw)
