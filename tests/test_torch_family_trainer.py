"""The port's ``Trainer.run`` on the new families' REDUCED configs: COVAP
I=4 with AdamW over a full cycle plus one step against
``repro.train.Trainer.run`` (qwen1.5-0.5b, gemma2-27b, deepseek-moe-16b,
xlstm-125m, zamba2-2.7b), the arena, sharded and fused forms against the
port's own post path bit for bit (zamba2 at 4 layers, so that its
weight-shared block runs twice a step), and a leaf outside the loss."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_reference_runs as ref_runs
import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, make_loader
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train import TrainConfig, Trainer, loss_and_grads

torch.set_num_threads(2)

STEPS = 5                       # a full COVAP cycle (I = 4) + 1
TC = dict(compressor="covap", interval=4, bucket_bytes=1 << 14, max_buckets=32,
          log_every=1, steps=STEPS)
DATA = dict(vocab_size=512, seq_len=32, global_batch=4, corpus_tokens=1 << 14)
LR = 1e-3


ADAMW_ARCHS = ["qwen1.5-0.5b", "gemma2-27b", "deepseek-moe-16b", "xlstm-125m",
               "zamba2-2.7b"]
# the reference runs of the AdamW test go to this many processes at once
REFERENCE_PROCESSES = 3


@pytest.fixture(scope="module", autouse=True)
def references():
    """Each arch's reference AdamW run (``_torch_reference_runs.family_adamw``),
    all started when the module starts: ``arch -> future``."""
    calls = {arch: (ref_runs.family_adamw, (arch, TC, DATA, LR, STEPS))
             for arch in ADAMW_ARCHS}
    with ref_runs.reference_pool(calls, REFERENCE_PROCESSES) as futures:
        yield futures


def _port(cfg, init, opt, steps=STEPS, group=None, **tc):
    model = build_model(cfg, device="cpu")
    if init is not None:
        model.load_state_dict(params_from_jax(init, device="cpu"))
    tr = Trainer(model, opt, TrainConfig(**dict(TC, steps=steps, **tc)), group=group)
    state = tr.run(tr.init_state(), make_loader(DataConfig(**DATA), device="cpu"),
                   log=None)
    return tr, state


@pytest.mark.parametrize("arch", ADAMW_ARCHS)
def test_trainer_adamw_matches_reference(arch, references):
    """The tolerances of ``tests/test_torch_trainer.py``'s AdamW run:
    losses at rtol 1e-5, params and residuals at rtol 1e-4 and ``atol = 2
    * lr * steps`` (Adam turns an ulp of a near-zero gradient into an
    lr-sized step), and 99.9% of param elements at rtol 1e-4, atol 1e-6."""
    ref = references[arch].result(timeout=900)
    tr, state = _port(tconfigs.get_reduced(arch), ref["init"],
                      adamw(cosine_warmup(LR, 1, STEPS)))
    assert state["step"] == ref["step"] == STEPS
    assert tr.schedule_report() == ref["schedule_report"]
    for key in ("loss", "aux_loss", "total_loss"):
        np.testing.assert_allclose([h[key] for h in tr.history],
                                   [h[key] for h in ref["history"]], rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    rparams, rresid = ref["params"], ref["comp"]
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


@pytest.fixture
def one_rank_gloo(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


FORMS = {"arena": dict(arena=True), "sharded": dict(sync="sharded"),
         "fused": dict(overlap="fused"),
         "fused-sharded-arena": dict(overlap="fused", sync="sharded", arena=True)}


# each arch's post run, the one every form of it is held against: run
# once, by the first of its forms
_POST: dict = {}


# the depth of a forms run: zamba2's REDUCED 2 layers are one superblock,
# and the shared block runs once; at 4 it runs after each of two
FORM_LAYERS = {"zamba2-2.7b": 4}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "gemma2-27b", "xlstm-125m",
                                  "zamba2-2.7b"])
def test_forms_equal_post_bitwise(arch, form, one_rank_gloo):
    """Each form against the post path over a full cycle plus one step, in
    a one-rank gloo group (sharded sync's head all-gather runs and settles
    each bucket at its superblock; gemma2's one superblock holds two
    layers; zamba2's shared block is read once, after the head gather's
    stage 0, and under fused its hook fires once, after both
    applications' gradients): losses, params, Adam moments and residuals
    by ``torch.equal``."""
    cfg = tconfigs.get_reduced(arch)
    if arch in FORM_LAYERS:
        cfg = cfg.with_(num_layers=FORM_LAYERS[arch])
    if arch not in _POST:
        _POST[arch] = _port(cfg, None, adamw(cosine_warmup(LR, 1, STEPS)),
                            group=one_rank_gloo)
    tp, sp = _POST[arch]
    tf, sf = _port(cfg.with_(remat=True) if "fused" in form else cfg, None,
                   adamw(cosine_warmup(LR, 1, STEPS)), group=one_rank_gloo,
                   **FORMS[form])
    assert [h["total_loss"] for h in tf.history] == [h["total_loss"] for h in tp.history]
    for part in ("params", "comp"):
        for a, b in zip(sf[part], sp[part]):
            assert torch.equal(a, b), part
    for key in ("m", "v"):
        for a, b in zip(sf["opt"][key], sp["opt"][key]):
            assert torch.equal(a, b), key
    if "sharded" in form:
        layers = [i for kind, i in tf.gather_events if kind == "layer"]
        assert layers == list(range(tf.model.num_stages + 1))
    if arch == "zamba2-2.7b":
        assert tf.model.num_stages == 2


class _TwoLeaves:
    """A model whose loss reads only its first leaf."""

    def __init__(self):
        self.a = torch.nn.Parameter(torch.ones(3))
        self.b = torch.nn.Parameter(torch.ones(2, dtype=torch.bfloat16))

    def loss_fn(self, batch, before_layer=None):
        total = torch.sum(self.a * batch["x"])
        return total, {"loss": total}


def test_loss_and_grads_gives_zeros_for_an_unreached_leaf():
    """As ``jax.grad`` does: a zero gradient of the leaf's shape and dtype,
    not ``None``."""
    m = _TwoLeaves()
    grads, metrics = loss_and_grads(m, [m.a, m.b], {"x": torch.arange(3.0)})
    assert torch.equal(grads[0], torch.arange(3.0))
    assert grads[1].dtype == torch.bfloat16 and torch.equal(grads[1], torch.zeros(2, dtype=torch.bfloat16))
    assert m.a.grad is None and m.b.grad is None
    assert float(metrics["total_loss"]) == 3.0
