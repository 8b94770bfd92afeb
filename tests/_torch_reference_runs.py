"""Reference (JAX) runs that a port test module starts in worker processes,
several at once, at its first use (``reference_pool``); each returns
numpy and plain Python values only.  It imports JAX and the reference
package, never ``repro_torch``.

The workers run XLA on one thread (``XLA_ONE_THREAD``): they run beside
the test workers, and a thread pool a process on a loaded machine spins
more than it computes.  The values are the same (a REDUCED trainer run
gives bit-identical params, residuals and losses either way)."""
import concurrent.futures
import contextlib
import multiprocessing
import os

import numpy as np

XLA_ONE_THREAD = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"


def one_thread_env(env: dict) -> dict:
    """``env`` with ``XLA_ONE_THREAD`` added to its ``XLA_FLAGS``."""
    flags = " ".join(f for f in (env.get("XLA_FLAGS", ""), XLA_ONE_THREAD) if f)
    return dict(env, XLA_FLAGS=flags)


def _one_thread():
    os.environ.update(one_thread_env(os.environ))


def flat(tree, prefix=""):
    """A nested dict of arrays as ``{dotted path: numpy array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def family_adamw(arch, tc, data, lr, steps):
    """``repro.train.Trainer.run`` on ``arch``'s REDUCED config with
    ``TrainConfig(**tc)`` and AdamW on ``cosine_warmup(lr, 1, steps)``,
    from ``PRNGKey(0)``: its initial params (nested numpy), history,
    schedule report, final params and residuals (flat) and step."""
    import jax

    import repro.configs as rconfigs
    from repro.data import DataConfig, make_loader
    from repro.models import build_model
    from repro.optim import adamw, cosine_warmup
    from repro.train.trainer import TrainConfig, Trainer

    tr = Trainer(build_model(rconfigs.get_reduced(arch)),
                 adamw(cosine_warmup(lr, 1, steps)), TrainConfig(**tc))
    state = tr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state["params"])
    state = tr.run(state, iter(make_loader(DataConfig(**data))), log=None)
    history = [{k: v if isinstance(v, (int, float, str)) else float(v)
                for k, v in h.items()} for h in tr.history]
    return {"init": init, "history": history,
            "schedule_report": tr.schedule_report(), "params": flat(state["params"]),
            "comp": flat(state["comp"]), "step": int(state["step"])}


@contextlib.contextmanager
def reference_pool(calls: dict, workers: int):
    """Start ``name -> (fn, args)`` on ``workers`` spawned processes at
    once; yields ``name -> future``.  The pool is shut down on exit."""
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_one_thread)
    try:
        yield {name: pool.submit(fn, *args) for name, (fn, args) in calls.items()}
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def perturbed_init(arch, seed=0):
    """The reference's REDUCED parameters (``PRNGKey(seed)``, nested numpy),
    with the zero-initialised norm scales and q/k/v biases set to small
    random values (numpy seed ``seed + 100``) so that their forward paths
    carry weight."""
    import jax

    import repro.configs as rconfigs
    from repro.models import build_model

    rcfg = rconfigs.get_reduced(arch)
    params = jax.tree.map(np.asarray, build_model(rcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    n = len(flat(params))

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("scale", "bq", "bk", "bv"):
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)

    perturb(params)
    assert len(flat(params)) == n
    return params


def frames(cfg, batch, seed=0):
    """Std-0.02 normal frames (batch, frontend_tokens, d_model), f32."""
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal((batch, cfg.frontend_tokens, cfg.d_model))
            ).astype(np.float32)


def family_grads(arch, seq):
    """The reference's eager ``jax.value_and_grad`` of ``loss_fn`` on
    ``arch``'s REDUCED config at :func:`perturbed_init`'s parameters, on a
    2-row batch of ``seq`` tokens and labels (numpy seed 0, row 1's first
    five labels -1; an encoder-decoder's batch with :func:`frames`): the
    parameters, the batch, the loss, its metrics and the gradients (flat)."""
    import jax
    import jax.numpy as jnp

    import repro.configs as rconfigs
    from repro.models import build_model

    rcfg = rconfigs.get_reduced(arch)
    rmodel = build_model(rcfg)
    params = perturbed_init(arch)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, rcfg.vocab_size, size=(2, seq)).astype(np.int32)
    labels = rng.integers(0, rcfg.vocab_size, size=(2, seq)).astype(np.int32)
    labels[1, :5] = -1
    batch = {"tokens": tokens, "labels": labels}
    if rcfg.is_encdec:
        batch["frames"] = frames(rcfg, 2)
    (loss, met), grads = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    return {"params": params, "batch": batch, "loss": float(loss),
            "metrics": {k: float(v) for k, v in met.items()},
            "grads": flat(jax.tree.map(np.asarray, grads))}


def _optimizer(spec):
    """``("sgd", lr, momentum)`` or ``("adamw-cosine", lr, steps)``: the
    reference optimizer, ``adamw(cosine_warmup(lr, 1, steps))`` for the
    second."""
    from repro.optim import adamw, cosine_warmup, sgd

    kind, lr, arg = spec
    if kind == "sgd":
        return sgd(lr, momentum=arg)
    return adamw(cosine_warmup(lr, 1, arg))


def trainer_run(arch, tc, data, opt_spec):
    """``repro.train.Trainer.run`` on ``arch``'s REDUCED config with
    ``TrainConfig(**tc)`` and the optimizer of ``opt_spec``
    (:func:`_optimizer`), from ``PRNGKey(0)``: the initial params and
    compressor state, the history, the schedule report, and the final
    ``{"params", "opt", "comp", "step"}``, every array as numpy in its
    tree."""
    import jax

    import repro.configs as rconfigs
    from repro.data import DataConfig, make_loader
    from repro.models import build_model
    from repro.train.trainer import TrainConfig, Trainer

    tr = Trainer(build_model(rconfigs.get_reduced(arch)), _optimizer(opt_spec),
                 TrainConfig(**tc))
    state = tr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state["params"])
    comp0 = jax.tree.map(np.asarray, state["comp"])
    state = tr.run(state, iter(make_loader(DataConfig(**data))), log=None)
    history = [{k: v if isinstance(v, (int, float, str)) else float(v)
                for k, v in h.items()} for h in tr.history]
    final = {k: jax.tree.map(np.asarray, state[k]) for k in ("params", "opt", "comp")}
    final["step"] = int(state["step"])
    return {"init": init, "comp0": comp0, "history": history,
            "schedule_report": tr.schedule_report(), "state": final}


def api_fit(arch, kw):
    """``repro.api.fit(arch, **kw)``: its final step and resilience
    summary."""
    import repro.api as rapi

    r = rapi.fit(arch, **kw)
    return {"step": int(r.state["step"]), "resilience": r.resilience}


def resilience_ladder(tc, data, lr, vocab_size, guards_kw, spec, steps):
    """``repro.train.Trainer.run`` on the REDUCED gpt2-paper at
    ``vocab_size`` with AdamW at ``lr``, ``steps`` steps under
    ``GuardConfig(**guards_kw)`` and the fault spec ``spec``, from
    ``PRNGKey(0)``: its trips by step and guard, actions (without their
    detail), resilience summary, injector log, final step and params (the
    tree's leaves)."""
    import jax

    import repro.configs as rconfigs
    import repro.resilience as rres
    from repro.data import DataConfig, make_loader
    from repro.models import build_model
    from repro.optim import adamw
    from repro.train.trainer import TrainConfig, Trainer

    tr = Trainer(build_model(rconfigs.get_reduced("gpt2-paper").with_(vocab_size=vocab_size)),
                 adamw(lr), TrainConfig(**tc))
    state = tr.run(tr.init_state(jax.random.PRNGKey(0)), iter(make_loader(DataConfig(**data))),
                   steps=steps, log=None, guards=rres.GuardConfig(**guards_kw), faults=spec)
    r = tr.resilience
    return {"trips": [(t.step, t.guard) for t in r.guards.trips],
            "actions": [{k: v for k, v in a.items() if k != "detail"} for a in r.actions],
            "summary": r.summary(), "injector_log": r.injector.log,
            "step": int(state["step"]),
            "params": [np.asarray(x) for x in jax.tree.leaves(state["params"])]}
