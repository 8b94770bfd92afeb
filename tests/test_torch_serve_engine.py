"""The port's serving engine: counterparts of the reference's
``test_serve_engine.py`` (batching invariance, slot reuse, finish reasons,
chunked-prefill call counting, reset, stage metrics, int8 KV, shedding
and retries) and ``test_serve_parity.py`` (batched == sequential for the
seven archs, the paged path == a dense decode), and the port's engine
against the reference's on the same parameters and prompts: the same
greedy tokens, finish reasons, page tables after every engine step, and
prefill call counts.

Batched against sequential, tokens and finish reasons must be equal, as
the reference asserts; the logits behind them are held at
``BATCH_RTOL``/``BATCH_ATOL``, since a GEMM's last bits may change with
its row count.  No test asserts a wall-clock threshold."""
import json
import math

import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import build_model as r_build_model
from repro.serve import Engine as REngine
from repro.serve import ServeConfig as RServeConfig

import repro_torch.configs as tconfigs
from repro_torch import obs
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.resilience import release_pages, starve_pages
from repro_torch.serve import (
    Engine,
    PagePool,
    ServeConfig,
    TrafficConfig,
    gather_caches,
    greedy_sample,
    run_traffic,
    sweep,
)

torch.set_num_threads(2)

ARCHS = tconfigs.reference_archs()
PROMPTS = [[5, 17, 3, 9], [88, 2], [1, 1, 1, 1, 1, 1, 1], [4, 40, 14]]
SC = dict(max_len=48, max_new_tokens=4, page_size=8, prefill_chunk=4)
# batched against sequential logits, f32 on the CPU
BATCH_RTOL, BATCH_ATOL = 1e-5, 1e-5


def _params(rcfg, seed):
    return jax.tree.map(np.asarray, r_build_model(rcfg).init(jax.random.PRNGKey(seed)))


def _port(cfg, params):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params, device="cpu"))
    return model


@pytest.fixture(scope="module")
def model_and_params():
    """REDUCED gpt2-paper at vocab 128 with the reference's PRNGKey(42)
    parameters; the engine takes the model's own (``params=None``)."""
    rcfg = rconfigs.get_reduced("gpt2-paper").with_(vocab_size=128)
    return _port(tconfigs.get_reduced("gpt2-paper").with_(vocab_size=128),
                 _params(rcfg, 42)), None


def _arch(arch, kv=""):
    rcfg = rconfigs.get_reduced(arch).with_(kv_cache_dtype=kv)
    cfg = tconfigs.get_reduced(arch).with_(kv_cache_dtype=kv)
    if cfg.num_experts:
        # drop-free capacity: token dropping depends on batch composition
        E = float(cfg.num_experts)
        rcfg, cfg = rcfg.with_(moe_capacity_factor=E), cfg.with_(moe_capacity_factor=E)
    params = _params(rcfg, 0)
    return r_build_model(rcfg), params, _port(cfg, params)


def test_single_request_greedy(model_and_params):
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=8))
    assert eng.device == torch.device("cpu")
    rid = eng.submit([5, 17, 3])
    results = eng.run_until_done()
    comp = results[rid]
    assert len(comp.tokens) == 8
    assert comp.finish_reason == "length"
    assert all(0 <= t < 128 for t in comp.tokens)
    assert comp.finish_s >= comp.first_token_s >= comp.submit_s


def test_batching_invariance(model_and_params):
    """A request's output must not depend on batch neighbours."""
    model, params = model_and_params
    prompt = [5, 17, 3, 9]
    eng1 = Engine(model, params, ServeConfig(batch_slots=1, max_len=64, max_new_tokens=6))
    r1 = eng1.submit(prompt)
    out1 = eng1.run_until_done()[r1].tokens
    eng2 = Engine(model, params, ServeConfig(batch_slots=3, max_len=64, max_new_tokens=6))
    r2 = eng2.submit(prompt)
    eng2.submit([88, 2])
    eng2.submit([1, 1, 1, 1, 1])
    assert eng2.run_until_done()[r2].tokens == out1


def test_slot_reuse_does_not_leak_state(model_and_params):
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=1, max_len=64, max_new_tokens=5))
    ra = eng.submit([7, 7, 7])
    rb = eng.submit([7, 7, 7])  # will reuse slot 0 (and recycled pages)
    res = eng.run_until_done()
    assert res[ra].tokens == res[rb].tokens


def test_many_requests_complete(model_and_params):
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=3, max_len=64, max_new_tokens=4))
    rids = [eng.submit([i + 1, i + 2]) for i in range(7)]
    res = eng.run_until_done()
    assert set(rids) <= set(res)
    assert all(len(res[r].tokens) == 4 for r in rids)
    assert all(res[r].finish_reason == "length" for r in rids)


def test_finish_reason_eos(model_and_params):
    model, params = model_and_params
    prompt = [5, 17, 3]
    eng = Engine(model, params, ServeConfig(batch_slots=1, max_len=64, max_new_tokens=4))
    r = eng.submit(prompt)
    first = eng.run_until_done()[r].tokens[0]
    eng2 = Engine(model, params, ServeConfig(batch_slots=1, max_len=64, max_new_tokens=4,
                                             eos_token=first))
    r2 = eng2.submit(prompt)
    comp = eng2.run_until_done()[r2]
    assert comp.finish_reason == "eos"
    assert comp.tokens == [first]


def test_finish_reason_truncated_at_context(model_and_params):
    model, params = model_and_params
    prompt = [5, 17, 3, 9]
    eng = Engine(model, params, ServeConfig(batch_slots=1, max_len=8, max_new_tokens=32,
                                            page_size=4))
    r = eng.submit(prompt)
    comp = eng.run_until_done()[r]
    assert comp.finish_reason == "truncated"
    assert len(comp.tokens) == 8 - len(prompt) + 1


def test_finish_reason_truncated_prompt_too_long(model_and_params):
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=1, max_len=8, max_new_tokens=4,
                                            page_size=4))
    r = eng.submit(list(range(1, 13)))  # 12 > max_len-1
    comp = eng.run_until_done()[r]
    assert comp.finish_reason == "truncated"
    assert comp.tokens == []


def test_finish_reason_truncated_on_page_exhaustion(model_and_params):
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=40,
                                            page_size=8, num_pages=3))
    ra = eng.submit([1, 2, 3])
    rb = eng.submit([4, 5, 6])
    res = eng.run_until_done()
    assert res[ra].finish_reason == "truncated"
    assert res[rb].finish_reason == "truncated"
    assert len(res[ra].tokens) > 0


def test_prefill_call_count(model_and_params):
    model, params = model_and_params
    L, chunk = 11, 4
    eng = Engine(model, params, ServeConfig(batch_slots=1, max_len=64, max_new_tokens=2,
                                            prefill_chunk=chunk))
    eng.submit(list(range(1, L + 1)))
    eng.run_until_done()
    assert eng.stats["prefill_tokens"] == L
    assert eng.stats["prefill_calls"] == math.ceil(L / chunk)  # 3, not 11


def test_prefill_chunk_size_does_not_change_output(model_and_params):
    model, params = model_and_params
    prompt = list(range(1, 14))
    outs = []
    for chunk in (1, 5, 16):
        eng = Engine(model, params, ServeConfig(batch_slots=1, max_len=64, max_new_tokens=5,
                                                prefill_chunk=chunk))
        r = eng.submit(prompt)
        outs.append(eng.run_until_done()[r].tokens)
    assert outs[0] == outs[1] == outs[2]


def test_engine_reset_gives_the_same_output(model_and_params):
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=4))
    r1 = eng.submit([5, 17, 3])
    out1 = eng.run_until_done()[r1].tokens
    eng.reset()
    assert not eng.busy and eng.results == {}
    r2 = eng.submit([5, 17, 3])
    assert eng.run_until_done()[r2].tokens == out1


def test_stage_metrics_populated(model_and_params):
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=4))
    eng.submit([5, 17, 3])
    eng.run_until_done()
    m = eng.metrics()
    assert m["prefill_tok_us"] > 0
    assert m["generate_tok_us"] > 0
    assert m["insert_us"] > 0
    st = eng.stats
    assert (st["requests"], st["completed"], st["insert_calls"]) == (1, 1, 1)
    assert (st["generate_calls"], st["generate_tokens"]) == (3, 3)


def test_int8_kv_engine(model_and_params):
    """Quantized KV serves out of two planes (int8 payload + bf16 scales)
    with the same batching-invariance contract."""
    model, _ = model_and_params
    cfg = model.cfg.with_(kv_cache_dtype="int8")
    q = build_model(cfg, device="cpu")
    q.load_state_dict(model.state_dict())
    sc = dict(max_len=64, max_new_tokens=4)
    e1 = Engine(q, None, ServeConfig(batch_slots=1, **sc))
    r1 = e1.submit([5, 17, 3, 9])
    out1 = e1.run_until_done()[r1].tokens
    e2 = Engine(q, None, ServeConfig(batch_slots=2, **sc))
    r2 = e2.submit([5, 17, 3, 9])
    e2.submit([88, 2])
    assert e2.run_until_done()[r2].tokens == out1
    assert e2.layout.plane_dtypes == ("int8", "bfloat16")


def test_overload_door_shedding_no_request_lost(model_and_params):
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=32, max_new_tokens=4,
                                            max_queue=2))
    rids = [eng.submit([i + 1, i + 2, i + 3]) for i in range(8)]
    res = eng.run_until_done()
    assert set(rids) == set(res)
    reasons = [res[r].finish_reason for r in rids]
    assert reasons.count("rejected") == 8 - 2
    for r in rids:
        comp = res[r]
        if comp.finish_reason == "rejected":
            assert comp.tokens == []
            assert comp.finish_s >= comp.submit_s
        else:
            assert comp.finish_reason == "length"
            assert len(comp.tokens) == 4


def test_overload_starvation_shedding_on_the_real_pool(model_and_params):
    """``resilience.starve_pages`` holds every page of the engine's own
    ``PagePool``; the queued request is shed after ``starve_patience``
    ticks, and once the pages are released the engine serves again."""
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=32, max_new_tokens=4,
                                            page_size=8, starve_patience=3))
    assert isinstance(eng.arena.pool, PagePool)
    held = starve_pages(eng.arena.pool)
    assert sorted(held) == list(range(eng.arena.num_pages))
    assert eng.arena.pool.available == 0
    rid = eng.submit([1, 2, 3])
    for _ in range(3):
        eng.step()
        assert eng.busy and rid not in eng.results
    res = eng.run_until_done()
    assert res[rid].finish_reason == "rejected" and res[rid].tokens == []
    assert eng.stats["starved_shed"] == 1
    release_pages(eng.arena.pool, held)
    assert eng.arena.pool.available == eng.arena.num_pages
    rid2 = eng.submit([1, 2, 3])
    assert eng.run_until_done()[rid2].finish_reason == "length"


def test_overload_qps_sweep_sheds_without_losing_requests(model_and_params):
    """A QPS sweep past capacity: shedding turns overload into
    ``rejected`` completions (never bogus ``length`` or ``truncated``
    ones) and loses no request.  The reference's counterpart also bounds
    the admitted requests' p99 by a multiple of a measured service time;
    that is a wall-clock threshold, so here the rejections and admitted
    completions are counted instead."""
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=32, max_new_tokens=4,
                                            page_size=8, max_queue=2))
    base = TrafficConfig(num_requests=16, prompt_len=(3, 6), vocab_size=128, seed=7)
    reports = sweep(eng, [20.0, 2000.0], base)
    for rep in reports:
        assert sum(rep.finish_reasons.values()) == 16
        assert set(rep.finish_reasons) <= {"length", "rejected"}
        assert rep.generated_tokens == 4 * rep.finish_reasons.get("length", 0)
    # far past capacity the door sheds, but not everyone: the first
    # arrival always finds the queue empty
    last = reports[-1].finish_reasons
    assert last.get("rejected", 0) > 0
    assert last.get("length", 0) >= 1
    assert sum(r.finish_reasons.get("rejected", 0) for r in reports) < 2 * 16
    admitted = [c for c in eng.results.values() if c.finish_reason != "rejected"]
    assert len(admitted) == last["length"]
    assert all(c.finish_s >= c.first_token_s >= c.admit_s >= c.submit_s for c in admitted)


class VirtualClock:
    """Time that moves only by a fixed cost a call of ``step`` and by what
    ``sleep`` is asked for, so a pump's outcomes do not ride the machine's
    speed or load."""

    def __init__(self, step_s: float):
        self.now, self.step_s = 0.0, step_s

    def __call__(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s

    def charge(self, step):
        def timed_step():
            self.now += self.step_s
            return step()
        return timed_step


# a virtual engine step's cost: about an unloaded REDUCED engine step on a CPU
VIRTUAL_STEP_S = 0.005


def test_overload_retry_with_backoff_resolves(model_and_params):
    """On a virtual clock (:class:`VirtualClock`, ``VIRTUAL_STEP_S`` an
    engine step), so that the count of finished requests does not move
    with the load of the machine running the test."""
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=32, max_new_tokens=4,
                                            max_queue=2))
    cfg = TrafficConfig(qps=500.0, num_requests=12, prompt_len=(3, 6), vocab_size=128,
                        seed=3, max_retries=4, retry_backoff_s=0.01)
    clock = VirtualClock(VIRTUAL_STEP_S)
    eng.step = clock.charge(eng.step)
    rep = run_traffic(eng, cfg, clock=clock, sleep=clock.sleep)
    assert sum(rep.finish_reasons.values()) == 12
    assert rep.retries > 0
    assert rep.finish_reasons.get("length", 0) >= 10


# ---------------------------------------------------------------------------
# parity: batched == sequential, paged == dense, port == reference
# ---------------------------------------------------------------------------


def _recording_engine(model, sc):
    """An engine whose sampler also keeps, per request, the logits row
    behind each token it samples: ``log[rid]`` lists them in order."""
    log: dict[int, list[np.ndarray]] = {}
    eng = None

    def sample(logits, generator=None, temperature=0.0):
        prefilling = [s for s in eng.sched.active_slots if not s.tokens]
        if prefilling:   # a prefill's (1, 1, V) logits
            log.setdefault(prefilling[0].request.rid, []).append(logits[0, 0].numpy().copy())
        else:
            for s in eng.sched.active_slots:
                log[s.request.rid].append(logits[s.index, 0].numpy().copy())
        return greedy_sample(logits, generator, temperature)

    eng = Engine(model, None, sc, sample=sample)
    return eng, log


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_equals_sequential(arch):
    _, _, model = _arch(arch)
    seq_eng, seq_log = _recording_engine(model, ServeConfig(batch_slots=1, **SC))
    seq = []
    for p in PROMPTS:
        r = seq_eng.submit(p)
        seq_eng.run_until_done()
        seq.append((r, seq_eng.results[r]))
    bat_eng, bat_log = _recording_engine(model, ServeConfig(batch_slots=3, **SC))
    rids = [bat_eng.submit(p) for p in PROMPTS]
    res = bat_eng.run_until_done()
    for p, r, (sr, s) in zip(PROMPTS, rids, seq):
        assert res[r].tokens == s.tokens, f"{arch}: prompt {p} diverged"
        assert res[r].finish_reason == s.finish_reason
        assert len(bat_log[r]) == len(seq_log[sr]) == len(s.tokens)
        for got, want in zip(bat_log[r], seq_log[sr]):
            np.testing.assert_allclose(got, want, rtol=BATCH_RTOL, atol=BATCH_ATOL)


def test_engine_matches_raw_dense_decode(model_and_params):
    """The paged path against a token-by-token decode over a dense cache
    with no arena at all."""
    model, params = model_and_params
    prompt, max_new = [5, 17, 3, 9], 6
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=64,
                                            max_new_tokens=max_new, page_size=8,
                                            prefill_chunk=4))
    r = eng.submit(prompt)
    got = eng.run_until_done()[r].tokens

    caches = model.init_caches(1, eng.layout.tokens)
    logits = None
    for pos, t in enumerate(prompt):
        logits, caches = model.decode_step(params, caches, {
            "tokens": torch.tensor([[t]]), "pos": torch.tensor([pos])})
    ref, pos = [], len(prompt)
    while True:
        t = int(torch.argmax(logits[:, 0, :], dim=-1)[0])
        ref.append(t)
        if len(ref) >= max_new:
            break
        logits, caches = model.decode_step(params, caches, {
            "tokens": torch.tensor([[t]]), "pos": torch.tensor([pos])})
        pos += 1
    assert got == ref


def test_generate_step_equals_decode_on_the_gathered_dense_cache(model_and_params):
    """At a generate step with every slot active, the generate call's
    logits equal ``decode_step`` on the dense caches gathered before it,
    bit for bit, and the gathered caches after it equal those dense
    caches after the step (the chip smoke holds the same at full width)."""
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=3, max_len=32, max_new_tokens=6,
                                            page_size=4))
    for p in PROMPTS[:3]:
        eng.submit(p)
    eng.step()
    eng.step()
    active = eng.sched.active_slots
    assert len(active) == 3
    for s in active:
        assert eng.arena.page_for(s.index, s.pos)
    pt, rt, tokens, pos = eng._step_inputs(active)
    dense = gather_caches(eng.layout, eng.arena.planes, pt, rt)
    dense = {k: {j: {n: t.clone() for n, t in b.items()} for j, b in v.items()}
             for k, v in dense.items()}
    want, dense = model.decode_step(params, dense, {"tokens": tokens, "pos": pos})
    got, _ = eng._generate(params, eng.arena.planes, pt, rt, tokens, pos)
    assert torch.equal(got, want)
    after = gather_caches(eng.layout, eng.arena.planes, pt, rt)
    for j in after["blocks"]:
        for n in after["blocks"][j]:
            assert torch.equal(after["blocks"][j][n], dense["blocks"][j][n])


@pytest.mark.parametrize("arch,kv", [(a, "") for a in ARCHS] + [("gpt2-paper", "int8")])
def test_engine_equals_reference_engine(arch, kv):
    """Both engines on the same parameters and prompts, stepped in turn:
    the same page and resident tables after every step, then the same
    tokens, finish reasons and prefill call counts."""
    rmodel, params, model = _arch(arch, kv)
    ref = REngine(rmodel, jax.tree.map(jax.numpy.asarray, params),
                  RServeConfig(batch_slots=3, **SC))
    eng = Engine(model, None, ServeConfig(batch_slots=3, **SC))
    rr = [ref.submit(p) for p in PROMPTS]
    rt = [eng.submit(p) for p in PROMPTS]
    steps = 0
    while ref.busy or eng.busy:
        ref.step()
        eng.step()
        steps += 1
        assert np.array_equal(eng.arena.page_tbl, ref.arena.page_tbl), steps
        assert np.array_equal(eng.arena.resident_tbl, ref.arena.resident_tbl), steps
    assert ref.busy == eng.busy
    for a, b in zip(rr, rt):
        assert eng.results[b].tokens == ref.results[a].tokens
        assert eng.results[b].finish_reason == ref.results[a].finish_reason
    for k in ("requests", "completed", "prefill_calls", "prefill_tokens", "insert_calls",
              "generate_calls", "generate_tokens"):
        assert eng.stats[k] == ref.stats[k], k
    assert eng.arena.nbytes() == ref.arena.nbytes()


def test_temperature_draws_from_a_seeded_generator(model_and_params):
    """``temperature > 0`` samples from the engine's ``torch.Generator``,
    seeded 0 at every reset: the same draws again after a reset (the
    values differ from the reference's ``jax.random`` draws)."""
    model, params = model_and_params
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=8,
                                            temperature=1.0))
    rids = [eng.submit([5, 17, 3]), eng.submit([9, 9])]
    first = [eng.run_until_done()[r].tokens for r in rids]
    eng.reset()
    rids = [eng.submit([5, 17, 3]), eng.submit([9, 9])]
    assert [eng.run_until_done()[r].tokens for r in rids] == first
    assert all(0 <= t < 128 for toks in first for t in toks)
    greedy = Engine(model, params, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=8))
    r = greedy.submit([5, 17, 3])
    assert greedy.run_until_done()[r].tokens != first[0]


def test_greedy_sample_takes_the_first_index_on_ties():
    logits = torch.tensor([[[0.0, 3.0, 3.0, 1.0]], [[2.0, 2.0, 2.0, 2.0]]])
    assert greedy_sample(logits).tolist() == [1, 0]
    assert greedy_sample(logits).dtype == torch.int32


def test_telemetry_events_are_valid(model_and_params, tmp_path):
    """``serve_request`` and ``serve_report`` events valid against the
    port's schema, one request event per completion; the stage
    histograms, the occupancy series and the per-request spans."""
    model, params = model_and_params
    tel = obs.Telemetry(str(tmp_path))
    eng = Engine(model, params, ServeConfig(batch_slots=2, max_len=32, max_new_tokens=3,
                                            max_queue=1), telemetry=tel)
    rep = run_traffic(eng, TrafficConfig(qps=1000.0, num_requests=5, prompt_len=(2, 4),
                                         vocab_size=128, seed=1))
    paths = tel.save()
    tel.close()
    with open(paths["events"]) as f:
        events = [json.loads(line) for line in f]
    kinds = [e["kind"] for e in events]
    assert kinds.count("serve_request") == 5 and kinds.count("serve_report") == 1
    assert all(obs.validate_event(e) == [] for e in events)
    snap = tel.registry.snapshot()
    assert any(k.startswith("serve_stage_ms") and "generate" in k for k in snap)
    assert any(k.startswith("serve_free_pages") for k in snap)
    assert sum(rep.finish_reasons.values()) == 5
    with open(paths["trace"]) as f:
        trace = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("queued r") for e in trace)
    assert any(e.get("name") == "serve occupancy" for e in trace)
