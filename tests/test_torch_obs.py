"""The port's copy of the telemetry stack (``repro_torch.obs``) against
``repro.obs``, and its hookup in the port's engine and trainer.

Each scenario mirrors a class of ``tests/test_observability.py`` that needs
no JAX: it drives one package's ``obs`` on a virtual clock, holds the
reference test's assertions, and returns what it recorded (spans, events,
flight-recorder windows and postmortems, ``dump_metrics()``, the chrome
trace).  The two packages must return equal records.  Then the port's
``ServeEngine`` serves the same tokens, bit for bit, with and without an
``obs`` that traces, its counter attributes read the registry, and the
port's ``Trainer`` logs into the registry's ``train.metrics`` series.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro.obs as JOBS
import repro_torch.obs as TOBS
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.models import api as TAPI
from repro_torch.serve.engine import ServeEngine, SliceSpec
from repro_torch.train.trainer import Trainer


def _spans(tr):
    return [dataclasses.asdict(s) for s in tr.spans]


def _tracer_nesting(O):
    clk = O.VirtualClock()
    tr = O.Tracer(clk)
    with tr.span("outer", track="t") as outer:
        clk.advance(1.0)
        with tr.span("inner", track="t") as inner:
            clk.advance(2.0)
    assert inner.parent == outer.sid and outer.parent is None
    assert [s.name for s in tr.spans] == ["inner", "outer"]
    a = tr.begin("a", track="track_a")
    b = tr.begin("b", track="track_b")
    assert b.parent is None
    tr.end(b)
    tr.end(a)
    outer = tr.begin("outer2", track="t")
    clk.advance(3.0)
    tr.begin("leaked", track="t")
    clk.advance(4.0)
    tr.end(outer)
    assert tr.find("leaked")[0].t1 == outer.t1 == 4.0
    assert not tr.open_spans()
    return _spans(tr)


def _tracer_ordering(O):
    tr = O.Tracer(O.VirtualClock(), max_spans=2, max_events=3)
    tr.complete("chunk", 5.0, 6.0, track="replica:0")
    tr.complete("chunk", 1.0, 2.0, track="replica:0")
    assert [s.t0 for s in tr.find("chunk")] == [5.0, 1.0]
    tr.event("late", t=9.0)
    tr.event("early", t=1.0)
    assert [e.name for e in tr.find_events()] == ["early", "late"]
    for i in range(4):
        tr.complete(f"s{i}", 0.0, 1.0)
        tr.event(f"e{i}", t=float(i))
    assert len(tr.spans) == 2 and tr.dropped_spans == 4
    assert len(tr.events) == 3 and tr.dropped_events == 3
    clk = O.VirtualClock(5.0)
    clk.advance(3.0)
    clk.advance(7.0)
    return (_spans(tr), [dataclasses.asdict(e) for e in tr.find_events()],
            clk())


def _flight(O):
    fr = O.FlightRecorder(capacity=3, max_postmortems=2)
    for i in range(10):
        fr.record("event", f"e{i}", float(i))
    assert [r["seq"] for r in fr.snapshot()] == [7, 8, 9]
    assert [r["name"] for r in fr.last(2)] == ["e8", "e9"]
    pm = fr.postmortem("drill", t=10.0, job=3)
    fr.record("event", "after", 11.0)
    assert [r["name"] for r in pm["window"]][-1] == "e9"
    assert fr.postmortem("b") is not None and fr.postmortem("c") is None
    return (fr.snapshot(), fr.postmortems, fr.postmortems_dropped,
            fr.total_records)


def _telemetry(O):
    obs = O.Telemetry(tracing=True, clock=O.VirtualClock())
    obs.event("machine.fail", cat="failure", block=3, t=1.0)
    assert len(obs.tracer.events) == 1 and len(obs.recorder.ring) == 1
    with obs.span("work", track="t"):
        obs.clock.advance(0.5)
    off = O.Telemetry()
    off.event("machine.fail", cat="failure", block=3, t=1.0)
    assert off.tracer is O.NOOP_TRACER and not off.tracing
    assert off.span("anything") is O.NOOP_TRACER.span("x")
    assert O.NoopTracer.spans == [] and O.NoopTracer.events == []
    return (obs.recorder.snapshot(), off.recorder.snapshot(),
            obs.postmortem("lost", job="train-0"))


def _registry(O):
    reg = O.MetricsRegistry()
    c1 = reg.counter("fleet.drops", reason="stranded")
    assert c1 is reg.counter("fleet.drops", reason="stranded")
    assert c1 is not reg.counter("fleet.drops", reason="wait_queue_full")
    c1.inc(2)
    reg.counter("a.n", k="v").inc()
    reg.gauge("a.g").set(2.5)
    h = reg.histogram("lat")
    for v in range(1, 101):
        h.observe(float(v))
    s = reg.series("train.metrics", cap=4)
    for i in range(6):
        s.append({"step": i})
    assert s.dropped > 0 and s.samples[-1]["step"] == 5
    return (reg.dump(), reg.value("fleet.drops", reason="stranded"),
            reg.sum("fleet.drops"), reg.labels_of("fleet.drops"),
            h.summary())


def _chrome(O):
    clk = O.VirtualClock()
    tr = O.Tracer(clk)
    tr.complete("chunk", 0.5, 0.75, cat="serve", track="replica:0",
                stall_s=0.0)
    with tr.span("step", cat="train", track="train", step=3):
        clk.advance(1.25)
    tr.event("fail", cat="failure", track="replica:0", t=2.0, block=4)
    obj = O.to_chrome_trace(tr, process_name="p",
                            metrics={"fleet.routed": 3})
    back = O.from_chrome_trace(json.dumps(obj))
    assert sorted(back["tracks"].values()) == ["replica:0", "train"]
    obs = O.Telemetry(tracing=True, clock=O.VirtualClock())
    obs.metrics.counter("n").inc()
    with obs.span("w", track="t"):
        pass
    return obj, back, obs.chrome_trace(), obs.dump_metrics()


@pytest.mark.parametrize("scenario", [_tracer_nesting, _tracer_ordering,
                                      _flight, _telemetry, _registry,
                                      _chrome])
def test_port_records_what_the_reference_records(scenario):
    assert scenario(TOBS) == scenario(JOBS)


def test_write_trace_and_postmortems_match(tmp_path):
    out = []
    for name, O in (("j", JOBS), ("t", TOBS)):
        obs = O.Telemetry(tracing=True, clock=O.VirtualClock())
        obs.metrics.counter("n").inc()
        with obs.span("w", track="t"):
            pass
        obs.postmortem("lost", t=1.0)
        obs.write_trace(str(tmp_path / f"{name}.json"))
        obs.recorder.dump_postmortems(str(tmp_path / f"{name}_pm.json"))
        out.append([(tmp_path / f"{name}{s}.json").read_text()
                    for s in ("", "_pm")])
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# The port's engine and trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_model():
    cfg = TREG.get_reduced("olmo-1b")
    return cfg, TAPI.init_params(cfg, seed=0, device="cpu")


@pytest.mark.parametrize("kv_block", [0, 8])
def test_serve_tokens_bitwise_equal_with_and_without_obs(small_model,
                                                         kv_block):
    cfg, params = small_model
    spec = SliceSpec(slots=2, max_len=32, prompt_len=8, chunk=4,
                     kv_block=kv_block)

    def run(obs):
        rng = np.random.default_rng(7)
        eng = ServeEngine(cfg, params, spec, device="cpu", obs=obs)
        reqs = [eng.submit(rng.integers(0, cfg.vocab_size, size=6),
                           max_new_tokens=8) for _ in range(3)]
        eng.run(max_steps=100)
        return [list(map(int, r.out_tokens)) for r in reqs]

    base = run(None)
    traced = run(TOBS.Telemetry(tracing=True, clock=TOBS.VirtualClock()))
    assert base == traced and all(len(t) == 8 for t in base)


def test_engine_counter_views_match_registry(small_model):
    cfg, params = small_model
    obs = TOBS.Telemetry()
    engines = [ServeEngine(cfg, params, SliceSpec(
        slots=1, max_len=32, prompt_len=8, chunk=4, kv_block=kb),
        device="cpu", obs=obs, obs_labels={"replica": kb}) for kb in (0, 8)]
    for e in engines:
        for _ in range(2):
            e.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
        e.run(max_steps=50)
        labels = {"replica": e.spec.kv_block}
        for name in ("prefill_flops_proxy", "kv_prompt_tokens",
                     "kv_shared_tokens", "kv_migrated_shared_blocks",
                     "kv_migrated_suffix_blocks"):
            assert getattr(e, name) == obs.metrics.value(f"serve.{name}",
                                                         **labels)
            assert e.kv_stats()[name] == getattr(e, name)
        assert e.prefill_flops_proxy > 0
        assert obs.metrics.histogram("serve.chunk_s", **labels).summary()[
            "count"] == len(e.chunk_lat_s)
    # a 6-token prompt fills no block of 8: nothing to share
    assert engines[1].kv_shared_tokens == 0
    assert obs.metrics.sum("serve.prefill_flops_proxy") == sum(
        e.prefill_flops_proxy for e in engines)
    engines[1].kv_close()


def test_trainer_logs_into_the_registry():
    cfg = TREG.get_reduced("dlrm0")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 1, 16),
                    parallel=ParallelConfig(remat="none"),
                    optimizer=OptimizerConfig(lr=3e-3, warmup_steps=2))
    obs = TOBS.Telemetry(tracing=True, clock=TOBS.VirtualClock())
    tr = Trainer(run, device="cpu", obs=obs, obs_labels={"job": "t0"})
    tr.train(2, log_every=1)
    series = obs.metrics.series("train.metrics", job="t0")
    assert tr.metrics_log is series.samples
    assert [m["step"] for m in tr.metrics_log] == [1, 2]
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
    assert obs.metrics.value("train.wire_bytes", job="t0") \
        == tr.metrics_log[-1]["wire_bytes"]
    assert [s.args["step"] for s in obs.tracer.find("train.step")] == [0, 1]
    # cooperative preemption: a fresh run stops at step 2 and logs it
    state = tr.train(3, preempt_at=2)
    assert tr.preempted and state.step == 2
    assert tr.metrics_log[-1] == {"step": 2, "preempt": 1.0}
    assert [e.args["step"] for e in
            obs.tracer.find_events("train.preempt")] == [2]
