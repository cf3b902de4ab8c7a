"""`repro_torch.fleet` on the CPU: against `repro.fleet`, and the mirror of
``tests/test_fleet.py``.

Both packages serve reduced olmo-1b with the same weights (JAX's init,
handed over through ``repro_torch.interop``).  With a fixed ``timing=``
every decision of the router, the autoscaler and the failure path depends
only on virtual time and request budgets, so on the same trace the port's
`FleetReport` (its ``to_dict()``, its log and its per-replica stats) must
equal the reference's exactly: for every router policy, for the failure
scenario (a spare burnt, then the busiest replica's block), and for a
`FleetTrace` run.  The tokens are the engines' and are held to the parity
bar of ROADMAP.md: a stream equals JAX's token for token, except where
JAX's top-2 logit margin is under 2^-5 of its largest |logit| (a near
tie); the first such position is reported.

The second half runs the reference's own fleet tests against the port:
conservation across failures and drains, drain-before-free, the
autoscaler's and forecaster's decisions, throughput scaling in virtual
time, the routing policies, and the service lifecycle.  Last, what only
the port has to show: one weight tree for every replica, the warmup on
the machine's device, no engine left alive by a reference cycle after
``close()``, and the ``serve_fleet`` twin.
"""
import gc
import os
import pathlib
import subprocess
import sys
import warnings
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro import fleet as J
from repro.cluster import Supercomputer as JSuper
from repro.configs import registry as JREG
from repro.models import api as JAPI
from repro.models import transformer as JTF
from repro.serve.engine import SliceSpec as JSpec
from repro_torch import fleet as T
from repro_torch import interop
from repro_torch.cluster import SliceError, SliceSpec, Supercomputer
from repro_torch.configs import registry as TREG
from repro_torch.core.goodput import (goodput_ocs, goodput_static,
                                      served_goodput)
from repro_torch.fleet import (Autoscaler, AutoscalerConfig, FleetService,
                               ForecastConfig, RateForecaster, ReplicaError,
                               RouterConfig, TrafficSpec, generate,
                               generate_trace, uniform_burst)
from repro_torch.optim.adam import leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHUNK_S = 0.01                      # fixed virtual chunk cost (deterministic)
SPEC_KW = dict(slots=2, max_len=48, prompt_len=8, chunk=4)
SPEC = SliceSpec(**SPEC_KW)
LOGIT_REL_TOL = 2.0 ** -5

_MODEL = {}


def _model():
    """Module-memoized reduced olmo-1b: JAX's init, and the same weights
    in the port (plain function so the hypothesis-shim property test can
    use it too)."""
    if "m" not in _MODEL:
        jcfg = JREG.get_reduced("olmo-1b")
        jp = JAPI.init_params(jcfg, jax.random.PRNGKey(0))
        _MODEL["m"] = dict(
            jcfg=jcfg, jp=jp, tcfg=TREG.get_reduced("olmo-1b"),
            tp=interop.params_from_numpy(jax.tree.map(np.asarray, jp)))
    return _MODEL["m"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The reduced model's ops are tiny: one intra-op thread runs them
    fastest, and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_model():
    m = _model()
    return m["tcfg"], m["tp"]


def _sc(num_blocks=8, **kw):
    return Supercomputer(num_blocks=num_blocks, device="cpu", **kw)


def _service(small_model, *, num_blocks=8, replicas=1, autoscale=None,
             router=None, timing=CHUNK_S, **kw):
    cfg, params = small_model
    sc = _sc(num_blocks)
    return sc, FleetService(sc, cfg, params, SPEC, geometry=(4, 4, 4),
                            initial_replicas=replicas, autoscale=autoscale,
                            router=router, timing=timing, **kw)


def _assert_conserved(requests, report):
    """Every request terminal exactly once; done => full token budget."""
    assert report.completed + report.dropped == len(requests)
    for r in requests:
        assert r.status in ("done", "dropped"), (r.fid, r.status)
        if r.status == "done":
            assert len(r.out_tokens) == r.max_new_tokens, \
                (r.fid, len(r.out_tokens), r.max_new_tokens)
            assert r.t_first is not None and r.t_done is not None
            assert r.t_arrival <= r.t_first <= r.t_done
        else:
            assert r.t_done is None


# -- parity with repro.fleet --------------------------------------------------

def _jax_margin(m, spec, prompt, tokens, i):
    """JAX's top-2 logit margin and tolerance where token ``i`` of a stream
    was chosen: the prompt as the engine lays it out (left-padded to
    ``prompt_len`` on the dense cache, as it is on the pooled one), then
    ``tokens[:i]``, through JAX's forward."""
    seq = np.asarray(prompt, np.int32)[-spec["prompt_len"]:]
    if not spec.get("kv_block"):
        seq = np.concatenate(
            [np.zeros(spec["prompt_len"] - len(seq), np.int32), seq])
    ctx = np.concatenate([seq, np.asarray(tokens[:i], np.int32)])
    logits, _ = JTF.forward(m["jcfg"], m["jp"],
                            {"tokens": jnp.asarray(ctx)[None]})
    last = np.sort(np.asarray(logits[0, -1], np.float32))
    return float(last[-1] - last[-2]), \
        LOGIT_REL_TOL * float(np.abs(last).max())


def assert_streams_match(m, spec, jreqs, treqs):
    """Request by request: equal statuses and replica paths; tokens equal
    up to the first near tie of JAX's stream (reported)."""
    assert len(jreqs) == len(treqs)
    for j, t in zip(jreqs, treqs):
        assert (j.fid, j.status, j.replicas, j.migrations) == \
            (t.fid, t.status, t.replicas, t.migrations)
        assert len(j.out_tokens) == len(t.out_tokens)
        diff = [i for i, (a, b) in enumerate(zip(j.out_tokens, t.out_tokens))
                if a != b]
        if not diff:
            continue
        i = diff[0]
        margin, tol = _jax_margin(m, spec, j.prompt, j.out_tokens, i)
        assert margin < tol, (
            f"request {j.fid}: token {i} differs (jax {j.out_tokens[i]}, "
            f"port {t.out_tokens[i]}) with a JAX top-2 margin {margin:.4f} "
            f">= tolerance {tol:.4f}")
        warnings.warn(f"request {j.fid}: streams part at token {i}, a near "
                      f"tie (JAX top-2 margin {margin:.4f} < {tol:.4f})")


def run_both(*, spec=SPEC_KW, arrivals, svc_kw=lambda pkg: {},
             machines=None, run_kw=None):
    """One scenario through both packages: ``arrivals(pkg)`` builds the
    trace and ``svc_kw(pkg)`` the service's keyword arguments from that
    package's fleet module, ``machines(pkg, kw)`` the machine argument
    (default: one machine of 8 blocks).  Asserts the reports, logs and
    replica stats equal and the streams within the parity bar; returns
    ((jax service, requests, report), (port ...))."""
    m = _model()
    out = []
    for pkg, Super, Spec, cfg, params, kw in (
            (J, JSuper, JSpec, m["jcfg"], m["jp"], {}),
            (T, Supercomputer, SliceSpec, m["tcfg"], m["tp"],
             {"device": "cpu"})):
        mach = (machines(pkg, kw) if machines is not None
                else Super(num_blocks=8, **kw))
        svc = pkg.FleetService(mach, cfg, params, Spec(**spec),
                               geometry=(4, 4, 4), **svc_kw(pkg))
        reqs = arrivals(pkg)
        rep = svc.run(reqs, **(run_kw or {}))
        if isinstance(reqs, (J.FleetTrace, T.FleetTrace)):
            reqs = svc.requests
        out.append((svc, reqs, rep))
    (js, jr, jrep), (ts, tr, trep) = out
    assert trep.to_dict() == jrep.to_dict()
    assert trep.log == jrep.log
    assert trep.replica_stats == jrep.replica_stats
    assert_streams_match(m, spec, jr, tr)
    return out


AUTOSCALE = dict(min_replicas=1, max_replicas=3, tick_s=0.05, cooldown_s=0.3,
                 scale_up_backlog=3.0, scale_down_backlog=0.5,
                 provision_s=0.1)
BURSTY = dict(duration_s=2.0, rate_rps=6.0, pattern="bursty",
              new_tokens_choices=(4, 8), new_tokens_weights=(0.5, 0.5))
# pooled KV and shared-header traffic: where prefix affinity's trie peek
# has something to find
KV_SPEC = dict(slots=2, max_len=48, prompt_len=24, chunk=4, kv_block=8)
HEADERS = dict(duration_s=2.0, rate_rps=8.0, header_len=16, prompt_len_max=8,
               new_tokens_choices=(4, 8), new_tokens_weights=(0.5, 0.5))


@pytest.mark.parametrize("policy", ["least_loaded", "least_eta",
                                    "round_robin", "prefix_affinity",
                                    "slo_tiered"])
def test_report_equals_reference_for_every_policy(policy):
    pooled = policy == "prefix_affinity"
    (js, _, jrep), (ts, _, trep) = run_both(
        spec=KV_SPEC if pooled else SPEC_KW,
        arrivals=lambda pkg: pkg.generate(
            pkg.TrafficSpec(**(HEADERS if pooled else BURSTY)), seed=13),
        svc_kw=lambda pkg: dict(
            router=pkg.RouterConfig(policy=policy),
            autoscale=pkg.AutoscalerConfig(**AUTOSCALE), timing=0.02),
        run_kw=dict(settle_s=0.5))
    assert trep.completed == trep.offered > 0
    assert ts.router.routed == js.router.routed
    assert (ts.router.prefix_hits, ts.router.prefix_misses) == \
        (js.router.prefix_hits, js.router.prefix_misses)
    if pooled:
        assert ts.router.prefix_hits > 0
        for r in ts.replicas:
            r.session.engine.kvpool.check()
    ts.close()
    js.close()


def test_failure_scenario_equals_reference():
    """examples/serve_fleet.py's plan on a 3-block machine: burn the
    spare, then fail the busiest replica's block; its in-flight requests
    migrate, re-prefill prompt + decoded tokens and finish elsewhere."""
    (js, _, jrep), (ts, _, trep) = run_both(
        arrivals=lambda pkg: pkg.generate(pkg.TrafficSpec(
            duration_s=4.0, rate_rps=4.0, pattern="bursty", burst_x=10.0,
            burst_period_s=2.0, burst_len_s=0.5, prompt_len_max=6,
            new_tokens_choices=(8, 16), new_tokens_weights=(0.6, 0.4)),
            seed=2),
        machines=lambda pkg, kw: (JSuper if pkg is J else Supercomputer)(
            num_blocks=3, **kw),
        svc_kw=lambda pkg: dict(
            router=pkg.RouterConfig(policy="least_eta"),
            autoscale=pkg.AutoscalerConfig(**AUTOSCALE), timing=0.05),
        run_kw=dict(fail_plan=[(2.15, "spare"), (2.2, "busiest")],
                    settle_s=3.0))
    assert trep.failures >= 1 and trep.migrated >= 1
    assert trep.scale_downs >= 1
    assert all(s["truncated_migrations"] == 0 for s in trep.replica_stats)
    ts.close()
    js.close()


def test_fleet_trace_run_equals_reference():
    """A `FleetTrace` (lazy arrivals): replica 0's block fails with no
    spare, the autoscaler cannot replace it until the block is repaired,
    then reclaims it."""
    (js, _, jrep), (ts, tr, trep) = run_both(
        arrivals=lambda pkg: pkg.generate_trace(
            pkg.TrafficSpec(**BURSTY), seed=5),
        machines=lambda pkg, kw: (JSuper if pkg is J else Supercomputer)(
            num_blocks=2, **kw),
        svc_kw=lambda pkg: dict(
            initial_replicas=2, timing=CHUNK_S,
            autoscale=pkg.AutoscalerConfig(**dict(
                AUTOSCALE, min_replicas=2, max_replicas=2))),
        run_kw=dict(fail_plan=[(0.3, "replica:0")],
                    repair_plan=[(0.8, "last_failed")], settle_s=0.5))
    assert trep.failures == 1 and trep.offered == len(tr) > 0
    assert trep.replicas_seen == 3 and ts.deferred_scale_ups > 0
    ts.close()
    js.close()


# -- the reference's fleet tests, on the port ---------------------------------

class TestTraffic:
    def test_deterministic_and_sorted(self):
        spec = TrafficSpec(duration_s=4.0, rate_rps=6.0, pattern="bursty")
        a, b = generate(spec, seed=3), generate(spec, seed=3)
        assert len(a) == len(b) > 0
        assert all(x.t_arrival == y.t_arrival for x, y in zip(a, b))
        ts = [r.t_arrival for r in a]
        assert ts == sorted(ts)
        assert all(0 <= t < spec.duration_s for t in ts)

    def test_mean_rate_tracks_spec(self):
        spec = TrafficSpec(duration_s=50.0, rate_rps=8.0)
        n = len(generate(spec, seed=0))
        assert abs(n - 400) < 100          # ~4 sigma for Poisson(400)

    def test_bursty_rate_peaks(self):
        spec = TrafficSpec(pattern="bursty", rate_rps=2.0, burst_x=5.0,
                           burst_period_s=4.0, burst_len_s=1.0)
        assert spec.rate_at(0.5) == 10.0
        assert spec.rate_at(2.0) == 2.0
        assert spec.rate_max == 10.0

    def test_diurnal_rate_between_trough_and_peak(self):
        spec = TrafficSpec(pattern="diurnal", rate_rps=8.0, trough_frac=0.25,
                           diurnal_period_s=8.0)
        assert np.isclose(spec.rate_at(0.0), 2.0)
        assert np.isclose(spec.rate_at(4.0), 8.0)
        for t in np.linspace(0, 8, 33):
            assert 2.0 - 1e-9 <= spec.rate_at(t) <= 8.0 + 1e-9

    def test_slo_tiers_assigned(self):
        reqs = generate(TrafficSpec(duration_s=30.0, rate_rps=5.0), seed=1)
        tiers = {r.tier for r in reqs}
        assert tiers == {"interactive", "batch"}
        assert all(r.ttft_slo_s > 0 for r in reqs)


class TestRoutingConservation:
    def test_uniform_load_all_complete(self, small_model):
        _, svc = _service(small_model, replicas=2)
        reqs = uniform_burst(8, new_tokens=6, prompt_len=6)
        rep = svc.run(reqs)
        _assert_conserved(reqs, rep)
        assert rep.dropped == 0
        assert rep.tokens_served == 8 * 6

    def test_conserved_across_replica_failure(self, small_model):
        """fail_block with no spares kills a replica mid-serve: its
        in-flight requests must complete on the survivor."""
        sc, svc = _service(small_model, num_blocks=2, replicas=2)
        reqs = uniform_burst(8, new_tokens=8, prompt_len=6)
        rep = svc.run(reqs, fail_plan=[(2.5 * CHUNK_S, "replica:0")])
        _assert_conserved(reqs, rep)
        assert rep.dropped == 0, "survivor had headroom; nothing may drop"
        assert rep.failures == 1
        assert rep.migrated > 0, "the failed replica held in-flight work"
        migrated = [r for r in reqs if r.migrations > 0]
        assert all(len(r.replicas) >= 2 for r in migrated)
        assert rep.slo_attainment > 0

    @settings(max_examples=5, deadline=None)
    @given(st.integers(min_value=3, max_value=10),
           st.integers(min_value=1, max_value=7),
           st.sampled_from(["least_loaded", "least_eta", "round_robin"]))
    def test_conservation_property(self, n_requests, fail_chunk, policy):
        """Random load size x failure timing x policy: requests are
        conserved wherever the failure lands."""
        m = _model()
        sc = _sc(2)
        svc = FleetService(sc, m["tcfg"], m["tp"], SPEC, geometry=(4, 4, 4),
                           initial_replicas=2, timing=CHUNK_S,
                           router=RouterConfig(policy=policy))
        reqs = uniform_burst(n_requests, new_tokens=5, prompt_len=4,
                             seed=n_requests)
        rep = svc.run(reqs, fail_plan=[(fail_chunk * CHUNK_S, "replica:0")])
        _assert_conserved(reqs, rep)
        assert rep.dropped == 0

    def test_stranded_requests_dropped_when_capacity_never_returns(
            self, small_model):
        """Every block dies with no repairs scheduled: the loop terminates
        and reports the unfinishable requests as dropped."""
        cfg, params = small_model
        sc = _sc(2)
        svc = FleetService(
            sc, cfg, params, SPEC, geometry=(4, 4, 4), initial_replicas=2,
            timing=CHUNK_S,
            autoscale=AutoscalerConfig(min_replicas=1, max_replicas=2,
                                       tick_s=5 * CHUNK_S,
                                       cooldown_s=10 * CHUNK_S,
                                       provision_s=0.0))
        reqs = uniform_burst(6, new_tokens=8, prompt_len=4)
        rep = svc.run(reqs, fail_plan=[(1.5 * CHUNK_S, "replica:0"),
                                       (2.5 * CHUNK_S, "replica:1")])
        _assert_conserved(reqs, rep)
        assert rep.dropped > 0
        assert rep.failures == 2

    def test_backpressure_drops_are_reported(self, small_model):
        _, svc = _service(small_model, replicas=1,
                          router=RouterConfig(max_queue_per_replica=2),
                          max_wait_queue=2)
        reqs = uniform_burst(12, new_tokens=6, prompt_len=6)
        rep = svc.run(reqs)
        _assert_conserved(reqs, rep)
        assert rep.dropped > 0
        assert rep.served_goodput < 1.0


class TestDrainBeforeFree:
    def test_free_with_inflight_raises(self, small_model):
        _, svc = _service(small_model, replicas=1)
        rep = svc.replicas[0]
        rep.dispatch(uniform_burst(1, new_tokens=4, prompt_len=4)[0])
        with pytest.raises(ReplicaError):
            rep.free()

    def test_draining_session_rejects_submits(self, small_model):
        _, svc = _service(small_model, replicas=1)
        rep = svc.replicas[0]
        rep.drain()
        with pytest.raises(SliceError):
            rep.session.submit(np.arange(4), max_new_tokens=2)

    def test_autoscaled_run_never_frees_inflight(self, small_model):
        """A bursty autoscaled run drains and frees repeatedly; `free`
        raises on any in-flight work, so finishing cleanly is the check."""
        sc, svc = _service(
            small_model, num_blocks=16, replicas=1, timing=0.05,
            autoscale=AutoscalerConfig(**AUTOSCALE))
        trace = generate(TrafficSpec(
            duration_s=4.0, rate_rps=4.0, pattern="bursty", burst_x=10.0,
            burst_period_s=2.0, burst_len_s=0.5, prompt_len_max=8,
            new_tokens_choices=(8, 16), new_tokens_weights=(0.6, 0.4)),
            seed=2)
        rep = svc.run(trace, settle_s=3.0)
        _assert_conserved(trace, rep)
        assert rep.scale_ups >= 1 and rep.scale_downs >= 1
        freed = [r for r in svc.retired if r.state == "freed"]
        assert freed, "scale-downs must have retired freed replicas"
        for r in freed:
            assert not r._assigned
        assert any(e.startswith("alloc") for e in sc.events)
        assert any(e.startswith("release") for e in sc.events)


class TestAutoscalerDecisions:
    def test_scale_to_zero_holds_at_zero_when_idle(self):
        asc = Autoscaler(AutoscalerConfig(min_replicas=1,
                                          scale_to_zero=True))
        action, victim = asc.decide(10.0, [], wait_len=0, p95_ttft_s=None)
        assert action == "hold" and victim is None

    def test_empty_pool_grows_on_backlog(self):
        asc = Autoscaler(AutoscalerConfig(min_replicas=0,
                                          scale_to_zero=True))
        action, _ = asc.decide(0.0, [], wait_len=3, p95_ttft_s=None)
        assert action == "up"

    def test_floor_enforced_without_scale_to_zero(self):
        asc = Autoscaler(AutoscalerConfig(min_replicas=2))
        action, _ = asc.decide(0.0, [], wait_len=0, p95_ttft_s=None)
        assert action == "up"


class TestTraceRun:
    def test_trace_and_list_runs_match(self, small_model):
        """`run(FleetTrace)` and `run(list)` of the same trace give the
        same report."""
        reports = {}
        for form in ("trace", "list"):
            _, svc = _service(small_model, replicas=2)
            trace = generate_trace(TrafficSpec(**BURSTY), seed=13)
            arrivals = trace if form == "trace" else trace.materialize()
            reports[form] = svc.run(arrivals).to_dict()
        assert reports["trace"] == reports["list"]

    def test_unsorted_list_still_served(self, small_model):
        _, svc = _service(small_model, replicas=1)
        reqs = generate(TrafficSpec(duration_s=2.0, rate_rps=6.0,
                                    new_tokens_choices=(4, 8),
                                    new_tokens_weights=(0.5, 0.5)), seed=3)
        rep = svc.run(list(reversed(reqs)))
        _assert_conserved(reqs, rep)
        assert rep.offered == len(reqs)

    def test_trace_stranded_counted_without_materializing(self, small_model):
        cfg, params = small_model
        sc = _sc(1)
        svc = FleetService(sc, cfg, params, SPEC, geometry=(4, 4, 4),
                           initial_replicas=1, timing=CHUNK_S)
        trace = generate_trace(
            TrafficSpec(duration_s=4.0, rate_rps=8.0), seed=5)
        rep = svc.run(trace, fail_plan=[(2 * CHUNK_S, "replica:0")])
        assert rep.offered == len(trace)
        assert rep.completed + rep.dropped == rep.offered
        assert rep.dropped > 0
        assert len(svc.requests) < len(trace), \
            "stranded arrivals must not be materialized just to be dropped"


class TestForecaster:
    def test_abstains_before_min_history(self):
        f = RateForecaster(ForecastConfig(bin_s=0.25, min_history_s=2.0))
        f.observe(0.1)
        assert f.forecast_peak(1.0, 1.0, 1.5) is None

    def test_persistence_tracks_recent_rate(self):
        f = RateForecaster(ForecastConfig(bin_s=0.25, recent_window_s=1.0,
                                          min_history_s=1.0))
        for i in range(40):                  # 10 rps over 4 seconds
            f.observe(i * 0.1)
        assert f.forecast_peak(4.0, 4.0, 4.5) == pytest.approx(10.0)

    def test_periodic_fold_predicts_peak_from_past_cycles(self):
        cfg = ForecastConfig(bin_s=0.25, period_s=4.0, min_history_s=1.0)
        f = RateForecaster(cfg)
        rng = np.random.default_rng(0)
        for cycle in range(2):
            base = cycle * 4.0
            for t in sorted(rng.uniform(0, 2, 8)):     # 4 rps quiet half
                f.observe(base + t)
            for t in sorted(rng.uniform(2, 4, 64)):    # 32 rps peak half
                f.observe(base + t)
        pred = f.forecast_peak(8.1, 10.0, 10.5)
        assert pred is not None and pred > 16.0
        low = f.forecast_peak(8.1, 8.5, 9.0)
        assert low is not None and low < pred / 2

    def test_predictive_up_bypasses_cooldown(self, small_model):
        _, svc = _service(small_model, replicas=1)
        live = list(svc.replicas)
        asc = Autoscaler(AutoscalerConfig(min_replicas=1, max_replicas=4,
                                          cooldown_s=100.0, tick_s=0.25,
                                          provision_s=0.75),
                         forecast=ForecastConfig(bin_s=0.25,
                                                 min_history_s=0.5,
                                                 recent_window_s=1.0))
        for i in range(80):                  # 20 rps sustained
            asc.observe_arrival(2.0 + i * 0.05)
        asc.record("up", 6.0)                # cooldown just started
        action, _ = asc.decide(6.1, live, wait_len=0, p95_ttft_s=None,
                               capacity_rps=4.0)
        assert action == "up"
        asc.record("up", 6.1)
        assert asc.predictive_ups == 1

    def test_forecast_holds_capacity_through_predicted_peak(self):
        asc = Autoscaler(AutoscalerConfig(min_replicas=1, max_replicas=4,
                                          cooldown_s=0.0, tick_s=0.25),
                         forecast=ForecastConfig(bin_s=0.25,
                                                 min_history_s=0.5,
                                                 recent_window_s=1.0))
        for i in range(80):
            asc.observe_arrival(2.0 + i * 0.05)

        class _Idle:
            state = "active"
            depth = 0
            rep_id = 0

            def tokens_owed(self):
                return 0
        live = [_Idle(), _Idle(), _Idle()]
        live[1].rep_id, live[2].rep_id = 1, 2
        action, victim = asc.decide(6.0, live, wait_len=0, p95_ttft_s=None,
                                    capacity_rps=8.0)
        assert action == "hold" and victim is None
        action, victim = asc.decide(6.0, live, wait_len=0, p95_ttft_s=None,
                                    capacity_rps=30.0)
        assert action == "down" and victim is not None


class TestThroughputScaling:
    def _tps(self, small_model, n_replicas, n_requests):
        _, svc = _service(small_model, replicas=n_replicas)
        reqs = uniform_burst(n_requests, new_tokens=8, prompt_len=6)
        rep = svc.run(reqs)
        _assert_conserved(reqs, rep)
        assert rep.dropped == 0
        return rep.aggregate_tokens_per_s

    def test_two_replicas_scale(self, small_model):
        one = self._tps(small_model, 1, 8)
        two = self._tps(small_model, 2, 8)
        assert two >= 0.9 * 2 * one, (one, two)

    def test_four_replicas_scale(self, small_model):
        one = self._tps(small_model, 1, 16)
        four = self._tps(small_model, 4, 16)
        assert four >= 0.9 * 4 * one, (one, four)


class TestRouterPolicies:
    def test_least_loaded_balances(self, small_model):
        _, svc = _service(small_model, replicas=2)
        reqs = uniform_burst(8, new_tokens=4, prompt_len=4)
        svc.run(reqs)
        first = [r.replicas[0] for r in reqs]
        assert sorted(first.count(rep.rep_id)
                      for rep in svc.replicas) == [4, 4]

    def test_round_robin_alternates(self, small_model):
        _, svc = _service(small_model, replicas=2,
                          router=RouterConfig(policy="round_robin"))
        reqs = uniform_burst(6, new_tokens=4, prompt_len=4)
        svc.run(reqs)
        assert [r.replicas[0] for r in reqs] == [0, 1, 0, 1, 0, 1]

    def test_least_eta_prefers_idle_replica(self, small_model):
        _, svc = _service(small_model, replicas=2,
                          router=RouterConfig(policy="least_eta"))
        r0, r1 = svc.replicas
        for q in uniform_burst(4, new_tokens=16, prompt_len=4):
            r0.dispatch(q)
        assert r1.eta_s(0.0) < r0.eta_s(0.0)
        assert svc.router.pick(svc.replicas, 0.0) is r1


class TestServiceLifecycle:
    def test_close_frees_replicas_and_unsubscribes(self, small_model):
        cfg, params = small_model
        sc = _sc(8)
        svc = FleetService(sc, cfg, params, SPEC, geometry=(4, 4, 4),
                           initial_replicas=2, timing=CHUNK_S)
        svc.run(uniform_burst(4, new_tokens=4, prompt_len=4))
        n_subs = len(sc._subscribers)
        svc.close()
        assert len(sc._subscribers) == n_subs - 1
        assert not svc.replicas and len(svc.retired) == 2
        assert sc.utilization() == 0.0
        for r in svc.retired:
            assert r.session is None and r.slice is None
            assert r.stats()["state"] == "freed"

    def test_migration_within_prompt_window_is_not_truncated(self,
                                                             small_model):
        cfg, params = small_model
        sc = _sc(2)
        svc = FleetService(sc, cfg, params, SPEC, geometry=(4, 4, 4),
                           initial_replicas=2, timing=CHUNK_S)
        reqs = uniform_burst(6, new_tokens=5, prompt_len=3)
        rep = svc.run(reqs, fail_plan=[(1.5 * CHUNK_S, "replica:0")])
        _assert_conserved(reqs, rep)
        stats = {s["rep_id"]: s for s in rep.replica_stats}
        assert all(s["truncated_migrations"] == 0 for s in stats.values())


class TestServedGoodput:
    def test_demand_one_matches_scheduled(self):
        for mode, sched in (("ocs", goodput_ocs), ("static", goodput_static)):
            got = served_goodput(512, 0.99, 1.0, mode=mode, trials=300,
                                 seed=0)
            want = sched(512, 0.99, trials=300, seed=0)
            assert np.isclose(got, want), (mode, got, want)

    def test_low_demand_ocs_serves_everything(self):
        assert served_goodput(512, 0.99, 0.25, trials=300) == 1.0

    def test_monotone_in_demand(self):
        vals = [served_goodput(3072, 0.99, d, trials=300)
                for d in (0.25, 0.5, 0.75, 1.0)]
        assert all(a >= b - 1e-9 for a, b in zip(vals, vals[1:])), vals

    def test_ocs_beats_static_at_fleet_level(self):
        ocs = served_goodput(512, 0.99, 0.75, mode="ocs", trials=200)
        static = served_goodput(512, 0.99, 0.75, mode="static", trials=200)
        assert ocs > static


# -- what only the port has to show -------------------------------------------

def test_replicas_share_one_weight_tree(small_model):
    """Every replica's engine holds the service's tree; params already on
    the machine's device are not copied."""
    cfg, params = small_model
    sc = _sc(8)
    svc = FleetService(sc, cfg, params, SPEC, geometry=(4, 4, 4),
                       initial_replicas=3, timing=CHUNK_S)
    assert all(a is b for a, b in zip(leaves(svc.params), leaves(params)))
    for r in svc.replicas:
        assert r.session.engine.params is svc.params
    svc.close()


def test_params_on_moves_only_the_leaves_elsewhere():
    """`params_on` moves each leaf that is not on the target device (a
    `QTensor`'s int8 rows and scales too), keeping shape and dtype, and
    keeps the leaves already there as they are (meta stands in for the
    card)."""
    from repro_torch.fleet.service import params_on
    from repro_torch.models.quant import QTensor
    meta = torch.device("meta")
    kept = torch.empty((3, 4), device=meta)
    tree = {"w": torch.randn(4, 5),
            "layers": [torch.randn(2, dtype=torch.bfloat16), kept],
            "q": QTensor(torch.ones((4, 8), dtype=torch.int8),
                         torch.ones((4, 1)), 8)}
    out = params_on(tree, meta)
    assert out["layers"][1] is kept
    src = [tree["w"], tree["layers"][0], tree["q"].q, tree["q"].scale]
    got = [out["w"], out["layers"][0], out["q"].q, out["q"].scale]
    for a, b in zip(src, got):
        assert b.device == meta and a.device.type == "cpu"
        assert (b.shape, b.dtype) == (a.shape, a.dtype)
    assert isinstance(out["q"], QTensor) and out["q"].tile == 8
    assert isinstance(out["layers"], list)


def test_measured_timing_warms_up_on_the_machines_device(small_model,
                                                          monkeypatch):
    """timing="measured" warms up one engine on the machine's device (the
    port's engine raises on a device it was not given); the chunks are
    then charged their wall time."""
    from repro_torch.fleet import service as SV
    made = []
    real = SV.ServeEngine

    def spy(*a, **kw):
        made.append(kw.get("device"))
        return real(*a, **kw)
    monkeypatch.setattr(SV, "ServeEngine", spy)
    _, svc = _service(small_model, replicas=2, timing="measured")
    rep = svc.run(uniform_burst(4, new_tokens=4, prompt_len=4))
    assert made == [torch.device("cpu")] and svc._warmed
    assert rep.completed == 4 and rep.makespan_s > 0
    assert all(r.busy_s > 0 for r in svc.replicas)
    svc.close()


def test_retired_engines_are_freed_without_a_collection(small_model):
    """No reference cycle keeps a retired replica's engine (and its KV
    cache) alive: with the collector off, every engine is gone once its
    replica retires (a drain in the run, the rest at ``close()``)."""
    sc, svc = _service(small_model, num_blocks=3, replicas=1, timing=0.05,
                       autoscale=AutoscalerConfig(**AUTOSCALE))
    engines = []
    scale_up = svc._scale_up

    def tracked(*a, **kw):
        rep = scale_up(*a, **kw)
        if rep is not None and rep.session is not None:
            engines.append(weakref.ref(rep.session.engine))
        return rep
    svc._scale_up = tracked
    engines += [weakref.ref(r.session.engine) for r in svc.replicas]
    trace = generate(TrafficSpec(
        duration_s=4.0, rate_rps=4.0, pattern="bursty", burst_x=10.0,
        burst_period_s=2.0, burst_len_s=0.5, prompt_len_max=6,
        new_tokens_choices=(8, 16), new_tokens_weights=(0.6, 0.4)), seed=2)
    gc.collect()
    gc.disable()
    try:
        rep = svc.run(trace, fail_plan=[(2.15, "spare"), (2.2, "busiest")],
                      settle_s=3.0)
        assert rep.scale_downs >= 1 and rep.failures == 1
        retired = {r.rep_id for r in svc.retired}
        assert retired
        svc.close()
        assert len(engines) == rep.replicas_seen
        assert all(e() is None for e in engines)
    finally:
        gc.enable()


def test_audio_family_is_refused(small_model):
    cfg, params = small_model
    with pytest.raises(AssertionError, match="whisper"):
        FleetService(_sc(2), cfg.replace(family="audio"), params, SPEC)


def test_serve_fleet_twin_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_fleet", "--device",
         "cpu"], capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "offered: 58 requests" in out and "completed: 58" in out
    assert "OK: 3 scale-up(s), 1 drain+scale-down(s), 2 migrated" in out
