"""`repro_torch.cluster` on the CPU: the mirror of ``tests/test_cluster.py``
(allocate -> train -> serve, slice reuse after free, the job queue, block
failures reaching live sessions), the §2.3 drill and a preempt/resume on
another shape bitwise equal to a clean run, the straggler path fed step
times through ``Slice.block_times`` (never the wall clock), the copied
``repro_torch.core`` against ``repro.core`` on the same inputs, the names
once stubbed (now the ported registry and tenancy), and the quickstart
twin."""
import dataclasses
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import autotopo as JAT
from repro.core import costmodel as JCM
from repro.core import goodput as JGP
from repro.core import ocs as JOCS
from repro.core import scheduler as JSCHED
from repro.core import topology as JTOPO
from repro_torch import cluster as TC
from repro_torch.cluster import (CapacityError, SliceError, SliceSpec,
                                 StragglerConfig, StragglerDetector,
                                 Supercomputer)
from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.core import autotopo as TAT
from repro_torch.core import costmodel as TCM
from repro_torch.core import goodput as TGP
from repro_torch.core import ocs as TOCS
from repro_torch.core import scheduler as TSCHED
from repro_torch.core import topology as TTOPO
from repro_torch.core.autotopo import ModelProfile, ParallelSpec
from repro_torch.models import api
from repro_torch.optim import adam as OPT
from repro_torch.parallel.context import LOCAL

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sc(**kw):
    return Supercomputer(device="cpu", **kw)


def _run(arch="olmo-1b", gb=2, T=16):
    return RunConfig(
        model=registry.get_reduced(arch),
        shape=ShapeConfig("t", "train", T, gb),
        parallel=ParallelConfig(remat="none"),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2))


@pytest.fixture(scope="module")
def served_params():
    cfg = registry.get_reduced("olmo-1b")
    return cfg, api.init_params(cfg, seed=0, device="cpu")


class TestAllocation:
    def test_allocate_by_dims_and_chips(self):
        sc = _sc()
        sl = sc.allocate((4, 8, 8))
        assert sl.dims == (4, 8, 8) and sl.num_chips == 256
        cube = sc.allocate(512)              # picks the max-bisection cube
        assert cube.dims == (8, 8, 8)
        assert sc.utilization() == pytest.approx(12 / 64)

    def test_reuse_after_free(self):
        sc = _sc(num_blocks=8)
        sl = sc.allocate((8, 8, 8))          # whole machine
        with pytest.raises(CapacityError):
            sc.allocate((4, 4, 4))
        blocks = sl.blocks
        sl.free()
        assert sl.status == "freed"
        with pytest.raises(SliceError):
            sl.dryrun(ModelProfile("x", 1e9, 12, 1024, 128, 64))
        sl2 = sc.allocate((8, 8, 8))
        assert sl2.blocks == blocks
        assert sc.utilization() == pytest.approx(1.0)

    def test_context_manager_frees(self):
        sc = _sc()
        with sc.allocate((4, 4, 4)) as sl:
            assert sc.utilization() > 0
        assert sl.status == "freed" and sc.utilization() == 0.0

    def test_twisted_allocation_and_retwist(self):
        sc = _sc()
        sl = sc.allocate((4, 4, 8), twisted=True)
        assert sl.topology.twisted and sl.describe() == "4x4x8_T"
        moved = sl.retwist(False)
        assert moved > 0 and not sl.twisted
        assert sl.retwist(False) == 0        # no-op
        with pytest.raises(ValueError):
            sc.allocate((4, 4, 4)).retwist(True)   # not twistable


class TestAnalytics:
    PROF = ModelProfile("p", params=1e9, layers=12, d_model=1024,
                        seq_len=128, global_batch=64)

    def test_dryrun_uses_slice_geometry(self):
        sl = _sc().allocate((4, 4, 8))
        ev = sl.dryrun(self.PROF)
        assert ev.geometry == (4, 4, 8) and ev.step_time > 0
        pinned = sl.dryrun(self.PROF, ParallelSpec(1, 4, 4, 8))
        assert pinned.spec.total == sl.num_chips

    def test_autotopo_searches_all_geometries(self):
        sc = _sc()
        sl = sc.allocate((4, 4, 8))
        evs = sl.autotopo(self.PROF, top_k=4)
        assert evs and evs[0].step_time <= evs[-1].step_time
        assert {e.geometry for e in evs} <= set(sc.geometries(128))

    def test_bound_cost_model(self):
        sc = _sc()
        sl = sc.allocate((4, 4, 8))
        topo = sl.topology
        assert sl.cost.all_reduce(2 ** 30) == pytest.approx(
            sc.costs.all_reduce(topo, 2 ** 30))
        assert sl.cost.all_to_all(2 ** 20) == pytest.approx(
            sc.costs.all_to_all(topo, 2 ** 20))

    def test_expected_goodput_modes(self):
        sc = _sc()
        ocs = sc.expected_goodput(1024, 0.99, trials=500)
        static = sc.expected_goodput(1024, 0.99, mode="static", trials=100)
        assert ocs > static


class TestFailurePropagation:
    def test_failure_reroutes_and_notifies_session(self, served_params):
        cfg, params = served_params
        sc = _sc()
        sl = sc.allocate((8, 8, 8))
        session = sl.serve(cfg, params,
                           SliceSpec(slots=2, max_len=32, prompt_len=8))
        for i in range(3):
            session.submit(np.arange(4) + i, max_new_tokens=4)
        sc.fail_block(sl.blocks[0])          # swapped for a spare
        assert sl.status == "active"
        assert [e.kind for e in session.interruptions] == ["reconfigure"]
        assert session.interruptions[0].circuits_moved > 0
        stats = session.run()
        assert not stats["aborted"]
        assert stats["requests_done"] == 3
        assert stats["interruptions"] == 1
        assert stats["reconfig_stall_s"] > 0

    def test_failure_without_spare_loses_slice(self, served_params):
        cfg, params = served_params
        sc = _sc(num_blocks=1)
        sl = sc.allocate((4, 4, 4))
        session = sl.serve(cfg, params,
                           SliceSpec(slots=1, max_len=32, prompt_len=8))
        sc.fail_block(sl.blocks[0])
        assert sl.status == "lost"
        assert session.lost
        with pytest.raises(SliceError):
            session.submit(np.arange(4))
        stats = session.run()
        assert stats["aborted"]
        for k in ("requests_done", "tokens", "wall_s", "tokens_per_s",
                  "mean_ttft_s", "decode_steps"):
            assert k in stats

    def test_sessions_unusable_after_free(self, served_params):
        cfg, params = served_params
        sl = _sc().allocate((4, 4, 4))
        serve = sl.serve(cfg, params,
                         SliceSpec(slots=1, max_len=32, prompt_len=8))
        train = sl.train(_run())
        sl.free()
        assert serve.closed and train.closed and not serve.lost
        with pytest.raises(SliceError):
            serve.submit(np.arange(4))
        with pytest.raises(SliceError):
            serve.run()
        with pytest.raises(SliceError):
            train.run(2)

    def test_idle_block_failure_touches_no_slice(self):
        sc = _sc()
        sl = sc.allocate((4, 4, 4))
        sc.fail_block(max(sc.scheduler.free))
        assert sl.status == "active" and len(sl.events) == 1

    def test_straggler_swap_event(self):
        sl = _sc().allocate((8, 8, 8))
        slow = sl.blocks[2]
        ev = sl.swap_straggler(slow)
        assert ev.kind == "straggler" and slow not in sl.blocks


class TestJobQueue:
    def test_fifo_drain(self):
        sc = _sc(num_blocks=2)
        for i in range(3):
            sc.submit((4, 4, 8), lambda s, i=i: (i, s.describe()))
        done = sc.run_pending()
        assert [t.result for t in done] == [
            (0, "4x4x8"), (1, "4x4x8"), (2, "4x4x8")]
        assert not sc.queue and sc.utilization() == 0.0

    def test_backfill_around_blocked_head(self):
        sc = _sc(num_blocks=2)
        hold = sc.allocate((4, 4, 4))
        sc.submit((4, 4, 8), lambda s: "big")
        sc.submit((4, 4, 4), lambda s: "small")
        assert [t.result for t in sc.run_pending()] == ["small"]
        hold.free()
        assert [t.result for t in sc.run_pending()] == ["big"]

    def test_submit_rejects_bad_geometry(self):
        sc = _sc(num_blocks=2)
        with pytest.raises(ValueError):
            sc.submit((8, 8, 8), lambda s: None, twisted=True)
        with pytest.raises(ValueError):
            sc.submit((16, 16, 16), lambda s: None)
        assert not sc.queue

    def test_failed_job_keeps_queue_draining(self):
        sc = _sc(num_blocks=2)
        sc.submit((4, 4, 4), lambda s: 1 / 0)
        sc.submit((4, 4, 4), lambda s: "ok")
        done = sc.run_pending()
        assert done[0].status == "failed" and "ZeroDivisionError" in \
            done[0].error
        assert done[1].result == "ok"
        assert sc.utilization() == 0.0


class TestTrainServe:
    def test_train_then_serve_on_one_slice(self, tmp_path):
        sc = _sc()
        sl = sc.allocate((4, 4, 4))
        run = _run()
        train = sl.train(run, 4, ckpt_dir=str(tmp_path), ckpt_every=2,
                         log_every=2)
        assert train.state.step == 4
        losses = [m["loss"] for m in train.metrics_log if "loss" in m]
        assert losses and all(np.isfinite(losses))
        session = sl.serve(run.model, train.params,
                           SliceSpec(slots=2, max_len=32, prompt_len=8))
        session.submit(np.arange(4), max_new_tokens=4)
        stats = session.run()
        assert stats["requests_done"] == 1 and stats["tokens"] == 4
        sl.free()

    def test_block_failure_during_training_session(self, tmp_path):
        """The §2.3 story through the facade: fail mid-run, swap a spare,
        restore from the checkpoint, finish; the session records it."""
        sc = _sc()
        sl = sc.allocate((8, 8, 8))
        sess = sl.train(_run(), 6, ckpt_dir=str(tmp_path), ckpt_every=2,
                        fail_at=4, log_every=1)
        assert sess.state.step == 6
        assert [e.kind for e in sess.interruptions] == ["reconfigure"]
        assert sess.interruptions[0].circuits_moved > 0
        assert sl.status == "active"
        assert all(b in sc.scheduler.healthy for b in sl.blocks)
        assert sum(1 for m in sess.metrics_log if m.get("event")) == 1


class TestServeEngineShim:
    def test_legacy_kwargs_raise_typeerror(self, served_params):
        cfg, params = served_params
        from repro_torch.serve.engine import ServeEngine
        with pytest.raises(TypeError):
            ServeEngine(cfg, params, slots=2, max_len=48, prompt_len=8)

    def test_spec_construction_no_warning(self, served_params):
        cfg, params = served_params
        from repro_torch.serve.engine import ServeEngine
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng = ServeEngine(cfg, params, SliceSpec(slots=3), device="cpu")
        assert not [x for x in w
                    if issubclass(x.category, DeprecationWarning)]
        assert eng.slots == 3


# -- the §2.3 drill and elastic resume, bitwise ----------------------------------

def _losses(sess):
    return {m["step"]: m["loss"] for m in sess.metrics_log if "loss" in m}


def test_fault_drill_matches_clean_run_bitwise(tmp_path):
    """Two slices on one machine, as examples/fault_tolerant_training.py:
    a block fails at step 7 of 12 (checkpoints every 4), a spare is swapped
    in, the run restores step 4 and ends on the clean run's losses and
    params, bit for bit."""
    run = _run()
    sc = _sc()
    faulted, reference = sc.allocate((8, 8, 8)), sc.allocate((8, 8, 8))
    ref = reference.train(run, 12, ckpt_dir=str(tmp_path / "ref"),
                          ckpt_every=4, log_every=1)
    failed_block = faulted.blocks[0]
    sess = faulted.train(run, 12, ckpt_dir=str(tmp_path / "ft"),
                         ckpt_every=4, fail_at=7, log_every=1)
    assert [e.kind for e in sess.interruptions] == ["reconfigure"]
    assert failed_block not in faulted.blocks
    assert failed_block not in sc.scheduler.healthy
    restarts = [m for m in sess.metrics_log if m.get("event")]
    assert [m["step"] for m in restarts] == [4]
    assert _losses(sess) == _losses(ref) and len(_losses(ref)) == 12
    assert all(torch.equal(a, b) for a, b in zip(
        OPT.leaves(sess.params), OPT.leaves(ref.params)))
    assert ref.interruptions == []


def test_preempt_then_resume_on_another_shape_is_bitwise(tmp_path):
    run = _run()
    sc = _sc()
    clean = sc.allocate((4, 4, 4)).train(run, 8, log_every=1)
    first = sc.allocate((8, 8, 8))
    sess = first.train(run, ckpt_dir=str(tmp_path), ckpt_every=100)
    state = sess.trainer.train(8, preempt_at=5, log_every=1)
    assert sess.preempted and state.step == 5
    first.free()
    second = sc.allocate((4, 4, 8))
    resumed = second.train(run, 8, ckpt_dir=str(tmp_path), log_every=1)
    assert resumed.state.step == 8
    got = {**_losses(sess), **_losses(resumed)}
    assert got == _losses(clean)
    assert all(torch.equal(a, b) for a, b in zip(
        OPT.leaves(resumed.params), OPT.leaves(clean.params)))


def test_preempt_event_stops_the_session(tmp_path):
    """A "preempt" SliceEvent asks the trainer to checkpoint and stop at
    the next step boundary (here: before its first step)."""
    sl = _sc().allocate((4, 4, 4))
    sess = sl.train(_run(), ckpt_dir=str(tmp_path))
    assert sl.request_preempt() is False        # the tenant did not free
    sess.run(4)
    assert sess.preempted and sess.state.step == 0
    assert any(e.kind == "preempt" for e in sess.interruptions)


# -- stragglers, step times through block_times ------------------------------

CFG = StragglerConfig(threshold=1.25, ema_alpha=0.5, patience=2,
                      cooldown_steps=2)


def test_straggler_detected_from_block_times_and_swapped():
    sc = _sc(num_blocks=8)
    sl = sc.allocate((8, 4, 4))
    slow = sl.blocks[1]
    sc.set_block_slowdown(slow, 2.0)
    assert sl.slowdown_factor() == 2.0
    det = StragglerDetector(CFG)
    fired = None
    for _ in range(CFG.patience + 1):
        fired = fired or det.observe(sl.block_times(0.5))
    assert fired == slow
    # the payback check on fixed numbers: a long run pays, one step does not
    cost = sl.swap_cost_s(slow)
    assert det.worth_swapping(slow, 0.5, cost, remaining_steps=1000)
    assert not det.worth_swapping(slow, 0.5, cost, remaining_steps=0)
    ev = sl.swap_straggler(slow)
    det.fired(slow)
    assert ev.kind == "straggler" and slow not in sl.blocks
    assert sl.slowdown_factor() == 1.0


def test_train_session_swaps_a_straggler(monkeypatch):
    """TrainSession.run(straggler=) feeds the detector this slice's
    block_times after every step and swaps the block it names; the payback
    check (the only part that reads a step time's size) is held true."""
    sc = _sc(num_blocks=8)
    sl = sc.allocate((8, 4, 4))
    slow = sl.blocks[1]
    sc.set_block_slowdown(slow, 2.0)
    det = StragglerDetector(CFG)
    monkeypatch.setattr(det, "worth_swapping", lambda *a, **k: True)
    sess = sl.train(_run())
    sess.run(6, straggler=det, log_every=100)
    assert det.fired_log and det.fired_log[0][1] == slow
    assert slow not in sl.blocks
    assert any(e.kind == "straggler" for e in sess.interruptions)
    assert sess.stall_s > 0


# -- the copied core against repro.core ----------------------------------------

@pytest.mark.parametrize("chips", [64, 128])
def test_core_geometries_and_topology_equal(chips):
    for n in (chips, 512, 4096):
        assert TTOPO.geometries_for(n) == JTOPO.geometries_for(n)
    for g in TTOPO.geometries_for(chips)[:2]:
        for tw in (False, True):
            if tw and not TTOPO.is_twistable(g):
                continue
            t, j = TTOPO.SliceTopology(g, tw), JTOPO.SliceTopology(g, tw)
            assert t.describe() == j.describe()
            assert t.bisection_links() == j.bisection_links()
            cm_t, cm_j = TCM.CollectiveCostModel(), JCM.CollectiveCostModel()
            assert cm_t.all_reduce(t, 2 ** 30) == cm_j.all_reduce(j, 2 ** 30)
            assert cm_t.all_to_all(t, 2 ** 20) == cm_j.all_to_all(j, 2 ** 20)


def test_core_scheduler_placements_and_reconfig_equal():
    out = []
    for S in (TSCHED.SliceScheduler, JSCHED.SliceScheduler):
        s = S(16)
        a = s.allocate((8, 8, 8))
        b = s.allocate((4, 4, 8), twisted=True, priority=1)
        res = [list(a.blocks), list(b.blocks), s.fail_block(a.blocks[2]),
               s.swap_straggler(b.job_id, b.blocks[0])]
        s.set_slowdown(a.blocks[0], 3.0)
        res.append(s.shrink(a.job_id, (4, 8, 8)))
        s.release(b.job_id)
        res += [sorted(s.free), s.utilization(), list(s.events)]
        out.append(res)
    assert out[0] == out[1]
    for n in (0, 1, 48, 97, 1000):
        assert TOCS.reconfig_time(n) == JOCS.reconfig_time(n)


def test_core_goodput_and_autotopo_equal():
    for chips in (256, 1024):
        for avail in (0.99, 0.999):
            assert TGP.goodput_ocs(chips, avail, trials=300, seed=1) == \
                JGP.goodput_ocs(chips, avail, trials=300, seed=1)
            assert TGP.goodput_static(chips, avail, trials=100, seed=2) == \
                JGP.goodput_static(chips, avail, trials=100, seed=2)
    kw = dict(name="p", params=1e9, layers=12, d_model=1024, seq_len=128,
              global_batch=64)
    t = TAT.search(TAT.ModelProfile(**kw), 256, top_k=5)
    j = JAT.search(JAT.ModelProfile(**kw), 256, top_k=5)
    assert t and [dataclasses.astuple(e) for e in t] == [
        dataclasses.astuple(e) for e in j]


# -- the rest of the surface ----------------------------------------------------

@pytest.mark.parametrize("name", ["MachineRegistry", "slice_key",
                                  "ElasticTrainJob", "MixedTenancyDriver",
                                  "TenancyReport", "TrainTenantSpec"])
def test_unported_cluster_names_raise_naming_their_item(name):
    """The names that raised naming item 16 until the registry and the
    tenancy were ported: each now resolves to the ported object in
    ``cluster/registry.py`` or ``cluster/tenancy.py``, never a stub."""
    import repro.cluster as JC
    from repro_torch.cluster import registry as TREGISTRY
    from repro_torch.cluster import tenancy as TTENANCY
    assert set(TC.__all__) == set(JC.__all__)
    obj = getattr(TC, name)
    home = TREGISTRY if name in ("MachineRegistry", "slice_key") \
        else TTENANCY
    assert obj is getattr(home, name)
    assert obj.__module__ == home.__name__
    assert obj.__qualname__ == getattr(JC, name).__qualname__
    assert "stub" not in obj.__qualname__


def test_supercomputer_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Supercomputer()
    sl = _sc().allocate((4, 4, 4))
    assert sl.device == torch.device("cpu")
    assert sl.parallel_context() is LOCAL and not LOCAL.has_mesh


def test_quickstart_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quickstart", "--device",
         "cpu"], capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "allocated 8x8x8" in out and "step  30" in out
    assert "4 requests, 32 tokens" in out
    assert "machine utilization 0.00" in out


def test_priority_allocation_preempts_a_cooperative_trainer(tmp_path):
    """allocate(priority=, preempt=True): the lower-priority training
    slice gets a "preempt" event, its tenant frees the slice from the
    handler, the trainer checkpoints at its next boundary and a later
    session resumes from that checkpoint."""
    sc = _sc(num_blocks=8)
    seen = []
    sc.subscribe(lambda sl, ev: seen.append((sl.job_id, ev.kind)))
    low = sc.allocate((8, 8, 8), priority=0)
    sess = low.train(_run(), ckpt_dir=str(tmp_path))
    sess.run(2, log_every=1)
    sess.add_listener(lambda s, ev: ev.kind == "preempt" and s.slice.free())
    high = sc.allocate((8, 8, 8), priority=1, preempt=True)
    assert low.status == "freed" and high.status == "active"
    assert (low.job_id, "preempt") in seen and (low.job_id, "free") in seen
    assert sess.trainer.preempt_requested
    # the owner resumes later, on the high slice once it is done with it
    high.free()
    again = sc.allocate((4, 8, 8))
    resumed = again.train(_run(), 3, ckpt_dir=str(tmp_path), log_every=1)
    assert resumed.state.step == 3
    assert [m["step"] for m in resumed.metrics_log] == [3]
    ov = sc.overview()
    assert ov["live_slices"] == {again.job_id: "4x8x8"}
    assert ov["free_blocks"] == 4 and ov["utilization"] == 0.5


def test_request_capacity_prefers_a_shrink():
    sc = _sc(num_blocks=8)
    low = sc.allocate((8, 8, 8), priority=0)
    low_sess = low.serve(*_cfg_and_params(), SliceSpec(slots=1, max_len=32,
                                                        prompt_len=8))

    def on_event(session, ev):
        if ev.kind == "shrink_request":
            session.slice.shrink((4, 8, 8))

    low_sess.add_listener(on_event)
    high = sc.allocate((4, 4, 8), priority=2, preempt="shrink")
    assert high.status == "active" and low.status == "active"
    assert low.dims == (4, 8, 8)
    assert [e.kind for e in low_sess.interruptions] == [
        "shrink_request", "shrink"]
    dead = high.blocks[0]
    sc.fail_block(dead)                      # a spare takes its place
    assert dead not in high.blocks and dead not in sc.scheduler.healthy
    sc.repair_block(dead)
    assert all(b in sc.scheduler.healthy for b in range(8))
    sc.set_block_slowdown(low.blocks[0], 1.5)
    assert low.slowdown_factor() == 1.5


def _cfg_and_params():
    cfg = registry.get_reduced("olmo-1b")
    return cfg, api.init_params(cfg, seed=0, device="cpu")
