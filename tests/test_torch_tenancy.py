"""`repro_torch.cluster.tenancy` on the CPU: against `repro.cluster.tenancy`,
and the mirror of ``tests/test_tenancy.py``'s `TestElasticTrainJob` and
`TestMixedDriver`.

Both packages run ``examples/mixed_cluster.py``'s scenario (a priority-1
autoscaled fleet of reduced olmo-1b on a 4-block machine, a diurnal
trace, an elastic priority-0 trainer on geometries 4x4x12 / 4x4x8 /
4x4x4) with the same serving weights (JAX's init, through
``repro_torch.interop``) and the same starting training state (a JAX
``Trainer``'s step-0 checkpoint, restored by both).  The control loop
reads only virtual time and budgets, so the port's `TenancyReport` must
equal the reference's exactly: with eviction, with ``"shrink"``, for the
static arm (``resume_training=False``) and with two trainers.  The
tenant's loss curve across a preemption and resume, and across a shrink,
must be bitwise the port's uninterrupted run of the same steps, and
within the dense-training bar (1e-3 + 2^-7 |loss|) of the reference
tenant's.  The served streams are held to the parity bar of
``tests/test_torch_fleet.py``.
"""
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import weakref

import pytest
import torch

from repro import cluster as JC
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import ParallelConfig as JPar
from repro.configs.base import RunConfig as JRun
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_local_mesh
from repro.serve.engine import SliceSpec as JSpec
from repro.train.trainer import Trainer as JTrainer
from repro_torch import cluster as TC
from repro_torch.cluster import (ElasticTrainJob, MixedTenancyDriver,
                                 SliceSpec, Supercomputer, TrainTenantSpec)
from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                      RunConfig, ShapeConfig)
from repro_torch.fleet import AutoscalerConfig, FleetService, uniform_burst
from repro_torch.optim.adam import leaves
from repro_torch.train.trainer import Trainer
from test_torch_fleet import J, T, _model, assert_streams_match

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE_SPEC = dict(slots=4, max_len=64, prompt_len=16, chunk=8)
AUTOSCALE = dict(min_replicas=1, max_replicas=3, tick_s=0.05, cooldown_s=0.3,
                 scale_up_backlog=3.0, scale_down_backlog=0.5,
                 provision_s=0.1)
DIURNAL = dict(duration_s=4.0, rate_rps=14.0, pattern="diurnal",
               trough_frac=0.1, diurnal_period_s=4.0,
               new_tokens_choices=(16, 32), new_tokens_weights=(0.5, 0.5),
               prompt_len_max=8)
GEOMETRIES = ((4, 4, 12), (4, 4, 8), (4, 4, 4))
SHAPE = ("mixed", "train", 32, 4)
OCFG = dict(lr=1e-3, warmup_steps=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the reduced model's ops are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jrun():
    return JRun(model=_model()["jcfg"], shape=JShape(*SHAPE),
                parallel=JPar(remat="none"), optimizer=JOpt(**OCFG))


def _trun():
    return RunConfig(model=registry.get_reduced("olmo-1b"),
                     shape=ShapeConfig(*SHAPE),
                     parallel=ParallelConfig(remat="none"),
                     optimizer=OptimizerConfig(**OCFG))


@pytest.fixture(scope="module")
def step0(tmp_path_factory):
    """A JAX Trainer's initial state checkpointed at step 0: both
    packages' tenants restore it, so they start from the same params."""
    d = tmp_path_factory.mktemp("step0")
    tr = JTrainer(_jrun(), make_local_mesh(), ckpt_dir=str(d))
    tr.save(tr.init_state())
    return str(d)


def _copy(src, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(src, dst)
    return str(dst)


def _losses(sc):
    """The tenant's loss curve: every ``train.metrics`` series the
    machine's telemetry holds (one a slice the tenant trained on)."""
    out = {}
    for kind, name, _, series in sc.obs.metrics.items():
        if kind == "series" and name == "train.metrics":
            out.update({m["step"]: m["loss"] for m in series.samples
                        if "loss" in m})
    return out


def _scenario(pkg, dirs, *, targets=(60,), priorities=(0,), preempt=True,
              resume=True, arm="elastic"):
    """mixed_cluster.py's scenario through one package: (report, machine,
    requests, jobs)."""
    m = _model()
    port = pkg is T
    C = TC if port else JC
    kw = {"device": "cpu"} if port else {}
    sc = C.Supercomputer(num_blocks=4, **kw)
    svc = pkg.FleetService(
        sc, m["tcfg"] if port else m["jcfg"], m["tp"] if port else m["jp"],
        (SliceSpec if port else JSpec)(**SERVE_SPEC), geometry=(4, 4, 4),
        initial_replicas=1, timing=0.15,
        autoscale=pkg.AutoscalerConfig(**AUTOSCALE), priority=1,
        preempt_on_allocate=preempt)
    jobs = [C.ElasticTrainJob(sc, C.TrainTenantSpec(
        run=_trun() if port else _jrun(), target_steps=t, ckpt_dir=d,
        geometries=GEOMETRIES, priority=p, base_step_s=0.25,
        name=f"train{i}"))
        for i, (t, p, d) in enumerate(zip(targets, priorities, dirs))]
    assert jobs[0].try_start(0.0)
    trace = pkg.generate(pkg.TrafficSpec(**DIURNAL), seed=5)
    drv = C.MixedTenancyDriver(svc, jobs if len(jobs) > 1 else jobs[0],
                               window_s=0.5, resume_training=resume)
    rep = drv.run(trace, extra_windows=6, arm=arm)
    svc.close()
    return rep, sc, trace, jobs


def _both(step0, tmp_path, **kw):
    n = len(kw.get("targets", (60,)))
    out = []
    for pkg in (J, T):
        dirs = [_copy(step0, tmp_path, f"{pkg.__name__}-{i}")
                for i in range(n)]
        out.append(_scenario(pkg, dirs, **kw))
    (jrep, jsc, jtrace, _), (trep, tsc, ttrace, tjobs) = out
    assert trep.to_dict() == jrep.to_dict()
    assert trep.log == jrep.log
    assert_streams_match(_model(), SERVE_SPEC, jtrace, ttrace)
    return out


def _clean_losses(step0, tmp_path, steps):
    """The port's uninterrupted run of ``steps`` from the same state."""
    tr = Trainer(_trun(), device="cpu",
                 ckpt_dir=_copy(step0, tmp_path, "clean"), ckpt_every=10**6)
    state = tr.train(steps, log_every=1)
    return {m["step"]: m["loss"] for m in tr.metrics_log if "loss" in m}, \
        state


def _within_jax_bar(got, want):
    assert set(got) == set(want)
    for s, w in want.items():
        assert abs(got[s] - w) <= 1e-3 + 2.0 ** -7 * abs(w), (s, got[s], w)


def test_mixed_cluster_report_and_losses(step0, tmp_path):
    """Eviction: the burst evicts the trainer at t = 1.0, it resumes on
    one block at the trough and grows back; the curve is the clean run's
    bit for bit, and JAX's within the training bar."""
    (jrep, jsc, _, _), (trep, tsc, _, tjobs) = _both(step0, tmp_path)
    assert trep.train_preemptions >= 1 and trep.train_resumes >= 1
    assert trep.train_steps == 60 and trep.serve["completed"] == 40
    got = _losses(tsc)
    clean, state = _clean_losses(step0, tmp_path, 60)
    assert got == clean and len(got) == 60
    _within_jax_bar(got, _losses(jsc))
    final = Trainer(_trun(), device="cpu",
                    ckpt_dir=tjobs[0].spec.ckpt_dir).restore()
    assert final.step == 60 and all(torch.equal(a, b) for a, b in zip(
        leaves(final.params), leaves(state.params)))


def test_shrink_report_and_losses(step0, tmp_path):
    """``preempt_on_allocate="shrink"``: the trainer hands blocks back and
    keeps training on a smaller geometry instead of being evicted."""
    (jrep, jsc, _, _), (trep, tsc, _, _) = _both(
        step0, tmp_path, targets=(24,), preempt="shrink")
    assert trep.train_shrinks >= 1 and trep.train_preemptions == 0
    got = _losses(tsc)
    assert got == _clean_losses(step0, tmp_path, 24)[0] and len(got) == 24
    _within_jax_bar(got, _losses(jsc))


def test_static_arm_and_two_trainers_equal_reference(step0, tmp_path):
    """Two trainers of two priority tiers with ``resume_training=False``
    (the static arm: an evicted trainer never comes back)."""
    (jrep, _, _, _), (trep, _, _, tjobs) = _both(
        step0, tmp_path, targets=(8, 8), priorities=(0, 1), resume=False,
        arm="static")
    assert trep.arm == "static" and len(trep.per_job) == 2
    assert trep.train_resumes == 0


def test_eviction_frees_the_state_during_the_notification(tmp_path):
    """The evicted trainer's params, m and v are gone (no collection
    needed) before ``_vacate`` returns, inside the requester's
    allocation, so the serving burst gets their memory."""
    seen = {}

    class Probed(ElasticTrainJob):
        def _vacate(self, *, save, reason):
            seen["param"] = weakref.ref(leaves(self.session.state.params)[0])
            super()._vacate(save=save, reason=reason)
            seen["dead_in_vacate"] = seen["param"]() is None

    sc = Supercomputer(num_blocks=2, device="cpu")
    job = Probed(sc, TrainTenantSpec(
        run=_trun(), target_steps=20, ckpt_dir=str(tmp_path),
        geometries=((4, 4, 8),)))
    assert job.try_start(0.0) and job.run_quantum(0.5) > 0
    hi = sc.allocate((4, 4, 8), priority=1, preempt=True)
    assert hi is not None and job.state == "preempted"
    assert seen["dead_in_vacate"]
    # and it resumes from the checkpoint the eviction wrote
    hi.free()
    assert job.try_start(1.0) and job.run_quantum(0.5) > 0
    assert job.steps_done == 8


# -- the reference's tests, on the port ---------------------------------------

class TestElasticTrainJob:
    def _spec(self, d, **kw):
        kw.setdefault("geometries", ((4, 4, 8), (4, 4, 4)))
        kw.setdefault("target_steps", 6)
        kw.setdefault("base_step_s", 0.25)
        return TrainTenantSpec(run=_trun(), ckpt_dir=d, **kw)

    def test_preempt_resume_grow_lifecycle(self):
        with tempfile.TemporaryDirectory() as d:
            sc = Supercomputer(num_blocks=2, device="cpu")
            job = ElasticTrainJob(sc, self._spec(d, target_steps=20))
            assert job.try_start(0.0)
            assert job.slice.dims == (4, 4, 8)       # largest fits
            assert job.run_quantum(0.5) > 0

            hi = sc.allocate((4, 4, 8), priority=1, preempt=True)
            assert job.state == "preempted" and job.preemptions == 1
            assert job.blocks_held == 0

            assert not job.try_start(1.0)
            hi.free()

            busy = sc.allocate((4, 4, 4), priority=1)
            assert job.try_start(2.0)
            assert job.slice.dims == (4, 4, 4)       # squeezed to 1 block
            assert job.resumes == 1
            steps_small = job.run_quantum(0.5)
            busy.free()
            assert job.maybe_grow(3.0)
            assert job.slice.dims == (4, 4, 8) and job.grows == 1
            steps_big = job.run_quantum(0.5)
            assert steps_big > steps_small           # more blocks, more steps

    def test_quantum_scales_with_blocks(self):
        with tempfile.TemporaryDirectory() as d:
            sc = Supercomputer(num_blocks=4, device="cpu")
            job = ElasticTrainJob(sc, self._spec(
                d, target_steps=1000, geometries=((4, 4, 8),)))
            assert job.try_start()
            assert job.steps_in(0.5) == 4            # 2 blocks / 0.25s
            job.state = "done"                       # skip actual training

    def test_completion_frees_blocks(self):
        with tempfile.TemporaryDirectory() as d:
            sc = Supercomputer(num_blocks=2, device="cpu")
            job = ElasticTrainJob(sc, self._spec(d, target_steps=2))
            assert job.try_start()
            while job.state == "running":
                job.run_quantum(0.5)
            assert job.state == "done" and job.steps_done == 2
            assert len(sc.scheduler.free) == 2       # everything returned


class TestMixedDriver:
    def test_serve_burst_evicts_and_training_recovers(self):
        m = _model()
        with tempfile.TemporaryDirectory() as d:
            sc = Supercomputer(num_blocks=2, device="cpu")
            svc = FleetService(
                sc, m["tcfg"], m["tp"],
                SliceSpec(slots=2, max_len=48, prompt_len=8, chunk=4),
                geometry=(4, 4, 4), initial_replicas=1, timing=0.2,
                autoscale=AutoscalerConfig(
                    min_replicas=1, max_replicas=2, tick_s=0.1,
                    cooldown_s=0.2, scale_up_backlog=1.5,
                    scale_down_backlog=0.25, provision_s=0.05),
                priority=1, preempt_on_allocate=True)
            job = ElasticTrainJob(sc, TrainTenantSpec(
                run=_trun(), target_steps=10, ckpt_dir=d,
                geometries=((4, 4, 4),), base_step_s=0.25))
            assert job.try_start(0.0)
            drv = MixedTenancyDriver(svc, job, window_s=0.5)
            burst = uniform_burst(8, new_tokens=8, prompt_len=6,
                                  t_arrival=0.25)
            rep = drv.run(burst, extra_windows=6, arm="elastic")
            svc.close()
            assert rep.serve["completed"] == 8
            assert rep.serve["dropped"] == 0
            assert rep.train_preemptions >= 1        # burst evicted training
            assert rep.train_resumes >= 1            # and it came back
            assert rep.train_steps == 10             # and finished
            assert rep.combined_score > 1.0


def test_mixed_cluster_twin_runs_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mixed_cluster", "--device",
         "cpu"], capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "serve : 40/40 requests" in out
    assert "train : 60/60 steps, 1 preemptions, 1 resumes, 2 grows" in out
