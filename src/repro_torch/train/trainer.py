"""Fault-tolerant, preemptible trainer (port of ``repro/train/trainer.py``,
one device).

``Trainer(run).train(n)`` draws batch ``step`` from the synthetic
``Dataset`` (pure in (seed, step)), moves it to the device, runs
``launch/steps.make_train_step`` and logs the reference's metrics every
``log_every`` steps into the ``train.metrics`` series of its
``obs.Telemetry`` (`metrics_log` is a view of it), inside a ``train.step``
span.  Params and optimizer state are updated in place.  The dense family
trains f32 master weights (cast to bf16 at each use); the DLRM trains
through the lookup route ``run.parallel.emb_pipeline`` picks.

With ``ckpt_dir`` it checkpoints every ``ckpt_every`` steps and at the end
(``train/checkpoint.py``, the reference's format v2: a checkpoint of either
package restores into the other).  The data cursor is the step, so a
restore continues the same batches; the manifest records the data seed
and the slice's geometry.  Cooperative preemption (`request_preempt`,
``preempt_at``) checkpoints at the next step boundary and returns early;
the §2.3 fault drill (``fail_at`` with a ``scheduler`` and ``job_id``)
fails the job's first block, lets the scheduler swap a spare in and
restores the last checkpoint.

It runs on the card unless ``device="cpu"`` is given, and raises without
one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.data.synthetic import Dataset
from repro_torch.launch import steps as STEPS
from repro_torch.models import api
from repro_torch.obs import Telemetry
from repro_torch.optim import adam as OPT
from repro_torch.train import checkpoint as CKPT


@dataclasses.dataclass
class TrainerState:
    """Everything training needs to continue: parameters, optimizer state,
    and the global step (which doubles as the data cursor)."""
    params: Any
    opt_state: Any
    step: int


class Trainer:
    """Training loop on one device, with checkpoint/restore, the fault
    drill and cooperative preemption.

    Args:
      run: full `RunConfig` (model, shape, parallelism, optimizer).
      device: where params, state and batches live (default: the card).
      ckpt_dir: checkpoint root (no checkpoints when None).
      ckpt_every: periodic checkpoint interval in steps.
      accum_steps: optional gradient-accumulation microsteps.
      slice_dims: chip geometry of the slice this trainer runs on, recorded
        in checkpoint manifests (observational).
      obs: the `Telemetry` that holds the metric log (a private one by
        default); obs_labels: the labels of its series and gauges.
    """

    def __init__(self, run: RunConfig, *, device="cuda",
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 accum_steps: Optional[int] = None,
                 slice_dims: Optional[tuple] = None,
                 obs: Optional[Telemetry] = None,
                 obs_labels: Optional[Dict[str, Any]] = None):
        if run.model.family not in ("dense", "dlrm"):
            raise NotImplementedError(
                f"training the {run.model.family!r} family waits for "
                f"ROADMAP.md queue 1, item 11")
        self.run = run
        self.device = api.resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.slice_dims = slice_dims
        self.preempt_requested = False
        self.preempted = False
        self.dataset = Dataset(run.model, run.shape, seed=run.seed)
        # the metric log is a Series of the registry; `metrics_log` views it
        self.obs = obs if obs is not None else Telemetry()
        self._obs_labels = dict(obs_labels or {})
        self._series = self.obs.metrics.series("train.metrics",
                                               **self._obs_labels)
        self.train_step = STEPS.make_train_step(
            run.model, run.shape, run.parallel, run.optimizer,
            accum_steps=accum_steps)

    @property
    def metrics_log(self) -> List[Dict[str, float]]:
        """The logged metric dicts (the registry Series' samples, live)."""
        return self._series.samples

    # -- state ------------------------------------------------------------------

    def _param_dtype(self):
        # the dense family trains f32 master weights (the reference's
        # param_dtype); a DLRM's params are f32 anyway
        return torch.float32 if self.run.model.family == "dense" else None

    def init_state(self) -> TrainerState:
        """Fresh params + optimizer state at step 0 (seeded by the run)."""
        params = api.init_params(self.run.model, seed=self.run.seed,
                                 device=self.device,
                                 dtype=self._param_dtype())
        return TrainerState(params, OPT.init(self.run.optimizer, params), 0)

    def save(self, state: TrainerState) -> None:
        """Checkpoint ``state`` (params + optimizer + data cursor), with
        the data seed and the slice's geometry in the manifest."""
        if not self.ckpt_dir:
            return
        CKPT.save(self.ckpt_dir, state.step,
                  {"params": state.params, "opt": state.opt_state},
                  extra={"step": state.step, "data_seed": self.run.seed,
                         "slice_dims": (list(self.slice_dims)
                                        if self.slice_dims else None)})

    def request_preempt(self) -> None:
        """Cooperative preemption: ask the running loop to checkpoint and
        stop at the next step boundary (idempotent; before `train` too: the
        loop then checkpoints at once and returns).  Without ``ckpt_dir``
        nothing lands on disk: keep the returned `TrainerState`."""
        self.preempt_requested = True

    def restore(self) -> Optional[TrainerState]:
        """The latest checkpoint on this trainer's device, or None without
        one.  Raises if it was trained on another data seed."""
        if not self.ckpt_dir or CKPT.latest_step(self.ckpt_dir) is None:
            return None
        shapes = api.param_shapes(self.run.model, self._param_dtype())
        like = {"params": shapes, "opt": OPT.init(self.run.optimizer, shapes)}
        tree, step, extra = CKPT.restore(self.ckpt_dir, like,
                                         device=self.device)
        saved_seed = extra.get("data_seed")
        assert saved_seed is None or saved_seed == self.run.seed, (
            f"checkpoint was trained on data seed {saved_seed}, this run "
            f"uses {self.run.seed}: resuming would fork the data stream")
        return TrainerState(tree["params"], tree["opt"], step)

    # -- loop ------------------------------------------------------------------

    def _put_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self.dataset.batch(step).items()}

    def _preempt(self, state: TrainerState, step: int) -> TrainerState:
        """Persist everything and mark the run preempted."""
        self.save(state)
        self.preempt_requested = False
        self.preempted = True
        self._series.append({"step": step, "preempt": 1.0})
        self.obs.event("train.preempt", cat="train", track="train",
                       step=step, **self._obs_labels)
        return state

    def train(self, num_steps: int, *, state: Optional[TrainerState] = None,
              fail_at: Optional[int] = None,
              preempt_at: Optional[int] = None,
              scheduler=None, job_id: Optional[int] = None,
              log_every: int = 10,
              on_step: Optional[Callable[[int, float], None]] = None
              ) -> TrainerState:
        """Run the loop to ``num_steps`` (absolute step count).

        Args:
          state: state to continue from (default: the latest checkpoint,
            else a fresh init).
          fail_at: inject a block failure at this step (the §2.3 drill):
            the scheduler fails the job's first block and swaps a spare in,
            and training restores the last checkpoint.
          preempt_at: call `request_preempt` at this step.
          scheduler/job_id: the OCS scheduler wiring of the fault drill.
          log_every: metric logging period; the step's metrics (``loss``,
            ``wire_bytes*``, ``grad_norm``, ``lr``) plus ``step`` and
            ``wall_s`` go to `metrics_log` (and at the last step).
          on_step: called after every step with ``(step, step_wall_s)``;
            the step is enqueued on the device, not waited for.

        Returns the final `TrainerState`; after a preemption request the
        loop checkpointed, set `preempted` and returned early."""
        state = state or self.restore() or self.init_state()
        t0 = time.monotonic()
        step = state.step
        self.preempted = False
        while step < num_steps:
            if preempt_at is not None and step == preempt_at:
                preempt_at = None
                self.request_preempt()
            if self.preempt_requested:
                return self._preempt(state, step)
            if fail_at is not None and step == fail_at:
                if scheduler is not None and job_id is not None:
                    scheduler.fail_block(scheduler.jobs[job_id].blocks[0])
                fail_at = None
                restored = self.restore()
                if restored is not None:
                    state = restored
                    step = state.step
                    self._series.append({"step": step, "event": 1.0})
                    self.obs.event("train.restore", cat="train",
                                   track="train", step=step,
                                   **self._obs_labels)
                    continue
            t_step = time.perf_counter()
            with self.obs.span("train.step", cat="train", track="train",
                               step=step):
                batch = self._put_batch(step)
                params, opt, metrics = self.train_step(
                    state.params, state.opt_state, batch)
            state = TrainerState(params, opt, step + 1)
            step += 1
            if on_step is not None:
                on_step(step, time.perf_counter() - t_step)
            if step % log_every == 0 or step == num_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, wall_s=round(time.monotonic() - t0, 2))
                self._series.append(m)
                # the last step's payload bytes, as the reference's gauges
                for k in ("wire_bytes", "wire_bytes_full",
                          "wire_overhead_bytes"):
                    if k in m:
                        self.obs.metrics.gauge(
                            f"train.{k}", **self._obs_labels).set(m[k])
            if self.ckpt_dir and step % self.ckpt_every == 0:
                self.save(state)
        if self.preempt_requested:
            # a request with no step left to run: serve it here so the flag
            # never leaks into the next call
            return self._preempt(state, step)
        if self.ckpt_dir:
            self.save(state)
        return state
