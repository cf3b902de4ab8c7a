"""The training loop (port of ``repro/train/trainer.py``, one device).

``Trainer(run).train(n)`` draws batch ``step`` from the synthetic
``Dataset`` (pure in (seed, step)), moves it to the device, runs
``launch/steps.make_train_step`` and logs the reference's metrics every
``log_every`` steps into the ``train.metrics`` series of its
``obs.Telemetry`` (`metrics_log` is a view of it), inside a ``train.step``
span.  Params and optimizer state are updated in place.

It runs on the card unless ``device="cpu"`` is given, and raises without
one.  The DLRM family only, through the lookup route that
``run.parallel.emb_pipeline`` picks (fused by default, per table when
off): dense training is ROADMAP.md slice 4.  Not
ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): checkpoints (``ckpt_dir``, `save`, `restore`; queue 1, item 7),
and the fault drill and cooperative preemption of the cluster layer
(``fail_at``, ``preempt_at``, ``scheduler``; queue 1, item 8).
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


def _not_ported(what: str, items: str = "item 7") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, "
        f"{items})")


@dataclasses.dataclass
class TrainerState:
    """Everything training needs to continue: parameters, optimizer state,
    and the global step (which doubles as the data cursor)."""
    params: Any
    opt_state: Any
    step: int


class Trainer:
    """Training loop on one device.

    Args:
      run: full `RunConfig` (model, shape, parallelism, optimizer).
      device: where params, state and batches live (default: the card).
      accum_steps: optional gradient-accumulation microsteps.
      ckpt_dir: checkpoints, not ported (must be None).
      obs: the `Telemetry` that holds the metric log (a private one by
        default); obs_labels: the labels of its series and gauges.
    """

    def __init__(self, run: RunConfig, *, device="cuda",
                 accum_steps: Optional[int] = None,
                 ckpt_dir: Optional[str] = None,
                 obs: Optional[Telemetry] = None,
                 obs_labels: Optional[Dict[str, Any]] = None):
        if run.model.family != "dlrm":
            raise NotImplementedError(
                f"training the {run.model.family!r} family is ROADMAP.md "
                f"slice 4 (queue 1, items 7 and 8); the port trains the DLRM")
        if ckpt_dir is not None:
            raise _not_ported("checkpointing (ckpt_dir)")
        self.run = run
        self.device = api.resolve_device(device)
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

    def init_state(self) -> TrainerState:
        """Fresh params + optimizer state at step 0 (seeded by the run)."""
        params = api.init_params(self.run.model, seed=self.run.seed,
                                 device=self.device)
        return TrainerState(params, OPT.init(self.run.optimizer, params), 0)

    def save(self, state: TrainerState) -> None:
        raise _not_ported("checkpointing (Trainer.save)")

    def restore(self) -> Optional[TrainerState]:
        raise _not_ported("checkpoint restore (Trainer.restore)")

    # -- loop ------------------------------------------------------------------

    def _put_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self.dataset.batch(step).items()}

    def train(self, num_steps: int, *, state: Optional[TrainerState] = None,
              fail_at: Optional[int] = None,
              preempt_at: Optional[int] = None,
              scheduler=None, job_id: Optional[int] = None,
              log_every: int = 10,
              on_step: Optional[Callable[[int, float], None]] = None
              ) -> TrainerState:
        """Run the loop to ``num_steps`` (absolute step count) from
        ``state`` (default: a fresh init).  ``on_step`` is called after
        every step with ``(step, step_wall_s)``; the step is enqueued on
        the device, not waited for.  Every ``log_every`` steps and at the
        last, the step's metrics (``loss``, ``wire_bytes*``,
        ``grad_norm``, ``lr``) plus ``step`` and ``wall_s`` are appended
        to `metrics_log`.  Returns the final `TrainerState`."""
        if fail_at is not None or scheduler is not None or job_id is not None:
            raise _not_ported("the block-failure drill (fail_at, "
                              "scheduler)", "items 7 and 8")
        if preempt_at is not None:
            raise _not_ported("cooperative preemption (preempt_at)",
                              "items 7 and 8")
        state = state or self.init_state()
        t0 = time.monotonic()
        step = state.step
        while step < num_steps:
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
        return state
