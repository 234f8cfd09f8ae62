"""Fault-tolerant training loop, the counterpart of ``repro/train/trainer.py``.

* **checkpoint/restart**: atomic ``CheckpointManager`` saves every
  ``ckpt_every`` steps (asynchronous by default); on construction the
  trainer resumes from the newest complete checkpoint, so that a killed
  process relaunched with the same command goes on where it stopped.
* **straggler count**: each step's wall time is kept; a step slower than
  ``straggler_factor`` times the running median (after five steps) is
  counted and logged.
* **data determinism across restarts**: ``data_fn(step)`` is called with the
  step's index, so that a resumed run sees the same batches.

A step's time ends in ``torch.cuda.synchronize()`` when its loss lies on
the card (the reference's ``block_until_ready``).  The state saved is
``{"params": params, "opt": opt_state}``; a ``Transformer`` restores in
place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager


@dataclasses.dataclass
class TrainerReport:
    steps: int = 0
    last_loss: float = float("nan")
    losses: list = dataclasses.field(default_factory=list)
    step_times: list = dataclasses.field(default_factory=list)
    stragglers: int = 0
    resumed_from: Optional[int] = None

    def median_step_time(self) -> float:
        return float(np.median(self.step_times)) if self.step_times else float("nan")


def _ready(loss) -> float:
    if isinstance(loss, torch.Tensor):
        if loss.device.type == "cuda":
            torch.cuda.synchronize(loss.device)
        return float(loss)
    return float(loss)


class Trainer:
    def __init__(
        self,
        step_fn: Callable,                 # (params, opt, inputs, labels) -> (params, opt, loss)
        params,
        opt_state,
        data_fn: Callable[[int], tuple],   # step index -> (inputs, labels)
        *,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50,
        ckpt_async: bool = True,
        keep: int = 3,
        straggler_factor: float = 3.0,
        log_every: int = 10,
        log_fn: Callable[[str], None] = print,
    ):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data_fn = data_fn
        self.ckpt_every = ckpt_every
        self.ckpt_async = ckpt_async
        self.straggler_factor = straggler_factor
        self.log_every = log_every
        self.log = log_fn
        self.report = TrainerReport()
        self.start_step = 0
        self.mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
        if self.mgr is not None and self.mgr.latest_step() is not None:
            step, state = self.mgr.restore({"params": self.params, "opt": self.opt_state})
            self.params, self.opt_state = state["params"], state["opt"]
            self.start_step = step
            self.report.resumed_from = step
            self.log(f"[trainer] resumed from checkpoint step {step}")

    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def run(self, num_steps: int) -> TrainerReport:
        end = self.start_step + num_steps
        for step in range(self.start_step, end):
            inputs, labels = self.data_fn(step)
            t0 = time.perf_counter()
            self.params, self.opt_state, loss = self.step_fn(self.params, self.opt_state, inputs, labels)
            loss = _ready(loss)
            dt = time.perf_counter() - t0
            self.report.step_times.append(dt)
            self.report.steps = step + 1
            self.report.last_loss = loss
            self.report.losses.append(loss)
            med = self.report.median_step_time()
            if len(self.report.step_times) > 5 and dt > self.straggler_factor * med:
                self.report.stragglers += 1
                self.log(f"[trainer] straggler at step {step}: {dt*1e3:.1f} ms vs median {med*1e3:.1f} ms")
            if self.log_every and (step + 1) % self.log_every == 0:
                self.log(f"[trainer] step {step+1}/{end} loss={loss:.4f} ({dt*1e3:.1f} ms/step)")
            if self.mgr is not None and (step + 1) % self.ckpt_every == 0:
                self.mgr.save(step + 1, self._state(), blocking=not self.ckpt_async)
        if self.mgr is not None:
            self.mgr.save(end, self._state())
            self.mgr.wait()
        return self.report
