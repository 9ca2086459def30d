"""Training loop with fault tolerance, straggler detection and resume.

Torch counterpart of ``repro.train.trainer``:

* checkpoint every N steps + on SIGTERM (preemption);
* step retry: a transient step failure (``RuntimeError``,
  ``FloatingPointError`` -- a non-finite loss -- or ``ValueError``;
  injected in tests through ``failure_hook``) restores the last
  checkpoint and continues, the path a node failure takes after the job
  restarts on spare capacity.  A kernel that cannot be built, loaded or
  launched (``KernelError``), or a CUDA error, is not transient: it would
  fail every retry, so it propagates at once;
* straggler watchdog: per-step wall time EMA (the first step, which
  builds the kernels, stays out of it); steps slower than
  ``straggler_factor`` x EMA are counted.

One device: a ``mesh`` other than None raises (multi-device training
is ``ROADMAP.md`` queue 1, item 1, the training slice).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike
from repro_torch.kernels.build import KernelError
from repro_torch.models.model import build_model
from repro_torch.train.steps import make_train_step


@dataclass
class TrainerReport:
    """What ``Trainer.run`` did: steps reached, each executed step's loss
    and wall seconds (a retried stretch appears twice), retries and
    straggler steps."""

    steps_done: int = 0
    final_loss: float = float("nan")
    losses: List[float] = field(default_factory=list)
    retries: int = 0
    straggler_steps: int = 0
    step_times: List[float] = field(default_factory=list)


def is_fatal(err: BaseException) -> bool:
    """A failure no retry can cure: a kernel's own (``KernelError``), or a
    CUDA error, after which the context is unusable."""
    return (isinstance(err, KernelError) or "CUDA error" in str(err)
            or type(err).__name__ == "AcceleratorError")


class Trainer:
    """Train a model for ``num_steps`` optimizer steps from a batch
    iterator, checkpointing, retrying and resuming as the module
    docstring says.  Runs on ``device`` (default: CUDA)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 ckpt_dir: Optional[str] = None, mesh=None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 straggler_factor: float = 3.0,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "not yet ported: mesh (ROADMAP.md queue 1, item 1: "
                "the multi-device training slice); the port trains on "
                "one device")
        self.cfg = cfg
        self.tc = tc
        self.mesh = mesh
        self.model = build_model(cfg, device)
        self.train_step = make_train_step(self.model, tc)
        self.ckpt = (CheckpointManager(ckpt_dir, keep=tc.keep_checkpoints)
                     if ckpt_dir else None)
        self.failure_hook = failure_hook
        self.straggler_factor = straggler_factor
        self._stop = False

    # -- state --------------------------------------------------------------

    def init_state(self, gen: Optional[torch.Generator] = None):
        """Fresh params (from ``gen``, else a generator on the model's
        device seeded with ``tc.seed``) and optimizer state, at step 0."""
        if gen is None:
            gen = torch.Generator(device=self.model.device)
            gen.manual_seed(self.tc.seed)
        params = self.model.init(gen)
        layout = (self.model.prefix, self.model.steps)
        return {"params": params,
                "opt": optim.init_state(params, self.tc, layout), "step": 0}

    def resume_or_init(self):
        """The newest readable checkpoint's state, else ``init_state()``."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            template = self.init_state()
            tree, meta = self.ckpt.restore(
                {"params": template["params"], "opt": template["opt"]})
            return {"params": tree["params"], "opt": tree["opt"],
                    "step": int(meta["extra"].get("train_step",
                                                  meta["step"]))}
        return self.init_state()

    def _save(self, state) -> None:
        if self.ckpt:
            self.ckpt.save(state["step"],
                           {"params": state["params"], "opt": state["opt"]},
                           extra={"train_step": state["step"]})

    # -- loop ---------------------------------------------------------------

    def run(self, data: Iterator[Dict[str, np.ndarray]],
            num_steps: int, state: Optional[Dict] = None) -> TrainerReport:
        """Step until ``state["step"]`` reaches ``num_steps`` (or SIGTERM);
        the final state is ``self.state``."""
        report = TrainerReport()
        state = state or self.resume_or_init()
        old_handler = None
        try:
            old_handler = signal.signal(
                signal.SIGTERM, lambda *_: setattr(self, "_stop", True))
        except ValueError:
            pass                                  # non-main thread (tests)
        ema: Optional[float] = None
        while state["step"] < num_steps and not self._stop:
            batch = next(data)
            t0 = time.perf_counter()
            try:
                if self.failure_hook:
                    self.failure_hook(state["step"])
                params, opt, metrics = self.train_step(
                    state["params"], state["opt"], batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"loss={loss}")
            except (RuntimeError, FloatingPointError, ValueError) as e:
                if is_fatal(e):
                    raise
                # node-failure path: restore last checkpoint, retry (a save
                # still being written is that checkpoint: wait for it)
                report.retries += 1
                if self.ckpt:
                    self.ckpt.wait()
                if self.ckpt and self.ckpt.latest_step() is not None:
                    state = self.resume_or_init()
                    continue
                raise
            dt = time.perf_counter() - t0
            report.step_times.append(dt)
            if ema is not None and dt > self.straggler_factor * ema:
                report.straggler_steps += 1
            # the first step builds the kernels -- keep it out of the
            # EMA so it doesn't mask genuine stragglers
            if len(report.step_times) >= 2:
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            state = {"params": params, "opt": opt,
                     "step": state["step"] + 1}
            report.losses.append(loss)
            report.steps_done = state["step"]
            report.final_loss = loss
            if (self.tc.checkpoint_every
                    and state["step"] % self.tc.checkpoint_every == 0):
                self._save(state)
        if self._stop:                            # preemption: final save
            self._save(state)
        if self.ckpt:
            self.ckpt.wait()
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
        self.state = state
        return report
