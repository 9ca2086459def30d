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
  ``straggler_factor`` x EMA are counted;
* elastic: checkpoints store global arrays, so ``resume`` re-places them
  under whatever mesh the restarted job has.

Multi-device (``mesh``, a ``DeviceMesh`` with ("data", "model") or
("pod", "data", "model") dims, one process a rank; every family):
the reference leaves placement to GSPMD, and its sharded step places
params and optimizer state by ``params_shardings`` and the batch by
``batch_shardings``; the port has no GSPMD, so it places everything
explicitly by those rules (``fsdp=tc.fsdp``) and runs the loop under
``use_mesh``.  Every rank iterates the same global batches and keeps its
rows.  Every rank makes the same decision: a step failure or a SIGTERM
on one rank becomes a retry or a stop on all of them, agreed by an
all-reduce before and after each step (a disagreement would deadlock
the next collective).
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
from repro_torch.launch.specs import batch_shardings
from repro_torch.models.model import build_model
from repro_torch.sharding.partition import (params_shardings, place_tree,
                                            use_mesh)
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
    docstring says.  Runs on ``device`` (default: CUDA; under a mesh,
    this rank's device of the mesh's type)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 ckpt_dir: Optional[str] = None, mesh=None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 straggler_factor: float = 3.0,
                 device: DeviceLike = None):
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
        return self.state_from(self.model.init(gen))

    def state_from(self, params, opt=None, step: int = 0):
        """A state at ``step`` from full params (the same on every rank)
        and their optimizer state (fresh when None), placed on the mesh
        by ``shardings``."""
        if opt is None:
            opt = optim.init_state(params, self.tc,
                                   (self.model.prefix, self.model.steps))
        if self.mesh is not None:
            sh = self.shardings({"params": params, "opt": opt})
            params, opt = (place_tree(params, sh["params"]),
                           place_tree(opt, sh["opt"]))
        return {"params": params, "opt": opt, "step": step}

    def shardings(self, tree):
        """``NamedSharding``s of a ``{"params", "opt"}`` tree on the mesh:
        every leaf by ``params_shardings(..., fsdp=tc.fsdp)`` (an
        optimizer slot by its parameter's name, as in the reference), the
        host step counter None (it stays on the host)."""
        sh = params_shardings(tree, self.mesh, fsdp=self.tc.fsdp)
        sh["opt"]["step"] = None
        return sh

    def resume_or_init(self):
        """The newest readable checkpoint's state, placed on the mesh,
        else ``init_state()``."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            template = self.init_state()
            tree = {"params": template["params"], "opt": template["opt"]}
            tree, meta = self.ckpt.restore(
                tree, shardings=(self.shardings(tree)
                                 if self.mesh is not None else None))
            return {"params": tree["params"], "opt": tree["opt"],
                    "step": int(meta["extra"].get("train_step",
                                                  meta["step"]))}
        return self.init_state()

    def _agree(self, code: int) -> int:
        """The largest ``code`` of any rank (an all-reduce over the
        world); ``code`` itself on one device."""
        if self.mesh is None:
            return code
        t = torch.tensor([float(code)], device=self.model.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        return int(t.item())

    @staticmethod
    def _guarded(fn):
        """``(fn(), None)``, or ``(None, error)`` when ``fn`` raises a
        step failure (``RuntimeError``, ``FloatingPointError``,
        ``ValueError``; a fatal one too, for ``_settle``)."""
        try:
            return fn(), None
        except (RuntimeError, FloatingPointError, ValueError) as e:
            return None, e

    def _settle(self, err) -> bool:
        """Agree on this rank's ``err`` with the others: raise when any
        rank's failure is fatal (``is_fatal``: this rank's own error, or
        one naming another rank), else True when any rank failed."""
        worst = self._agree(0 if err is None else 2 if is_fatal(err) else 1)
        if worst == 2:
            if err is not None and is_fatal(err):
                raise err
            raise RuntimeError("a fatal failure on another rank")
        return worst == 1

    def _step(self, state, batch):
        """One train step: ``(params, opt, loss)``; a non-finite loss
        raises ``FloatingPointError``."""
        params, opt, metrics = self.train_step(state["params"], state["opt"],
                                               batch)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise FloatingPointError(f"loss={loss}")
        return params, opt, loss

    def place_batch(self, batch):
        """A host batch as tensors on the model's device; under a mesh,
        each rank's rows of it as DTensors (``batch_shardings``)."""
        if self.mesh is None:
            return batch
        batch = {k: torch.as_tensor(np.asarray(v)).to(self.model.device)
                 for k, v in batch.items()}
        return place_tree(batch, batch_shardings(batch, self.mesh))

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
        with use_mesh(self.mesh):
            while state["step"] < num_steps:
                if self._agree(int(self._stop)):  # a SIGTERM on any rank
                    self._stop = True
                    break
                batch = self.place_batch(next(data))
                t0 = time.perf_counter()
                # a hook failure on one rank stops every rank before the
                # step's collectives, a step failure before the next ones
                _, err = self._guarded(lambda: self.failure_hook and
                                       self.failure_hook(state["step"]))
                failed = self._settle(err)
                if not failed:
                    out, err = self._guarded(lambda: self._step(state,
                                                                batch))
                    failed = self._settle(err)
                if failed:
                    # node-failure path: restore last checkpoint, retry (a
                    # save still being written is that checkpoint: wait)
                    report.retries += 1
                    if self.ckpt:
                        self.ckpt.wait()
                    if self.ckpt and self.ckpt.latest_step() is not None:
                        state = self.resume_or_init()
                        continue
                    raise err or RuntimeError(
                        "a train step failed on another rank")
                params, opt, loss = out
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
