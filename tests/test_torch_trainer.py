"""The port's Trainer: every case of tests/test_trainer.py (convergence,
retry from a checkpoint, resume, stragglers), the preemption save, the
one-device rule, and a kernel failure that propagates at once instead of
being retried from the checkpoint forever."""
import time

import numpy as np
import pytest
import torch

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batches
from repro_torch.kernels.build import KernelError
from repro_torch.models import attention as attention_mod
from repro_torch.train import Trainer


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these tiny models: with the test runner's
    workers sharing the cores, torch's thread pools would oversubscribe
    them and stretch a few-ms step to seconds (the straggler watchdog
    reads step times)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small():
    return get_config("smollm-360m").reduced()


def data(cfg, bs=4):
    return batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                              batch_size=bs))


def trainer(tc, **kw):
    return Trainer(small(), tc, device="cpu", **kw)


def test_loss_decreases():
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=25,
                     checkpoint_every=0)
    rep = trainer(tc).run(data(small()), 25)
    assert rep.steps_done == 25
    assert rep.losses[-1] < rep.losses[0]


def test_failure_injection_retries_from_checkpoint(tmp_path):
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=20,
                     checkpoint_every=2, keep_checkpoints=2)
    crashes = {"n": 0}

    def failure_hook(step):
        if step == 5 and crashes["n"] == 0:
            crashes["n"] += 1
            raise RuntimeError("injected node failure")

    tr = trainer(tc, ckpt_dir=str(tmp_path), failure_hook=failure_hook)
    rep = tr.run(data(small()), 8)
    assert crashes["n"] == 1
    assert rep.retries == 1
    assert rep.steps_done == 8
    assert np.isfinite(rep.final_loss)


def test_resume_from_checkpoint_continues_step(tmp_path):
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=20,
                     checkpoint_every=2)
    trainer(tc, ckpt_dir=str(tmp_path)).run(data(small()), 4)
    tr2 = trainer(tc, ckpt_dir=str(tmp_path))
    state = tr2.resume_or_init()
    assert state["step"] == 4
    assert int(state["opt"]["step"]) == 4
    rep = tr2.run(data(small()), 6, state=state)
    assert rep.steps_done == 6


def test_straggler_detection():
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=20,
                     checkpoint_every=0)
    slow = {8}

    def failure_hook(step):          # reuse hook as a delay injector
        if step in slow:
            time.sleep(1.0)

    tr = trainer(tc, failure_hook=failure_hook, straggler_factor=3.0)
    rep = tr.run(data(small()), 12)
    assert rep.straggler_steps >= 1


def test_preemption_saves_final_state(tmp_path):
    """The SIGTERM handler's flag stops the loop after the running step
    and saves that step, whatever ``checkpoint_every`` says."""
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=20,
                     checkpoint_every=0)
    tr = trainer(tc, ckpt_dir=str(tmp_path))

    def failure_hook(step):
        if step == 2:
            tr._stop = True          # what the SIGTERM handler sets

    tr.failure_hook = failure_hook
    rep = tr.run(data(small()), 10)
    assert rep.steps_done == 3
    assert tr.ckpt.list_steps() == [3]
    assert trainer(tc, ckpt_dir=str(tmp_path)).resume_or_init()["step"] == 3


def test_kernel_failure_is_not_retried(tmp_path, monkeypatch):
    """With a checkpoint to go back to, a transient failure is retried;
    a kernel's failure (``KernelError``: build, load or launch) would fail
    every retry, so it propagates on its first occurrence."""
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=20,
                     checkpoint_every=1)
    trainer(tc, ckpt_dir=str(tmp_path)).run(data(small()), 2)
    calls = {"n": 0}

    def broken(*args, **kw):
        calls["n"] += 1
        raise KernelError("kernel build failed: libflash: nvcc exited 1")

    monkeypatch.setattr(attention_mod, "flash_attention_train", broken)
    tr = trainer(tc, ckpt_dir=str(tmp_path))
    with pytest.raises(KernelError):
        tr.run(data(small()), 5)
    assert calls["n"] == 1


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-2.7b"])
def test_mesh_refuses_other_families(arch):
    """Training on a mesh covers every family now: a MoE (and MLA) or an
    SSM config under one is refused no more; the trainer keeps the mesh
    (``test_torch_mesh`` trains them on one)."""
    tc = TrainConfig(checkpoint_every=0)
    mesh = object()
    assert Trainer(get_config(arch).reduced(), tc, device="cpu",
                   mesh=mesh).mesh is mesh
