"""The port's training step against the reference's on bridged weights
(reduced configs, float32): loss and gradients for tinyllama, danube
(sliding window) and mamba2 (K7's forward), the params after a step,
gradient accumulation, remat, the K6 and K7 autograd wrappers against
autograd through their plain versions, and five Trainer steps against
the JAX Trainer from the same state and batches."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_model
from repro.train import Trainer as JaxTrainer
from repro.train.steps import make_loss_fn as jax_loss_fn
from repro.train.steps import make_train_step as jax_train_step
from repro_torch import bridge, optim
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, batches
from repro_torch.kernels.flash import (flash_attention_backward,
                                       flash_attention_ref,
                                       flash_attention_train)
from repro_torch.kernels.ssd import (ssd_chunk_scan_backward,
                                     ssd_chunk_scan_plain,
                                     ssd_chunk_scan_ref,
                                     ssd_chunk_scan_train)
from repro_torch.models import build_model
from repro_torch.train import Trainer
from repro_torch.train.steps import (value_and_grad, make_loss_fn,
                                     make_train_step)
from repro_torch.tree import leaves

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # of each gradient leaf's max-abs
# params after a step: Adam's first update is g / (|g| + 1e-8), about
# lr * sign(g), so an element whose gradient is near zero may move either
# way in the two packages; those with |g| below SMALL_G of their leaf's
# max are left out (and counted).  Just above that cut (|g| a few 1e-8)
# a float32 gradient difference of a few 1e-9 still moves the update by
# a few percent: those elements are held within 5% of the step's lr,
# and the ones with |g| of at least EPS_FREE of the max, where the 1e-8
# no longer matters, within PARAM_TOL
SMALL_G = 1e-6
EPS_FREE = 1e-4
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
NEAR_EPS_TOL = 0.05
ARCHS = ["tinyllama-1.1b", "h2o-danube-1.8b", "mamba2-2.7b"]
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
          checkpoint_every=0)


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


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(reference model, its params as numpy, port model, port params)."""
    jcfg = jax_config(arch).reduced()
    jm = jax_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(get_config(arch).reduced(), "cpu")
    return jm, jp, tm, bridge.params_from_jax(jp)


def batch(cfg, B=4, S=32, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}


def close_grads(tg, jg):
    for (path, a), (_, b) in zip(leaves(tg), leaves(
            bridge.params_from_jax(jax.tree.map(np.asarray, jg)))):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= GRAD_TOL * scale, (path, err, scale)


def close_params(tp, jp, grads, lr, label):
    """Params after a step, leaving out the elements whose gradient is
    below SMALL_G of its leaf's max; returns how many were left out."""
    ref = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    left_out = 0
    for (path, a), (_, b), (_, g) in zip(leaves(tp), leaves(ref),
                                         leaves(grads)):
        keep = g.abs() >= SMALL_G * g.abs().max()
        far = g.abs() >= EPS_FREE * g.abs().max()
        left_out += int((~keep).sum())
        np.testing.assert_allclose(a[keep].numpy(), b[keep].numpy(),
                                   rtol=PARAM_TOL["rtol"],
                                   atol=NEAR_EPS_TOL * lr,
                                   err_msg=f"{label} {path}")
        np.testing.assert_allclose(a[far].numpy(), b[far].numpy(),
                                   err_msg=f"{label} {path}", **PARAM_TOL)
    print(f"{label}: {left_out} elements with |g| < {SMALL_G} x max left "
          f"out of the params comparison")
    return left_out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """Loss and every gradient leaf on the same batch, then the params
    and the loss metric after one AdamW step."""
    jm, jp, tm, tp = pair(arch)
    tc, jtc = TrainConfig(**TC), JaxTrainConfig(**TC)
    b = batch(tm.cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jst = jax_optim.init_state(jp, jtc)
    jloss_fn = jax_loss_fn(jm, jtc)

    @jax.jit
    def ref(p, s, bb):
        (loss, _), g = jax.value_and_grad(jloss_fn, has_aux=True)(p, bb)
        return loss, g, jax_train_step(jm, jtc)(p, s, bb)

    jloss, jg, (jp2, _, jmet) = ref(jp, jst, jb)
    metrics, tg = value_and_grad(make_loss_fn(tm, tc), tp, b)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=LOSS_RTOL)
    close_grads(tg, jg)
    tp2, st2, tmet = make_train_step(tm, tc)(tp, optim.init_state(tp, tc), b)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    assert tmet["lr"] == float(jmet["lr"])
    assert int(st2["step"]) == 1
    close_params(tp2, jp2, tg, tmet["lr"], arch)


def test_grad_accum_matches_reference():
    """grad_accum=2: two microbatches, float32 accumulation, divided and
    cast, against the reference's lax.scan."""
    jm, jp, tm, tp = pair("tinyllama-1.1b")
    kw = dict(TC, grad_accum=2)
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    b = batch(tm.cfg)
    jp2, _, jmet = jax.jit(jax_train_step(jm, jtc))(
        jp, jax_optim.init_state(jp, jtc),
        {k: jnp.asarray(v) for k, v in b.items()})
    tp2, _, tmet = make_train_step(tm, tc)(tp, optim.init_state(tp, tc), b)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    # the mean of the two microbatches' gradients is the batch's
    _, g = value_and_grad(make_loss_fn(tm, tc), tp, b)
    close_params(tp2, jp2, g, tmet["lr"], "grad_accum=2")


@pytest.mark.parametrize("policy", ["nothing", "dots", "full"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-2.7b"])
def test_remat_changes_no_number(arch, policy):
    """Gradients with each remat policy equal those without remat, bit
    for bit (the recomputed forward is the same arithmetic)."""
    _, _, _, tp = pair(arch)
    cfg = get_config(arch).reduced()
    b = batch(cfg, B=2, S=32)
    tc = TrainConfig(**TC)
    grads = {}
    for pol in ("none", policy):
        m = build_model(dataclasses.replace(cfg, remat_policy=pol), "cpu")
        met, grads[pol] = value_and_grad(make_loss_fn(m, tc), tp, b)
        grads[pol + " loss"] = float(met["loss"])
    assert grads["none loss"] == grads[policy + " loss"]
    for (path, a), (_, c) in zip(leaves(grads["none"]),
                                 leaves(grads[policy])):
        assert torch.equal(a, c), path


def _grads(fn, inputs, seed):
    """Gradients of a fixed random projection of ``fn``'s outputs."""
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g)).sum()
               for o in outs)
    return torch.autograd.grad(loss, ins)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 7)])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_flash_autograd_matches_plain(m, causal, window):
    """K6's autograd wrapper (the plain forward on the CPU, the blocked
    backward) against autograd through the plain version: S 37 over
    blocks of 16 queries, windows narrower than a block."""
    g = torch.Generator().manual_seed(m * 10 + window)
    B, Hkv, S, dh, dv = 2, 2, 37, 16, 8
    q = torch.randn((B, Hkv * m, S, dh), generator=g)
    k = torch.randn((B, Hkv, S, dh), generator=g)
    v = torch.randn((B, Hkv, S, dv), generator=g)
    opts = dict(causal=causal, window=window)
    before = flash_attention_backward.launches
    got = _grads(lambda *t: flash_attention_train(*t, **opts), (q, k, v), 1)
    assert flash_attention_backward.launches == before + 1
    want = _grads(lambda *t: flash_attention_ref(*t, **opts), (q, k, v), 1)
    for a, b_, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    dout = torch.randn((B, Hkv * m, S, dv), generator=g)
    for one, *blocked in zip(*(flash_attention_backward(
            q, k, v, dout, block_q=bq, **opts)
            for bq in (S, 16, 1))):              # blocks change no sum
        for b_ in blocked:
            np.testing.assert_allclose(b_.numpy(), one.numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_autograd_matches_plain(chunk, with_h0):
    """K7's autograd wrapper against autograd through its plain chunked
    version (float32) and through the float64 recurrence: S 20 (ragged
    chunks of 8, one chunk of 32), two groups of two heads."""
    g = torch.Generator().manual_seed(chunk + with_h0)
    Bsz, nh, G, S, hd, n = 2, 4, 2, 20, 8, 16
    x = torch.randn((Bsz, nh, S, hd), generator=g)
    dt = torch.rand((Bsz, nh, S), generator=g) * 0.5 + 0.01
    a = -dt * torch.rand((nh,), generator=g)[None, :, None] * 4
    Bm = torch.randn((Bsz, G, S, n), generator=g)
    Cm = torch.randn((Bsz, G, S, n), generator=g)
    ins = [x, a, dt, Bm, Cm]
    if with_h0:
        ins.append(torch.randn((Bsz, nh, n, hd), generator=g))

    def run(fn, **kw):
        def f(*t):
            return fn(*t[:5], h0=t[5] if with_h0 else None, **kw)
        return f
    before = ssd_chunk_scan_backward.launches
    got = _grads(run(ssd_chunk_scan_train, chunk=chunk), ins, 2)
    assert ssd_chunk_scan_backward.launches == before + 1
    plain = _grads(run(ssd_chunk_scan_plain, chunk=chunk), ins, 2)
    exact = _grads(run(ssd_chunk_scan_ref), [t.double() for t in ins], 2)
    for a_, p_, e_ in zip(got, plain, exact):
        np.testing.assert_allclose(a_.numpy(), p_.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(a_.numpy(), e_.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_trainer_matches_jax_trainer():
    """Five steps of the port's Trainer against the JAX Trainer from the
    same bridged params and optimizer state, on the same batches: the
    loss of every step."""
    arch = "tinyllama-1.1b"
    jm, jp, tm, tp = pair(arch)
    kw = dict(TC, warmup_steps=2)
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    jst = jax_optim.init_state(jp, jtc)
    # the port's state first: the JAX trainer donates its inputs
    state = {"params": tp, "step": 0, "opt": bridge.opt_state_from_jax(
        jax.tree.map(np.asarray, jst))}
    dc = DataConfig(vocab_size=tm.cfg.vocab_size, seq_len=32, batch_size=4)
    jr = JaxTrainer(jax_config(arch).reduced(), jtc).run(
        batches(dc), 5, state={"params": jax.tree.map(jnp.asarray, jp),
                               "opt": jst, "step": 0})
    rep = Trainer(get_config(arch).reduced(), tc, device="cpu").run(
        batches(dc), 5, state=state)
    assert rep.steps_done == jr.steps_done == 5
    np.testing.assert_allclose(rep.losses, jr.losses, rtol=1e-4)
    assert rep.losses[-1] < rep.losses[0]
