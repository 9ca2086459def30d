"""The hybrid family at model level and in the engine: the port against
the reference on reduced jamba-1.5-large-398b (period 4, attention at
offset 1, 8 layers: six Mamba-2 SSD layers and two GQA attention layers,
MoE on every 2nd layer; float32, bridged weights).  Counterparts of
test_models_smoke.py's forward, train-step and prefill/decode tests
(2e-4), the full and the KQ-SVD-compressed logits against the reference
(1e-5), one AdamW and one Adafactor step against the reference's, the
bridge's multi-layer scan steps, greedy engine tokens on dense slots, the
paged store refused as the reference refuses it, and the cache bytes of
the reference's tree."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dropless
from repro import optim as jax_optim
from repro.config import CompressionConfig as JaxCompression
from repro.config import ServeConfig as JaxServe
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator
from repro.models import blocks as jax_blocks
from repro.models import build_model as jax_model
from repro.models.layers import rms_norm as jax_rms_norm
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.train.steps import make_loss_fn as jax_loss_fn
from repro.optim.schedule import learning_rate as jax_learning_rate
from repro_torch import bridge, optim
from repro_torch.config import ServeConfig, TrainConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.models import build_model as torch_model
from repro_torch.models import model as model_mod
from repro_torch.serving import Request, ServingEngine
from repro_torch.train.steps import (make_loss_fn, make_train_step,
                                     value_and_grad)
from repro_torch.tree import leaves, stack_layers, unstack_layers
from test_torch_train import close_grads, close_params


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=2e-4, atol=2e-4)
FN_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
          checkpoint_every=0)


@functools.lru_cache(maxsize=None)
def pair():
    """Reference model, params (numpy) and projections, the port's
    twins."""
    jcfg, tcfg = jax_config(ARCH).reduced(), torch_config(ARCH).reduced()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jm = jax_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    acc = GramAccumulator(len(jm.attn_layers))
    rng = np.random.default_rng(5)
    calibrate = jax.jit(jm.calibrate)
    for _ in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        acc.update_from_captures([jax.tree.map(np.asarray, c)
                                  for c in calibrate(jp, toks)])
    mp = acc.solve(JaxCompression(method="kqsvd", epsilon=0.1),
                   jm.group_output_weights(jp))
    tm = torch_model(tcfg, "cpu")
    return (jm, jp, mp, jm.projections_pytree(mp, jnp.float32), tm,
            bridge.params_from_jax(jp), bridge.projections_from_jax(mp))


def _batch(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def test_layout_is_the_references():
    """Layer kinds (SSM, attention at offset 1 of each period of 4), FFN
    kinds (MoE on even layers), the reference's step grouping, one
    attention layer a step, and the projections' layer order."""
    jm, _, _, _, tm, tp, tmp = pair()
    cfg = tm.cfg
    assert cfg.layer_kinds() == ("ssm", "attn", "ssm", "ssm") * 2
    assert [cfg.ffn_kind(i) for i in range(8)] == ["moe", "dense"] * 4
    assert (tm.prefix, tm.steps) == (jm.prefix, jm.steps) \
        == ([], [[0, 1, 2, 3], [4, 5, 6, 7]])
    assert tm.attn_layers == jm.attn_layers == [1, 5]
    assert len(tm.projections_pytree(tmp)) == 2
    for i, layer in enumerate(tp["layers"]):
        assert ("attn" in layer) == (i % 4 == 1)
        assert ("router" in layer["ffn"]) == (i % 2 == 0)


def test_forward_shapes_and_no_nan():
    """Training logits (B, S, V), finite, equal to the reference's at
    1e-5, with the aux sums of the four MoE layers."""
    jm, jp, _, _, tm, tp, _ = pair()
    b = _batch(tm.cfg)
    tl, taux = tm.train_logits(tp, b)
    jl, jaux = jm.train_logits(jp, {"tokens": jnp.asarray(b["tokens"])})
    assert tl.shape == (2, 32, tm.cfg.vocab_size)
    assert torch.isfinite(tl).all()
    _close(tl, jl, FN_TOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6)
    assert float(taux["n_moe"]) == 4.0


@functools.lru_cache(maxsize=None)
def reference_grads():
    """The reference's loss and gradients on ``_batch`` (one compile for
    both optimizers' steps)."""
    jm, jp, _, _, tm, _, _ = pair()
    jtc = JaxTrainConfig(**TC)
    jb = {k: jnp.asarray(v) for k, v in _batch(tm.cfg).items()}
    (loss, _), g = jax.jit(jax.value_and_grad(
        jax_loss_fn(jm, jtc), has_aux=True))(jp, jb)
    return float(loss), g


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_one_train_step_matches_reference(optimizer):
    """One step with the MoE aux losses in the objective: the loss and
    every gradient leaf equal the reference's, then the params after the
    reference's update of those gradients at the step's learning rate
    (Adafactor's statistics per position of the hybrid period, stacked
    over the steps as the reference's scan stacks them)."""
    _, jp, _, _, tm, tp, _ = pair()
    kw = dict(TC, optimizer=optimizer)
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    b = _batch(tm.cfg)
    jloss, jg = reference_grads()
    met, tg = value_and_grad(make_loss_fn(tm, tc), tp, b)
    np.testing.assert_allclose(float(met["loss"]), jloss, rtol=LOSS_RTOL)
    close_grads(tg, jg)
    tp2, st2, tmet = make_train_step(tm, tc)(
        tp, optim.init_state(tp, tc, (tm.prefix, tm.steps)), b)
    lr = jax_learning_rate(jtc, jnp.int32(0))
    jp2, _, jmet = jax.jit(jax_optim.apply_updates, static_argnums=3)(
        jp, jg, jax_optim.init_state(jp, jtc), jtc, lr)
    np.testing.assert_allclose(float(tmet["loss"]), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    assert tmet["lr"] == float(lr)
    assert int(st2["step"]) == 1
    if optimizer == "adamw":
        close_params(tp2, jp2, tg, tmet["lr"], ARCH)
        return
    ref_p = dict(leaves(bridge.params_from_jax(jax.tree.map(np.asarray,
                                                            jp2))))
    for path, a in leaves(tp2):
        np.testing.assert_allclose(a.numpy(), ref_p[path].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=str(path))


def test_adafactor_state_matches_reference():
    """Adafactor's slots over the hybrid period: one stacked slot tree
    per position of the period (``opt_state_from_jax`` of the
    reference's ``steps/layers/j``), and one update from the same
    gradients equal to the reference's in params and statistics."""
    from repro.optim import adafactor as jax_adafactor
    from repro_torch.optim import adafactor
    _, jp, _, _, tm, tp, _ = pair()
    layout = (tm.prefix, tm.steps)
    kw = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=1.0,
              optimizer="adafactor")
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    rng = np.random.default_rng(7)
    jg = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype)
                      * 1e-2, jp)
    jst = jax_adafactor.init_state(jp, jtc)
    st = adafactor.init_state(tp, tc, layout)
    assert len(st["slots"]["layers"]) == 4
    mine = dict(leaves(st))
    ref = dict(leaves(bridge.opt_state_from_jax(
        jax.tree.map(np.asarray, jst))))
    assert set(mine) == set(ref)
    for path, a in mine.items():
        assert a.shape == ref[path].shape, path
    jp2, jst2, _ = jax.jit(jax_adafactor.apply_updates, static_argnums=3)(
        jp, jg, jst, jtc, jnp.float32(1e-2))
    tp2, st2, _ = adafactor.apply_updates(tp, bridge.params_from_jax(jg), st,
                                          tc, 1e-2, layout)
    ref_p = dict(leaves(bridge.params_from_jax(jax.tree.map(np.asarray,
                                                            jp2))))
    for path, a in leaves(tp2):
        np.testing.assert_allclose(a.numpy(), ref_p[path].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=str(path))
    ref_s = dict(leaves(bridge.opt_state_from_jax(
        jax.tree.map(np.asarray, jst2))))
    for path, a in leaves(st2):
        if a.dtype == torch.bfloat16:          # the first moment: one ulp
            np.testing.assert_allclose(
                a.float().numpy(), ref_s[path].float().numpy(), rtol=0,
                atol=2.0 ** -7 * float(ref_s[path].float().abs().max()),
                err_msg=str(path))
        else:
            np.testing.assert_allclose(a.numpy(), ref_s[path].numpy(),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=str(path))


def test_prefill_decode_consistency():
    """Prefill's last logits and each decode step's equal the training
    forward's at the same position (dropless; test_models_smoke.py:59,
    2e-4): the SSM layers' carried state and the attention cache agree
    with the full sequence."""
    _, _, _, _, tm, tp, _ = pair()
    tm = torch_model(dropless(tm.cfg), "cpu")
    B, S, extra = 2, 24, 4
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (B, S + extra)).astype(np.int32)
    full, _ = tm.train_logits(tp, {"tokens": toks})
    lg, cache = tm.prefill(tp, toks[:, :S], S + extra)
    _close(lg[:, 0], full[:, S - 1].detach().numpy())
    for t in range(extra):
        lg, cache = tm.decode_step(tp, cache, toks[:, S + t: S + t + 1],
                                   S + t)
        _close(lg[:, 0], full[:, S + t].detach().numpy())


@pytest.mark.parametrize("compressed", [False, True])
def test_prefill_and_decode_logits_match_reference(compressed):
    """Prefill and decode logits with the full and the KQ-SVD cache of
    the two attention layers (the SSM state beside it) equal the
    reference's at 1e-5."""
    jm, jp, _, jproj, tm, tp, tmp = pair()
    tproj = tm.projections_pytree(tmp)
    if not compressed:
        jproj = tproj = None
    B, S, extra = 2, 16, 4
    toks = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (B, S + extra)).astype(np.int32)
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)
    jl, jc = jprefill(jp, {"tokens": toks[:, :S]}, S + extra, jproj)
    tl, tc = tm.prefill(tp, toks[:, :S], S + extra, proj=tproj)
    _close(tl, jl, FN_TOL)
    names = {"kc", "vc"} if compressed else {"k", "v"}
    assert set(tc[1]) == names and set(tc[0]) == {"conv", "s"}
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        jl, jc = jdecode(jp, jc, tok, jnp.int32(S + t), jproj)
        tl, tc = tm.decode_step(tp, tc, tok, S + t, proj=tproj)
        _close(tl, jl, FN_TOL)


def test_bridge_multi_layer_steps():
    """``params_from_jax`` puts step ``i``, position ``j`` at layer
    ``4 i + j``; ``tree.stack_layers`` over the model's layout (two steps
    of a period of 4) gives the reference's ``steps/layers`` back, one
    stacked dict per position, and ``unstack_layers`` inverts it."""
    _, jp, _, _, tm, tp, _ = pair()
    steps = jp["steps"]["layers"]
    assert len(steps) == 4 and len(tp["layers"]) == 8
    for i in range(2):
        for j in range(4):
            for path, a in leaves(tp["layers"][4 * i + j]):
                ref = steps[j]
                for key in path:
                    ref = ref[key]
                np.testing.assert_array_equal(a.numpy(), ref[i])
    layout = (tm.prefix, tm.steps)
    assert layout == ([], [[0, 1, 2, 3], [4, 5, 6, 7]])
    st = stack_layers(tp, layout)
    assert "prefix" not in st and len(st["layers"]) == 4
    for j in range(4):
        for path, a in leaves(st["layers"][j]):
            ref = steps[j]
            for key in path:
                ref = ref[key]
            np.testing.assert_array_equal(a.numpy(), ref)
    back = unstack_layers(st, layout)
    for (p, a), (_, b) in zip(leaves(back), leaves(tp)):
        assert torch.equal(a, b), p


def test_init_cache_bytes_match_reference():
    """The decode cache holds SSM state (conv tail, f32 state) in the six
    SSM layers and K/V (or the compressed entries) in the two attention
    layers: the same bytes as the reference's cache tree, full and
    KQ-SVD, whatever the length."""
    jm, _, mp, _, tm, _, _ = pair()

    def nbytes_j(tree):
        return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))

    def nbytes_t(cache):
        return sum(t.numel() * t.element_size()
                   for layer in cache for t in layer.values())
    for T in (64, 256):
        for ranks in ((0, 0), (mp.rank_k, mp.rank_v)):
            assert nbytes_t(tm.init_cache(2, T, ranks)) == nbytes_j(
                jm.init_cache(2, T, ranks)), (T, ranks)


DENSE = dict(max_seq_len=48, max_batch=3, temperature=0.0, decode_chunk=4)


@pytest.mark.parametrize("compressed", [False, True])
def test_engine_dense_slots_match_reference(compressed):
    """Greedy tokens on dense slots equal the reference engine's: 5
    requests on 3 slots, so slots are freed and refilled (the SSM state
    and the attention cache of a new request overwrite the old one's)."""
    jm, jp, mp, _, tm, tp, tmp = pair()
    prompts = [np.random.default_rng(3 + i).integers(0, 256, L).astype(
        np.int32) for i, L in enumerate([9, 17, 4, 12, 25])]
    jeng = JaxEngine(jm.cfg, jp, JaxServe(**DENSE),
                     projections=mp if compressed else None)
    teng = ServingEngine(tm.cfg, tp, ServeConfig(**DENSE),
                         projections=tmp if compressed else None,
                         device="cpu")
    jr = [JaxRequest(rid=i, prompt=p, max_new_tokens=8)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=8)
          for i, p in enumerate(prompts)]
    jeng.generate(jr)
    teng.generate(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and not r.failed and len(r.out_tokens) == 8
               for r in tr)
    assert teng.capacity_gain() == jeng.capacity_gain()


def test_paged_store_refused():
    """A hybrid stack has SSM layers: the paged cache and the paged
    engine refuse it at construction, as the reference does."""
    jm, _, mp, _, tm, tp, tmp = pair()
    paged = dict(DENSE, paged=True, page_size=4, n_pages=24)
    with pytest.raises(NotImplementedError, match="plain attention"):
        tm.init_paged_cache(8, 4)
    with pytest.raises(NotImplementedError, match="plain attention"):
        ServingEngine(tm.cfg, tp, ServeConfig(**paged), projections=tmp,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="plain attention"):
        JaxEngine(jm.cfg, {}, JaxServe(**paged), projections=mp)


@pytest.mark.parametrize("compressed", [False, True])
def test_stack_cut_past_a_period_matches_reference_layers(monkeypatch,
                                                          compressed):
    """A hybrid stack cut one layer past a whole period (5 of the reduced
    8 layers: one period of four, then an SSM layer), the cut the card's
    full-width jamba serves.  The reference's ``step_layout`` asserts
    whole periods, so its LM cannot hold such a stack: its own
    ``blocks.apply_layer`` runs layer by layer in JAX on the first 5 of
    its 8 layers.  The port's ``LM.prefill`` and 4 greedy ``decode_step``
    calls (full or KQ-SVD cache on the attention layer) give every
    layer's hidden states within 2e-4, the logits within 2e-4 and the
    same greedy tokens."""
    jm, jp, _, jproj, tm, tp, tmp = pair()
    jcfg, period = jm.cfg, tm.cfg.hybrid.period
    n = period + 1
    cut = torch_model(dataclasses.replace(tm.cfg, n_layers=n), "cpu")
    assert (cut.prefix, cut.steps) == ([], [[0, 1, 2, 3], [4]])
    assert cut.attn_layers == [1]
    tparams = dict(tp, layers=tp["layers"][:n])
    tproj = cut.projections_pytree(tmp) if compressed else None
    # layer i of the reference is position i % period of step i // period
    jlayers = [jax.tree.map(lambda a, i=i: jnp.asarray(a[i // period]),
                            jp["steps"]["layers"][i % period])
               for i in range(n)]
    jlproj = (jax.tree.map(lambda a: a[0], jproj["steps"])
              if compressed else None)
    apply_layer = jax.jit(jax_blocks.apply_layer,
                          static_argnums=(2, 3, 4, 8))
    recorded = []

    def recording(*args, **kw):
        out = model_mod_apply(*args, **kw)
        recorded.append(out[0])
        return out
    model_mod_apply = model_mod.apply_layer
    monkeypatch.setattr(model_mod, "apply_layer", recording)

    def reference(x, mode, caches, pos=None):
        """The reference's layers in order: each layer's output, the last
        position's logits and the new caches."""
        outs, new = [], []
        for i in range(n):
            attn = jcfg.layer_kinds()[i] == "attn"
            x, c, _, _ = apply_layer(
                jlayers[i], x, jcfg, i, mode,
                caches[i] if caches else None, pos,
                jlproj if attn else None, T)
            outs.append(x)
            new.append(c)
        h = jax_rms_norm(x[:, -1:], jnp.asarray(jp["final_norm"]),
                         jcfg.rms_eps)
        return outs, jm._logits(jp, h), new

    def held(outs, logits, tl):
        assert len(recorded) == n
        for i, (t, j) in enumerate(zip(recorded, outs)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       err_msg=f"layer {i}", **TOL)
        _close(tl, logits)
        recorded.clear()

    B, S, steps = 2, 16, 4
    T = S + steps
    toks = np.random.default_rng(4).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    tl, tc = cut.prefill(tparams, toks, T, proj=tproj)
    outs, jl, jc = reference(jnp.asarray(jp["embed"])[toks], "prefill",
                             None)
    held(outs, jl, tl)
    for t in range(steps):
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))
        np.testing.assert_array_equal(
            torch.argmax(tl[:, -1], dim=-1).numpy(), tok)
        tl, tc = cut.decode_step(tparams, tc, tok[:, None], S + t,
                                 proj=tproj)
        outs, jl, jc = reference(
            jnp.asarray(jp["embed"])[tok[:, None]], "decode", jc,
            jnp.full((B,), S + t, jnp.int32))
        held(outs, jl, tl)
