"""The MoE and MLA families at model level: the port's LM against the
reference's on bridged weights (reduced deepseek-v2-lite-16b and
arctic-480b, float32).  Counterparts of test_models_smoke.py's
forward / train-step / prefill-decode tests (logits within 2e-4, the
loss, the aux losses and every gradient leaf against the reference),
prefill and decode logits with the full and the KQ-SVD-compressed cache
(2e-4), test_compression_e2e.py::test_full_rank_compression_is_exact for
deepseek-v2-lite, and the bridge's prefix layers."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dropless
from repro.config import CompressionConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator
from repro.models import build_model as jax_model
from repro.train.steps import make_loss_fn as jax_loss_fn
from repro_torch import bridge, optim
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.models import build_model as torch_model
from repro_torch.train.steps import (make_loss_fn, make_train_step,
                                     value_and_grad)
from repro_torch.tree import leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = 1e-4        # of each gradient leaf's max-abs
LOSS_RTOL = 1e-5
ARCHS = ["deepseek-v2-lite-16b", "arctic-480b"]
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
          checkpoint_every=0)


@functools.lru_cache(maxsize=None)
def pair(arch, drop_free=False):
    """Reference model, params (numpy) and projections, the port's twins,
    on the reduced config (``drop_free``: dropless)."""
    jcfg, tcfg = jax_config(arch).reduced(), torch_config(arch).reduced()
    if drop_free:
        jcfg, tcfg = dropless(jcfg), dropless(tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jm = jax_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    acc = GramAccumulator(len(jm.attn_layers))
    rng = np.random.default_rng(5)
    for _ in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        acc.update_from_captures([jax.tree.map(np.asarray, c)
                                  for c in jm.calibrate(jp, toks)])
    mp = acc.solve(CompressionConfig(method="kqsvd", epsilon=0.1),
                   jm.group_output_weights(jp))
    tm = torch_model(tcfg, "cpu")
    return (jm, jp, jm.projections_pytree(mp, jnp.float32), tm,
            bridge.params_from_jax(jp),
            tm.projections_pytree(bridge.projections_from_jax(mp)), acc)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _batch(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_no_nan(arch):
    """Training logits (B, S, V), finite, equal to the reference's, and the
    aux sums of its MoE layers (``n_moe`` 2: deepseek-v2-lite's first
    layer is dense)."""
    jm, jp, _, tm, tp, _, _ = pair(arch)
    b = _batch(tm.cfg)
    tl, taux = tm.train_logits(tp, b)
    jl, jaux = jm.train_logits(jp, {"tokens": jnp.asarray(b["tokens"])})
    assert tl.shape == (2, 32, tm.cfg.vocab_size)
    assert torch.isfinite(tl).all()
    _close(tl, jl)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6)
    assert float(taux["n_moe"]) == 2.0


def _close_grads(tg, jg):
    for (path, a), (_, b) in zip(leaves(tg), leaves(
            bridge.params_from_jax(jax.tree.map(np.asarray, jg)))):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= GRAD_TOL * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    """One AdamW step with the MoE aux losses in the objective: the loss,
    the router losses' metrics (``moe_lb``, ``moe_rz``, ``moe_dropped``)
    and every gradient leaf equal the reference's; finite, and the params
    moved (test_models_smoke.py::test_one_train_step)."""
    jm, jp, _, tm, tp, _, _ = pair(arch)
    tc, jtc = TrainConfig(**TC), JaxTrainConfig(**TC)
    b = _batch(tm.cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jmet), jg = jax.jit(jax.value_and_grad(
        jax_loss_fn(jm, jtc), has_aux=True))(jp, jb)
    met, tg = value_and_grad(make_loss_fn(tm, tc), tp, b)
    np.testing.assert_allclose(float(met["loss"]), float(jloss),
                               rtol=LOSS_RTOL)
    for k in ("moe_lb", "moe_rz", "moe_dropped"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-6)
    _close_grads(tg, jg)
    assert float(tg["layers"][1]["ffn"]["router"].abs().max()) > 0
    tp2, st2, tmet = make_train_step(tm, tc)(tp, optim.init_state(tp, tc), b)
    assert np.isfinite(float(tmet["loss"]))
    assert np.isfinite(float(tmet["grad_norm"]))
    assert int(st2["step"]) == 1
    delta = sum(float((a.float() - c.float()).abs().max())
                for (_, a), (_, c) in zip(leaves(tp), leaves(tp2)))
    assert delta > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Dropless: prefill then decode give the training logits at each
    position (test_models_smoke.py::test_prefill_decode_consistency),
    and equal the reference's prefill and decode logits."""
    jm, jp, _, tm, tp, _, _ = pair(arch, drop_free=True)
    B, S, extra = 2, 24, 4
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (B, S + extra)).astype(np.int32)
    full, _ = tm.train_logits(tp, {"tokens": toks})
    lg, cache = tm.prefill(tp, toks[:, :S], S + extra)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, S + extra)
    _close(lg[:, 0], full[:, S - 1].detach())
    _close(lg, jl)
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        lg, cache = tm.decode_step(tp, cache, tok, S + t)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(S + t))
        _close(lg[:, 0], full[:, S + t].detach())
        _close(lg, jl)


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    """The reference's prefill and masked decode step, jitted once per
    arch (its eager ops would compile one by one for every shape)."""
    jm = pair(arch)[0]
    prefill = jax.jit(lambda p, b, T, proj: jm.prefill(p, b, T, proj=proj),
                      static_argnums=2)
    decode = jax.jit(lambda p, c, tok, pos, proj, mask: jm.decode_step(
        p, c, tok, pos, proj=proj, token_mask=mask))
    return prefill, decode


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match(arch, compressed, masked):
    """Prefill and four decode steps, the full and the KQ-SVD cache, the
    configs' own (dropping) capacity, per-sequence positions over slots
    prefilled one by one; ``masked``: the decode's live-slot mask leaves
    a finished slot out of MoE routing, as the engines pass it."""
    from test_attention import merge_slot_caches
    jm, jp, jproj, tm, tp, tproj, _ = pair(arch)
    if not compressed:
        jproj = tproj = None
    lens, extra = (6, 13, 9), 4
    B, T = len(lens), max(lens) + extra + 2
    toks = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (B, max(lens) + extra)).astype(np.int32)
    jprefill, jdecode = _jitted(arch)
    jcs, tcs = [], []
    for b, L in enumerate(lens):
        jl, jc = jprefill(jp, {"tokens": toks[b: b + 1, :L]}, T, jproj)
        tl, tc = tm.prefill(tp, toks[b: b + 1, :L], T, proj=tproj)
        _close(tl, jl)
        jcs.append(jc)
        tcs.append(tc)
    jc = merge_slot_caches(jcs)
    tc = [{k: torch.cat([c[i][k] for c in tcs]) for k in tcs[0][i]}
          for i in range(len(tcs[0]))]
    pos = np.asarray(lens, np.int32)
    live = np.array([True, not masked, True])
    for t in range(extra):
        feed = np.stack([toks[b, lens[b] + t] for b in range(B)])[:, None]
        jl, jc = jdecode(jp, jc, feed, jnp.asarray(pos + t), jproj,
                         jnp.asarray(live))
        tl, tc = tm.decode_step(tp, tc, feed, pos + t, proj=tproj,
                                token_mask=torch.as_tensor(live))
        _close(tl[live], np.asarray(jl)[live])


def test_full_rank_compression_is_exact():
    """deepseek-v2-lite: KQ-SVD at the latent's full rank (kv_lora 32)
    gives the uncompressed logits in prefill and decode
    (test_compression_e2e.py::test_full_rank_compression_is_exact)."""
    _, _, _, tm, tp, _, acc = pair("deepseek-v2-lite-16b", drop_free=True)
    from repro_torch.core.calibration import GramAccumulator as TAcc
    from repro_torch.core.calibration import LayerGrams
    tacc = TAcc(len(acc.layers))
    tacc.layers = [LayerGrams(st.g_k.copy(), st.g_q.copy(), st.g_v.copy(),
                              st.tokens) for st in acc.layers]
    from repro_torch.config import CompressionConfig as TCompression
    mp = tacc.solve(TCompression(method="kqsvd", rank_k=32, rank_v=32),
                    tm.group_output_weights(tp))
    proj = tm.projections_pytree(mp)
    B, S, extra = 2, 16, 4
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (B, S + extra)).astype(np.int32)
    lr, cr = tm.prefill(tp, toks[:, :S], S + extra)
    lc, cc = tm.prefill(tp, toks[:, :S], S + extra, proj=proj)
    _close(lc, lr.numpy())
    assert set(cc[1]) == {"cc", "ccv", "kr"} and set(cr[1]) == {"c", "kr"}
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        lr, cr = tm.decode_step(tp, cr, tok, S + t)
        lc, cc = tm.decode_step(tp, cc, tok, S + t, proj=proj)
        _close(lc, lr.numpy())


def test_bridge_prefix_layers():
    """``params_from_jax`` puts the reference's unrolled prefix (the dense
    first layer, ``first_dense_ff`` wide) first in ``layers``, then the
    unstacked MoE steps; the stacked layout (``tree.stack_layers``) gives
    the reference's ``prefix`` / ``steps`` split back."""
    from repro_torch.tree import stack_layers, unstack_layers
    jm, jp, _, tm, tp, _, _ = pair("deepseek-v2-lite-16b")
    layout = (tm.prefix, tm.steps)
    assert layout == ([0], [[1], [2]])
    cfg = tm.cfg
    assert len(tp["layers"]) == cfg.n_layers == 3
    assert set(tp["layers"][0]["ffn"]) == {"wi", "wg", "wo"}
    assert tp["layers"][0]["ffn"]["wi"].shape == (cfg.d_model,
                                                  cfg.moe.first_dense_ff)
    np.testing.assert_array_equal(tp["layers"][0]["ffn"]["wi"].numpy(),
                                  jp["prefix"][0]["ffn"]["wi"])
    for i in (1, 2):
        assert "router" in tp["layers"][i]["ffn"]
        np.testing.assert_array_equal(
            tp["layers"][i]["ffn"]["wi_e"].numpy(),
            jp["steps"]["layers"][0]["ffn"]["wi_e"][i - 1])
    st = stack_layers(tp, layout)
    assert len(st["prefix"]) == 1 and len(st["layers"]) == 1
    assert st["layers"][0]["ffn"]["wi_e"].shape[0] == 2
    back = unstack_layers(st, layout)
    for (p, a), (_, b) in zip(leaves(back), leaves(tp)):
        assert torch.equal(a, b), p
    # arctic: no prefix, every layer a step
    _, _, _, am, ap, _, _ = pair("arctic-480b")
    assert "prefix" not in stack_layers(ap, (am.prefix, am.steps))


def test_adafactor_with_prefix_matches_reference():
    """Adafactor over deepseek-v2-lite's layout: the prefix layer's slots
    beside the stacked steps' (``opt_state_from_jax``), and one update
    from the same gradients equal to the reference's."""
    from repro.optim import adafactor as jax_adafactor
    from repro_torch.optim import adafactor
    jm, jp, _, tm, tp, _, _ = pair("deepseek-v2-lite-16b")
    kw = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip=1.0,
              optimizer="adafactor")
    tc, jtc = TrainConfig(**kw), JaxTrainConfig(**kw)
    rng = np.random.default_rng(7)
    jg = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype)
                      * 1e-2, jp)
    jst = jax_adafactor.init_state(jp, jtc)
    layout = (tm.prefix, tm.steps)
    st = adafactor.init_state(tp, tc, layout)
    mine = dict(leaves(st))
    ref = dict(leaves(bridge.opt_state_from_jax(
        jax.tree.map(np.asarray, jst))))
    assert set(mine) == set(ref)
    assert any(p[:2] == ("slots", "prefix") for p in mine)
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
