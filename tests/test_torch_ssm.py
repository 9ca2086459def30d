"""The SSM family in the port against the reference, on bridged weights:
the counterparts of tests/test_ssm.py's three tests, ``ssm_forward`` and
``ssm_decode`` against the reference's on ``init_ssm`` params, the causal
conv at 1, 2 and 3 tokens, reduced mamba2-2.7b's prefill and decode
logits against the reference's ``train_logits``, prefill and decode
(tests/test_models_smoke.py's 2e-4), the dense-slot engine's greedy
tokens against the reference engine's, the refusal of the paged store,
and the CLI.  Float32; inputs come from numpy with fixed seeds; K7 runs
as its plain version on these CPU tensors."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SSMConfig as JaxSSM
from repro.config import ServeConfig as JaxServe
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_model
from repro.models import ssm as jax_ssm
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import bridge
from repro_torch.config import SSMConfig, ServeConfig
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve as cli
from repro_torch.models import build_model as torch_model
from repro_torch.models import ssm
from repro_torch.serving import Request, ServingEngine
from test_ssm import naive_ssd


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "mamba2-2.7b"
TOL = dict(rtol=2e-4, atol=2e-4)       # test_models_smoke.py's bar
STEP_TOL = dict(rtol=5e-4, atol=5e-4)  # test_ssm.py's bar


@functools.lru_cache(maxsize=None)
def models(d_ff: int = 128):
    """Reduced mamba2 (2 layers, d_model 64, 8 heads of 16, d_state 16,
    chunk 32): the reference model and params, the port's twins.
    ``cfg.reduced()`` gives each layer a SwiGLU of 128; ``d_ff=0`` keeps
    the full config's layer, the SSM alone."""
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), d_ff=d_ff)
    tcfg = dataclasses.replace(torch_config(ARCH).reduced(), d_ff=d_ff)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jm = jax_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, torch_model(tcfg, "cpu"), bridge.params_from_jax(
        jax.tree.map(np.asarray, jp))


def _np(t):
    return t.detach().float().numpy()


def _ssm_params(cfg_kw, D, seed=0):
    """Reference ``init_ssm`` params and the port's bridged copy."""
    jp = jax_ssm.init_ssm(jax.random.PRNGKey(seed), D, JaxSSM(**cfg_kw),
                          jnp.float32)
    return jp, {k: bridge.to_tensor(np.asarray(v)) for k, v in jp.items()}


def test_config_matches_reference():
    full = torch_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_config(ARCH))
    assert full.param_count() == jax_config(ARCH).param_count()
    assert abs(full.param_count() / 2.7e9 - 1) < 0.1
    assert full.attention_free and set(full.layer_kinds()) == {"ssm"}


# -- the counterparts of tests/test_ssm.py ------------------------------------


def test_chunked_ssd_matches_naive():
    rng = np.random.default_rng(0)
    B, S, nh, hd, G, n = 2, 64, 4, 8, 2, 16
    xh = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, S, nh)), 0).astype(np.float32)
    A = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, G, n)).astype(np.float32)
    Cm = rng.normal(size=(B, S, G, n)).astype(np.float32)
    y_ref, h_ref = naive_ssd(xh, dt, A, Bm, Cm)
    for chunk in (8, 16, 64):
        y, h = ssm._ssd_chunked(*(torch.as_tensor(v) for v in
                                  (xh, dt, A, Bm, Cm)), chunk)
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(h.numpy(), h_ref, rtol=1e-4, atol=1e-4)


def test_decode_matches_forward():
    cfg = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=8,
                    chunk_size=16)
    D, B, S = 32, 2, 24
    p = ssm.init_ssm(torch.Generator().manual_seed(0), D, cfg,
                     torch.float32, "cpu")
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(B, S, D))
                        .astype(np.float32) * 0.5)
    y_full, _ = ssm.ssm_forward(p, x, cfg)
    state = ssm.make_ssm_state(cfg, D, B, torch.float32)
    ys = []
    for t in range(S):
        y_t, state = ssm.ssm_decode(p, x[:, t: t + 1], state, cfg)
        ys.append(y_t)
    np.testing.assert_allclose(_np(torch.cat(ys, dim=1)), _np(y_full),
                               **STEP_TOL)


def test_prefill_state_continues():
    """ssm_forward(return_state) + decode == full forward."""
    cfg = SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=8,
                    chunk_size=8)
    D, B, S, extra = 16, 1, 16, 4
    p = ssm.init_ssm(torch.Generator().manual_seed(0), D, cfg,
                     torch.float32, "cpu")
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(B, S + extra, D)).astype(np.float32) * 0.5)
    y_full, _ = ssm.ssm_forward(p, x, cfg)
    y_pre, state = ssm.ssm_forward(p, x[:, :S], cfg, return_state=True)
    np.testing.assert_allclose(_np(y_pre), _np(y_full[:, :S]), **STEP_TOL)
    for t in range(extra):
        y_t, state = ssm.ssm_decode(p, x[:, S + t: S + t + 1], state, cfg)
        np.testing.assert_allclose(_np(y_t), _np(y_full[:, S + t: S + t + 1]),
                                   **STEP_TOL)


# -- the port's layers against the reference's -------------------------------

SSM_KW = dict(d_state=16, d_conv=4, expand=2, head_dim=8, n_groups=2,
              chunk_size=16)


def test_init_ssm_shapes_and_law():
    """The port's init draws the reference's shapes and types; the
    deterministic leaves (decay, dt bias, skip, norm) are equal."""
    D = 32
    jp, _ = _ssm_params(SSM_KW, D)
    tp = ssm.init_ssm(torch.Generator().manual_seed(0), D,
                      SSMConfig(**SSM_KW), torch.bfloat16, "cpu")
    jb = jax_ssm.init_ssm(jax.random.PRNGKey(0), D, JaxSSM(**SSM_KW),
                          jnp.bfloat16)
    for k, v in jb.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).split(".")[1] == str(v.dtype), k
    for k in ("a_log", "dt_bias", "d_skip", "norm"):
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k], np.float32),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("S", [1, 2, 3])
def test_conv_apply_short_prompts(S, with_state):
    """The causal conv at 1, 2 and 3 tokens: out and the carried tail
    (with a 1-token prompt, mostly the initial state's zeros) equal the
    reference's."""
    rng = np.random.default_rng(S)
    B, Cd, K = 2, 12, 4
    w = rng.normal(size=(Cd, K)).astype(np.float32)
    x = rng.normal(size=(B, S, Cd)).astype(np.float32)
    st = rng.normal(size=(B, Cd, K - 1)).astype(np.float32) \
        if with_state else None
    out, tail = ssm._conv_apply(torch.as_tensor(w), torch.as_tensor(x),
                                None if st is None else torch.as_tensor(st))
    jout, jtail = jax_ssm._conv_apply(jnp.asarray(w), jnp.asarray(x),
                                      None if st is None else jnp.asarray(st))
    assert tuple(tail.shape) == (B, Cd, K - 1)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(_np(tail), np.asarray(jtail))


@pytest.mark.parametrize("S", [1, 24, 40])
def test_ssm_forward_and_decode_match_reference(S):
    """Bridged ``init_ssm`` params: ``ssm_forward`` with its returned
    state, then 4 ``ssm_decode`` steps, equal the reference's outputs and
    states; the decode updates the port's state in place."""
    D, B = 32, 2
    jp, tp = _ssm_params(SSM_KW, D, seed=S)
    jcfg, tcfg = JaxSSM(**SSM_KW), SSMConfig(**SSM_KW)
    x = np.random.default_rng(S).normal(size=(B, S + 4, D)).astype(
        np.float32) * 0.5
    jy, js = jax_ssm.ssm_forward(jp, jnp.asarray(x[:, :S]), jcfg,
                                 return_state=True)
    ty, ts = ssm.ssm_forward(tp, torch.as_tensor(x[:, :S]), tcfg,
                             return_state=True)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    for k in ("conv", "s"):
        np.testing.assert_allclose(_np(ts[k]), np.asarray(js[k]), **TOL)
    for t in range(S, S + 4):
        s_before = ts["s"]
        jy, js = jax_ssm.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), js, jcfg)
        ty, ts = ssm.ssm_decode(tp, torch.as_tensor(x[:, t:t + 1]), ts, tcfg)
        assert ts["s"] is s_before
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        for k in ("conv", "s"):
            np.testing.assert_allclose(_np(ts[k]), np.asarray(js[k]), **TOL)


def test_ssm_forward_continues_a_carried_state():
    """``ssm_forward`` given a state (conv tail and h0) equals the
    reference's: the second half of a sequence after the first."""
    D, B, S = 32, 1, 32
    jp, tp = _ssm_params(SSM_KW, D, seed=3)
    jcfg, tcfg = JaxSSM(**SSM_KW), SSMConfig(**SSM_KW)
    x = np.random.default_rng(3).normal(size=(B, 2 * S, D)).astype(
        np.float32) * 0.5
    _, js = jax_ssm.ssm_forward(jp, jnp.asarray(x[:, :S]), jcfg,
                                return_state=True)
    _, ts = ssm.ssm_forward(tp, torch.as_tensor(x[:, :S]), tcfg,
                            return_state=True)
    jy, js = jax_ssm.ssm_forward(jp, jnp.asarray(x[:, S:]), jcfg, state=js,
                                 return_state=True)
    ty, ts = ssm.ssm_forward(tp, torch.as_tensor(x[:, S:]), tcfg, state=ts,
                             return_state=True)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(ts["s"]), np.asarray(js["s"]), **TOL)


# -- the model and the engine -------------------------------------------------


def test_bridge_keeps_ssm_leaves_and_types():
    """A bf16 mamba2 layer: ``ln1`` and ``ssm`` with its seven leaves, no
    ``ln2``/``ffn``, no ``lm_head`` (tied); a_log, dt_bias and d_skip stay
    float32."""
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), dtype="bfloat16",
                               d_ff=0)
    jp = jax_model(jcfg).init(jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp))
    assert "lm_head" not in tp and len(tp["layers"]) == jcfg.n_layers
    layer = tp["layers"][0]
    assert set(layer) == {"ln1", "ssm"}
    assert set(layer["ssm"]) == {"in_proj", "conv", "a_log", "dt_bias",
                                 "d_skip", "norm", "out_proj"}
    for k, t in layer["ssm"].items():
        want = (torch.float32 if k in ("a_log", "dt_bias", "d_skip")
                else torch.bfloat16)
        assert t.dtype == want, k


@pytest.mark.parametrize("S,d_ff", [(1, 128), (24, 128), (33, 128),
                                    (64, 128), (24, 0), (33, 0)])
def test_prefill_decode_consistency(S, d_ff):
    """Mirror of test_models_smoke.py::test_prefill_decode_consistency
    [mamba2-2.7b] on bridged weights, with the reduced config's SwiGLU and
    without (the full config's layer): the port's prefill and 4 decode
    steps give the reference's ``train_logits`` at each position and its
    own prefill and decode logits and states, within 2e-4."""
    jm, jp, tm, tp = models(d_ff)
    assert ("ffn" in tp["layers"][0]) == (d_ff > 0)
    B, extra = 2, 4
    toks = np.random.default_rng(S).integers(
        0, jm.cfg.vocab_size, (B, S + extra)).astype(np.int32)
    full, _ = jm.train_logits(jp, {"tokens": toks})
    jl, jc = jm.prefill(jp, {"tokens": toks[:, :S]}, S + extra)
    tl, tc = tm.prefill(tp, toks[:, :S], S + extra)
    assert set(tc[0]) == {"conv", "s"} and len(tc) == jm.cfg.n_layers
    np.testing.assert_allclose(_np(tl[:, 0]), np.asarray(full[:, S - 1]),
                               **TOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    for t in range(extra):
        tok = toks[:, S + t: S + t + 1]
        jl, jc = jm.decode_step(jp, jc, tok, jnp.int32(S + t))
        tl, tc = tm.decode_step(tp, tc, tok, S + t)
        np.testing.assert_allclose(_np(tl[:, 0]), np.asarray(full[:, S + t]),
                                   **TOL)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    ref_state = jc["steps"]["layers"][0]
    for i, layer in enumerate(tc):
        for k, t in layer.items():
            np.testing.assert_allclose(_np(t), np.asarray(ref_state[k][i]),
                                       **TOL)


def test_prefill_takes_lengths_the_reference_rejects():
    """A 70-token prompt is fine for both (2 x 35); 65 and 97 the
    reference's lax path cannot cut at chunk 32; the port's prefill there
    equals its own prefill of the first tokens continued by decode
    steps, which never chunk."""
    _, _, tm, tp = models()
    toks = np.random.default_rng(0).integers(0, 256, (1, 97)).astype(
        np.int32)
    for S in (65, 97):
        tl, _ = tm.prefill(tp, toks[:, :S], S)
        lg, cache = tm.prefill(tp, toks[:, :60], S)
        for t in range(60, S):
            lg, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_np(tl), _np(lg), **TOL)


def test_model_has_no_attention_layers():
    """Calibration, output weights and projections iterate attention
    layers only, so mamba2 gives empty lists."""
    _, _, tm, tp = models()
    assert tm.attn_layers == []
    assert tm.calibrate(tp, np.zeros((1, 8), np.int32)) == []
    assert tm.group_output_weights(tp) == []


def _serve(engine_cls, request_cls, eng_args, prompts, max_new):
    eng = engine_cls(*eng_args)
    rs = [request_cls(rid=i, prompt=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    eng.generate(rs)
    return eng, rs


def test_engine_matches_reference():
    """The dense-slot engine: 6 requests of 5..64 prompt tokens (lengths
    the reference takes) and 6 new tokens on 3 slots, so slots are
    reused, give the reference engine's greedy tokens."""
    jm, jp, tm, tp = models()
    kw = dict(max_seq_len=80, max_batch=3, temperature=0.0, decode_chunk=4)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jm.cfg.vocab_size, L).astype(np.int32)
               for L in (5, 17, 33, 40, 64, 9)]
    _, jr = _serve(JaxEngine, JaxRequest, (jm.cfg, jp, JaxServe(**kw)),
                   prompts, 6)
    teng, tr = _serve(lambda *a: ServingEngine(*a, device="cpu"), Request,
                      (tm.cfg, tp, ServeConfig(**kw)), prompts, 6)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and len(r.out_tokens) == 6 for r in tr)
    assert tuple(teng._cache[0]["s"].shape) == (3, 8, 16, 16)


def test_reused_slot_state_is_rebuilt():
    """One slot serves a 40-token prompt, then a 9-token one: its state
    after the second prefill (no decode: one new token) is the fresh
    prefill's, and the second request's tokens with decode equal a fresh
    engine's."""
    _, _, tm, tp = models()
    rng = np.random.default_rng(4)
    long_p, short_p = (rng.integers(0, 256, L).astype(np.int32)
                       for L in (40, 9))
    sc = ServeConfig(max_seq_len=64, max_batch=1, decode_chunk=4)
    eng, _ = _serve(lambda *a: ServingEngine(*a, device="cpu"), Request,
                    (tm.cfg, tp, sc), [long_p, short_p], 1)
    _, fresh = tm.prefill(tp, short_p[None], 64)
    for layer, want in zip(eng._cache, fresh):
        for k in ("conv", "s"):
            np.testing.assert_array_equal(_np(layer[k]), _np(want[k]))
    _, both = _serve(lambda *a: ServingEngine(*a, device="cpu"), Request,
                     (tm.cfg, tp, sc), [long_p, short_p], 6)
    _, alone = _serve(lambda *a: ServingEngine(*a, device="cpu"), Request,
                      (tm.cfg, tp, sc), [short_p], 6)
    assert both[1].out_tokens == alone[0].out_tokens


@pytest.mark.parametrize("what", ["init_paged_cache", "paged",
                                  "paged-chunked"])
def test_paged_store_raises_like_the_reference(what):
    jm, jp, tm, tp = models()
    if what == "init_paged_cache":
        with pytest.raises(NotImplementedError, match="attention"):
            jm.init_paged_cache(8, 4)
        with pytest.raises(NotImplementedError, match="attention"):
            tm.init_paged_cache(8, 4)
        return
    kw = dict(paged=True, page_size=4, max_seq_len=64)
    if what == "paged-chunked":
        kw.update(chunked_prefill=True, prefill_chunk=8)
    with pytest.raises(NotImplementedError, match="attention"):
        JaxEngine(jm.cfg, jp, JaxServe(**kw))
    with pytest.raises(NotImplementedError, match="attention"):
        ServingEngine(tm.cfg, tp, ServeConfig(**kw), device="cpu")


def test_cli_serves_mamba2_without_calibrating(capsys, monkeypatch):
    """``--method kqsvd`` on an attention-free arch: no calibration (as
    the reference CLI), every request served."""
    def no_calibration(*a, **kw):
        raise AssertionError("calibrated an attention-free model")
    monkeypatch.setattr(cli, "calibrate_model", no_calibration)
    cli.main(["--arch", ARCH, "--reduced", "--method", "kqsvd",
              "--requests", "4", "--prompt-len", "40",
              "--max-new-tokens", "5", "--decode-chunk", "4",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 4 and "calibrated" not in out
    assert "failed" not in out and "truncated" not in out


@pytest.mark.parametrize("S", [1, 2, 40])
def test_model_hands_k7_views_it_takes(S, monkeypatch):
    """What ``ssm_forward`` hands K7 on the card is what its wrapper
    checks there: x, B and C with their last dim contiguous (slices of
    the conv output, read in place), a and dt float32; the conv tail
    comes back contiguous."""
    seen, kernel = [], ssm.ssd_chunk_scan

    def checked(x, a, dt, B, C, **kw):
        assert all(t.stride(-1) == 1 for t in (x, B, C))
        assert a.dtype == dt.dtype == torch.float32
        assert kw["out_dtype"] == torch.float32
        seen.append(x.shape)
        return kernel(x, a, dt, B, C, **kw)

    monkeypatch.setattr(ssm, "ssd_chunk_scan", checked)
    D = 32
    _, tp = _ssm_params(SSM_KW, D)
    x = torch.as_tensor(np.random.default_rng(S).normal(size=(2, S, D))
                        .astype(np.float32))
    _, st = ssm.ssm_forward(tp, x, SSMConfig(**SSM_KW), return_state=True)
    assert seen == [(2, 8, S, 8)] and st["conv"].is_contiguous()
