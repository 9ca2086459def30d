"""The port's roofline arithmetic and FLOP count against the reference's.

``repro_torch.roofline.analysis`` carries the reference's config
arithmetic unchanged with the H100's constants: the six cases of
tests/test_roofline.py run on the port's copy, and ``useful_bytes_for``
and ``model_flops_for`` equal the reference's on every arch of
``list_archs()``, every applicable shape of ``SHAPES`` and every variant.

``repro_torch.roofline.flop_count`` is the counterpart of
``roofline/hlo_cost.py``: an op count of the port's own steps on reduced
dense configs, whose ``dot_flops`` (matrix products by
``torch.utils.flop_counter``'s formulas, and the kernels' booked work)
are held to ``model_flops_for``.  The hold is exact (rtol 1e-12) once
the terms the two count differently are taken off, each from the
config's shapes:

* ``model_flops_for`` counts every parameter at 2 FLOPs a token a pass,
  the token embedding and the RMSNorm gains too, which do no matrix
  product (the lookup is a gather); with tied embeddings the table is
  the LM head and counts once;
* it leaves out the attention scores and values: K6 books Q K^T and P V
  over the causal pairs, S (S + 1) / 2 a sequence (``flash_work``, on
  the CPU too, where its plain version runs unseen), and in training
  its plain backward six products more over the whole (S, S) square at
  these lengths (scores and values recomputed, dP, dQ, dK, dV);
* ``LM.prefill`` runs the LM head on the last position only, where
  ``model_flops_for`` counts it on every token.

A decode step's attention over its cache is in ``model_flops_for``
already; the plain decode scores all ``max_len`` positions, which is what
it counts at ``T = max_len``.  Training counts without remat here
(``remat_policy="none"``); with it, each layer's recomputed forward adds
on top.

tests/test_torch_hlo_cost.py holds the op count (bytes,
transcendentals, the collectives) to the reference's ``analyze`` and
``parse_collectives`` on tests/test_hlo_cost.py's functions."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.config import SHAPES as JAX_SHAPES
from repro.config import shape_applicable as jax_applicable
from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_archs
from repro.roofline import analysis as jax_roofline
from repro_torch.config import (SHAPES, CompressionConfig, ShapeSpec,
                                shape_applicable)
from repro_torch.configs import get_config, list_archs
from repro_torch.core.calibration import calibrate_model
from repro_torch.data import calibration_batches
from repro_torch.models import build_model
from repro_torch.tree import tree_map
from repro_torch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                  PEAK_FLOPS_F32, Roofline, count_flops,
                                  count_step_flops, model_flops_for,
                                  packed_pairs, summarize, useful_bytes_for)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VARIANTS = ("baseline", "kqsvd", "kqsvd_int8")
DENSE = ("tinyllama-1.1b", "smollm-360m", "paper-llama2-7b")


# -- tests/test_roofline.py on the port's copy --------------------------------

def test_packed_pairs_counts():
    assert packed_pairs(4096, 512) == 36          # 8 blocks -> 8*9/2
    assert packed_pairs(32768, 512) == 2080       # 64 blocks
    assert packed_pairs(512, 512) == 1
    assert packed_pairs(4096, 512, window=512) < 36


def test_model_flops_train_matches_6nd():
    cfg = get_config("deepseek-67b")
    sh = SHAPES["train_4k"]
    f = model_flops_for(cfg, sh, "baseline")
    assert abs(f - 6 * cfg.active_param_count() * sh.tokens) / f < 1e-6


def test_decode_flops_shrink_with_compression():
    cfg = get_config("deepseek-67b")
    sh = SHAPES["decode_32k"]
    assert model_flops_for(cfg, sh, "kqsvd") < model_flops_for(
        cfg, sh, "baseline")


def test_useful_bytes_orderings():
    cfg = get_config("deepseek-67b")
    sh = SHAPES["decode_32k"]
    full = useful_bytes_for(cfg, sh, "baseline")
    kq = useful_bytes_for(cfg, sh, "kqsvd")
    i8 = useful_bytes_for(cfg, sh, "kqsvd_int8")
    assert i8 < kq < full
    assert full > cfg.active_param_count() * 2


def test_swa_bounds_cache_bytes():
    cfg = get_config("h2o-danube-1.8b")             # window 4096
    long = useful_bytes_for(cfg, SHAPES["long_500k"], "baseline")
    short = useful_bytes_for(cfg, SHAPES["decode_32k"], "baseline")
    assert long < short


def test_roofline_terms_and_bottleneck():
    r = Roofline(arch="x", shape="train_4k", mesh="m", variant="baseline",
                 n_devices=256, hlo_flops=1e18, hlo_bytes=1e15,
                 collective_wire_bytes_per_dev=1e9, model_flops=5e17,
                 useful_bytes=5e14).finalize()
    assert r.t_compute > 0 and r.t_memory > 0 and r.t_collective > 0
    assert r.bottleneck in ("compute", "memory", "collective")
    assert 0 < r.useful_flops_frac <= 1
    assert 0 < r.roofline_frac_projected <= 1.0 + 1e-9
    # the H100's terms: 1e18 FLOPs over 256 cards at 989 TFLOP/s
    assert r.t_compute == pytest.approx(1e18 / (256 * 989e12))
    assert r.t_collective == pytest.approx(1e9 / 450e9)
    assert "comp=" in summarize(r) and "roof=" in summarize(r)


# -- the arithmetic equals the reference's ------------------------------------

def test_constants_are_the_h100_datasheets():
    assert (PEAK_FLOPS, PEAK_FLOPS_F32, HBM_BW, LINK_BW) == (
        989e12, 67e12, 3.35e12, 450e9)
    fields = [f.name for f in dataclasses.fields(Roofline)]
    assert fields == [f.name for f in
                      dataclasses.fields(jax_roofline.Roofline)]


def test_shapes_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_config_arithmetic_equals_reference(arch):
    """``useful_bytes_for`` and ``model_flops_for`` on every applicable
    shape and variant equal the reference's bit for bit, and so do
    ``shape_applicable``'s verdicts: on every arch of the reference's
    ``list_archs()`` and on paper-llama2-7b, which it leaves out of the
    assigned list."""
    assert set(jax_archs()) | {"paper-llama2-7b"} == set(list_archs())
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name, sh in SHAPES.items():
        ok, why = shape_applicable(cfg, sh)
        assert (ok, why) == jax_applicable(jcfg, JAX_SHAPES[name])
        if not ok:
            continue
        for v in VARIANTS:
            assert useful_bytes_for(cfg, sh, v) == \
                jax_roofline.useful_bytes_for(jcfg, JAX_SHAPES[name], v)
            assert model_flops_for(cfg, sh, v) == \
                jax_roofline.model_flops_for(jcfg, JAX_SHAPES[name], v)


# -- the FLOP count of the port's own steps -----------------------------------

def test_dot_flops_with_batch_dims():
    a, b = torch.zeros(4, 8, 16), torch.zeros(4, 16, 32)
    t = count_flops(lambda: torch.einsum("bij,bjk->bik", a, b))
    assert t.dot_flops == t.flops == 2 * 4 * 8 * 16 * 32


def _model(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), remat_policy="none")
    model = build_model(cfg, "cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, model, model.init(gen)


def _terms(cfg):
    """(parameters that do no matrix product, one layer stack's forward
    attention FLOPs a (batch, query, key) triple, the head's size)."""
    D, V = cfg.d_model, cfg.vocab_size
    no_product = (2 * cfg.n_layers + 1) * D \
        + (0 if cfg.tie_embeddings else V * D)
    attn = 2 * cfg.n_layers * cfg.n_heads * 2 * cfg.d_head
    return no_product, attn, V * D


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flop_count_held_to_model_flops(arch, kind):
    cfg, model, params = _model(arch)
    B, S, T = 2, 32, 64
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    no_product, attn, head = _terms(cfg)
    if kind == "decode":
        got = count_step_flops(model, params, kind, toks[:, :1], max_len=T)
        want = model_flops_for(cfg, ShapeSpec("d", T, B, "decode"),
                               "baseline") - 2 * no_product * B
    else:
        got = count_step_flops(model, params, kind, toks)
        sh = ShapeSpec("x", S, B, kind)
        want = model_flops_for(cfg, sh, "baseline")
        pairs = S * (S + 1) // 2                  # K6's causal pairs
        if kind == "train":
            want += (-6 * no_product * sh.tokens
                     + attn * B * (pairs + 3 * S * S))
        else:
            want += (-2 * no_product * sh.tokens + attn * B * pairs
                     - 2 * head * (sh.tokens - B))
        assert got.kernels["flash_attention"]["calls"] == cfg.n_layers
    assert got.dot_flops == pytest.approx(want, rel=1e-12), got.by_op
    assert got.flops == sum(got.by_op.values())


def test_flop_count_of_compressed_steps():
    """With KQ-SVD projections at rank 4 of 16, a decode step over a
    256-position cache counts fewer FLOPs than the full cache's: the
    scores and values run at the compressed ranks."""
    cfg, model, params = _model("tinyllama-1.1b")
    mp = calibrate_model(model, params,
                         calibration_batches(cfg.vocab_size, 4, 32, batch=2),
                         CompressionConfig(method="kqsvd", rank_k=4,
                                           rank_v=4))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 1)).astype(np.int32)
    full = count_step_flops(model, params, "decode", toks, max_len=256)
    comp = count_step_flops(model, params, "decode", toks, projections=mp,
                            max_len=256)
    assert 0 < comp.flops < full.flops
    assert comp.kernels["kq_decode_attention"]["calls"] == cfg.n_layers


def test_flop_count_refuses_a_card_model():
    """The count no longer refuses a model off the CPU: the kernels are
    counted by their booked work on any device and on fake tensors (a
    dry run's: shapes only, no arithmetic), so a prefill on fake tensors
    counts what the same prefill on real CPU tensors counts, FLOPs,
    bytes and kernels; an unknown step kind is still refused."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, model, params = _model("tinyllama-1.1b")
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    real = count_step_flops(model, params, "prefill", toks)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                        params)
        got = count_step_flops(model, fake, "prefill", toks)
    assert (got.flops, got.dot_flops, got.bytes, got.kernels) == \
        (real.flops, real.dot_flops, real.bytes, real.kernels)
    with pytest.raises(ValueError, match="unknown step kind"):
        count_step_flops(model, params, "serve", toks)
