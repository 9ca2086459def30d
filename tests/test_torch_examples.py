"""The port's twins of ``examples/quickstart.py``,
``examples/serve_compressed.py`` and ``examples/train_100m.py``
(``python -m repro_torch.examples.<name>``), each run on the CPU at
reduced size, printing the reference example's lines: the same lines in
the same order and format, and where a line does not depend on trained
or random weights (the model line, the cache bytes a token at the solved
ranks, the capacity gain, the parameter count) the reference's own
value.  Token ids and losses differ by design: the port cannot draw
JAX's initial weights."""
import dataclasses
import importlib.util
import os
import re

import pytest
import torch

from repro.config import ModelConfig as JaxModelConfig
from repro.configs import get_config as jax_config
from repro.core.compressed import cache_footprint as jax_footprint
from repro_torch.examples import quickstart, serve_compressed, train_100m


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = r"\[\d+(, \d+)*\]"


def reference_example(name):
    """The reference example's module, loaded from ``examples/`` (its
    top level must define functions only: ``train_100m``)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_reference_lines(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    cfg = jax_config("tinyllama-1.1b").reduced()
    assert out[0] == (f"model: {cfg.name}  layers={cfg.n_layers} "
                      f"d={cfg.d_model} heads={cfg.n_heads}/"
                      f"{cfg.n_kv_heads}")
    loss = re.fullmatch(r"trained 30 steps: loss (\S+) -> (\S+)", out[1])
    assert loss and float(loss.group(2)) < float(loss.group(1))
    ranks = re.fullmatch(r"KQ-SVD ranks per layer: k=\[(\d+), (\d+)\] "
                         r"v=\[(\d+), (\d+)\]", out[2])
    assert ranks, out[2]
    rk, rv = (max(int(ranks.group(i)), int(ranks.group(i + 1)))
              for i in (1, 3))
    fp = jax_footprint(cfg.n_kv_heads, cfg.d_head, rk, rv)
    assert out[3] == (f"cache bytes/token/layer: {fp.full_bytes} -> "
                      f"{fp.compressed_bytes} ({1/fp.ratio:.2f}x more "
                      f"sequences per HBM)")
    assert re.fullmatch(rf"full cache : {TOKENS}", out[4])
    assert re.fullmatch(rf"kqsvd cache: {TOKENS}", out[5])
    assert len(out) == 6


def test_serve_compressed_prints_the_reference_lines(capsys):
    serve_compressed.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    cfg = jax_config("tinyllama-1.1b").reduced()
    R = cfg.d_head // 2
    gain = 1 / jax_footprint(cfg.n_kv_heads, cfg.d_head, R, R).ratio
    assert re.fullmatch(rf"full    : {TOKENS}", out[0])
    assert len(out) == 4
    for method, line in zip(("ksvd", "eigen", "kqsvd"), out[1:]):
        m = re.fullmatch(rf"{method:8s}: {TOKENS}  agree (\d)/8  "
                         rf"capacity x(\S+)", line)
        assert m, line
        assert m.group(3) == f"{gain:.1f}"


def test_train_100m_prints_the_reference_lines():
    """The 100M config is the reference's field for field, with its
    parameter count; the run trains a narrower twin of it (2 layers,
    d 64) for 30 steps of 4 x 32 tokens, and its loss falls."""
    steps = 30
    ref = reference_example("train_100m").model_100m()
    assert isinstance(ref, JaxModelConfig)
    assert dataclasses.asdict(train_100m.model_100m()) == \
        dataclasses.asdict(ref)
    narrow = dataclasses.replace(
        train_100m.model_100m(), n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        attn_block_q=8, attn_block_k=8)
    lines = train_100m.run(steps=steps, seq_len=32, batch=4, device="cpu",
                           cfg=narrow)
    assert lines[0] == f"params: {narrow.param_count()/1e6:.0f}M"
    assert train_100m.model_100m().param_count() == ref.param_count()
    m = re.fullmatch(r"steps=(\d+) loss (\S+) -> (\S+) mean step (\d+)ms "
                     r"retries=(\d+)", lines[1])
    assert m and int(m.group(1)) == steps and m.group(5) == "0"
    assert float(m.group(3)) < float(m.group(2))
