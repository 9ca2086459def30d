"""The port's twin of ``examples/long_context_decode.py``
(``python -m repro_torch.examples.long_context_decode``): the cache bytes
it prints for mamba2, jamba and danube at reduced size, full and KQ-SVD
at T 256 and 1024, equal those of the reference's cache trees, and its
run on the CPU prints the reference example's lines."""
import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_model
from repro_torch.examples import long_context_decode as example


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_lines(arch):
    """The reference example's cache lines for ``arch``."""
    cfg = jax_config(arch).reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    model = jax_model(cfg)

    def nbytes(tree):
        return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))
    lines = []
    for T in (256, 1024):
        full = nbytes(model.init_cache(1, T))
        line = f"{arch:24s} T={T:5d}: cache {full:9d} B"
        if not cfg.attention_free:
            r = max(1, cfg.d_head // 2)
            line += f"  kqsvd {nbytes(model.init_cache(1, T, (r, r))):9d} B"
        lines.append(line)
    return lines


@pytest.mark.parametrize("arch", example.ARCHS)
def test_cache_bytes_match_reference_trees(arch):
    sizes = example.cache_sizes(arch)
    lines = []
    for T, (full, kq) in sizes.items():
        line = f"{arch:24s} T={T:5d}: cache {full:9d} B"
        if kq:
            line += f"  kqsvd {kq:9d} B"
        lines.append(line)
    ref = reference_lines(arch)
    print("\n".join(ref))
    assert lines == ref


def test_example_prints_the_reference_lines(capsys):
    """The CLI on the CPU: every arch's cache lines as the reference
    example prints them, then a finite decode step each."""
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    want = []
    for arch in example.ARCHS:
        want += reference_lines(arch)
        want.append(f"{arch:24s} decode step OK, logits (1, 1, 256)")
    assert out == want
