"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the reduced model on the card against the CPU.  Marked
``cuda``; skips where there is no GPU.  Imports no JAX, so it also runs
on a machine without it (``--noconftest``: the repository's conftest
imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import CompressionConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.core.calibration import calibrate_model
from repro_torch.data import calibration_batches
from repro_torch.device import tree_to
from repro_torch.kernels.kq_decode import (kq_decode_attention,
                                           kq_decode_attention_ref)
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,T,Rk,Rv,lengths", [
    (2, 8, 2, 128, 32, 16, (101, 7)),
    (3, 4, 2, 100, 16, 16, (100, 37, 1)),
    (8, 32, 4, 1024, 37, 45, (1, 31, 32, 33, 500, 777, 1023, 1024)),
    (2, 32, 32, 300, 128, 128, (0, 299)),
    (2, 64, 4, 70, 256, 256, (70, 3)),              # m=16, widest ranks
    (3, 12, 4, 50, 5, 7, (50, 0, 9)),               # m=3
])
def test_k3_matches_plain_version(cuda, B, H, Hkv, T, Rk, Rv, lengths,
                                  dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    qc = torch.randn(B, H, Rk, generator=g, device=cuda).to(dtype)
    kc = torch.randn(B, Hkv, T, Rk, generator=g, device=cuda).to(dtype)
    vc = torch.randn(B, Hkv, T, Rv, generator=g, device=cuda).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = kq_decode_attention.launches
    out = kq_decode_attention(qc, kc, vc, lens, scale=0.25)
    torch.cuda.synchronize()
    assert kq_decode_attention.launches == before + 1
    ref = kq_decode_attention_ref(qc, kc, vc, lens, scale=0.25)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=tol, atol=tol)


def test_reduced_model_card_matches_cpu(cuda):
    cfg = get_config("tinyllama-1.1b").reduced()
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_to(p_cpu, cuda)
    mp = calibrate_model(cpu, p_cpu,
                         calibration_batches(cfg.vocab_size, 8, 32, batch=4),
                         CompressionConfig(method="kqsvd", epsilon=0.1))
    prompts = [np.random.default_rng(i).integers(
        0, cfg.vocab_size, L).astype(np.int32) for i, L in enumerate((5, 9))]
    served = []
    for m, p in ((cpu, p_cpu), (gpu, p_gpu)):
        eng = ServingEngine(cfg, p, ServeConfig(max_seq_len=32, max_batch=2,
                                                decode_chunk=4),
                            projections=mp, device=m.device)
        rs = [Request(rid=i, prompt=q, max_new_tokens=6)
              for i, q in enumerate(prompts)]
        eng.generate(rs)
        served.append([r.out_tokens for r in rs])
    assert served[0] == served[1]
