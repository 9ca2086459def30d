"""End-to-end lifecycle in the port: train -> calibrate -> compress ->
serve (the counterpart of tests/test_system.py::test_full_lifecycle), on
reduced tinyllama on the CPU: a few training steps, calibration of the
trained params (host Grams and the device step), the KQ-SVD solve at
epsilon 0.05, compressed serving, and the accounting that justifies it."""
import numpy as np
import pytest
import torch

from repro_torch.config import CompressionConfig, ServeConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.calibration import (accumulator_from_grams,
                                          calibrate_model,
                                          make_calibrate_step)
from repro_torch.core.compressed import (cache_footprint,
                                         projection_param_bytes)
from repro_torch.data import DataConfig, batches, calibration_batches
from repro_torch.serving import Request, ServingEngine
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


def test_full_lifecycle():
    cfg = get_config("tinyllama-1.1b").reduced()
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=10,
                     checkpoint_every=0)
    trainer = Trainer(cfg, tc, device="cpu")
    state = trainer.init_state()
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)
    report = trainer.run(batches(dc), 10, state=state)
    assert report.losses[-1] < report.losses[0]

    # calibration of the trained params (paper: sequences through the
    # model, collect caches), host Grams; the device step agrees
    model, params = trainer.model, trainer.state["params"]
    calib = calibration_batches(cfg.vocab_size, n_seqs=4, seq_len=32,
                                batch=2)
    ccfg = CompressionConfig(method="kqsvd", epsilon=0.05)
    mp = calibrate_model(model, params, calib, ccfg)
    assert len(mp.ranks_k) == len(model.attn_layers)
    init_grams, step = make_calibrate_step(model)
    grams = init_grams(cfg.d_head, cfg.d_head, cfg.n_kv_heads)
    for b in calib:
        grams = step(params, grams, b)
    mp_dev = accumulator_from_grams(grams).solve(
        ccfg, model.group_output_weights(params))
    assert mp_dev.ranks_k == mp.ranks_k and mp_dev.ranks_v == mp.ranks_v

    # compressed serving
    eng = ServingEngine(cfg, params, ServeConfig(max_seq_len=64,
                                                 max_batch=2),
                        projections=mp, device="cpu")
    reqs = [Request(rid=i, prompt=np.arange(8, dtype=np.int32),
                    max_new_tokens=4) for i in range(2)]
    eng.generate(reqs)
    assert all(len(r.out_tokens) == 4 for r in reqs)

    # accounting: the compressed cache no larger at eps=0.05; the
    # projections' bytes as the reference counts them
    from repro.core.compressed import projection_param_bytes as ref_bytes
    fp = cache_footprint(cfg.n_kv_heads, cfg.d_head, mp.rank_k, mp.rank_v)
    assert fp.compressed_bytes <= fp.full_bytes
    assert projection_param_bytes(mp) > 0
    assert projection_param_bytes(mp) == ref_bytes(mp)
    assert projection_param_bytes(mp, 4) == 2 * projection_param_bytes(mp)
