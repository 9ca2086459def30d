"""The port's synthetic data pipeline: every case of tests/test_data.py
(determinism, host sharding, label shift, restart, Zipf skew), and the
same tokens and labels as the reference's for the same config."""
import numpy as np
import pytest
import torch

from repro_torch.data import (DataConfig, batches, calibration_batches,
                              sample_batch)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small models: the test runner's
    workers share the cores, and torch's thread pools would oversubscribe
    them, stretching a few-ms step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_deterministic_across_calls():
    cfg = DataConfig(vocab_size=100, seq_len=16, batch_size=4, seed=7)
    a = sample_batch(cfg, 3)
    b = sample_batch(cfg, 3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab_size=100, seq_len=16, batch_size=2)
    b = sample_batch(cfg, 0)
    assert b["tokens"].shape == (2, 16)
    assert b["labels"].shape == (2, 16)
    # labels[t] is the next token of the same underlying stream
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_hosts_get_disjoint_streams():
    c0 = DataConfig(vocab_size=1000, seq_len=16, batch_size=2, host_id=0,
                    n_hosts=2)
    c1 = DataConfig(vocab_size=1000, seq_len=16, batch_size=2, host_id=1,
                    n_hosts=2)
    b0 = next(batches(c0))
    b1 = next(batches(c1))
    assert not np.array_equal(b0["tokens"], b1["tokens"])


def test_restart_stability():
    cfg = DataConfig(vocab_size=100, seq_len=8, batch_size=2)
    it = batches(cfg)
    first = [next(it)["tokens"] for _ in range(3)]
    it2 = batches(cfg, start=2)
    np.testing.assert_array_equal(next(it2)["tokens"], first[2])


def test_calibration_batches_shape():
    got = calibration_batches(vocab=50, n_seqs=10, seq_len=8, batch=4)
    assert sum(b.shape[0] for b in got) >= 10
    assert all(b.shape[1] == 8 for b in got)


def test_zipf_skew():
    cfg = DataConfig(vocab_size=1000, seq_len=512, batch_size=8)
    toks = sample_batch(cfg, 0)["tokens"]
    # low ids much more frequent than high ids under Zipf
    assert (toks < 10).mean() > (toks > 500).mean() * 3


@pytest.mark.parametrize("seed,host_id,n_hosts", [(0, 0, 1), (7, 1, 2)])
def test_batches_equal_reference(seed, host_id, n_hosts):
    from repro.data import DataConfig as RefConfig
    from repro.data import batches as ref_batches
    kw = dict(vocab_size=1000, seq_len=16, batch_size=3, seed=seed,
              host_id=host_id, n_hosts=n_hosts)
    mine, ref = batches(DataConfig(**kw), start=1), batches(
        RefConfig(**kw), start=1)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
