"""The port's CheckpointManager: every case of tests/test_checkpoint.py
on torch trees, plus a bfloat16 round trip (stored through its int16
view, no ml_dtypes) that restores onto the template's devices."""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
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


def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)},
            "layers": [torch.zeros((2, 2)), torch.full((3,), 7.0)],
            "step": torch.tensor(3, dtype=torch.int32)}


def assert_trees_equal(a, b):
    for (pa, x), (pb, y) in zip(leaves(a), leaves(b)):
        assert pa == pb
        assert x.dtype == y.dtype and x.device == y.device, pa
        assert torch.equal(x, y), pa


def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    t = tree()
    m.save(5, t, extra={"train_step": 5})
    out, meta = m.restore(t)
    assert meta["extra"]["train_step"] == 5
    assert_trees_equal(t, out)


def test_bf16_roundtrip_without_ml_dtypes(tmp_path):
    """bfloat16 leaves go through their int16 view, with the true dtype
    in the index; no ml_dtypes module is imported on the way."""
    import sys
    g = torch.Generator().manual_seed(0)
    t = {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
         "m": torch.randn((3,), generator=g).to(torch.bfloat16)}
    m = CheckpointManager(str(tmp_path), async_save=False)
    had = "ml_dtypes" in sys.modules
    m.save(1, t)
    out, meta = m.restore(t)
    assert_trees_equal(t, out)
    with open(os.path.join(str(tmp_path), "step_00000001",
                           "index.json")) as f:
        assert '"dtype": "bfloat16"' in f.read()
    with np.load(os.path.join(str(tmp_path), "step_00000001",
                              "shard_00000.npz")) as data:
        assert data["w"].dtype == np.int16
    assert ("ml_dtypes" in sys.modules) == had


def test_async_save_and_wait(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    for s in (1, 2):
        m.save(s, tree())
    m.wait()
    assert m.list_steps() == [1, 2]


def test_async_save_copies_before_returning(tmp_path):
    """The host copy is taken before ``save`` returns: writing into the
    tree afterwards does not reach the checkpoint."""
    m = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    t = tree()
    m.save(1, t)
    t["a"].add_(100.0)
    m.wait()
    out, _ = m.restore(tree())
    assert_trees_equal(tree(), out)


def test_keep_n_gc(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in range(5):
        m.save(s, tree())
    assert m.list_steps() == [3, 4]


def test_damaged_checkpoint_falls_back(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    t = tree()
    m.save(1, t, extra={"train_step": 1})
    m.save(2, t, extra={"train_step": 2})
    os.remove(os.path.join(str(tmp_path), "step_00000002",
                           "shard_00000.npz"))
    out, meta = m.restore(t)
    assert meta["extra"]["train_step"] == 1


def test_restore_missing_leaf_raises(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    m.save(1, {"a": torch.ones((2,))})
    with pytest.raises((IOError, KeyError, FileNotFoundError)):
        m.restore({"a": torch.ones((2,)), "new": torch.ones((3,))})


def test_atomic_commit_no_tmp_left(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    m.save(1, tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(str(tmp_path)))
    assert not any(f.endswith(".part")
                   for f in os.listdir(os.path.join(str(tmp_path),
                                                    "step_00000001")))
    assert open(os.path.join(str(tmp_path), "LATEST")).read() \
        == "step_00000001"


def test_torn_write_preserves_previous_checkpoint(tmp_path, monkeypatch):
    """Kill the writer mid-shard (partial bytes on disk, no fsync, no
    rename): the torn step is invisible to ``list_steps`` / ``restore``
    and the previous checkpoint loads intact; so after a crash between
    the shard and the index; the next clean save recovers."""
    m = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    t = tree()
    m.save(1, t, extra={"train_step": 1})

    def torn_savez(f, **arrays):
        f.write(b"PK\x03\x04 torn npz header")   # partial garbage
        raise KeyboardInterrupt("simulated crash mid-write")

    monkeypatch.setattr(np, "savez", torn_savez)
    with pytest.raises(KeyboardInterrupt):
        m.save(2, t, extra={"train_step": 2})
    monkeypatch.undo()
    assert m.list_steps() == [1]
    assert open(os.path.join(str(tmp_path), "LATEST")).read() \
        == "step_00000001"
    out, meta = m.restore(t)
    assert meta["extra"]["train_step"] == 1
    assert_trees_equal(t, out)

    real_commit = CheckpointManager._commit_file

    def torn_index(path, write_fn):
        if path.endswith("index.json"):
            raise KeyboardInterrupt("simulated crash before index")
        real_commit(path, write_fn)

    monkeypatch.setattr(CheckpointManager, "_commit_file",
                        staticmethod(torn_index))
    with pytest.raises(KeyboardInterrupt):
        m.save(3, t, extra={"train_step": 3})
    monkeypatch.undo()
    assert m.list_steps() == [1]
    _, meta = m.restore(t)
    assert meta["extra"]["train_step"] == 1

    m.save(4, t, extra={"train_step": 4})
    assert m.list_steps() == [1, 4]
    _, meta = m.restore(t)
    assert meta["extra"]["train_step"] == 4
