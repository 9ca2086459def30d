"""The port's dry run (``repro_torch.launch.dryrun``) on fake process
groups, held to the local-shard arithmetic and to the reference's grid.

* Reduced configs on a fake 16-rank (4, 4) mesh, one a family (dense
  tinyllama, MLA + MoE deepseek-v2-lite, SSM mamba2, the hybrid jamba):
  every kind (train, prefill, decode, and decode with a batch of one,
  the cache ``seq_sharded``) and every variant the grid gives it reaches
  ``ok``; ``mem_args`` equals the bytes of each input's local shard,
  computed from its spec and the mesh's axis sizes; the collectives are
  counted a step (a (4, 4) mesh's FSDP gathers at the least).  The peak
  of a train and a prefill step follows the local batch, not the global
  one.  The
  prefills are the ones whose FFN rows met a strided shard before the
  residual was pinned to the data axes, and the train steps run the
  optimizer on the host step counter.
* Full-width tinyllama ``decode_32k`` on the fake 256-rank (16, 16)
  mesh, baseline and KQ-SVD: its 4 kv heads on the 16-way model axis cut
  the cache's sequence, so the compressed step books K3's span output
  once a layer.
* The record's keys are the reference's (its ``run_cell``'s record and
  ``Roofline``'s fields) without the XLA-only ones (``t_lower_s``,
  ``t_compile_s``, ``xla_flops_per_dev``, ``xla_bytes_per_dev``), with
  ``t_trace_s``, ``kernels``, ``grad_accum`` and ``microbatches_traced``
  (1 and 1 for a serving step).
* ``all_cells()`` and ``train_config_for`` equal the reference's over
  its archs, compared in a child process: importing the reference's
  dry run sets ``XLA_FLAGS`` (512 host devices), which must not leak
  into this worker.  Importing the port's sets nothing and starts no
  group.
* Gradient accumulation on the (4, 4) mesh: a train cell at
  ``grad_accum`` 2 and 4 (dense tinyllama and MLA + MoE deepseek-v2-lite
  with AdamW, the hybrid jamba with Adafactor, each given through the
  cell's ``TrainConfig``), which traces one microbatch and counts it n
  times, equals the same cell traced through ``make_train_step``'s whole
  loop; a cell of ``grad_accum`` 1 is one whole trace of its step, as
  before; a step's count does not depend on DTensor's propagation cache.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.roofline import analysis as jax_analysis
from repro_torch.config import SHAPES as PORT_SHAPES
from repro_torch.config import ShapeSpec, TrainConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.models.model import build_model
from repro_torch.sharding.partition import mesh_axes, params_shardings
from repro_torch.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (4, 4)
SHAPES = {"train": ShapeSpec("train_small", 32, 16, "train"),
          "prefill": ShapeSpec("prefill_small", 32, 8, "prefill"),
          "decode": ShapeSpec("decode_small", 64, 8, "decode"),
          "long": ShapeSpec("long_small", 64, 1, "decode")}
# (arch, kind, variant): every kind and variant of one arch a family
CELLS = [("tinyllama-1.1b", "train", "baseline"),
         ("tinyllama-1.1b", "prefill", "baseline"),
         ("tinyllama-1.1b", "prefill", "kqsvd"),
         ("tinyllama-1.1b", "decode", "baseline"),
         ("tinyllama-1.1b", "decode", "kqsvd"),
         ("tinyllama-1.1b", "decode", "kqsvd_int8"),
         ("tinyllama-1.1b", "long", "kqsvd"),
         ("deepseek-v2-lite-16b", "train", "baseline"),
         ("deepseek-v2-lite-16b", "prefill", "kqsvd"),
         ("deepseek-v2-lite-16b", "decode", "baseline"),
         ("deepseek-v2-lite-16b", "decode", "kqsvd"),
         ("mamba2-2.7b", "train", "baseline"),
         ("mamba2-2.7b", "prefill", "baseline"),
         ("mamba2-2.7b", "long", "baseline"),
         ("jamba-1.5-large-398b", "train", "baseline"),
         ("jamba-1.5-large-398b", "prefill", "kqsvd"),
         ("jamba-1.5-large-398b", "decode", "kqsvd_int8"),
         ("jamba-1.5-large-398b", "long", "kqsvd")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _local_bytes(tree, shardings, sizes) -> int:
    """Bytes of each leaf's local shard: every dim cut by the product of
    the sizes of the mesh axes its spec entry names."""
    total = 0
    for (_, t), (_, sh) in zip(leaves(tree), leaves(shardings)):
        spec = () if sh is None else sh.spec
        n = 1
        for i, d in enumerate(t.shape):
            s = spec[i] if i < len(spec) else None
            names = () if s is None else (s if isinstance(s, tuple) else (s,))
            n *= d // math.prod(sizes[a] for a in names)
        total += n * t.element_size()
    return total


def _want_args(cfg, shape, variant, mesh_cfg) -> int:
    """The local bytes of a cell's inputs, from the shardings the
    reference's ``_lower_cell`` gives each kind."""
    from repro_torch.config import MeshConfig
    mesh = MeshConfig(shape=mesh_cfg, axis_names=("data", "model"))
    sizes = mesh_axes(mesh)
    model = build_model(cfg, "cpu")
    params = S.abstract_params(model)
    if shape.kind == "train":
        tc = dryrun.train_config_for(cfg, MESH[0], shape.global_batch)
        opt = S.abstract_opt_state(params, tc, (model.prefix, model.steps))
        os_ = params_shardings(opt, mesh, fsdp=tc.fsdp)
        os_["step"] = None
        batch = S.batch_specs(cfg, shape.global_batch, shape.seq_len, True)
        return (_local_bytes(params, params_shardings(params, mesh,
                                                      tc.fsdp), sizes)
                + _local_bytes(opt, os_, sizes)
                + _local_bytes(batch, S.batch_shardings(batch, mesh), sizes))
    total = _local_bytes(params, params_shardings(params, mesh, True), sizes)
    ranks = S.default_ranks(cfg) if variant != "baseline" else (0, 0)
    if variant == "kqsvd_int8":
        cfg = dataclasses.replace(cfg, cache_quant="int8")
    model = build_model(cfg, "cpu")
    if variant != "baseline":
        proj = S.abstract_projections(model, ranks)
        total += _local_bytes(proj, S.projection_shardings(proj, mesh), sizes)
    if shape.kind == "prefill":
        batch = S.batch_specs(cfg, shape.global_batch, shape.seq_len, False)
        return total + _local_bytes(batch, S.batch_shardings(batch, mesh),
                                    sizes)
    cache = S.abstract_cache(model, shape.global_batch, shape.seq_len, ranks)
    tok = {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                 device="meta")}
    return (total + _local_bytes(cache, S.cache_shardings(
        cache, mesh, seq_sharded=shape.global_batch == 1), sizes)
        + _local_bytes(tok, S.batch_shardings(tok, mesh), sizes))


@pytest.mark.parametrize("arch,kind,variant", CELLS)
def test_reduced_cell_on_a_fake_16_rank_mesh(arch, kind, variant, tmp_path):
    cfg = get_config(arch).reduced()
    shape = SHAPES[kind]
    rec = dryrun.run_cell(arch, shape, False, variant, str(tmp_path),
                          mesh_shape=MESH, device_type="cpu", cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "mesh_4x4" and rec["n_devices"] == 16
    assert rec["mem_args"] == _want_args(cfg, shape, variant, MESH)
    assert rec["mem_temp"] >= 0 and rec["mem_out"] > 0
    coll = rec["collectives"]
    assert coll["count"] == sum(coll["count_by_op"].values()) > 0
    assert coll["by_op"]["all-gather"] > 0            # FSDP's gathers
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    kernels = {k: v["calls"] for k, v in rec["kernels"].items()}
    n_attn = sum(k in ("attn", "mla") for k in cfg.layer_kinds())
    n_ssm = sum(k == "ssm" for k in cfg.layer_kinds())
    if kind in ("train", "prefill"):
        passes = 2 if kind == "train" else 1      # remat recomputes
        want = {"flash_attention": passes * n_attn,
                "ssd_chunk_scan": passes * n_ssm}
        assert kernels == {k: v for k, v in want.items() if v}
        assert coll["attn_loops_subbed"] == passes * n_attn
    elif variant == "kqsvd" and cfg.mla is None:
        # 2 kv heads on the 4-way model axis: the sequence is cut
        assert kernels == {"kq_decode_attention_span": n_attn}
    else:
        assert kernels == {}


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_peak_follows_the_local_batch(kind, tmp_path):
    """The peak counts each rank's own tensors: a (2, 4) mesh at batch B
    and a (4, 4) mesh at 2B (the same local batch) give the same
    ``mem_temp`` within 1%, and the (4, 4) mesh at B (half the local
    batch) less.  The logits (8192 words) dominate the train step, so a
    tensor of the global batch's logits would break the first."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              vocab_size=8192)
    temp = {}
    for mesh, batch in (((2, 4), 32), ((4, 4), 64), ((4, 4), 32)):
        shape = ShapeSpec(f"{kind}_b{batch}", 64, batch, kind)
        rec = dryrun.run_cell("tinyllama-1.1b", shape, False, "baseline",
                              str(tmp_path), mesh_shape=mesh,
                              device_type="cpu", cfg=cfg)
        assert rec["status"] == "ok", rec.get("traceback")
        temp[mesh, batch] = rec["mem_temp"]
    same, half = temp[(4, 4), 64], temp[(4, 4), 32]
    assert abs(same - temp[(2, 4), 32]) <= 0.01 * same, temp
    assert half < 0.75 * same, temp


def test_full_width_tinyllama_decode_on_the_256_rank_mesh(tmp_path):
    recs = {v: dryrun.run_cell("tinyllama-1.1b", "decode_32k", False, v,
                               str(tmp_path), device_type="cpu")
            for v in ("baseline", "kqsvd")}
    cfg = get_config("tinyllama-1.1b")
    for v, rec in recs.items():
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["mesh"] == "pod_16x16" and rec["n_devices"] == 256
        assert rec["mem_args"] == _want_args(cfg, PORT_SHAPES["decode_32k"],
                                             v, (16, 16))
        assert rec["collectives"]["count_by_op"]["all-gather"] > 0
        assert 0 < rec["hbm_per_device_gib"] < 80
    assert recs["baseline"]["kernels"] == {}
    assert {k: v["calls"] for k, v in recs["kqsvd"]["kernels"].items()} == {
        "kq_decode_attention_span": cfg.n_layers}


def test_record_keys_are_the_references(tmp_path):
    rec = dryrun.run_cell("tinyllama-1.1b", SHAPES["decode"], False,
                          "baseline", str(tmp_path), mesh_shape=MESH,
                          device_type="cpu",
                          cfg=get_config("tinyllama-1.1b").reduced())
    # the reference's run_cell record: its own keys and Roofline's fields
    ref = ({"arch", "shape", "mesh", "variant", "status", "reason",
            "t_lower_s", "t_compile_s", "dot_flops_total",
            "xla_flops_per_dev", "xla_bytes_per_dev", "walker_warnings",
            "hbm_per_device_gib"}
           | {f.name for f in dataclasses.fields(jax_analysis.Roofline)})
    xla_only = {"t_lower_s", "t_compile_s", "xla_flops_per_dev",
                "xla_bytes_per_dev"}
    assert set(rec) == (ref - xla_only) | {
        "t_trace_s", "kernels", "grad_accum", "microbatches_traced"}
    assert (rec["grad_accum"], rec["microbatches_traced"]) == (1, 1)
    assert {"by_op", "count", "top", "attn_loops_subbed"} <= set(
        rec["collectives"])
    with open(os.path.join(tmp_path, "mesh_4x4",
                           "tinyllama-1.1b__decode_small__baseline.json")) as f:
        assert json.load(f)["status"] == "ok"
    skip = dryrun.run_cell("tinyllama-1.1b", "long_500k", False, "baseline",
                           str(tmp_path), device_type="cpu")
    assert skip["status"] == "skip" and "sub-quadratic" in skip["reason"]
    na = dryrun.run_cell("mamba2-2.7b", "decode_32k", False, "kqsvd",
                         str(tmp_path), device_type="cpu")
    assert (na["status"], na["reason"]) == (
        "skip", "kqsvd variant n/a (attention-free or train)")


GRID_SCRIPT = r"""
import dataclasses, json, os, sys
before = dict(os.environ)
import torch.distributed as dist
from repro_torch.launch import dryrun
from repro_torch.configs import get_config
assert dict(os.environ) == before and not dist.is_initialized()
port = {"cells": dryrun.all_cells(), "tc": {
    f"{a} {n} {b}": dataclasses.asdict(dryrun.train_config_for(
        get_config(a), n, b)) for a in dryrun.ARCHS
    for n, b in ((16, 256), (32, 256), (1, 8))}}
from repro.launch import dryrun as ref_dryrun
from repro.configs import get_config as ref_config
ref = {"cells": ref_dryrun.all_cells(), "tc": {
    f"{a} {n} {b}": dataclasses.asdict(ref_dryrun.train_config_for(
        ref_config(a), n, b)) for a in dryrun.ARCHS
    for n, b in ((16, 256), (32, 256), (1, 8))}}
print(json.dumps({"port": port, "ref": ref,
                  "archs": list(dryrun.ARCHS)}))
"""


def test_grid_and_train_configs_equal_the_references():
    from repro.configs import list_archs as jax_archs
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", GRID_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["archs"] == jax_archs()
    port_cells = [tuple(c) for c in out["port"]["cells"]]
    assert port_cells == [tuple(c) for c in out["ref"]["cells"]]
    assert len(port_cells) == 61
    assert out["port"]["tc"] == out["ref"]["tc"]
    assert "XLA_FLAGS" not in os.environ or "512" not in os.environ[
        "XLA_FLAGS"]


# (arch, grad_accum, optimizer): the dense, the MLA + MoE and the hybrid
# stacks, cut to the fewest layers that still hold each kind (tinyllama:
# one; deepseek-v2-lite: one MLA layer with MoE; jamba: an SSM layer with
# MoE, then attention)
ACCUM = [(arch, n, opt) for arch, opt in (("tinyllama-1.1b", "adamw"),
                                          ("deepseek-v2-lite-16b", "adamw"),
                                          ("jamba-1.5-large-398b",
                                           "adafactor"))
         for n in (2, 4)]
ACCUM_SHAPE = ShapeSpec("train_accum", 16, 16, "train")


def _few_layers(arch):
    cfg = get_config(arch).reduced()
    if arch == "jamba-1.5-large-398b":
        return dataclasses.replace(cfg, n_layers=2)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, first_k_dense=0))
    return dataclasses.replace(cfg, n_layers=1)


class _KeptCounter(dryrun.OpCounter):
    """The op count, its totals kept (the record has no transcendentals
    and no ``by_op``)."""
    kept = []

    def totals(self):
        t = super().totals()
        self.kept.append(t)
        return t


def _close(a, b, rel, what):
    assert abs(a - b) <= rel * max(abs(b), 1.0), (what, a, b)


@pytest.mark.parametrize("arch,n,optimizer", ACCUM)
def test_one_microbatch_counted_n_times_equals_the_whole_loop(
        arch, n, optimizer, tmp_path, monkeypatch):
    """A train cell at ``grad_accum`` n traces one microbatch and counts
    it n times; the same cell traced through ``make_train_step``'s whole
    loop (``all_microbatches``) under the same counters gives the same
    FLOPs, dot FLOPs, transcendentals, bytes and FLOPs by operator
    (1e-9 relative), the same kernels booked and collectives by kind,
    and the same memory within 1%.  Adafactor and AdamW both come in
    through the cell's own ``TrainConfig``."""
    monkeypatch.setattr(_KeptCounter, "kept", [])
    monkeypatch.setattr(dryrun, "OpCounter", _KeptCounter)
    cfg = _few_layers(arch)
    tc = TrainConfig(grad_accum=n, optimizer=optimizer)
    scaled, whole = (dryrun.run_cell(
        arch, ACCUM_SHAPE, False, "baseline", str(tmp_path / str(every)),
        mesh_shape=MESH, device_type="cpu", cfg=cfg, tc=tc,
        all_microbatches=every) for every in (False, True))
    for rec in (scaled, whole):
        assert rec["status"] == "ok", rec.get("traceback")
    assert (scaled["grad_accum"], scaled["microbatches_traced"]) == (n, 1)
    assert (whole["grad_accum"], whole["microbatches_traced"]) == (n, n)
    ts, tw = _KeptCounter.kept
    for k in ("flops", "dot_flops", "transcendentals", "bytes"):
        _close(getattr(ts, k), getattr(tw, k), 1e-9, k)
    assert set(ts.by_op) == set(tw.by_op)
    for op in tw.by_op:
        _close(ts.by_op[op], tw.by_op[op], 1e-9, op)
    for k in ("hlo_flops", "dot_flops_total", "hlo_bytes"):
        _close(scaled[k], whole[k], 1e-9, k)
    assert scaled["kernels"] == whole["kernels"]
    calls = {k: v["calls"] for k, v in whole["kernels"].items()}
    n_attn = sum(k in ("attn", "mla") for k in cfg.layer_kinds())
    assert calls.get("flash_attention", 0) == 2 * n * n_attn
    cs, cw = scaled["collectives"], whole["collectives"]
    assert cs["count_by_op"] == cw["count_by_op"]
    assert cs["count"] == cw["count"] == sum(cw["count_by_op"].values())
    for op in cw["by_op"]:
        _close(cs["by_op"][op], cw["by_op"][op], 1e-9, op)
    _close(scaled["collective_wire_bytes_per_dev"],
           whole["collective_wire_bytes_per_dev"], 1e-9, "wire bytes")
    for k in ("mem_args", "mem_out", "mem_temp"):
        _close(scaled[k], whole[k], 0.01, k)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_a_cell_without_accumulation_is_traced_as_before(kind, tmp_path):
    """A cell of ``grad_accum`` 1 (``train_config_for``'s for a reduced
    config, and every serving step) is one whole trace of its step, as
    before microbatches were counted: its record equals what the step's
    own trace under the three counters gives, and its keys are the
    earlier ones with ``grad_accum`` and ``microbatches_traced`` (1, 1)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.multiprocessing.reductions import StorageWeakRef
    import torch.distributed as dist
    from repro_torch.roofline.analysis import count_collectives
    from repro_torch.roofline.flop_count import LivePeak, OpCounter
    from repro_torch.sharding.partition import use_mesh
    arch, cfg = "tinyllama-1.1b", get_config("tinyllama-1.1b").reduced()
    shape = SHAPES[kind]
    variant = "kqsvd" if kind == "decode" else "baseline"
    rec = dryrun.run_cell(arch, shape, False, variant, str(tmp_path),
                          mesh_shape=MESH, device_type="cpu", cfg=cfg)
    assert rec["status"] == "ok", rec.get("traceback")
    assert (rec["grad_accum"], rec["microbatches_traced"]) == (1, 1)
    # the step traced whole, as the dry run traced every cell before
    mesh = dryrun._start_mesh(False, MESH, "cpu")
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh):
            step, args = dryrun._trace_cell(cfg, shape, mesh, variant,
                                            torch.device("cpu"))
            arg_ts = dryrun._local(list(args))
            with LivePeak() as live, OpCounter() as oc, \
                    count_collectives() as coll:
                live.track(*arg_ts)
                out = step(*args)
            seen = {StorageWeakRef(t.untyped_storage()) for t in arg_ts}
            fresh = {StorageWeakRef(t.untyped_storage()): t
                     for t in dryrun._local(list(out))}
            mem_out = dryrun._nbytes(t for ref, t in fresh.items()
                                     if ref not in seen)
    finally:
        dist.destroy_process_group()
    t, n_dev = oc.totals(), 16
    assert rec["hlo_flops"] == t.flops * n_dev
    assert rec["dot_flops_total"] == t.dot_flops * n_dev
    assert rec["hlo_bytes"] == t.bytes * n_dev
    assert rec["kernels"] == t.kernels
    assert rec["collectives"]["count_by_op"] == coll.count_by_op
    assert rec["collectives"]["by_op"] == coll.by_op
    assert rec["collectives"]["top"] == coll.top
    mem_args = dryrun._nbytes(arg_ts)
    assert rec["mem_args"] == mem_args and rec["mem_out"] == mem_out
    assert rec["mem_temp"] == max(0.0, live.peak - mem_args - mem_out)


def test_count_does_not_depend_on_the_propagation_cache(tmp_path):
    """DTensor propagates some operators (softplus' backward, under the
    SSM layer's step size) through their decomposition on a cache miss;
    those operators are not the step's and are not counted, so a step
    traced on a cold propagation cache counts what it counts warm."""
    from torch.distributed.tensor import DTensor
    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(),
                              n_layers=1)
    recs = []
    for cold in (True, False):
        if cold:
            DTensor._op_dispatcher.sharding_propagator \
                .propagate_op_sharding.cache_clear()
        recs.append(dryrun.run_cell(
            "mamba2-2.7b", SHAPES["train"], False, "baseline",
            str(tmp_path), mesh_shape=MESH, device_type="cpu", cfg=cfg))
    for rec in recs:
        assert rec["status"] == "ok", rec.get("traceback")
    for k in ("hlo_flops", "dot_flops_total", "hlo_bytes"):
        assert recs[0][k] == recs[1][k], k
