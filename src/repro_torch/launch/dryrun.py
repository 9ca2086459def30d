"""Dry run of the port over the production meshes: one step of every
(arch x shape x variant) cell traced on fake tensors.

Torch counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's step for 256 or 512 host devices and reads XLA's
memory analysis, cost analysis and HLO.  The port has no compiler: for
each cell the dry run

  1. starts a fake process group (``torch.distributed``'s ``"fake"``
     backend) of the mesh's size and builds the mesh on it
     (``make_production_mesh``: (16, 16) data x model, or (2, 16, 16)
     pod x data x model);
  2. places fake tensors (shapes, types and devices, no memory) for the
     step's inputs under the reference's shardings
     (``repro_torch.launch.specs``, ``params_shardings``), each rank's own
     shard only, and runs the step once on them under ``FakeTensorMode``
     with the op count (``roofline.flop_count.OpCounter``: FLOPs, bytes,
     transcendentals and the kernels' booked work, per device), the
     collectives' count (``roofline.analysis.count_collectives``) and
     ``roofline.flop_count.LivePeak`` (the per-device peak of live
     local storages); a train step of ``grad_accum`` n > 1 runs its
     accumulation loop's body once, its counts taken n times
     (``kernels.booking.repeated``), as the reference's HLO walker
     multiplies a ``while`` body by its trip count;
  3. destroys the group and writes the record to
     ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>__<variant>.json``.

The record keeps the reference's keys where they mean the same:
``Roofline.to_dict()`` (the H100's datasheet constants), ``status`` ok /
skip / error and ``reason``, ``dot_flops_total``, ``walker_warnings``,
``hbm_per_device_gib``, ``mem_args`` (the local bytes of params,
optimizer state, batch, cache and projections), ``mem_out`` (outputs in
storage of their own: a decode step updates its cache in place) and
``mem_temp`` (peak - args - out).  ``t_trace_s`` replaces the
reference's ``t_lower_s`` and ``t_compile_s``; there are no ``xla_*``
keys; ``kernels`` holds the kernels booked per device; ``grad_accum``
(a train step's microbatches, 1 for a serving step) and
``microbatches_traced`` (1, or n under ``all_microbatches``) say what was
traced.  A decode step runs at the last position of its cache (every
position live).

The device type is CUDA (fake CUDA tensors, so every wrapper takes its
kernel's route) unless the caller asks for ``device_type="cpu"`` (the
CPU tests; the wrappers' plain routes).  Importing this module sets no
environment variable and starts no group.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs-filter k]
      [--jobs N [--cell-timeout S]]
  python -m repro_torch.launch.dryrun --table
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional, Tuple, Union

import torch

from repro_torch.config import (SHAPES, ModelConfig, ShapeSpec, TrainConfig,
                                shape_applicable)
from repro_torch.configs import get_config
from repro_torch.kernels import booking
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.roofline.analysis import (Roofline, attn_substitution,
                                           count_collectives,
                                           model_flops_for, summarize,
                                           useful_bytes_for)
from repro_torch.roofline.flop_count import LivePeak, OpCounter
from repro_torch.sharding.partition import (dp_axes, axis_size,
                                            is_dtensor, params_shardings,
                                            use_mesh, zeros_placed)
from repro_torch.train.steps import (accum_finish, accum_microbatch,
                                     accum_start, make_decode_step,
                                     make_loss_fn, make_prefill_step,
                                     make_train_step, update_step)
from repro_torch.tree import leaves, unflatten

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# the reference's assigned archs, in its ``list_archs()`` order (the
# port also carries paper-llama2-7b, which the grid leaves out)
ARCHS = ("jamba-1.5-large-398b", "mamba2-2.7b", "deepseek-v2-lite-16b",
         "arctic-480b", "musicgen-large", "deepseek-67b", "tinyllama-1.1b",
         "smollm-360m", "h2o-danube-1.8b", "phi-3-vision-4.2b")


def train_config_for(cfg: ModelConfig, n_dp: int = 16,
                     global_batch: int = 256) -> TrainConfig:
    """Memory-vs-traffic policy by model size (the reference's).

    Gradient accumulation re-reads every weight per microbatch, so it is
    pure HBM overhead unless activations would not fit: accum=1 for
    small models, scaled up with parameter count; >=100B configs also
    switch to Adafactor.  The global microbatch must still cover the
    data axes."""
    n = cfg.param_count()
    accum = 16 if n > 30e9 else (4 if n > 8e9 else 1)
    accum = min(accum, max(1, global_batch // n_dp))
    return TrainConfig(
        optimizer="adafactor" if n > 100e9 else "adamw",
        grad_accum=accum)


def _placed(tree, shardings, device: torch.device):
    """Fake tensors for a tree of meta tensors, each placed by its
    ``NamedSharding`` as a DTensor of which this rank holds only its own
    shard; a leaf whose sharding is None becomes a plain tensor on
    ``device``.  Call under a ``FakeTensorMode``."""
    out = []
    for (_, t), (_, sh) in zip(leaves(tree), leaves(shardings)):
        if sh is None:
            out.append(torch.empty(t.shape, dtype=t.dtype, device=device))
        else:
            out.append(zeros_placed(t.shape, t.dtype, sh.mesh,
                                    sh.placements))
    return unflatten(tree, out)


def _local(tree):
    """The tensors of a tree as this rank holds them."""
    return [t.to_local() if is_dtensor(t) else t
            for _, t in leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _counted_train_step(model, tc: TrainConfig):
    """``make_train_step(model, tc)``'s step with its accumulation loop's
    body run once, for microbatch 0, under ``booking.repeated(n)``: the
    counts take it ``tc.grad_accum`` times, and the accumulator's zeros,
    the division and cast, the clip and the update once.  Every
    microbatch issues the same operators on the same shapes, and holds
    the same live tensors (``accum_microbatch``), so the count and the
    peak are the whole step's."""
    loss_fn = make_loss_fn(model, tc)
    n = tc.grad_accum

    def step(params, opt_state, batch):
        acc = accum_start(params, model.device)
        with booking.repeated(n):
            acc = accum_microbatch(loss_fn, params, batch, 0, n, acc)
        metrics, grads = accum_finish(acc, params, n)
        return update_step(model, tc, params, opt_state, grads, metrics)

    return step


def _trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, variant: str,
                device: torch.device, tc: Optional[TrainConfig] = None,
                scaled: bool = False):
    """``(step, args)``: the cell's step and its inputs as placed fake
    tensors (call under a ``FakeTensorMode``), the shardings per kind and
    variant the reference's ``_lower_cell`` gives them: serving params
    under FSDP's rule (``fsdp=True``), training params and optimizer
    state under ``tc.fsdp``, the cache ``seq_sharded`` for a batch of
    one, the VLM's patches ahead of its prefill's text, and the int8
    cache for ``kqsvd_int8``.  A train step's ``tc``:
    ``train_config_for`` unless given; ``scaled``: its microbatch loop
    counted from one microbatch (``_counted_train_step``) where
    ``tc.grad_accum`` > 1, else ``make_train_step``'s whole."""
    model = build_model(cfg, device)
    params_abs = S.abstract_params(model)
    p_shard_serve = params_shardings(params_abs, mesh, fsdp=True)
    n_dp = axis_size(dp_axes(mesh), mesh)
    if shape.kind == "train":
        tc = tc or train_config_for(cfg, n_dp, shape.global_batch)
        step = (_counted_train_step(model, tc)
                if scaled and tc.grad_accum > 1
                else make_train_step(model, tc))
        opt_abs = S.abstract_opt_state(params_abs, tc,
                                       (model.prefix, model.steps))
        batch_abs = S.batch_specs(cfg, shape.global_batch, shape.seq_len,
                                  with_labels=True)
        params = _placed(params_abs, params_shardings(params_abs, mesh,
                                                      fsdp=tc.fsdp), device)
        os_ = params_shardings(opt_abs, mesh, fsdp=tc.fsdp)
        os_["step"] = None
        opt = _placed(opt_abs, os_, device)
        # the host step counter, its value known to the fake mode (the
        # schedule and the bias corrections read it as a Python float)
        opt["step"] = torch.tensor(0, dtype=torch.int32)
        batch = _placed(batch_abs, S.batch_shardings(batch_abs, mesh),
                        device)
        return step, (params, opt, batch)

    compressed = variant.startswith("kqsvd")
    ranks = S.default_ranks(cfg) if compressed else (0, 0)
    if variant == "kqsvd_int8":
        cfg = dataclasses.replace(cfg, cache_quant="int8")
    model_ = build_model(cfg, device)
    params = _placed(params_abs, p_shard_serve, device)
    proj = None
    if compressed:
        proj_abs = S.abstract_projections(model_, ranks)
        proj = _placed(proj_abs, S.projection_shardings(proj_abs, mesh),
                       device)

    if shape.kind == "prefill":
        # vlm: the patch tokens prepend to the text sequence
        max_len = shape.seq_len + cfg.num_patch_tokens
        step = make_prefill_step(model_, max_len, compressed)
        batch_abs = S.batch_specs(cfg, shape.global_batch, shape.seq_len,
                                  with_labels=False)
        batch = _placed(batch_abs, S.batch_shardings(batch_abs, mesh),
                        device)
        return step, ((params, proj, batch) if compressed
                      else (params, batch))

    # decode, at the cache's last position
    step = make_decode_step(model_, compressed)
    cache_abs = S.abstract_cache(model_, shape.global_batch, shape.seq_len,
                                 ranks)
    cs = S.cache_shardings(cache_abs, mesh,
                           seq_sharded=shape.global_batch == 1)
    cache = _placed(cache_abs, cs, device)
    tok_abs = {"tokens": torch.empty((shape.global_batch, 1),
                                     dtype=torch.int32, device="meta")}
    tokens = _placed(tok_abs, S.batch_shardings(tok_abs, mesh),
                     device)["tokens"]
    pos = shape.seq_len - 1
    return step, ((params, proj, cache, tokens, pos) if compressed
                  else (params, cache, tokens, pos))


def _mesh_name(multi_pod: bool, mesh_shape) -> str:
    if mesh_shape is not None:
        return "mesh_" + "x".join(map(str, mesh_shape))
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


def _start_mesh(multi_pod: bool, mesh_shape, device_type: str):
    """A fake process group of the mesh's size and the mesh on it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = (math.prod(mesh_shape) if mesh_shape is not None
             else 512 if multi_pod else 256)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
    return make_local_mesh(*mesh_shape, device_type=device_type)


def _write(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=2)


def run_cell(arch: str, shape: Union[str, ShapeSpec], multi_pod: bool,
             variant: str = "baseline", out_dir: Optional[str] = None, *,
             mesh_shape: Optional[Tuple[int, int]] = None,
             device_type: Optional[str] = None,
             cfg: Optional[ModelConfig] = None,
             tc: Optional[TrainConfig] = None,
             all_microbatches: bool = False) -> Optional[dict]:
    """Trace one (arch x shape x mesh x variant) cell and write its
    record; returns the record (status "skip" with a reason when the
    shape does not apply to the arch).  ``shape``: a name of ``SHAPES``
    or a ``ShapeSpec``; ``mesh_shape``: a (data, model) mesh in place of
    the production mesh; ``device_type``: ``"cuda"`` (default) or
    ``"cpu"``; ``cfg``: a config in place of ``get_config(arch)`` (a
    reduced one); ``tc``: a train step's ``TrainConfig`` in place of
    ``train_config_for``'s (its ``grad_accum`` and optimizer).

    A train step of ``grad_accum`` n > 1 traces one microbatch and
    counts it n times (``_counted_train_step``) unless
    ``all_microbatches``, which traces ``make_train_step``'s whole loop
    (the check of that count).  The record says so: ``grad_accum`` (n; 1
    for a serving step) and ``microbatches_traced``."""
    cfg = cfg or get_config(arch)
    shape = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    device_type = device_type or "cuda"
    ok, why = shape_applicable(cfg, shape)
    mesh_name = _mesh_name(multi_pod, mesh_shape)
    record = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "variant": variant, "status": "skip", "reason": why,
    }
    out_dir = out_dir or ARTIFACT_DIR
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    path = os.path.join(out_dir, mesh_name,
                        f"{arch}__{shape.name}__{variant}.json")
    if not ok:
        _write(path, record)
        print(f"SKIP  {arch} {shape.name} {variant}: {why}")
        return record
    if variant.startswith("kqsvd") and (cfg.attention_free
                                        or shape.kind == "train"):
        record["reason"] = "kqsvd variant n/a (attention-free or train)"
        _write(path, record)
        return record

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.multiprocessing.reductions import StorageWeakRef
    mesh = _start_mesh(multi_pod, mesh_shape, device_type)
    if shape.kind == "train":
        tc = tc or train_config_for(cfg, axis_size(dp_axes(mesh), mesh),
                                    shape.global_batch)
    t0 = time.time()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh):
            device = torch.device(device_type, 0) if device_type == "cuda" \
                else torch.device(device_type)
            step, args = _trace_cell(cfg, shape, mesh, variant, device,
                                     tc, scaled=not all_microbatches)
            arg_ts = _local(list(args))
            with LivePeak() as live, OpCounter() as oc, \
                    count_collectives() as coll:
                live.track(*arg_ts)
                out = step(*args)
            peak = live.peak
            seen = {StorageWeakRef(t.untyped_storage()) for t in arg_ts}
            out_ts = {StorageWeakRef(t.untyped_storage()): t
                      for t in _local(list(out))}
            mem_out = float(_nbytes(t for ref, t in out_ts.items()
                                    if ref not in seen))
        t_trace = time.time() - t0
    except Exception as e:
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        _write(path, record)
        print(f"ERROR {arch} {shape.name} {variant}: {e}")
        return record
    finally:
        dist.destroy_process_group()

    n_dev = mesh.size()
    walked = oc.totals()
    removed, added, n_passes = attn_substitution(cfg, shape, walked.kernels)
    mem_args = float(_nbytes(arg_ts))
    r = Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, variant=variant,
        n_devices=n_dev,
        hlo_flops=walked.flops * n_dev,
        hlo_bytes=walked.bytes * n_dev,
        hlo_bytes_kernel=max(0.0, walked.bytes - removed + added) * n_dev,
        collective_wire_bytes_per_dev=coll.wire_bytes,
        model_flops=model_flops_for(cfg, shape, variant),
        useful_bytes=useful_bytes_for(cfg, shape, variant),
        mem_args=mem_args, mem_out=mem_out,
        mem_temp=max(0.0, float(peak) - mem_args - mem_out),
        collectives={"by_op": coll.by_op, "count": coll.count,
                     "count_by_op": coll.count_by_op, "top": coll.top,
                     "attn_loops_subbed": n_passes},
    ).finalize()
    record.update(r.to_dict())
    record["status"] = "ok"
    record["t_trace_s"] = t_trace
    record["dot_flops_total"] = walked.dot_flops * n_dev
    record["walker_warnings"] = walked.warnings[:5]
    record["kernels"] = walked.kernels
    record["hbm_per_device_gib"] = (r.mem_args + r.mem_out + r.mem_temp) \
        / 2**30
    n_acc = tc.grad_accum if shape.kind == "train" else 1
    record["grad_accum"] = n_acc
    record["microbatches_traced"] = n_acc if all_microbatches else 1
    _write(path, record)
    print(summarize(r) + f"  [trace {t_trace:.0f}s hbm/dev "
          f"{record['hbm_per_device_gib']:.1f}GiB]")
    return record


def all_cells(include_variants: bool = True):
    """Every (arch, shape, variant) cell of the assignment grid;
    compressed variants only where a decode shape applies."""
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            shape = SHAPES[shape_name]
            ok, _ = shape_applicable(cfg, shape)
            cells.append((arch, shape_name, "baseline"))
            if (include_variants and ok and shape.kind == "decode"
                    and not cfg.attention_free):
                cells.append((arch, shape_name, "kqsvd"))
                if cfg.mla is None:          # int8 path: GQA caches
                    cells.append((arch, shape_name, "kqsvd_int8"))
    return cells


def _record_path(out_dir: Optional[str], mesh_name: str, cell) -> str:
    arch, shape, variant = cell
    return os.path.join(out_dir or ARTIFACT_DIR, mesh_name,
                        f"{arch}__{shape}__{variant}.json")


def _run_children(cells, multi_pod: bool, out_dir: Optional[str],
                  jobs: int, cell_timeout: Optional[float]) -> None:
    """Each cell a run of this CLI in a process of its own, ``jobs`` at a
    time, training cells first (the longest); a cell still tracing after
    ``cell_timeout`` seconds is stopped and recorded as an error."""
    import subprocess
    import sys
    todo = sorted(cells, key=lambda c: SHAPES[c[1]].kind != "train")
    mesh_name = _mesh_name(multi_pod, None)
    running = []
    while todo or running:
        while todo and len(running) < jobs:
            cell = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", cell[0], "--shape", cell[1],
                   "--variant", cell[2]] + (["--multi-pod"] if multi_pod
                                            else [])
            if out_dir:
                cmd += ["--out", out_dir]
            running.append((subprocess.Popen(cmd), time.time(), cell))
        time.sleep(1.0)
        for item in list(running):
            proc, start, cell = item
            if proc.poll() is None:
                if cell_timeout is None or time.time() - start < cell_timeout:
                    continue
                proc.kill()
                proc.wait()
                _write(_record_path(out_dir, mesh_name, cell), {
                    "arch": cell[0], "shape": cell[1], "mesh": mesh_name,
                    "variant": cell[2], "status": "error",
                    "reason": f"trace not finished in {cell_timeout:.0f} s",
                    "error": "timeout"})
            running.remove(item)


def grid_table(out_dir: Optional[str] = None) -> str:
    """The records of ``all_cells()`` on both production meshes as a
    markdown table, a row a cell with each mesh's status, hbm GiB a
    device, compute / memory / collective ms and bottleneck (or the
    reason it has none), then the count of each status a mesh."""
    meshes = [_mesh_name(m, None) for m in (False, True)]
    cols = ("status", "GiB/dev", "comp ms", "mem ms", "coll ms", "bound")
    lines = ["| arch | shape | variant | " + " | ".join(
        f"{m.split('_')[-1]} {c}" for m in meshes for c in cols) + " |",
        "| --- " * (3 + 2 * len(cols)) + "|"]
    counts = {}
    for cell in all_cells():
        row = list(cell)
        for mesh in meshes:
            p = _record_path(out_dir, mesh, cell)
            r = json.load(open(p)) if os.path.exists(p) \
                else {"status": "missing"}
            counts[mesh, r["status"]] = counts.get((mesh, r["status"]), 0) + 1
            if r["status"] != "ok":
                why = (r.get("reason") or r.get("error") or "")[:48]
                row += [f"{r['status']}: {why}"] + [""] * (len(cols) - 1)
            else:
                row += ["ok", f"{r['hbm_per_device_gib']:.2f}"] + [
                    f"{r[t] * 1e3:.3f}" for t in
                    ("t_compute", "t_memory", "t_collective")] + [
                    r["bottleneck"]]
        lines.append("| " + " | ".join(row) + " |")
    lines += ["", "; ".join(f"{m} {st}: {n}"
                            for (m, st), n in sorted(counts.items()))]
    return "\n".join(lines)


def main() -> None:
    """CLI entry: one cell (--arch/--shape) or the whole grid (--all),
    cell after cell, or ``--jobs`` cells at a time in processes of their
    own, each cut at ``--cell-timeout`` seconds; ``--table`` prints the
    grid's records of both meshes as a markdown table."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs-filter", type=int, default=None,
                    help="run cells where index %% 4 == this (sharded runs)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--cell-timeout", type=float, default=None)
    ap.add_argument("--table", action="store_true")
    args = ap.parse_args()

    if args.table:
        print(grid_table(args.out))
    elif args.all:
        mesh_name = _mesh_name(args.multi_pod, None)
        os.makedirs(os.path.join(args.out or ARTIFACT_DIR, mesh_name),
                    exist_ok=True)
        cells = []
        for i, cell in enumerate(all_cells()):
            if args.jobs_filter is not None and i % 4 != args.jobs_filter:
                continue
            path = _record_path(args.out, mesh_name, cell)
            if args.skip_existing and os.path.exists(path):
                try:
                    with open(path) as f:
                        ok = json.load(f).get("status") in ("ok", "skip")
                except Exception:
                    ok = False
                if ok:
                    continue
            cells.append(cell)
        if args.jobs > 1:
            _run_children(cells, args.multi_pod, args.out, args.jobs,
                          args.cell_timeout)
        else:
            for arch, shape, variant in cells:
                run_cell(arch, shape, args.multi_pod, variant, args.out)
    else:
        run_cell(args.arch, args.shape, args.multi_pod, args.variant,
                 args.out)


if __name__ == "__main__":
    main()
