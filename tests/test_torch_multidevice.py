"""Training on a (data, model) device mesh, held to the reference.

Counterpart of ``tests/test_multidevice.py`` (which stops at its first
sharded step under this jax version).  One module-scoped fixture starts
four gloo ranks once (``RANK_SCRIPT``, one process each, meeting through
a ``FileStore`` under ``tmp_path``) and, beside them, one process on the
fake backend that builds the production meshes (``FAKE_SCRIPT``).  The
parent builds reduced tinyllama at 4 layers (float32) with the
reference's ``LM.init``, bridges the params and hands them and the
batches to the ranks in a file; while the ranks run, it computes the
reference's single-device ``make_train_step`` results (no mesh) and the
port's one-process ``Trainer`` run.  Rank 0 writes every result of the
ranks' runs (gathered into full tensors) to a file, and each test
asserts one check:

* a (2, 2) mesh, 3 AdamW steps: loss, ``grad_norm``, the first step's
  gradients and the params after 3 steps against the reference;
* one Adafactor step and one ``grad_accum=2`` step on (2, 2);
* a (1, 4) mesh, where the rules shard the 4 query heads and replicate
  the 2 kv heads: loss and gradients of a step against the reference;
* ``Trainer(mesh=...)`` for 3 steps, a failure injected on rank 1 at step
  2 (all ranks retry from the step-2 checkpoint), against the port's
  one-process ``Trainer`` and the unfailed steps;
* its step-3 checkpoint, written on (2, 2), restored onto (4, 1) and onto
  no mesh: bit for bit the state it saved;
* the fake 256- and 512-rank production meshes: each leaf's local shape
  under ``params_shardings`` is the spec's arithmetic, and a batch of
  ``batch_specs`` keeps its rows of the data axes.

The ranks import no JAX.  Every step runs the same batch, so a retried
step reads the batch the failed one did.
"""
import dataclasses
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_model
from repro.train.steps import make_loss_fn as jax_loss_fn
from repro.train.steps import make_train_step as jax_train_step
from repro_torch import bridge, optim
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.train import Trainer
from repro_torch.train.steps import (make_loss_fn, make_train_step,
                                     value_and_grad)
from repro_torch.tree import leaves
from test_torch_train import (EPS_FREE, GRAD_TOL, LOSS_RTOL, NEAR_EPS_TOL,
                              PARAM_TOL, SMALL_G, TC)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LAYERS = 4
B, S = 8, 16

RANK_SCRIPT = r"""
import dataclasses, itertools, os, sys, time, traceback
import torch
import torch.distributed as dist

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
try:
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.partition import (is_dtensor,
                                                params_shardings, use_mesh)
    from repro_torch.train import Trainer
    from repro_torch.train.steps import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_map

    # DTensor's first use imports much of torch: done while the parent
    # writes the inputs
    mesh22 = make_local_mesh(2, 2, "cpu")
    distribute_tensor(torch.zeros(4), mesh22, [Replicate(), Replicate()])
    while not os.path.exists(os.path.join(tmp, "inputs.pt")):
        time.sleep(0.05)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              n_layers=inp["layers"])
    full = lambda tree: tree_map(
        lambda x: x.full_tensor() if is_dtensor(x) else x, tree)
    out = {}

    def steps(mesh, tc, batch, n, grads=False):
        tr = Trainer(cfg, tc, mesh=mesh, device="cpu")
        st = tr.state_from(inp["params"])
        p, o = st["params"], st["opt"]
        res = {"loss": [], "grad_norm": [], "placements": {
            k: (tuple(map(str, p["layers"][0]["attn"][k].placements)),
                tuple(p["layers"][0]["attn"][k].to_local().shape))
            for k in ("wq", "wk")}}
        with use_mesh(mesh):
            b = tr.place_batch(batch)
            if grads:
                with CommDebugMode() as comm:
                    m, g = value_and_grad(make_loss_fn(tr.model, tc), p, b)
                res["comms"] = {str(k): v for k, v in
                                comm.get_comm_counts().items()}
                res["grads"], res["grad_loss"] = full(g), float(m["loss"])
            for i in range(n):
                p, o, m = tr.train_step(p, o, b)
                res["loss"].append(float(m["loss"]))
                res["grad_norm"].append(float(m["grad_norm"]))
                if i == 0:
                    res["params1"] = full(p)
        res["params"] = full(p)
        return res

    tc = TrainConfig(**inp["tc"])
    out["adamw"] = steps(mesh22, tc, inp["batch"], 3, grads=True)

    fired = []

    def hook(step):
        if rank == 1 and step == 2 and not fired:
            fired.append(step)
            raise RuntimeError("injected failure on rank 1")

    ck = os.path.join(tmp, "ckpt")
    tr = Trainer(cfg, dataclasses.replace(tc, checkpoint_every=1),
                 ckpt_dir=ck, mesh=mesh22, failure_hook=hook, device="cpu")
    rep = tr.run(itertools.repeat(inp["batch"]), 3,
                 state=tr.state_from(inp["params"]))
    saved = full({"params": tr.state["params"], "opt": tr.state["opt"]})
    out["trainer"] = {"losses": rep.losses, "retries": rep.retries,
                      "steps_done": rep.steps_done, "state": saved}

    # elastic: the (2, 2) checkpoint onto (4, 1) and onto no mesh, into
    # abstract (meta) templates
    template = {"params": specs.abstract_params(tr.model)}
    template["opt"] = specs.abstract_opt_state(template["params"], tc)
    mesh41 = make_local_mesh(4, 1, "cpu")
    sh = params_shardings(template, mesh41, fsdp=tc.fsdp)
    sh["opt"]["step"] = None
    mgr = CheckpointManager(ck)
    on41, meta = mgr.restore(template, shardings=sh)
    out["elastic"] = {
        "step": meta["step"], "saved": saved, "on41": full(on41),
        "placements41": tuple(map(str, on41["params"]["embed"].placements)),
        "plain": mgr.restore(template)[0]}

    out["adafactor"] = steps(mesh22, dataclasses.replace(
        tc, optimizer="adafactor"), inp["batch"], 1)
    out["accum"] = steps(mesh22, dataclasses.replace(tc, grad_accum=2),
                         inp["accum_batch"], 1)
    out["mesh14"] = steps(make_local_mesh(1, 4, "cpu"), tc, inp["batch"], 0,
                          grads=True)
    if rank == 0:
        torch.save(out, os.path.join(tmp, "out.pt"))
except BaseException:
    with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
        f.write(traceback.format_exc())
    raise
finally:
    dist.destroy_process_group()
"""

FAKE_SCRIPT = r"""
import math, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (abstract_params, batch_shardings,
                                     batch_specs)
from repro_torch.models.model import build_model
from repro_torch.sharding.partition import (axis_size, dp_axes, mesh_axes,
                                            params_shardings)
from repro_torch.tree import leaves

cfg = get_config("tinyllama-1.1b")
params = abstract_params(build_model(cfg, "meta"))
batch = batch_specs(cfg, 256, 4096, with_labels=True)
for multi_pod, world in ((False, 256), (True, 512)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    sizes = mesh_axes(mesh)
    n = 0
    for (path, p), (_, sh) in zip(leaves(params),
                                  leaves(params_shardings(params, mesh,
                                                          fsdp=True))):
        axes = [() if s is None else s if isinstance(s, tuple) else (s,)
                for s in sh.spec + (None,) * (p.ndim - len(sh.spec))]
        want = tuple(d // math.prod(sizes[a] for a in ax)
                     for d, ax in zip(p.shape, axes))
        got = tuple(sh.place(p).to_local().shape)
        assert got == want, (path, p.shape, sh.spec, got, want)
        n += int(got != tuple(p.shape))
    rows = 256 // axis_size(dp_axes(mesh), mesh)
    for k, sh in batch_shardings(batch, mesh).items():
        assert tuple(sh.place(batch[k]).to_local().shape) == (rows, 4096), k
    print("MESH", tuple(mesh.shape), mesh.mesh_dim_names, len(leaves(params)),
          n, flush=True)
    dist.destroy_process_group()
"""


def _batch(rows, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (rows, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _reference(jm, jp, batch, n):
    """The reference's single-device ``make_train_step`` (no mesh) for
    ``n`` AdamW steps on one batch: losses, grad norms, learning rates,
    the params after the first and the last step (port layout), and the
    first step's gradients."""
    jtc = JaxTrainConfig(**TC)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jax_train_step(jm, jtc))
    p, s = jax.tree.map(jnp.asarray, jp), jax_optim.init_state(jp, jtc)
    port = lambda tree: bridge.params_from_jax(jax.tree.map(np.asarray,
                                                            tree))
    g = jax.jit(jax.grad(lambda q: jax_loss_fn(jm, jtc)(q, jb)[0]))(p)
    out = {"loss": [], "grad_norm": [], "lr": [], "grads": port(g)}
    for _ in range(n):
        p, s, m = step(p, s, jb)
        out.setdefault("params1", port(p))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["lr"].append(float(m["lr"]))
    out["params"] = port(p)
    return out


def _port_steps(cfg, tp, tc_kw, batch, n):
    """The port's one-process ``make_train_step`` for ``n`` steps: the
    same record as ``_reference``, and the gradients before each step
    (the masks of the params comparisons: ``test_torch_train`` takes the
    port's)."""
    model, tc = build_model(cfg, "cpu"), TrainConfig(**tc_kw)
    step, loss_fn = make_train_step(model, tc), make_loss_fn(model, tc)
    p, s = tp, optim.init_state(tp, tc, (model.prefix, model.steps))
    out = {"loss": [], "grad_norm": [], "lr": [], "masks": []}
    for _ in range(n):
        out["masks"].append(value_and_grad(loss_fn, p, batch)[1])
        p, s, m = step(p, s, batch)
        out.setdefault("params1", p)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["lr"].append(float(m["lr"]))
    out["params"] = p
    return out


def close_grads(tg, rg):
    """Each gradient leaf within GRAD_TOL of the reference's max-abs."""
    for (path, a), (_, b) in zip(leaves(tg), leaves(rg)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= GRAD_TOL * scale, path


def close_params(tp, ref, masks, lrs, label):
    """``test_torch_train.close_params`` over ``len(lrs)`` steps, on
    port-layout trees: an element is left out if its gradient was below
    SMALL_G of its leaf's max before any step, and held within
    NEAR_EPS_TOL of the steps' summed lr; after one step, the elements
    whose gradient was at least EPS_FREE of the max are held within
    PARAM_TOL too.  That bound is a one-step bound: over three steps a
    float32 gradient difference compounds past it in the one-process
    port as well."""
    rel = [[g.abs() / g.abs().max() for _, g in leaves(gs)] for gs in masks]
    for i, ((path, a), (_, b)) in enumerate(zip(leaves(tp), leaves(ref))):
        low = torch.stack([r[i] for r in rel]).min(dim=0).values
        keep = low >= SMALL_G
        np.testing.assert_allclose(a[keep].numpy(), b[keep].numpy(),
                                   rtol=PARAM_TOL["rtol"],
                                   atol=NEAR_EPS_TOL * sum(lrs),
                                   err_msg=f"{label} {path}")
        if len(lrs) == 1:
            far = low >= EPS_FREE
            np.testing.assert_allclose(a[far].numpy(), b[far].numpy(),
                                       err_msg=f"{label} {path}",
                                       **PARAM_TOL)


def _wait(procs, tmp, timeout=600):
    for p in procs:
        p.wait(timeout=timeout)
    errs = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
            if f.endswith(".err")]
    assert not errs and all(p.returncode == 0 for p in procs), \
        "\n".join(errs) or [p.returncode for p in procs]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the ranks and the fake-mesh process, hands the ranks their
    inputs, computes the references meanwhile, and returns everything."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), "4",
                               tmp], env=env) for r in range(4)]
    procs.append(subprocess.Popen([sys.executable, "-c", FAKE_SCRIPT],
                                  env=env, stdout=subprocess.PIPE, text=True))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)              # the ranks have the other cores
    try:
        jcfg = dataclasses.replace(jax_config("tinyllama-1.1b").reduced(),
                                   n_layers=LAYERS)
        jm = jax_model(jcfg)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        tp = bridge.params_from_jax(jp)
        batch, accum_batch = _batch(B, 3), _batch(2 * B, 4)
        part = os.path.join(tmp, "inputs.part")
        torch.save({"params": tp, "batch": batch, "accum_batch": accum_batch,
                    "tc": TC, "layers": LAYERS}, part)
        os.rename(part, os.path.join(tmp, "inputs.pt"))
        cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                                  n_layers=LAYERS)
        one = Trainer(cfg, TrainConfig(**TC), device="cpu")
        ref = {"reference": _reference(jm, jp, batch, 3),
               "adamw": _port_steps(cfg, tp, TC, batch, 3),
               "adafactor": _port_steps(cfg, tp,
                                        dict(TC, optimizer="adafactor"),
                                        batch, 1),
               "accum": _port_steps(cfg, tp, dict(TC, grad_accum=2),
                                    accum_batch, 1),
               "trainer": one.run(itertools.repeat(batch), 3,
                                  state=one.state_from(tp)).losses}
        fake_out = procs[-1].communicate(timeout=600)[0]
        _wait(procs[:-1], tmp)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        torch.set_num_threads(threads)
    assert procs[-1].returncode == 0, fake_out
    return {"ref": ref, "fake": fake_out,
            "out": torch.load(os.path.join(tmp, "out.pt"),
                              weights_only=False)}


def _check_steps(got, ref, masks, label):
    """Each step's loss and grad norm; the params after the first step
    and after the last (``close_params``)."""
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=1e-5)
    close_params(got["params1"], ref["params1"], masks[:1], ref["lr"][:1],
                 label)
    close_params(got["params"], ref["params"], masks, ref["lr"], label)


def test_mesh_2x2_adamw_matches_reference(run):
    """(2, 2), FSDP on the data axis and TP on the model axis: 3 AdamW
    steps' losses and grad norms, the first step's gradients, and the
    params after the first and the third step against the reference's
    single-device step."""
    got, ref = run["out"]["adamw"], run["ref"]["reference"]
    np.testing.assert_allclose(got["grad_loss"], ref["loss"][0],
                               rtol=LOSS_RTOL)
    close_grads(got["grads"], ref["grads"])
    _check_steps(got, ref, run["ref"]["adamw"]["masks"], "(2, 2) adamw")
    assert got["loss"][-1] < got["loss"][0]


def test_fsdp_gathers_at_use_and_reduce_scatters_gradients(run):
    """One forward and backward on (2, 2), its collectives counted
    (``CommDebugMode``): the parameters' data-axis shards are
    all-gathered at use, the gradients of the FSDP-sharded ones
    reduce-scattered back to their shards, and the partial sums of the
    replicated ones (and the loss) all-reduced."""
    comms = run["out"]["adamw"]["comms"]
    kinds = {k.split(".")[-1]: v for k, v in comms.items()}
    assert kinds.get("all_gather_into_tensor", 0) > 0, comms
    assert kinds.get("reduce_scatter_tensor", 0) > 0, comms
    assert kinds.get("all_reduce", 0) > 0, comms


def test_mesh_2x2_adafactor_matches_one_process(run):
    """One Adafactor step on (2, 2) (stacked statistics over sharded
    leaves) against the port's one-process step, which
    ``test_torch_losses_optim`` holds to the reference."""
    ref = run["ref"]["adafactor"]
    _check_steps(run["out"]["adafactor"], ref, ref["masks"],
                 "(2, 2) adafactor")


def test_mesh_2x2_grad_accum_matches_one_process(run):
    """grad_accum=2 on (2, 2): each microbatch the reference's rows of
    the global batch, a float32 accumulator per shard, against the
    port's one-process step (held to the reference in
    ``test_torch_train``)."""
    ref = run["ref"]["accum"]
    _check_steps(run["out"]["accum"], ref, ref["masks"],
                 "(2, 2) grad_accum=2")


def test_mesh_1x4_query_heads_sharded_kv_replicated(run):
    """4 query heads over the 4-way model axis, the 2 kv heads replicated
    (they do not divide it): each rank reads its head's kv group; loss
    and gradients against the reference."""
    got, ref = run["out"]["mesh14"], run["ref"]["reference"]
    assert got["placements"]["wq"] == (("R", "S(1)"), (64, 1, 16))
    assert got["placements"]["wk"] == (("R", "R"), (64, 2, 16))
    np.testing.assert_allclose(got["grad_loss"], ref["loss"][0],
                               rtol=LOSS_RTOL)
    close_grads(got["grads"], ref["grads"])


def test_mesh_trainer_matches_one_process_trainer(run):
    """Trainer(mesh=(2, 2)) for 3 steps against the port's one-process
    Trainer on the same params and batches."""
    got = run["out"]["trainer"]
    assert got["steps_done"] == 3
    np.testing.assert_allclose(got["losses"], run["ref"]["trainer"],
                               rtol=LOSS_RTOL)


def test_failure_on_one_rank_retries_on_all(run):
    """A failure injected on rank 1 at step 2: every rank restores the
    step-2 checkpoint and retries, ending with the unfailed run's losses
    (bit for bit) and params (to float32 rounding: the host's matrix
    products may sum in another order in another run)."""
    got, unfailed = run["out"]["trainer"], run["out"]["adamw"]
    assert got["retries"] == 1
    assert got["losses"] == unfailed["loss"]
    want = dict(leaves(unfailed["params"]))
    assert len(want) == len(leaves(got["state"]["params"]))
    for path, a in leaves(got["state"]["params"]):
        np.testing.assert_allclose(a.numpy(), want[path].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))


def test_elastic_restore_is_bit_exact(run):
    """The (2, 2) step-3 checkpoint restored onto (4, 1) (FSDP now 4-way
    on the data axis) and onto no mesh equals the saved state bit for
    bit."""
    el = run["out"]["elastic"]
    assert el["step"] == 3
    assert el["placements41"] == ("S(0)", "R")
    for restored in (el["on41"], el["plain"]):
        pairs = list(zip(leaves(restored), leaves(el["saved"])))
        assert len(pairs) == len(leaves(el["saved"]))
        for (path, a), (_, b) in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b), path


def test_production_meshes_local_shapes(run):
    """The fake 256-rank (16, 16) and 512-rank (2, 16, 16) meshes: every
    leaf of full-size tinyllama's params has the local shape its spec's
    arithmetic gives, every leaf is sharded, and a (256, 4096) batch
    keeps 256 / 16 or 256 / 32 rows a rank."""
    lines = [ln.split() for ln in run["fake"].splitlines()
             if ln.startswith("MESH")]
    assert len(lines) == 2
    for ln in lines:
        n_leaves, n_sharded = int(ln[-2]), int(ln[-1])
        assert n_leaves == 3 + 9 * 22 and n_sharded == n_leaves
