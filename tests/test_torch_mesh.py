"""Serving and training on a (data, model) device mesh for every family,
held to the reference's single-device steps.

The reference's own sharded decode (``tests/test_multidevice.py``) is held
only by lower + compile, and that test stops at its first train step under
this jax version, so this file holds the port's mesh steps to the
reference's single-device ``make_prefill_step`` / ``make_decode_step`` /
``make_train_step`` and ``moe_ffn``.  One module-scoped fixture starts
four gloo ranks once (``RANK_SCRIPT``, one process each, meeting through a
``FileStore`` under ``tmp_path``); the parent builds the reduced configs
(float32) with the reference's ``LM.init``, bridges params and solved
KQ-SVD projections (``bridge.params_from_jax``,
``bridge.projections_from_jax``) and hands them to the ranks in a file,
then computes the reference's results while the ranks run.  Rank 0 writes
the ranks' results, gathered into full tensors, to a file, and each test
asserts one check:

* compressed prefill + 4 greedy decode steps of reduced tinyllama at 4
  layers (2 kv heads) on (2, 2), where the model axis cuts the kv heads;
  on (1, 4), where it cuts the cache's sequence (each rank attends its
  span, K3's span output on the card, and the spans merge by their LSE);
  and on (4, 1) with a batch of one, ``seq_sharded``, where the data axis
  cuts the sequence: logits within ``DECODE_TOL``, equal greedy tokens,
  and the gathered cache within ``DECODE_TOL`` of the reference's; the
  same on (1, 4) for reduced danube's ring cache (its window of 16
  wrapped), on (2, 2) for reduced mamba2's conv and SSM state (cut by
  channels and heads), and for the dense int8 cache its logits within
  ``INT8_TOL``;
* one training step of reduced deepseek-v2-lite (MLA + MoE), arctic (MoE
  beside a dense residual), mamba2 (SSM), jamba (the hybrid), musicgen
  (frontend ``embeds``) and phi-3-vision (``image_embeds``) through
  ``Trainer(mesh=(2, 2))``: the loss (``LOSS_RTOL``) and every gradient
  leaf (``GRAD_TOL`` of its max-abs) against the reference's, the MoE
  configs at a capacity at which nothing drops, so that the groups (2
  here, 1 in the reference) do not change the result;
* the MoE layer on (2, 2), its two dispatch groups on the data axis and
  its experts on the model axis, at a capacity that drops tokens, against
  the reference's ``moe_ffn`` at ``n_groups=2`` on one device: outputs
  (``MOE_TOL``), ``dropped_frac`` exactly, the aux losses (``AUX_RTOL``).

The ranks import no JAX.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dropless, make_batch
from repro.optim.adamw import global_norm
from repro.config import CompressionConfig
from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_config
from repro.core.calibration import GramAccumulator
from repro.models import build_model as jax_model
from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro.train.steps import make_decode_step as jax_decode_step
from repro.train.steps import make_loss_fn as jax_loss_fn
from repro.train.steps import make_prefill_step as jax_prefill_step
from repro_torch import bridge
from repro_torch.config import MeshConfig
from repro_torch.configs import get_config
from repro_torch.launch.specs import cache_spec
from repro_torch.models import build_model
from repro_torch.sharding.partition import placements
from repro_torch.tree import leaves
from test_torch_multidevice import _wait, close_grads
from test_torch_train import LOSS_RTOL, TC

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LAYERS = 4
MAX_LEN, STEPS = 32, 4
DECODE_TOL = 2e-4        # logits and cache entries, absolute and relative
# the int8 cache over a cut sequence: each span's probabilities round to
# bf16 (before the value product, as one device rounds the whole row's)
# once normalised within the span, where one device normalises over the
# whole row; logits only (the codes of later tokens move with them)
INT8_TOL = 5e-2
# id: (arch, cache_quant, mesh shape, batch, prompt length).  tinyllama
# at 4 layers (2 kv heads): heads cut on (2, 2), the sequence cut on the
# model axis on (1, 4), on the data axis on (4, 1) with a batch of one
# (the dry run's seq_sharded); the dense int8 cache over a cut sequence;
# reduced danube's ring of 16 slots over a cut sequence, the prompt of 14
# and 4 new tokens wrapping it; mamba2's conv and SSM state, channels and
# heads cut on the model axis (no projections: its full cache is the
# state); deepseek-v2-lite's compressed latent over a cut sequence (MLA's
# absorbed decode, MoE decode)
DECODE_CASES = {
    "2x2-heads": ("tinyllama-1.1b", None, (2, 2), 4, 12),
    "1x4-sequence": ("tinyllama-1.1b", None, (1, 4), 4, 12),
    "4x1-seq-sharded": ("tinyllama-1.1b", None, (4, 1), 1, 12),
    "1x4-int8": ("tinyllama-1.1b", "int8", (1, 4), 4, 12),
    "1x4-ring": ("h2o-danube-1.8b", None, (1, 4), 4, 14),
    "2x2-ssm": ("mamba2-2.7b", None, (2, 2), 4, 12),
    "1x4-mla": ("deepseek-v2-lite-16b", None, (1, 4), 4, 12),
}
TRAIN_ARCHS = ("deepseek-v2-lite-16b", "arctic-480b", "mamba2-2.7b",
               "jamba-1.5-large-398b", "musicgen-large", "phi-3-vision-4.2b")
TRAIN_B, TRAIN_S = 4, 16
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_RTOL = 1e-5
MOE_CAPACITY = 1.0       # reduced deepseek's 4 experts, top 2: drops

RANK_SCRIPT = r"""
import dataclasses, os, sys, time, traceback
import torch
import torch.distributed as dist

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
    rank=rank, world_size=world)
try:
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.config import MoEConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_ffn
    from repro_torch.sharding.partition import (
        is_dtensor, merge_spans, named, params_shardings, place_tree,
        use_mesh)
    from repro_torch.train import Trainer
    from repro_torch.train.steps import (make_decode_step, make_loss_fn,
                                         make_prefill_step, value_and_grad)
    from repro_torch.tree import tree_map

    meshes = {(2, 2): make_local_mesh(2, 2, "cpu"),
              (1, 4): make_local_mesh(1, 4, "cpu"),
              (4, 1): make_local_mesh(4, 1, "cpu")}
    distribute_tensor(torch.zeros(4), meshes[(2, 2)],
                      [Replicate(), Replicate()])

    def load(name):
        while not os.path.exists(os.path.join(tmp, name)):
            time.sleep(0.05)
        return torch.load(os.path.join(tmp, name), weights_only=False)

    inp = load("serve.pt")
    full = lambda tree: tree_map(
        lambda x: x.full_tensor() if is_dtensor(x) else x, tree)
    out = {"decode": {}, "train": {}}

    # -- compressed prefill + greedy decode ---------------------------------
    for case, d in inp["decode"].items():
        cfg = get_config(d["arch"]).reduced()
        cfg = dataclasses.replace(cfg, n_layers=d["layers"],
                                  cache_quant=d["quant"] or cfg.cache_quant)
        model = build_model(cfg, "cpu")
        mesh = meshes[d["shape"]]
        res = {"logits": [], "tokens": []}
        with use_mesh(mesh):
            p = place_tree(d["params"], params_shardings(d["params"], mesh,
                                                         fsdp=True))
            comp = d["proj"] is not None
            proj = (place_tree(d["proj"], specs.projection_shardings(
                d["proj"], mesh)),) if comp else ()
            batch = {"tokens": torch.as_tensor(d["prompts"])}
            batch = place_tree(batch, specs.batch_shardings(batch, mesh))
            merges = merge_spans.calls
            logits, cache = make_prefill_step(model, d["max_len"], comp)(
                p, *proj, batch)
            name = next(n for n in ("kc", "cc", "s") if n in cache[0])
            res["leaf"] = (name, tuple(cache[0][name].shape),
                           tuple(map(str, cache[0][name].placements)))
            decode = make_decode_step(model, comp)
            for i in range(d["steps"]):
                lg = full(logits)[:, -1]
                res["logits"].append(lg)
                nxt = {"tokens": lg.argmax(-1)[:, None].to(torch.int32)}
                res["tokens"].append(nxt["tokens"][:, 0])
                nxt = place_tree(nxt, specs.batch_shardings(nxt, mesh))
                logits, cache = decode(p, *proj, cache, nxt["tokens"],
                                       d["prompts"].shape[1] + i)
            res["logits"].append(full(logits)[:, -1])
            res["merges"] = merge_spans.calls - merges
            res["cache"] = full(cache)
        out["decode"][case] = res

    # -- the MoE layer with drops -------------------------------------------
    mo = MoEConfig(**inp["moe"]["cfg"])
    mesh = meshes[(2, 2)]
    with use_mesh(mesh):
        pm = inp["moe"]["params"]
        pm = place_tree(pm, params_shardings({"ffn": pm}, mesh,
                                             fsdp=True)["ffn"])
        x = named(mesh, ("data",), None, None).place(inp["moe"]["x"])
        y, aux = moe_ffn(pm, x, mo, "train")
    out["moe"] = {"y": full(y), "aux": {k: float(full(v))
                                        for k, v in aux.items()}}

    # -- one training step of each family -----------------------------------
    inp = load("train.pt")
    for arch, t in inp["train"].items():
        cfg = get_config(arch).reduced()
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        tc = TrainConfig(**inp["tc"])
        mesh = meshes[(2, 2)]
        tr = Trainer(cfg, tc, mesh=mesh, device="cpu")
        st = tr.state_from(t["params"])
        with use_mesh(mesh):
            b = tr.place_batch(t["batch"])
            m, g = value_and_grad(make_loss_fn(tr.model, tc), st["params"], b)
            _, _, sm = tr.train_step(st["params"], st["opt"], b)
        out["train"][arch] = {"loss": float(m["loss"]), "grads": full(g),
                              "step_loss": float(sm["loss"]),
                              "grad_norm": float(sm["grad_norm"])}
    if rank == 0:
        torch.save(out, os.path.join(tmp, "out.pt"))
except BaseException:
    with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
        f.write(traceback.format_exc())
    raise
finally:
    dist.destroy_process_group()
"""


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _solved(jm, jp, jcfg):
    """The reference's KQ-SVD projections solved on two calibration
    batches (``test_torch_families``' recipe)."""
    acc = GramAccumulator(len(jm.attn_layers))
    rng = np.random.default_rng(5)
    for _ in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        acc.update_from_captures([_np(c) for c in jm.calibrate(jp, toks)])
    return acc.solve(CompressionConfig(method="kqsvd", epsilon=0.1),
                     jm.group_output_weights(jp))


def _decode_inputs():
    """Each decode case's bridged params and projections (the reference's
    ``LM.init`` and solve, one per config) and prompts, and the
    reference's single-device prefill + greedy decode on them (logits,
    tokens, per-layer cache)."""
    models = {}
    rng = np.random.default_rng(11)
    inputs, ref = {}, {}
    for case, (arch, quant, shape, batch, prompt) in DECODE_CASES.items():
        if (arch, quant) not in models:
            jcfg = jax_config(arch).reduced()
            layers = min(LAYERS, jcfg.n_layers)
            jcfg = dataclasses.replace(jcfg, n_layers=layers,
                                       cache_quant=quant or jcfg.cache_quant)
            jm = jax_model(jcfg)
            jp = _np(jm.init(jax.random.PRNGKey(0)))
            jproj, tproj = (), None
            if not jcfg.attention_free:
                mp = _solved(jm, jp, jcfg)
                tm = build_model(dataclasses.replace(
                    get_config(arch).reduced(), n_layers=layers), "cpu")
                jproj = (jm.projections_pytree(mp, jnp.float32),)
                tproj = tm.projections_pytree(
                    bridge.projections_from_jax(mp))
            models[(arch, quant)] = (jm, jp, jproj, layers, {
                "params": bridge.params_from_jax(jp), "proj": tproj})
        jm, jp, jproj, layers, bridged = models[(arch, quant)]
        toks = rng.integers(0, jm.cfg.vocab_size, (batch, prompt)).astype(
            np.int32)
        comp = bool(jproj)
        logits, cache = jax.jit(jax_prefill_step(jm, MAX_LEN, comp))(
            jp, *jproj, {"tokens": jnp.asarray(toks)})
        decode = jax.jit(jax_decode_step(jm, comp))
        res = {"logits": [], "tokens": []}
        for i in range(STEPS):
            lg = np.asarray(logits)[:, -1]
            res["logits"].append(lg)
            nxt = lg.argmax(-1).astype(np.int32)
            res["tokens"].append(nxt)
            logits, cache = decode(jp, *jproj, cache,
                                   jnp.asarray(nxt[:, None]), prompt + i)
        res["logits"].append(np.asarray(logits)[:, -1])
        res["cache"] = _np(list(cache["prefix"]))
        if cache["steps"] is not None:          # one layer a scan step
            layer = _np(cache["steps"]["layers"][0])
            res["cache"] += [{k: v[i] for k, v in layer.items()}
                             for i in range(layers - len(res["cache"]))]
        ref[case] = res
        inputs[case] = dict(bridged, arch=arch, quant=quant, shape=shape,
                            prompts=toks, layers=layers, max_len=MAX_LEN,
                            steps=STEPS)
    return inputs, ref


def _train_batch(cfg, seed):
    """A training batch: ``make_batch``'s inputs, labels over the tokens
    (-100 over a VLM's patches)."""
    b = {k: np.asarray(v, np.float32 if k != "tokens" else np.int32)
         for k, v in make_batch(cfg, TRAIN_B, TRAIN_S, seed).items()}
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size,
                          (TRAIN_B, TRAIN_S + cfg.num_patch_tokens))
    labels[:, :cfg.num_patch_tokens] = -100
    b["labels"] = labels.astype(np.int32)
    return b


def _train_inputs():
    """Each training arch's bridged params and batch, and the reference's
    single-device loss, gradients (port layout) and their global norm
    (the norm its ``make_train_step`` reports and clips by, over the
    loss its step takes)."""
    inputs, ref = {}, {}
    jtc = JaxTrainConfig(**TC)
    for i, arch in enumerate(TRAIN_ARCHS):
        jcfg = dropless(jax_config(arch).reduced())
        jm = jax_model(jcfg)
        jp = _np(jm.init(jax.random.PRNGKey(0)))
        batch = _train_batch(jcfg, 20 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), g = jax.jit(jax.value_and_grad(jax_loss_fn(jm, jtc),
                                                  has_aux=True))(jp, jb)
        inputs[arch] = {"params": bridge.params_from_jax(jp),
                        "batch": batch}
        ref[arch] = {"loss": float(loss),
                     "grads": bridge.params_from_jax(_np(g)),
                     "grad_norm": float(global_norm(g))}
    return inputs, ref


def _moe_inputs():
    """Reduced deepseek-v2-lite's MoE layer (4 experts, top 2, a shared
    expert) at ``MOE_CAPACITY``: its params from the reference's
    ``init_moe``, an input, and the reference's ``moe_ffn`` at
    ``n_groups=2`` on one device."""
    mo = dataclasses.replace(jax_config("deepseek-v2-lite-16b").reduced().moe,
                             capacity_factor=MOE_CAPACITY)
    d = jax_config("deepseek-v2-lite-16b").reduced().d_model
    jpm = _np(jax_init_moe(jax.random.PRNGKey(3), d, mo, jnp.float32))
    x = np.random.default_rng(4).standard_normal((8, 16, d)).astype(
        np.float32)
    y, aux = jax_moe_ffn(jpm, jnp.asarray(x), mo, "train", n_groups=2)
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else
                      bridge.to_tensor(v) for k, v in t.items()}
    inputs = {"cfg": dataclasses.asdict(mo), "params": tree(jpm),
              "x": torch.as_tensor(x)}
    return inputs, {"y": np.asarray(y),
                    "aux": {k: float(v) for k, v in aux.items()}}


def _hand(tmp, name, inputs):
    """Write the ranks' inputs under ``name`` at once (a rename)."""
    part = os.path.join(tmp, name + ".part")
    torch.save(inputs, part)
    os.rename(part, os.path.join(tmp, name))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Starts the ranks, hands them their inputs, computes the
    references meanwhile, and returns both."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r), "4",
                               tmp], env=env) for r in range(4)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)              # the ranks have the other cores
    try:
        dec_in, dec_ref = _decode_inputs()
        moe_in, moe_ref = _moe_inputs()
        _hand(tmp, "serve.pt", {"decode": dec_in, "moe": moe_in})
        train_in, train_ref = _train_inputs()
        _hand(tmp, "train.pt", {"tc": TC, "train": train_in})
        _wait(procs, tmp)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        torch.set_num_threads(threads)
    return {"ref": {"decode": dec_ref, "train": train_ref, "moe": moe_ref},
            "out": torch.load(os.path.join(tmp, "out.pt"),
                              weights_only=False)}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_mesh_decode_matches_reference(run, case):
    """Compressed prefill + 4 greedy decode steps on the mesh: every
    step's logits, the greedy tokens, and the gathered cache against the
    reference's single-device steps; the prefill's cache placed as
    ``cache_spec`` says (heads on model, sequence on model, sequence on
    data: held to the reference's rule in ``test_torch_partition``), and
    the spans merged every decode step where an axis cuts the sequence
    (one merge a layer a step).  The int8 cache's logits
    are held to ``INT8_TOL``, its tokens and codes not (module
    docstring)."""
    arch, quant, shape, batch, _ = DECODE_CASES[case]
    got, ref = run["out"]["decode"][case], run["ref"]["decode"][case]
    layers = len(ref["cache"])
    name, leaf_shape, got_pl = got["leaf"]
    mesh = MeshConfig(shape)
    spec = cache_spec(name, leaf_shape, mesh, seq_sharded=batch == 1)
    assert got_pl == tuple(map(str, placements(mesh, *spec)))
    assert got["merges"] == (0 if shape == (2, 2) else layers * STEPS)
    tol = INT8_TOL if quant == "int8" else DECODE_TOL
    for a, b in zip(got["logits"], ref["logits"]):
        assert a.shape == (batch, a.shape[-1])
        np.testing.assert_allclose(a.numpy(), b, rtol=tol, atol=tol)
    if quant == "int8":
        return
    for a, b in zip(got["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert len(got["cache"]) == layers
    for lg, lr in zip(got["cache"], ref["cache"]):
        assert set(lg) == set(lr)
        for k in lr:
            np.testing.assert_allclose(lg[k].numpy(), lr[k],
                                       rtol=DECODE_TOL, atol=DECODE_TOL,
                                       err_msg=f"{case} {k}")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_train_step_matches_reference(run, arch):
    """One step through ``Trainer(mesh=(2, 2))``: the loss and every
    gradient leaf against the reference's single-device loss and
    gradients, and the step's loss and grad norm against the ones the
    reference's ``make_train_step`` reports (the loss before the update,
    the gradients' global norm)."""
    got, ref = run["out"]["train"][arch], run["ref"]["train"][arch]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["step_loss"], ref["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=1e-4)
    assert len(leaves(got["grads"])) == len(leaves(ref["grads"]))
    close_grads(got["grads"], ref["grads"])


def test_mesh_moe_layer_with_drops_matches_reference(run):
    """The MoE layer on (2, 2) at a capacity that drops tokens: its two
    groups (one a data rank) route, assign capacity and drop as the
    reference's ``moe_ffn`` at ``n_groups=2`` does: outputs, the dropped
    fraction (exactly) and the aux losses."""
    got, ref = run["out"]["moe"], run["ref"]["moe"]
    assert ref["aux"]["dropped_frac"] > 0
    np.testing.assert_allclose(got["y"].numpy(), ref["y"], **MOE_TOL)
    assert got["aux"]["dropped_frac"] == pytest.approx(
        ref["aux"]["dropped_frac"], abs=1e-7)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(got["aux"][k], ref["aux"][k],
                                   rtol=AUX_RTOL)
