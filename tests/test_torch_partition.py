"""The port's parameter partition rules against the reference's, entry
for entry: ``repro_torch.sharding.partition.param_spec`` on a
``MeshConfig`` against ``repro.sharding.partition.param_spec`` on a
``jax.sharding.AbstractMesh`` of the same shape, for every leaf of the
reference's full-size abstract params of all eleven configs, on the
(16, 16) and (2, 16, 16) production meshes and the (2, 4) and (4, 2)
test meshes, with ``fsdp`` and ``serve`` each on and off; and the
serving half of ``repro_torch.launch.specs`` (the decode cache, the
KQ-SVD projections and their shardings) against ``repro.launch.specs``
on the production meshes, for the same configs.  No process group, no
device memory: the params are ``jax.eval_shape`` structs, the port's
caches and projections meta tensors."""
import dataclasses
import functools

import jax
import pytest

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.models import build_model as jax_model
from repro.launch import specs as jax_specs
from repro.sharding.partition import param_spec as jax_param_spec
from torch.distributed.tensor import Replicate

from repro_torch.config import MeshConfig
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.models import build_model
from repro_torch.sharding.partition import (clean_spec, named,
                                            param_spec, placements)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model"))]
# the ten assigned configs and the paper's own evaluation model
ARCHS = list_archs() + ["paper-llama2-7b"]


def axes_of(entry):
    """A spec entry as a tuple of axis names (None: replicated); the
    reference's ``PartitionSpec`` writes a one-name tuple as the name."""
    if entry is None:
        return None
    return entry if isinstance(entry, tuple) else (entry,)


@functools.lru_cache(maxsize=None)
def abstract_leaves(arch):
    """(path keys, shape) of every leaf of the reference's full-size
    params, the keys as the reference's ``params_shardings`` makes
    them."""
    model = jax_model(jax_config(arch))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
        out.append((keys, tuple(leaf.shape)))
    return out


def test_eleven_configs():
    assert len(ARCHS) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference(arch):
    """Every leaf, every mesh, every (fsdp, serve): the same spec."""
    n = 0
    for shape, names in MESHES:
        amesh = jax.sharding.AbstractMesh(shape, names)
        mesh = MeshConfig(shape, names)
        for fsdp in (True, False):
            for serve in (True, False):
                for keys, lshape in abstract_leaves(arch):
                    ref = tuple(map(axes_of, jax_param_spec(
                        keys, lshape, amesh, fsdp, serve)))
                    ref += (None,) * (len(lshape) - len(ref))
                    got = tuple(map(axes_of, param_spec(keys, lshape, mesh,
                                                      fsdp, serve)))
                    assert got == ref, (arch, shape, fsdp, serve, keys,
                                        lshape, got, ref)
                    n += 1
    assert n > 0


def test_named_placements_follow_the_mesh_order():
    """A spec becomes one placement a mesh dim; ("pod", "data") on one
    tensor dim shards it over both mesh dims in mesh order; a tuple
    against the mesh's order, or one mesh axis on two dims, raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshConfig((2, 16, 16), ("pod", "data", "model"))
    assert named(mesh, ("pod", "data"), "model").placements == (
        Shard(0), Shard(0), Shard(1))
    assert placements(mesh, None, None) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(mesh, ("data", "pod"), None)
    with pytest.raises(ValueError):
        placements(mesh, "model", "model")
    # the activation constraint's cleaning, as the reference's shard():
    # absent axes dropped, non-dividing entries replicated
    assert clean_spec((32, 7, 64), (("pod", "data"), "model", "gone"),
                      mesh) == (("pod", "data"), None, None)


# ---------------------------------------------------------------------------
# The serving half of specs: caches and projections
# ---------------------------------------------------------------------------

PRODUCTION = MESHES[:2]
# (batch, capacity) of the reference's decode_32k and long_500k cells
CACHE_SHAPES = ((128, 32768), (1, 524288))


def _per_layer(tree, n_layers, prefix, steps, item):
    """The reference's ``{"prefix": [...], "steps": stacked}`` tree as a
    list in layer order: ``item(node, stacked)`` of each layer's node
    (``stacked``: the node's leaves carry the scan's leading dim)."""
    out = [None] * n_layers
    for i, node in zip(prefix, tree["prefix"]):
        out[i] = item(node, False)
    if tree["steps"] is not None:
        for layer_ids in steps:      # one stacked node a sublayer
            for l, i in enumerate(layer_ids):
                out[i] = item(tree["steps"]["layers"][l], True)
    return out


def _specs_of(shardings, stacked):
    """``{leaf name: spec}`` of one layer's reference shardings, the
    stacking dim's entry dropped."""
    return {k: tuple(map(axes_of, tuple(v.spec)[int(stacked):]))
            for k, v in shardings.items()}


def _port_specs(tree, shapes):
    """``{leaf name: spec}`` of one layer's port shardings, padded to the
    leaves' ranks."""
    return {k: tuple(map(axes_of, v.spec))
            + (None,) * (len(shapes[k].shape) - len(v.spec))
            for k, v in tree.items()}


def _variants(arch):
    """(config, ranks) pairs: the full cache, KQ-SVD at the default ranks,
    and KQ-SVD over the dense int8 cache (the dry run's three variants;
    the last two only where the model has attention)."""
    jcfg = jax_config(arch)
    out = [(jcfg, (0, 0))]
    if not jcfg.attention_free:
        r = jax_specs.default_ranks(jcfg)
        out += [(jcfg, r), (dataclasses.replace(jcfg, cache_quant="int8"),
                            r)]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch):
    """``abstract_cache`` (shapes and types) and ``cache_shardings``,
    ``seq_sharded`` both ways, leaf for leaf against the reference's on
    the (16, 16) and (2, 16, 16) meshes, at the decode_32k and long_500k
    cells' batch and capacity, for the full, KQ-SVD and int8 caches."""
    n = 0
    for jcfg, ranks in _variants(arch):
        jm = jax_model(jcfg)
        model = build_model(dataclasses.replace(
            get_config(arch), cache_quant=jcfg.cache_quant), "meta")
        assert specs.default_ranks(model.cfg) == \
            jax_specs.default_ranks(jcfg)
        for batch, cap in CACHE_SHAPES:
            jcache = jax_specs.abstract_cache(jm, batch, cap, ranks)
            cache = specs.abstract_cache(model, batch, cap, ranks)
            ref_shapes = _per_layer(
                jcache, jcfg.n_layers, jm.prefix, jm.steps,
                lambda node, st: {k: (tuple(v.shape)[int(st):],
                                      str(v.dtype)) for k, v in node.items()})
            got_shapes = [{k: (tuple(v.shape),
                               str(v.dtype).replace("torch.", ""))
                           for k, v in layer.items()} for layer in cache]
            assert got_shapes == ref_shapes, (arch, batch, cap, ranks)
            for shape, names in PRODUCTION:
                amesh = jax.sharding.AbstractMesh(shape, names)
                mesh = MeshConfig(shape, names)
                for seq in (False, True):
                    jsh = jax_specs.cache_shardings(jcache, amesh,
                                                    seq_sharded=seq)
                    ref = _per_layer(jsh, jcfg.n_layers, jm.prefix, jm.steps,
                                     _specs_of)
                    sh = specs.cache_shardings(cache, mesh, seq_sharded=seq)
                    got = [_port_specs(layer, c)
                           for layer, c in zip(sh, cache)]
                    assert got == ref, (arch, batch, cap, ranks, shape, seq)
                    n += 1
    assert n > 0


def test_tinyllama_decode_cache_is_sequence_parallel():
    """Full-width tinyllama on (16, 16), compressed at the default ranks:
    its 4 kv heads do not divide the 16-way model axis, so ``kc`` and
    ``vc`` (22 layers of (16, 4, 1024, 32) here) put their sequence on
    ``model``; on (2, 16, 16) with ``seq_sharded`` the data axes join
    it."""
    model = build_model(get_config("tinyllama-1.1b"), "meta")
    cache = specs.abstract_cache(model, 16, 1024,
                                 specs.default_ranks(model.cfg))
    assert len(cache) == 22
    assert tuple(cache[0]["kc"].shape) == (16, 4, 1024, 32)
    sh = specs.cache_shardings(cache, MeshConfig((16, 16)),
                               seq_sharded=False)
    for layer in sh:
        for k in ("kc", "vc"):
            assert tuple(map(axes_of, layer[k].spec)) == (
                ("data",), None, ("model",), None)
    sh = specs.cache_shardings(
        cache, MeshConfig((2, 16, 16), ("pod", "data", "model")),
        seq_sharded=True)
    assert tuple(map(axes_of, sh[0]["kc"].spec)) == (
        None, None, ("pod", "data", "model"), None)


@pytest.mark.parametrize("arch", ARCHS)
def test_projection_shardings_match_reference(arch):
    """``abstract_projections`` (shapes and types) and
    ``projection_shardings`` layer for layer against the reference's on
    the production meshes at the default ranks (an attention-free stack
    has none in either)."""
    jcfg = jax_config(arch)
    jm = jax_model(jcfg)
    model = build_model(get_config(arch), "meta")
    ranks = jax_specs.default_ranks(jcfg)
    jproj = jax_specs.abstract_projections(jm, ranks)
    proj = specs.abstract_projections(model, ranks)
    if jcfg.attention_free:
        assert proj == [] and jproj == {"prefix": [], "steps": None}
        return
    n_pre = len(jproj["prefix"])
    ref_shapes = [{k: (tuple(v.shape), str(v.dtype)) for k, v in d.items()}
                  for d in jproj["prefix"]]
    n_body = len(model.attn_layers) - n_pre
    for j in range(n_body):
        ref_shapes.append({k: (tuple(v.shape)[1:], str(v.dtype))
                           for k, v in jproj["steps"].items()})
    got_shapes = [{k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                   for k, v in d.items()} for d in proj]
    assert got_shapes == ref_shapes
    for shape, names in PRODUCTION:
        amesh = jax.sharding.AbstractMesh(shape, names)
        jsh = jax_specs.projection_shardings(jproj, amesh)
        ref = [_specs_of(d, False) for d in jsh["prefix"]]
        ref += [_specs_of(jsh["steps"], True)] * n_body
        sh = specs.projection_shardings(proj, MeshConfig(shape, names))
        got = [_port_specs(d, p) for d, p in zip(sh, proj)]
        assert got == ref, (arch, shape)
        rep = specs.tree_replicated(proj, MeshConfig(shape, names))
        assert all(s.spec == () for d in rep for s in d.values())
        assert tuple(jax_specs.replicated(amesh).spec) == ()
        assert specs.replicated(MeshConfig(shape, names)).placements == \
            (Replicate(),) * len(shape)
