"""The port's parameter partition rules against the reference's, entry
for entry: ``repro_torch.sharding.partition.param_spec`` on a
``MeshConfig`` against ``repro.sharding.partition.param_spec`` on a
``jax.sharding.AbstractMesh`` of the same shape, for every leaf of the
reference's full-size abstract params of all eleven configs, on the
(16, 16) and (2, 16, 16) production meshes and the (2, 4) and (4, 2)
test meshes, with ``fsdp`` and ``serve`` each on and off.  No process
group, no device memory: the params are ``jax.eval_shape`` structs."""
import functools

import jax
import pytest

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.models import build_model as jax_model
from repro.sharding.partition import param_spec as jax_param_spec
from repro_torch.config import MeshConfig
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
