"""Logical->physical sharding rules (DP/FSDP/TP) and the serving shards.

Torch counterpart of ``repro.sharding.partition``.  A process-global
"active mesh" contextvar (``use_mesh``) lets model code place activation
constraints (``shard``) without threading the mesh through every call;
with no active mesh every helper is a no-op, so single-device code runs
the exact same model.

Conventions, as in the reference:

* ``data-parallel axes``: ("pod", "data") when present -- batch and FSDP;
* ``model axis``: "model" -- TP (heads / d_ff / vocab) and EP (experts);
* dims that don't divide the axis size are replicated, e.g. 4 kv heads
  on a 16-way model axis.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with dim names;
the rules read only its axis names and sizes, so they also take a
``repro_torch.config.MeshConfig`` (no process group needed).  A spec is
what the reference's ``PartitionSpec`` holds: one entry per tensor dim,
an axis name, a tuple of names or None.  ``named(mesh, *spec)`` turns it
into DTensor placements, one per mesh dim: a tensor dim that two mesh
axes shard (``("pod", "data")``) is cut left to right over those mesh
dims, the reference's order, so the names of one entry must follow the
mesh's own order.

Sequence-parallel decode on a mesh: a cache whose sequence dim a mesh
axis cuts (``launch.specs.cache_spec``) is attended span by span, each
rank over the positions it holds (``shard_range``), and the ranks'
softmax rows merge by their log-sum-exp over the axes that cut it
(``merge_spans``, the all-reduce of the maximum and of the weighted
sums that GSPMD inserts in the reference).

The serving half: a torch tensor lives on one device, so the sharded
serving engine's shards own their tensors outright: ``serve_devices`` is
the list of devices the shards run on, and ``slot_slice`` /
``slot_slices`` say which slice of the global slot axis each shard
serves (the reference's ``serve_mesh`` / ``slot_spec``).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import leaves, unflatten

_ACTIVE_MESH: contextvars.ContextVar[Optional[Any]] = \
    contextvars.ContextVar("repro_torch_active_mesh", default=None)

Spec = Tuple[Any, ...]


@contextlib.contextmanager
def use_mesh(mesh):
    """Context manager installing ``mesh`` as the process-global active
    mesh (``None`` deactivates, making every helper a no-op)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    """The mesh installed by ``use_mesh``, or None outside one."""
    return _ACTIVE_MESH.get()


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a ``MeshConfig``, in
    mesh order."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.shape))


def mesh_device(mesh) -> torch.device:
    """This rank's device of a ``DeviceMesh``: the current CUDA device of
    a CUDA mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def dp_axes(mesh=None) -> Tuple[str, ...]:
    """Data-parallel axis names present on the mesh (("data",) when no
    mesh is active)."""
    mesh = mesh or active_mesh()
    if mesh is None:
        return ("data",)
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def axis_size(name, mesh=None) -> int:
    """Product of the named mesh axes' sizes (1 without a mesh, and
    absent axes count as 1)."""
    mesh = mesh or active_mesh()
    if mesh is None:
        return 1
    sizes = mesh_axes(mesh)
    n = 1
    for a in (name if isinstance(name, tuple) else (name,)):
        n *= sizes.get(a, 1)
    return n


def maybe_axis(dim_size: int, name, mesh=None):
    """Return the axis name if dim_size divides its size, else None."""
    sz = axis_size(name, mesh)
    if sz > 1 and dim_size % sz == 0:
        return name
    return None


def clean_spec(shape, spec: Spec, mesh) -> Spec:
    """``spec`` against ``mesh``, as the reference's ``shard`` cleans it:
    absent axis names dropped, an entry whose axes do not divide its dim
    (or have size 1) replicated."""
    sizes = mesh_axes(mesh)
    cleaned: List[Any] = []
    for dim, s in zip(shape, spec):
        names = () if s is None else (s if isinstance(s, tuple) else (s,))
        names = tuple(n for n in names if n in sizes)
        size = 1
        for n in names:
            size *= sizes[n]
        cleaned.append(names if names and size > 1 and dim % size == 0
                       else None)
    return tuple(cleaned) + (None,) * (len(shape) - len(cleaned))


def placements(mesh, *spec) -> Tuple:
    """DTensor placements, one per mesh dim, of a spec: ``Shard(d)`` on
    every mesh dim that tensor dim ``d``'s entry names, ``Replicate``
    elsewhere.  An entry's names must follow the mesh's order (DTensor
    cuts a dim left to right over mesh dims)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for d, s in enumerate(spec):
        if s is None:
            continue
        idx = [names.index(n)
               for n in (s if isinstance(s, tuple) else (s,))]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec entry {s!r} of dim {d} does not follow "
                             f"the mesh's axis order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the reference's ``NamedSharding``.  ``place``
    turns a full tensor (the same on every rank) into its DTensor."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple:
        """The spec's DTensor placements on the mesh (``placements``)."""
        return placements(self.mesh, *self.spec)

    def place(self, t: torch.Tensor):
        """The DTensor of full tensor ``t`` under this sharding; each
        rank keeps its own slice of its copy (no communication).  A meta
        tensor stays on the meta device (shapes only)."""
        from torch.distributed.tensor import distribute_tensor
        if t.device.type != "meta":
            t = t.to(mesh_device(self.mesh))
        return distribute_tensor(t, self.mesh, self.placements,
                                 src_data_rank=None)


def named(mesh, *spec) -> NamedSharding:
    """Shorthand for ``NamedSharding(mesh, spec)``."""
    return NamedSharding(mesh, tuple(spec))


def shard(x, *spec):
    """Activation sharding constraint against the active mesh (no-op
    without one, and on a tensor that is not a DTensor).  spec entries:
    axis name, tuple of names, or None; cleaned as ``clean_spec`` says,
    then ``x`` is redistributed to it (differentiably)."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return redistributed(x, placements(x.device_mesh, *clean_spec(
        x.shape, spec, x.device_mesh)))


def gather_dp(x):
    """FSDP's gather at use: a DTensor's data-axis shards all-gathered
    (its model-axis placement kept); its gradient comes back through the
    reduce-scatter.  Anything else is returned as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    return redistributed(x, [Replicate() if names[i] in ("pod", "data")
                             else pl for i, pl in enumerate(x.placements)])


def placed_like(x, like):
    """``x`` redistributed to the placements of DTensor ``like`` (``x``
    as it is when ``like`` is not a DTensor)."""
    return redistributed(x, like.placements) if is_dtensor(like) else x


def redistributed(x, placements_):
    """DTensor ``x`` redistributed to ``placements_`` (differentiably),
    or ``x`` itself when it has them."""
    placements_ = tuple(placements_)
    if tuple(x.placements) == placements_:
        return x
    return x.redistribute(x.device_mesh, placements_)


class _GradPlaced(torch.autograd.Function):
    """Identity whose backward redistributes the gradient to given
    placements."""

    @staticmethod
    def forward(ctx, x, placements_):
        ctx.placements = placements_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return redistributed(g, ctx.placements), None


def grad_placed(x, placements_=None):
    """DTensor ``x`` as it is, its gradient redistributed to
    ``placements_`` (default: ``x``'s own) on the way back: a partial sum
    reduced there, before a view that flattens the batch into rows would
    meet it (anything else is returned as it is)."""
    if not is_dtensor(x):
        return x
    return _GradPlaced.apply(x, tuple(placements_ or x.placements))


def remap(placements_, dims: Dict[int, int]) -> Tuple:
    """Placements of a tensor laid out like another in the dims they
    share: ``Shard(dims[d])`` on each mesh dim where ``placements_`` has
    ``Shard(d)`` for a ``d`` in ``dims``, ``Replicate`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[pl.dim]) if isinstance(pl, Shard)
                 and pl.dim in dims else Replicate() for pl in placements_)


def partial_where(placements_, like) -> Tuple:
    """``placements_`` with ``Partial`` on every mesh dim where ``like``
    shards and ``placements_`` does not: the gradient placements of a
    tensor each rank reads only in part (``local_map``'s
    ``in_grad_placements``)."""
    from torch.distributed.tensor import Partial, Shard
    return tuple(Partial() if isinstance(lp, Shard) and not
                 isinstance(pl, Shard) else pl
                 for pl, lp in zip(placements_, like))


def cut_axes(x, dim: int) -> Tuple[str, ...]:
    """Names of the mesh dims that shard DTensor ``x``'s dim ``dim``, in
    mesh order (empty for a dim every rank holds whole)."""
    from torch.distributed.tensor import Shard
    dim %= x.ndim
    return tuple(n for n, pl in zip(x.device_mesh.mesh_dim_names,
                                    x.placements) if pl == Shard(dim))


def shard_range(x, dim: int) -> Tuple[int, int]:
    """``(start, length)`` of this rank's slice of DTensor ``x``'s dim
    ``dim``: the mesh dims that shard it cut it left to right, as
    ``placements`` lays them out (the rules shard only dims they
    divide)."""
    from torch.distributed.tensor import Shard
    dim %= x.ndim
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, pl in enumerate(x.placements):
        if pl == Shard(dim):
            idx = idx * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    size = x.shape[dim] // n
    return idx * size, size


def merge_spans(out: torch.Tensor, lse: torch.Tensor, mesh,
                axes: Tuple[str, ...]) -> torch.Tensor:
    """Merge the ranks' span-local softmax rows over mesh ``axes``: ``out``
    (..., R) float32 rows of this rank's span, ``lse`` (...) their
    log-sum-exp.  With ``lse* = max over ranks`` and ``w = exp(lse -
    lse*)`` the rows over the whole sequence are ``sum w out / sum w``
    (``combine_split_partials``' rule), so a rank whose span holds no
    live entry (its LSE -1e30 or -inf) weighs 0.  Two all-reduces an
    axis (the maximum, then the weighted rows with their weights in one
    buffer); every rank gets the merged rows.  Each call adds one to
    ``merge_spans.calls``."""
    import torch.distributed as dist
    mx = lse.float().clone()
    for a in axes:
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    w = torch.exp(lse.float() - mx)
    buf = torch.cat([w[..., None] * out.float(), w[..., None]], dim=-1)
    for a in axes:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.get_group(a))
    merge_spans.calls += 1
    return buf[..., :-1] / buf[..., -1:].clamp_min(1e-30)


merge_spans.calls = 0


def zeros_placed(shape, dtype, mesh, placements_):
    """A zeroed DTensor of global ``shape`` under ``placements_``, each
    rank allocating only its own shard (the rules shard only dims their
    axes divide)."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            local[pl.dim] //= mesh.size(i)
    t = torch.zeros(local, dtype=dtype, device=mesh_device(mesh))
    return DTensor.from_local(t, mesh, placements_, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (without importing DTensor for the
    plain tensors of a single-device run)."""
    return type(x).__name__ == "DTensor"


# ---------------------------------------------------------------------------
# Serving-engine data shards
# ---------------------------------------------------------------------------


def serve_devices(shards: int, device: DeviceLike = None
                  ) -> List[torch.device]:
    """The devices of a ``shards``-way sharded engine, one a shard: the
    first ``shards`` CUDA devices, or, given ``device``, that device
    ``shards`` times (the CPU tests; one card serving every shard).

    Raises ``ValueError`` when fewer CUDA devices exist than shards."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if device is not None:
        return [resolve_device(device)] * shards
    n = torch.cuda.device_count()
    if n < shards:
        raise ValueError(
            f"serve_devices needs {shards} devices, found {n} CUDA "
            f"device(s) (pass device=... to place every shard on one "
            f"device)")
    return [torch.device("cuda", i) for i in range(shards)]


def slot_slice(shard: int, per_shard: int) -> slice:
    """Shard ``shard``'s contiguous slice of the global slot axis, each
    shard owning ``per_shard`` slots."""
    return slice(shard * per_shard, (shard + 1) * per_shard)


def slot_slices(n_slots: int, shards: int) -> List[slice]:
    """The global slot axis of ``n_slots`` cut into ``shards`` equal
    contiguous slices, in shard order; raises ``ValueError`` when the
    shards do not divide it."""
    if shards < 1 or n_slots % shards:
        raise ValueError(
            f"{n_slots} slots do not split into {shards} equal shards")
    return [slot_slice(s, n_slots // shards) for s in range(shards)]


# ---------------------------------------------------------------------------
# Parameter partition rules
# ---------------------------------------------------------------------------


# model-axis dim, counted FROM THE END of the shape (robust to any number
# of leading stacking dims).  None => replicated on the model axis.
_MODEL_DIM_FROM_END = {
    "wq": -2, "wk": -2, "wv": -2,            # (D, H[kv], dh) -> head dim
    "wuk": -2, "wuv": -2,                     # (lora, H, e)   -> head dim
    "wi": -1, "wg": -1,                       # (D, ff)        -> ff dim
    "wi_e": -3, "wg_e": -3, "wo_e": -3,       # (E, D, ff)     -> expert dim
    "embed": -2,                              # (V, D)         -> vocab dim
    "lm_head": -1,                            # (D, V)         -> vocab dim
    "in_proj": -1,                            # (D, inner)
    "out_proj": -2,                           # (inner, D)
    "conv": -2,                               # (conv_dim, K)
}

# forward-contracted dim per weight: serve-mode "resident" sharding puts
# the data axes HERE instead of FSDP's largest-dim rule, so decode never
# all-gathers weights
_CONTRACT_DIM_FROM_END = {
    "wq": -3, "wk": -3, "wv": -3,             # contract D
    "wuk": -3, "wuv": -3,                     # contract lora
    "wd": -2,                                 # contract D
    "wi": -2, "wg": -2,                       # contract D
    "wi_e": -2, "wg_e": -2,                   # contract D
    "wo_e": -2,                               # contract ff
    "embed": -1,                              # shard D (row residency)
    "lm_head": -2,                            # contract D
    "in_proj": -2,                            # contract D
    "out_proj": -2,                           # contract inner
}


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               fsdp: bool, serve: bool = False) -> Spec:
    """The spec of a parameter identified by its tree path.

    TP on the model axis per ``_MODEL_DIM_FROM_END`` (``wo`` is contextual:
    attention output (H, dh, D) shards heads at -3; SwiGLU output (ff, D)
    shards ff at -2).  Data axes: ``serve`` shards the forward-contracted
    dim (resident weights, activation all-reduce); otherwise FSDP shards
    the largest remaining divisible dim (gather-at-use, reduce-scatter
    grads).  Non-divisible dims replicate.  The reference's rule, entry
    for entry."""
    path = tuple(str(k) for k in path)
    name = path[-1]
    sizes = mesh_axes(mesh)
    parts: List[Any] = [None] * len(shape)

    def setm(from_end: int):
        d = len(shape) + from_end
        if 0 <= d < len(shape) and maybe_axis(shape[d], "model", mesh):
            parts[d] = "model"

    if name == "wo":
        setm(-3 if "attn" in path else -2)
    elif name in _MODEL_DIM_FROM_END:
        setm(_MODEL_DIM_FROM_END[name])

    dp = dp_axes(mesh)
    dpsize = axis_size(dp, mesh)
    if dpsize > 1 and serve:
        tgt = -2 if name == "wo" else _CONTRACT_DIM_FROM_END.get(name)
        if tgt is not None:
            d = len(shape) + tgt
            if 0 <= d < len(shape):
                if parts[d] is None and shape[d] % dpsize == 0:
                    parts[d] = dp
                elif parts[d] == "model" and \
                        shape[d] % (dpsize * sizes["model"]) == 0:
                    parts[d] = ("model",) + dp
    if fsdp and not serve and dpsize > 1:
        order = sorted(range(len(shape)), key=lambda d: -shape[d])
        for d in order:
            if parts[d] is None and shape[d] % dpsize == 0:
                parts[d] = dp
                break
    return tuple(parts)


def params_shardings(params, mesh, fsdp: bool, serve: bool = False):
    """``NamedSharding``s for a params tree (tensors, meta tensors or
    anything with a ``shape``), one a leaf, by ``param_spec``."""
    return unflatten(params, [
        named(mesh, *param_spec(path, tuple(leaf.shape), mesh, fsdp, serve))
        for path, leaf in leaves(params)])


def place_tree(tree, shardings):
    """Each full tensor of ``tree`` placed by its ``NamedSharding``
    (``NamedSharding.place``); a leaf whose sharding is None stays as
    it is (the optimizer's host step counter)."""
    return unflatten(tree, [
        leaf if sh is None else sh.place(leaf)
        for (_, leaf), (_, sh) in zip(leaves(tree), leaves(shardings))])
