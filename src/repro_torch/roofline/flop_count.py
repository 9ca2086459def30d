"""Op cost of the port's own steps: FLOPs, bytes, transcendentals and
the hand-written kernels' booked work.

Torch counterpart of ``repro.roofline.hlo_cost``.  The reference walks
the optimized XLA HLO text of a compiled step and multiplies ``while``
bodies by their trip counts, because ``compiled.cost_analysis()`` counts
a scanned body once.  The port emits no HLO: its steps are eager
PyTorch, and a Python loop over the layers runs every layer's
operations.  So ``OpCounter``, a ``TorchDispatchMode``, sees every aten
operator the step runs, once a call, and counts by the reference's
rules:

* ``dot_flops``: matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, SDPA) by ``torch.utils.flop_counter``'s
  formulas, two FLOPs a multiply-add;
* elementwise FLOPs, one a result element, for the operators of the
  reference's ``_ELEMENTWISE`` set (``_ELEMENTWISE`` here, by their aten
  names), and one a result element for reductions (its ``reduce``);
* ``transcendentals``, one a result element, for its
  ``_TRANSCENDENTAL`` set (with the softmax, SiLU, softplus and GELU
  operators eager PyTorch runs whole);
* ``bytes``: operands plus results of every operator that materializes a
  tensor.  Views, aliases and metadata are free, as the reference's
  ``_FREE`` set is; in-place scatters and index copies pay their update
  footprint (twice the values written, plus the indices), as its
  dynamic-update-slice rule does, and gathers twice their result plus the
  indices.  Eager PyTorch fuses nothing, so this is the eager program's
  own traffic, every intermediate written and read back, where the
  reference counts a fusion's intermediates free.

In a ``kernels.booking.repeated(n)`` block every count (operators and
booked kernels) stands for n: the dry run traces one microbatch of a
gradient-accumulation loop whose microbatches issue the same work, as
the reference multiplies a ``while`` body by its trip count.

The hand-written kernels are ``ctypes`` launches (and on fake tensors no
arithmetic at all), which no dispatch mode sees: each wrapper books its
call's ``(flops, bytes)`` from its kernel's work formula with the active
counts (``kernels.booking``), on every device, and its plain version's
own operators on the CPU are not counted.  Their FLOPs count as
``dot_flops`` (attention products and the SSD scan's contractions), and
``kernels`` keeps each one's calls, FLOPs and bytes.  Under DTensor the
counter sees each rank's local operators (per-device counts); the
operators DTensor's sharding propagation runs under its own fake mode
are not counted (while a counter is entered they run under a fake mode
of their own, as they do on real tensors), nor are those of an
operator's decomposition it propagates through on a cache miss.

``count_step_flops`` runs one step of a model under the counter:

* ``"train"``: the loss of ``LM.train_logits`` and its gradient
  (``train.steps.value_and_grad`` of ``make_loss_fn``), forward and
  backward, and under a ``remat_policy`` the forward each layer's
  checkpoint recomputes;
* ``"prefill"``: ``LM.prefill`` of a token batch
  (``train.steps.make_prefill_step``);
* ``"decode"``: one ``LM.decode_step`` over a fresh cache of ``max_len``
  positions (``train.steps.make_decode_step``).

On the CPU the matrix products outside the kernels are the plain
PyTorch ones; a decode step's plain attention (the full cache, no
projections) scores every position of its cache.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.config import TrainConfig
from repro_torch.kernels import booking
from repro_torch.train.steps import (make_decode_step, make_loss_fn,
                                     make_prefill_step, value_and_grad)

KINDS = ("train", "prefill", "decode")

# the reference's sets (roofline/hlo_cost.py), by aten operator name (an
# in-place operator's trailing "_" dropped)
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "eq", "ne",
    "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "neg", "abs", "clamp", "clamp_min",
    "clamp_max", "floor", "ceil", "round", "sign", "remainder", "fmod",
    "masked_fill", "reciprocal", "addcmul", "addcdiv", "lerp"}
_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log2", "tanh", "rsqrt", "sqrt", "pow",
    "sigmoid", "expm1", "log1p", "cos", "sin", "erf", "atan2", "silu",
    "softplus", "gelu", "_softmax", "_log_softmax", "logsumexp"}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
    "argmin", "any", "all", "var", "var_mean", "std", "norm",
    "linalg_vector_norm", "cumsum", "cumprod", "logsumexp"}
# free: metadata, aliases, uninitialised allocations, waits
_FREE = {
    "detach", "alias", "_unsafe_view", "lift_fresh", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "wait_tensor", "set", "resize", "size",
    "stride", "sym_size", "sym_stride", "sym_numel", "numel", "dim",
    "is_contiguous", "sym_is_contiguous", "storage_offset",
    "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type"}
# in-place updates: twice the values written, plus the indices
_UPDATE = {"index_put_", "_index_put_impl_", "index_copy_", "index_add_",
           "scatter_", "scatter_add_", "scatter_reduce_"}
# reads through an index: twice the result, plus the indices
_GATHER = {"index", "index_select", "gather", "embedding"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _numel(tree) -> int:
    return sum(t.numel() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


_DECOMPOSABLE: Dict = {}


def _decomposable(func) -> bool:
    """Whether an aten operator outside the FLOP formulas has a
    CompositeImplicitAutograd decomposition, which the counter runs in
    its place (as ``FlopCounterMode`` does); cached an operator."""
    known = _DECOMPOSABLE.get(func)
    if known is None:
        dk = torch._C.DispatchKey.CompositeImplicitAutograd
        known = _DECOMPOSABLE[func] = (
            func.namespace == "aten"
            and func._overloadpacket not in flop_registry
            and (dk in func.py_kernels
                 or torch._C._dispatch_has_kernel_for_dispatch_key(
                     func.name(), dk)))
    return known


_PROPAGATION = {"counters": 0, "original": None, "decomp": None}


def _propagation_apart(on: bool) -> None:
    """While a counter is entered, DTensor's sharding propagation runs its
    operator on global-shape fake tensors under a fake mode of its own.
    It takes the fake mode it finds active: on real tensors none, so its
    own, which the counter and ``LivePeak`` skip; in a dry run the dry
    run's, where its global-shape tensors would count as local
    operators and live tensors (and only on a propagation cache miss).
    Where torch propagates an operator through its decomposition (on
    meta tensors, over a mesh of its own), those operators are not
    counted either (``booking.unseen``): they run on a cache miss only,
    so a step's first trace in a process would read more than a later
    one."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._decompositions import \
        DecompShardingStrategy
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if on:
        _PROPAGATION["counters"] += 1
        if _PROPAGATION["counters"] > 1:
            return
        original = ShardingPropagator._propagate_tensor_meta_non_cached
        _PROPAGATION["original"] = original

        def apart(self, op_schema):
            with unset_fake_temporarily():
                return original(self, op_schema)
        ShardingPropagator._propagate_tensor_meta_non_cached = apart
        decomp = DecompShardingStrategy.propagate_strategy
        _PROPAGATION["decomp"] = decomp

        def unseen(self, op_schema):
            with booking.unseen():
                return decomp(self, op_schema)
        DecompShardingStrategy.propagate_strategy = unseen
    else:
        _PROPAGATION["counters"] -= 1
        if _PROPAGATION["counters"] == 0:
            ShardingPropagator._propagate_tensor_meta_non_cached = \
                _PROPAGATION["original"]
            DecompShardingStrategy.propagate_strategy = _PROPAGATION["decomp"]


@dataclass
class CostTotals:
    """A step's counted cost (the reference's field names where they mean
    the same): ``flops`` (matrix products, elementwise operators,
    reductions and the kernels' booked FLOPs), ``dot_flops`` (products
    and kernels), ``transcendentals``, ``bytes`` (operators' operands and
    results, kernels' booked bytes), ``by_op`` FLOPs per aten operator
    and per kernel, ``kernels`` each booked kernel's ``{"calls", "flops",
    "bytes"}``, ``warnings`` operators the counter could not cost."""
    flops: float = 0.0
    dot_flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    by_op: Dict[str, float] = field(default_factory=dict)
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)


class OpCounter(TorchDispatchMode):
    """Counts every aten operator dispatched in its block and books the
    kernels' work (the module docstring's rules); ``totals()`` reads the
    count.  Enter it inside a ``FakeTensorMode`` to count a step on fake
    tensors.  ``paused`` > 0 (``kernels.booking.unseen``) stops the
    operator count for a plain version standing in for a booked
    kernel."""

    def __init__(self):
        super().__init__()
        self.paused = 0
        self._t = CostTotals()
        self._by_op: Dict[str, float] = defaultdict(float)
        self._fake_on_entry = None
        self._depth = 0          # re-entered to decompose an operator

    def __enter__(self):
        from torch._guards import active_fake_mode
        if self._depth == 0:
            self._fake_on_entry = active_fake_mode()
            booking.ACTIVE.append(self)
            _propagation_apart(True)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            booking.ACTIVE.remove(self)
            _propagation_apart(False)
        return super().__exit__(*exc)

    def book_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of hand-written kernel ``name`` (``booking.repeat()``
        of them in a ``booking.repeated`` block)."""
        r = booking.repeat()
        k = self._t.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                              "bytes": 0.0})
        k["calls"] += r
        k["flops"] += flops * r
        k["bytes"] += nbytes * r
        self._t.flops += flops * r
        self._t.dot_flops += flops * r
        self._t.bytes += nbytes * r
        self._by_op[name] += flops * r

    def totals(self) -> CostTotals:
        """The count so far."""
        t = self._t
        return CostTotals(flops=t.flops, dot_flops=t.dot_flops,
                          transcendentals=t.transcendentals, bytes=t.bytes,
                          by_op=dict(self._by_op),
                          kernels={k: dict(v) for k, v in t.kernels.items()},
                          warnings=list(t.warnings))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        # a DTensor's operator desugars into local operators (and
        # collectives), which come back here
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        if _decomposable(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self.paused and active_fake_mode() is self._fake_on_entry:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        t = self._t
        if func.namespace not in ("aten", "_c10d_functional", "c10d"):
            return
        name = func._overloadpacket.__name__
        base = name.rstrip("_")
        if func.is_view or name in _FREE or base in _FREE:
            return
        r = booking.repeat()
        if func._overloadpacket in flop_registry:
            f = flop_registry[func._overloadpacket](*args, **kwargs,
                                                    out_val=out) * r
            t.flops += f
            t.dot_flops += f
            self._by_op[str(func._overloadpacket)] += f
        elif base in _TRANSCENDENTAL:
            t.transcendentals += _numel(out) * r
            if base in _REDUCE:
                t.flops += _numel(out) * r
                self._by_op[str(func._overloadpacket)] += _numel(out) * r
        elif base in _ELEMENTWISE or base in _REDUCE:
            t.flops += _numel(out) * r
            self._by_op[str(func._overloadpacket)] += _numel(out) * r
        if name in _UPDATE:
            if base.startswith(("index_put", "_index_put")):
                idx, vals = args[1], args[2]        # (self, indices, values)
            else:                                   # (self, dim, index, src)
                idx = args[2]
                vals = args[3] if len(args) > 3 and isinstance(
                    args[3], torch.Tensor) else None
            written = (_nbytes(vals) if vals is not None
                       else _numel(idx) * args[0].element_size())
            t.bytes += (2 * written + _nbytes(idx)) * r
        elif base in _GATHER:
            idx = args[2] if base in ("index_select", "gather") else args[1]
            t.bytes += (2 * _nbytes(out) + _nbytes(idx)) * r
        elif name == "copy_":
            t.bytes += (_nbytes(args[0]) + _nbytes(args[1])) * r
        else:
            t.bytes += (_nbytes((args, kwargs)) + _nbytes(out)) * r


class LivePeak(TorchDispatchMode):
    """The peak bytes of live storages in its block, a device, under
    ``OpCounter``'s rule: a DTensor's operator desugars into local ones
    and only those are seen, and the operators of DTensor's sharding
    propagation (global shapes, under a fake mode of their own while this
    is entered) are not.  ``track(*tensors)`` counts tensors made before
    the block (a step's local inputs) live from then on; a storage leaves
    the count when it is freed.  ``peak`` is the largest of the devices'
    peaks, meta tensors (shapes only) left out.  On fake tensors this is
    what the step would allocate."""

    def __init__(self):
        super().__init__()
        self.live: Dict[str, int] = defaultdict(int)
        self.peaks: Dict[str, int] = defaultdict(int)
        self._refs: Dict = {}
        self._fake_on_entry = None

    @property
    def peak(self) -> int:
        return max(self.peaks.values(), default=0)

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_on_entry = active_fake_mode()
        _propagation_apart(True)
        return super().__enter__()

    def __exit__(self, *exc):
        _propagation_apart(False)
        return super().__exit__(*exc)

    def track(self, *tensors: torch.Tensor) -> None:
        """Count ``tensors``' storages live from now on."""
        for t in tensors:
            if t.device.type == "meta":
                continue
            st = t.untyped_storage()
            key = StorageWeakRef(st)
            if key in self._refs:
                continue
            dev, n = str(t.device), st.nbytes()
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, dev=dev, n=n: self._freed(key, dev, n))
            self.live[dev] += n
            self.peaks[dev] = max(self.peaks[dev], self.live[dev])

    def _freed(self, key, dev: str, n: int) -> None:
        if self._refs.pop(key, None) is not None:
            self.live[dev] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        fake = active_fake_mode()
        if (func is torch.ops._c10d_functional.wait_tensor.default
                and fake is not None):
            # eager waits in place; the fake kernel returns a new tensor
            return args[0]
        out = func(*args, **(kwargs or {}))
        if fake is self._fake_on_entry:
            self.track(*(t for t in tree_flatten(out)[0]
                         if isinstance(t, torch.Tensor)))
        return out


def count_step_flops(model, params, kind: str, tokens: np.ndarray,
                     projections=None, max_len: int = 0) -> CostTotals:
    """Count one ``kind`` step of ``model`` (an ``LM``) at ``params``.
    ``tokens``: (B, S) int32, the batch of a train or prefill step (its
    own labels in training), or (B, 1) the tokens of a decode step at the
    last position of its cache.  ``projections``: solved
    ``ModelProjections`` for the compressed prefill and decode.
    ``max_len``: the prefill's cache length (default S) or the decode
    cache's."""
    if kind not in KINDS:
        raise ValueError(f"unknown step kind {kind!r} (known: {KINDS})")
    tokens = np.asarray(tokens, np.int32)
    proj = (model.projections_pytree(projections)
            if projections is not None else None)
    if kind == "train":
        loss_fn = make_loss_fn(model, TrainConfig())

        def run():
            value_and_grad(loss_fn, params,
                           {"tokens": tokens, "labels": tokens})
    elif kind == "prefill":
        step = make_prefill_step(model, max_len or tokens.shape[1],
                                 compressed=proj is not None)
        args = (params, proj, tokens) if proj is not None \
            else (params, tokens)

        def run():
            step(*args)
    else:
        ranks = ((projections.rank_k, projections.rank_v)
                 if projections is not None else (0, 0))
        cache = model.init_cache(tokens.shape[0], max_len, ranks)
        step = make_decode_step(model, compressed=proj is not None)
        pos = max_len - 1
        args = ((params, proj, cache, tokens, pos) if proj is not None
                else (params, cache, tokens, pos))

        def run():
            step(*args)
    return count_flops(run)


def count_flops(fn: Callable[[], object]) -> CostTotals:
    """Run ``fn()`` once under an ``OpCounter`` and return its count."""
    with OpCounter() as counter:
        fn()
    return counter.totals()
