"""Three-term roofline arithmetic for the port on one NVIDIA H100.

    compute term    = FLOPs / (devices x PEAK_FLOPS)
    memory term     = bytes / (devices x HBM_BW)
    collective term = collective wire bytes per device / LINK_BW

Torch counterpart of ``repro.roofline.analysis``: ``Roofline`` (its
fields and ``finalize``), the config arithmetic ``useful_bytes_for``
(the analytic minimum of bytes a step moves), ``model_flops_for``
(6·N·D for training, 2·N·D plus attention over the cache for
inference), ``packed_pairs`` and ``summarize`` are the reference's,
unchanged.  The constants are the card's, from NVIDIA's datasheet for
the H100 SXM part at its 700 W power limit, not measured: 989e12 FLOP/s
dense bf16 (``PEAK_FLOPS``), 67e12 FLOP/s float32 outside the tensor
cores (``PEAK_FLOPS_F32``), 3.35e12 B/s of HBM3 (``HBM_BW``) and 450e9
B/s of NVLink 4 a direction (``LINK_BW``).  A card set below 700 W runs
slower under load, so a share of these peaks is stated beside the
card's power limit.

Collectives: ``count_collectives()`` is a dispatch-mode context that
counts the collectives a step issues, where the reference parses them
out of compiled HLO (``parse_collectives``): the functional collectives
(``_c10d_functional.all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single`` and their
``_coalesced`` forms), which DTensor's redistributions issue, and the
in-place ``c10d`` ones (``allreduce_`` and kin, whose tensors come in a
list and whose group is a ``ProcessGroup``), which ``merge_spans`` and
the optimizer's global norm issue.  Each is costed as the reference
costs its HLO op (raw bytes the result's, wire bytes by the ring model:
all-reduce 2(n-1)/n, reduce-scatter (n-1) times its scattered result,
all-gather and all-to-all (n-1)/n, collective-permute 1x), with n the
size of the op's own group.  One divergence: ``funcol.permute_tensor``
reaches the dispatcher as ``all_to_all_single``, so a permute is counted
as an all-to-all.

``attn_substitution``: the reference swaps its lax attention stand-in's
measured bytes for the flash kernel's analytic traffic.  The port's K6
books its own traffic by formula (``kernels.flash.flash_work``), so
nothing is swapped (``hlo_bytes_kernel`` equals ``hlo_bytes``), and the
count it returns is the K6 passes booked a device.  ``Roofline``'s
``hlo_flops`` / ``hlo_bytes`` keep their names: in the port they are the
op count of ``roofline.flop_count``.
"""
from __future__ import annotations

import contextlib
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import booking

PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s, H100 SXM
PEAK_FLOPS_F32 = 67e12       # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s, one direction


@dataclass
class CollectiveStats:
    wire_bytes: float = 0.0               # per device, cost-model adjusted
    raw_bytes: float = 0.0                # per device, sum of result shapes
    count: int = 0
    by_op: Dict[str, float] = field(default_factory=dict)
    top: List[Tuple[str, float]] = field(default_factory=list)
    count_by_op: Dict[str, int] = field(default_factory=dict)   # calls

    def add(self, op: str, raw: float, n: int) -> None:
        """One collective ``op`` (the reference's HLO name) over a group
        of ``n`` with ``raw`` result bytes, costed as
        ``parse_collectives`` costs it; ``booking.repeat()`` of them in a
        ``kernels.booking.repeated`` block, where ``top`` still lists the
        one operation, as the reference's HLO list does."""
        if raw == 0 or n <= 1:
            return
        if op == "all-reduce":
            wire = 2.0 * (n - 1) / n * raw
        elif op == "reduce-scatter":
            wire = float(n - 1) * raw            # raw is the scattered out
        elif op in ("all-gather", "all-to-all"):
            wire = (n - 1) / n * raw
        else:                                     # collective-permute
            wire = float(raw)
        r = booking.repeat()
        self.count += r
        self.raw_bytes += raw * r
        self.wire_bytes += wire * r
        self.by_op[op] = self.by_op.get(op, 0.0) + wire * r
        self.count_by_op[op] = self.count_by_op.get(op, 0) + r
        self.top.append((f"{op} {raw/1e6:.1f}MB n={n}", wire))


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _group_size(group) -> int:
    """The size of a collective's group: a ``ProcessGroup`` or the name
    the functional collectives carry."""
    import torch.distributed as dist
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(group)
    elif not isinstance(group, dist.ProcessGroup):      # the boxed object
        group = dist.ProcessGroup.unbox(group)
    return group.size()


# functional collectives: (HLO name, index of the group argument)
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", 2), "all_reduce_": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "all_reduce_coalesced_": ("all-reduce", 2),
    "all_gather_into_tensor": ("all-gather", 2),
    "all_gather_into_tensor_out": ("all-gather", 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "reduce_scatter_tensor_out": ("reduce-scatter", 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
}
# in-place c10d collectives: (HLO name, index of the result tensors, index
# of the ProcessGroup)
_INPLACE = {
    "allreduce_": ("all-reduce", 0, 1),
    "allreduce_coalesced_": ("all-reduce", 0, 1),
    "allgather_": ("all-gather", 0, 2),
    "_allgather_base_": ("all-gather", 0, 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 2),
    "allgather_coalesced_": ("all-gather", 0, 2),
    "reduce_scatter_": ("reduce-scatter", 0, 2),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 2),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 2),
    "alltoall_base_": ("all-to-all", 0, 2),
    "alltoall_": ("all-to-all", 0, 2),
}


class _CollectiveCounter(TorchDispatchMode):
    """Adds each collective dispatched in its block to ``stats``."""

    def __init__(self, stats: CollectiveStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in ("_c10d_functional", "_c10d_functional_autograd") \
                and name in _FUNCTIONAL:
            op, gi = _FUNCTIONAL[name]
            self.stats.add(op, _tensor_bytes(out), _group_size(args[gi]))
        elif ns == "c10d" and name in _INPLACE:
            op, ri, gi = _INPLACE[name]
            self.stats.add(op, _tensor_bytes(args[ri]),
                           _group_size(args[gi]))
        return out


@contextlib.contextmanager
def count_collectives():
    """A context that yields a ``CollectiveStats`` and counts into it, per
    device, every collective the block issues (the module docstring's
    ops and cost model); on exit ``top`` keeps the eight largest by wire
    bytes, as the reference's does."""
    stats = CollectiveStats()
    try:
        with _CollectiveCounter(stats):
            yield stats
    finally:
        stats.top = sorted(stats.top, key=lambda t: -t[1])[:8]


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    variant: str
    n_devices: int
    # raw measurements (totals across chips unless noted)
    hlo_flops: float = 0.0
    hlo_bytes: float = 0.0
    collective_wire_bytes_per_dev: float = 0.0
    model_flops: float = 0.0              # 6*N*D (active params)
    useful_bytes: float = 0.0             # analytic min traffic (total)
    hlo_bytes_kernel: float = 0.0         # after flash-kernel substitution
    # terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_memory_kernel: float = 0.0
    t_memory_projected: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    bottleneck_projected: str = ""
    useful_flops_frac: float = 0.0
    useful_bytes_frac: float = 0.0
    roofline_frac: float = 0.0            # vs stand-in bound
    roofline_frac_kernel: float = 0.0     # vs kernel-substituted bound
    roofline_frac_projected: float = 0.0  # vs projected bound
    # memory analysis (per device, bytes)
    mem_args: float = 0.0
    mem_out: float = 0.0
    mem_temp: float = 0.0
    collectives: Optional[Dict] = None

    def finalize(self):
        n = self.n_devices
        self.t_compute = self.hlo_flops / (n * PEAK_FLOPS)
        self.t_memory = self.hlo_bytes / (n * HBM_BW)
        if not self.hlo_bytes_kernel:
            self.hlo_bytes_kernel = self.hlo_bytes
        self.t_memory_kernel = self.hlo_bytes_kernel / (n * HBM_BW)
        self.t_collective = self.collective_wire_bytes_per_dev / LINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        if self.hlo_flops > 0:
            self.useful_flops_frac = self.model_flops / self.hlo_flops
        if self.hlo_bytes > 0:
            self.useful_bytes_frac = self.useful_bytes / self.hlo_bytes
        t_useful = max(self.model_flops / (n * PEAK_FLOPS),
                       self.useful_bytes / (n * HBM_BW))
        t_bound = max(terms.values())
        self.roofline_frac = (t_useful / t_bound) if t_bound > 0 else 0.0
        t_bound_k = max(self.t_compute, self.t_memory_kernel,
                        self.t_collective)
        self.roofline_frac_kernel = (t_useful / t_bound_k) \
            if t_bound_k > 0 else 0.0
        # projected bound: the counted compute and collectives with the
        # memory term at the analytic minimum (bf16, each byte once)
        self.t_memory_projected = self.useful_bytes / (n * HBM_BW)
        t_bound_p = max(self.t_compute, self.t_memory_projected,
                        self.t_collective)
        self.bottleneck_projected = max(
            {"compute": self.t_compute,
             "memory": self.t_memory_projected,
             "collective": self.t_collective}.items(),
            key=lambda kv: kv[1])[0]
        self.roofline_frac_projected = (t_useful / t_bound_p) \
            if t_bound_p > 0 else 0.0
        return self

    def to_dict(self) -> Dict:
        return asdict(self)


def useful_bytes_for(cfg, shape, variant: str) -> float:
    """Analytic minimum HBM traffic (bytes, cluster total) — the
    memory-roofline numerator.

    decode: every active parameter read once + the whole cache read once
    (+ SSM state read/write).  prefill: params + one activation stream
    read/write per layer + cache write.  train: params x (fwd+bwd reads +
    grad write + optimizer state read/write) x weight re-reads per
    microbatch + saved activations.
    """
    P = cfg.active_param_count() * 2.0                    # bf16
    B = shape.global_batch
    L_attn = sum(1 for k in cfg.layer_kinds() if k in ("attn", "mla"))
    L_ssm = sum(1 for k in cfg.layer_kinds() if k == "ssm")
    T = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    # cache bytes (whole cluster)
    if cfg.mla is not None:
        per_tok = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2.0
        if "kqsvd" in variant:
            r = cfg.mla.kv_lora_rank // 4
            per_tok = (2 * r + cfg.mla.qk_rope_dim) * 2.0
    else:
        per_tok = cfg.n_kv_heads * 2 * cfg.d_head * 2.0
        if "kqsvd" in variant:
            r = max(1, cfg.d_head // 2)
            itm = 1.0 if "int8" in variant else 2.0
            per_tok = cfg.n_kv_heads * (2 * r * itm
                                        + (4.0 if itm == 1.0 else 0.0))
    cache = L_attn * per_tok * T * B
    ssm_state = 0.0
    if cfg.ssm is not None:
        s = cfg.ssm
        d_in = s.d_inner(cfg.d_model)
        ssm_state = L_ssm * B * 2.0 * (
            s.n_heads(cfg.d_model) * s.d_state * s.head_dim * 4.0
            + (d_in + 2 * s.n_groups * s.d_state) * s.d_conv * 2.0)
    act_stream = 4.0 * shape.tokens * cfg.d_model * 2.0 * cfg.n_layers
    if shape.kind == "decode":
        return P + cache + ssm_state
    if shape.kind == "prefill":
        return P + act_stream + cache
    # train: params fwd+bwd reads, grad write, adam m/v read+write (f32)
    opt = 16.0 if cfg.param_count() <= 100e9 else 4.0     # adafactor small
    accum = 1.0
    n = cfg.param_count()
    accum = 16.0 if n > 30e9 else (4.0 if n > 8e9 else 1.0)
    return (P * (2.0 * accum + 1.0) + cfg.param_count() * opt
            + 3.0 * act_stream)


def model_flops_for(cfg, shape, variant: str) -> float:
    """MODEL_FLOPS = 6*N_active*D(tokens) for train; 2*N*D for inference."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    # decode: one new token per sequence + attention over the cache
    flops = 2.0 * n_active * shape.global_batch
    if not cfg.attention_free:
        n_attn = sum(1 for k in cfg.layer_kinds() if k in ("attn", "mla"))
        if cfg.mla is not None:
            dk = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
            dv = cfg.mla.kv_lora_rank
            heads_k = cfg.n_heads
        else:
            dk = dv = cfg.d_head
            heads_k = cfg.n_heads
        if "kqsvd" in variant and cfg.mla is None:
            dk = dv = max(1, cfg.d_head // 2)
        if "kqsvd" in variant and cfg.mla is not None:
            dk = cfg.mla.kv_lora_rank // 2 + cfg.mla.qk_rope_dim
            dv = cfg.mla.kv_lora_rank // 2
        T = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        flops += (2.0 * shape.global_batch * n_attn * heads_k * T
                  * (dk + dv))
    return flops


def packed_pairs(seq_len: int, block: int, window: int = 0) -> int:
    """Trip count of the packed-causal attention scan (attention.py)."""
    n = max(1, seq_len // min(block, seq_len))
    wb = n if not window else -(-window // min(block, seq_len))
    return sum(min(i, wb) + 1 for i in range(n))


def attn_substitution(cfg, shape, kernels: Dict[str, Dict[str, float]]):
    """The reference's kernel substitution, for the port: ``(bytes
    removed, bytes added, passes)`` a device.  K6 books its own traffic
    (``kernels``: the op count's booked kernels), so nothing is removed or
    added; ``passes`` is the K6 calls booked (0 for decode and for
    attention-free stacks, as in the reference)."""
    if cfg.attention_free or shape.kind == "decode":
        return 0.0, 0.0, 0
    return 0.0, 0.0, int(kernels.get("flash_attention", {}).get("calls", 0))


def summarize(r: Roofline) -> str:
    return (f"{r.arch:26s} {r.shape:12s} {r.variant:10s} "
            f"comp={r.t_compute*1e3:9.2f}ms mem={r.t_memory*1e3:9.2f}ms "
            f"mem_proj={r.t_memory_projected*1e3:8.2f}ms "
            f"coll={r.t_collective*1e3:8.2f}ms -> "
            f"{r.bottleneck_projected:10s} "
            f"useful={r.useful_flops_frac*100:5.1f}% "
            f"roof={r.roofline_frac_projected*100:5.1f}%")
