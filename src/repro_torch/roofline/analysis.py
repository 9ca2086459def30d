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

Not ported yet: ``parse_collectives`` / ``CollectiveStats`` and
``attn_substitution`` read the XLA HLO text of a compiled dry run, which
the port does not emit.  Training on a mesh is ported; its dry run on
placed meta tensors over a fake 256- or 512-rank group, which will count
the port's own collectives and attention passes in their place, is the
next slice (``ROADMAP.md`` queue 1).  ``Roofline``'s
``hlo_flops`` / ``hlo_bytes`` keep their names: in the port they are
whatever count the caller gives (``roofline.flop_count`` for FLOPs).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s, H100 SXM
PEAK_FLOPS_F32 = 67e12       # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s, one direction


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


def summarize(r: Roofline) -> str:
    return (f"{r.arch:26s} {r.shape:12s} {r.variant:10s} "
            f"comp={r.t_compute*1e3:9.2f}ms mem={r.t_memory*1e3:9.2f}ms "
            f"mem_proj={r.t_memory_projected*1e3:8.2f}ms "
            f"coll={r.t_collective*1e3:8.2f}ms -> "
            f"{r.bottleneck_projected:10s} "
            f"useful={r.useful_flops_frac*100:5.1f}% "
            f"roof={r.roofline_frac_projected*100:5.1f}%")
