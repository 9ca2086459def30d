"""Cross-entropy with z-loss and ignore-index masking; MoE aux mixing.

Torch counterpart of ``repro.train.losses``, the same arithmetic in
float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.sharding.partition import is_dtensor, shard

IGNORE = -100


def _lse_gold(logits: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's log-partition and its label's logit."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse, gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_weight: float = 0.0) -> Tuple[torch.Tensor, Dict]:
    """logits (B,S,V) float32, labels (B,S) integer (IGNORE masks).
    Returns the mean negative log-likelihood over unmasked tokens (plus
    ``z_weight`` times the mean squared log-partition) and metrics
    ``ce``, ``tokens`` and, with a z-loss, ``z_loss``."""
    # DTensor has no rule for a gather over a sharded vocab: under a mesh
    # the logits are gathered over the model axis first
    logits = shard(logits, ("pod", "data"), None, None)
    labels = labels.long()
    mask = (labels != IGNORE).float()
    safe = labels.masked_fill(labels == IGNORE, 0)
    if is_dtensor(logits):
        # each rank on its own rows: DTensor's gather backward would
        # build a zero tensor of the global (B, S, V) logits on every rank
        from torch.distributed.tensor.experimental import local_map
        pl = logits.placements
        lse, gold = local_map(_lse_gold, out_placements=(pl, pl),
                              in_placements=(pl, pl),
                              device_mesh=logits.device_mesh,
                              redistribute_inputs=True)(logits, safe)
    else:
        lse, gold = _lse_gold(logits, safe)
    nll = (lse - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    metrics = {"ce": loss, "tokens": mask.sum()}
    if z_weight:
        zl = z_weight * ((lse * mask) ** 2).sum() / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics


def total_loss(logits, labels, aux, train_cfg, moe_cfg=None):
    """``cross_entropy`` with the config's z-loss, plus the MoE router's
    load-balance and z losses, each averaged over the ``n_moe`` MoE
    layers, when the model has a MoE config (``moe_cfg``), with metrics
    ``moe_lb``, ``moe_rz`` and ``moe_dropped``."""
    loss, metrics = cross_entropy(logits, labels, train_cfg.z_loss)
    if moe_cfg is not None and aux is not None:
        n = aux["n_moe"].clamp_min(1.0)
        lb = aux["load_balance"] / n
        rz = aux["router_z"] / n
        loss = loss + moe_cfg.router_aux_weight * lb \
            + moe_cfg.router_z_weight * rz
        metrics.update({"moe_lb": lb, "moe_rz": rz,
                        "moe_dropped": aux["dropped_frac"] / n})
    metrics["loss"] = loss
    return loss, metrics
