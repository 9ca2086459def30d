"""Plain PyTorch version of K6: the reference's ``reference_attention``
(``repro.models.attention``) in float32, the oracle the kernel is held
to and the route of CPU tensors."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(qpos: torch.Tensor, kpos: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: the query at position ``qpos[s]`` sees the key at
    ``kpos[t]`` when ``kpos[t] <= qpos[s]`` (causal) and ``qpos[s] -
    kpos[t] < window`` (``window`` > 0)."""
    qpos, kpos = qpos[:, None], kpos[None, :]
    mask = (kpos <= qpos if causal
            else torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool,
                            device=qpos.device))
    if window:
        mask = mask & (qpos - kpos < window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None,
                        pos0_q: int = 0) -> torch.Tensor:
    """Masked GQA attention in f32.  q: (B,H,Sq,dh); k/v: (B,Hkv,Sk,*) ->
    (B,H,Sq,dv) in q's type.  Query s sits at position ``pos0_q + s`` and
    key t at t (``attention_mask``); query head h reads kv head
    ``h // (H // Hkv)``."""
    B, H, S, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    m = H // Hkv
    scale = scale or 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Hkv, m, S, dh).float()
    s = torch.einsum("bgmsd,bgtd->bgmst", qg, k.float()) * scale
    mask = attention_mask(torch.arange(S, device=q.device) + pos0_q,
                          torch.arange(Sk, device=q.device), causal=causal,
                          window=window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgmst,bgtd->bgmsd", p, v.float())
    return out.reshape(B, H, S, -1).to(q.dtype)
