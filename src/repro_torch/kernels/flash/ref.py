"""Plain PyTorch version of K6: the reference's ``reference_attention``
(``repro.models.attention``) in float32, the oracle the kernel is held
to and the route of CPU tensors."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Masked GQA attention in f32.  q: (B,H,S,dh); k/v: (B,Hkv,S,*) ->
    (B,H,S,dv) in q's type.  Query s sees key t when ``t <= s`` (causal)
    and ``s - t < window`` (``window`` > 0); query head h reads kv head
    ``h // (H // Hkv)``."""
    B, H, S, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    m = H // Hkv
    scale = scale or 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Hkv, m, S, dh).float()
    s = torch.einsum("bgmsd,bgtd->bgmst", qg, k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = (kpos <= qpos if causal
            else torch.ones(S, Sk, dtype=torch.bool, device=q.device))
    if window:
        mask = mask & (qpos - kpos < window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgmst,bgtd->bgmsd", p, v.float())
    return out.reshape(B, H, S, -1).to(q.dtype)
