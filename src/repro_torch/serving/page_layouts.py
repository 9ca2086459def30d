"""Per-page byte formats of the paged KV cache, in PyTorch.

Torch counterpart of ``repro.serving.page_layouts`` (DESIGN.md
§page-layouts).  A ``PageLayout`` names the pool leaves one attention
layer needs per side (data pages plus per-token scale pools), encodes new
cache entries into those leaves and decodes gathered pages back to
float32 for the plain paths.  Every leaf is an ordinary
``(P, Hkv, page_size, width)`` pool, so the page store (``PagePool``,
``BlockTables``, ``append_token``/``append_chunk``/``gather_pages``)
moves aux pools in lockstep with their data pages with no layout-specific
code.

* ``FpLayout``: one fp leaf per side at the cache dtype;
* ``Int8Layout``: int8 data pages plus a per-token bf16 scale pool
  (``kscale``/``vscale``, width 1), the quantizer of the dense int8
  cache (``quantize_int8``); the paged decode kernel K5 dequantizes in
  registers, so device-memory reads stay int8;
* ``SvdqLayout``: per-rank bit allocation on the key side (SVDq,
  arXiv 2502.15304): the calibrated spectrum orders ranks, the leading
  ones keep 8 bits and the tail drops to 4 or 2, nibble- and
  crumb-packed into one uint8 page stride; values stay int8.  It has no
  kernel in the reference either (``kernel = None``): its decode is
  plain PyTorch.

Encoded bytes are those of the reference's encoders on the same inputs:
the scale is computed in float32 (``max(|x|, 1e-8) / 127``), the codes
are ``round(x / scale)`` (half to even) clipped to the width's range, and
only then is the scale stored as bf16.  With ``s = max|x| / 127`` and
``w_b = 127 / (2^(b-1) - 1)``, a rank stored at ``b`` bits reconstructs
within ``1.0 * s * w_b`` per component (0.5 from rounding, the rest from
storing ``s`` in bf16; tests/test_page_layouts.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

VALID_CACHE_QUANT = ("none", "int8", "svdq")

#: leaf spec: (leaf name, trailing width, dtype or None for cache dtype)
LeafSpec = Tuple[str, int, Optional[torch.dtype]]


def quantize_int8(x: torch.Tensor, dim: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization along ``dim``: returns
    (codes int8, scale bf16 without ``dim``).  The scale is computed in
    float32 and rounded to bf16 only after the codes are taken."""
    xf = x.float()
    scale = xf.abs().amax(dim=dim).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale.unsqueeze(dim)).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Sub-byte packing
# ---------------------------------------------------------------------------


def pack_nibbles(u: torch.Tensor) -> torch.Tensor:
    """Pack (..., n) uint8 values in [0, 15] two per byte ->
    (..., ceil(n/2)), the even element in the low nibble.  Odd counts are
    padded with 7 (the zero code at 4 bits)."""
    if u.shape[-1] % 2:
        u = torch.cat([u, torch.full(u.shape[:-1] + (1,), 7, dtype=u.dtype,
                                     device=u.device)], dim=-1)
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8)


def unpack_nibbles(b: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_nibbles``: (..., ceil(n/2)) bytes -> (..., n)."""
    u = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=-1)
    return u.reshape(b.shape[:-1] + (-1,))[..., :n]


def pack_crumbs(u: torch.Tensor) -> torch.Tensor:
    """Pack (..., n) uint8 values in [0, 3] four per byte ->
    (..., ceil(n/4)), element 4i + k at bits 2k.  Counts are padded to a
    multiple of 4 with 1 (the zero code at 2 bits)."""
    pad = (-u.shape[-1]) % 4
    if pad:
        u = torch.cat([u, torch.full(u.shape[:-1] + (pad,), 1,
                                     dtype=u.dtype, device=u.device)], dim=-1)
    g = u.reshape(u.shape[:-1] + (-1, 4))
    return (g[..., 0] | (g[..., 1] << 2) | (g[..., 2] << 4)
            | (g[..., 3] << 6)).to(torch.uint8)


def unpack_crumbs(b: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``pack_crumbs``: (..., ceil(n/4)) bytes -> (..., n)."""
    u = torch.stack([(b >> (2 * i)) & 0x3 for i in range(4)], dim=-1)
    return u.reshape(b.shape[:-1] + (-1,))[..., :n]


# ---------------------------------------------------------------------------
# Bit allocation (SVDq)
# ---------------------------------------------------------------------------


def default_svdq_bits(rank: int) -> Tuple[int, ...]:
    """Positional bit allocation without a spectrum: the top quarter of
    the (singular-value ordered) ranks keeps 8 bits, the next half 4, the
    tail 2."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    n8 = max(1, round(rank * 0.25))
    n4 = min(rank - n8, max(0, round(rank * 0.5)))
    n2 = rank - n8 - n4
    return (8,) * n8 + (4,) * n4 + (2,) * n2


def svdq_bits_from_spectrum(sigma, rank: Optional[int] = None,
                            thresholds: Tuple[float, float] = (0.85, 0.98)
                            ) -> Tuple[int, ...]:
    """Per-rank bits from a calibrated singular-value spectrum: ranks
    inside the leading ``thresholds[0]`` fraction of the energy (sum of
    sigma^2) keep 8 bits, ranks up to ``thresholds[1]`` get 4, the tail
    2; the first rank always keeps 8."""
    sigma = np.asarray(sigma, np.float64)
    if rank is not None:
        sigma = sigma[:rank]
    if sigma.ndim != 1 or sigma.size < 1:
        raise ValueError(f"need a non-empty 1-d spectrum, got shape "
                         f"{sigma.shape}")
    energy = sigma ** 2
    total = energy.sum()
    if total <= 0.0:
        return (8,) * sigma.size
    frac = np.cumsum(energy) / total
    t8, t4 = thresholds
    bits = tuple(8 if f <= t8 else (4 if f <= t4 else 2) for f in frac)
    if bits[0] != 8:
        bits = (8,) + bits[1:]
    return bits


def _split_bits(bits: Tuple[int, ...]) -> Tuple[int, int, int]:
    """A non-increasing {8, 4, 2} allocation -> (n8, n4, n2)."""
    if not bits or any(b not in (8, 4, 2) for b in bits) \
            or list(bits) != sorted(bits, reverse=True):
        raise ValueError(f"svdq bits must be a non-empty, non-increasing "
                         f"(spectrum-ordered) tuple of 8, 4, 2: {bits}")
    n8 = sum(1 for b in bits if b == 8)
    n4 = sum(1 for b in bits if b == 4)
    return n8, n4, len(bits) - n8 - n4


def packed_width(bits: Tuple[int, ...]) -> int:
    """Bytes per token needed to store one rank vector at ``bits``."""
    n8, n4, n2 = _split_bits(bits)
    return n8 + -(-n4 // 2) + -(-n2 // 4)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


class FpLayout:
    """The identity layout: fp pages at the cache dtype."""

    name = "fp"
    #: decode-kernel tag: "fp" (K1/K4) and "int8" (K5) have kernels;
    #: None decodes gathered pages with plain PyTorch
    kernel = "fp"

    def leaves(self, side: str, rank: int) -> Tuple[LeafSpec, ...]:
        """One data leaf per side, dtype deferred to the cache dtype."""
        return ((side + "c", rank, None),)

    def encode(self, side: str, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Identity: the pool write casts to the pool dtype."""
        return {side + "c": x}

    def decode(self, side: str, leaves: Dict[str, torch.Tensor],
               rank: int) -> torch.Tensor:
        """Identity: gathered pages are already the fp entries."""
        return leaves[side + "c"]

    def token_bytes(self, side: str, rank: int, fp_bytes: int = 2) -> int:
        """Bytes one cache entry occupies per kv head at this layout."""
        return rank * fp_bytes


class Int8Layout:
    """Int8 data pages plus per-token bf16 scale pools (width-1 leaves)."""

    name = "int8"
    kernel = "int8"

    def leaves(self, side: str, rank: int) -> Tuple[LeafSpec, ...]:
        """Data leaf (int8, width R) plus its scale leaf (bf16, width 1)."""
        return ((side + "c", rank, torch.int8),
                (side + "scale", 1, torch.bfloat16))

    def encode(self, side: str, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Quantize (..., R) entries with the dense-cache quantizer."""
        q, s = quantize_int8(x)
        return {side + "c": q, side + "scale": s[..., None]}

    def decode(self, side: str, leaves: Dict[str, torch.Tensor],
               rank: int) -> torch.Tensor:
        """Dequantize gathered pages to float32: ``q * scale``."""
        return leaves[side + "c"].float() * leaves[side + "scale"].float()

    def token_bytes(self, side: str, rank: int, fp_bytes: int = 2) -> int:
        """R int8 bytes plus one bf16 scale per entry per kv head."""
        return rank + 2


@dataclass(frozen=True)
class SvdqLayout:
    """Per-rank bit allocation on the key side; int8 on the value side.

    ``bits`` is the non-increasing per-rank allocation of the key ranks
    (``None``: ``default_svdq_bits`` at the call's rank).  The key data
    leaf is uint8 of width ``packed_width(bits)``: 8-bit ranks as biased
    bytes, 4-bit ranks nibble-packed, 2-bit ranks crumb-packed, all
    sharing the per-vector scale ``s`` with the step widened by
    ``w_b = 127 / (2^(b-1) - 1)`` so every width spans ``[-amax, amax]``.
    """

    bits: Optional[Tuple[int, ...]] = None
    name = "svdq"
    kernel = None
    _int8 = Int8Layout()

    def resolve_bits(self, rank: int) -> Tuple[int, ...]:
        """The key-side allocation at ``rank`` ranks."""
        if self.bits is None:
            return default_svdq_bits(rank)
        if len(self.bits) != rank:
            raise ValueError(f"svdq bits {self.bits} for rank {rank}")
        return self.bits

    def leaves(self, side: str, rank: int) -> Tuple[LeafSpec, ...]:
        """Packed uint8 key leaf plus scale; int8 leaves for values."""
        if side == "v":
            return self._int8.leaves(side, rank)
        return ((side + "c", packed_width(self.resolve_bits(rank)),
                 torch.uint8), (side + "scale", 1, torch.bfloat16))

    def encode(self, side: str, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Quantize and pack (..., R) entries into the page stride."""
        if side == "v":
            return self._int8.encode(side, x)
        n8, n4, n2 = _split_bits(self.resolve_bits(x.shape[-1]))
        xf = x.float()
        s = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
        q8 = torch.round(xf[..., :n8] / s[..., None]).clamp(-127, 127)
        segs = [(q8 + 127).to(torch.uint8)]
        if n4:
            step = s * (127.0 / 7.0)
            q4 = torch.round(xf[..., n8:n8 + n4] / step[..., None]).clamp(
                -7, 7)
            segs.append(pack_nibbles((q4 + 7).to(torch.uint8)))
        if n2:
            step = s * 127.0
            q2 = torch.round(xf[..., n8 + n4:] / step[..., None]).clamp(-1, 1)
            segs.append(pack_crumbs((q2 + 1).to(torch.uint8)))
        return {side + "c": torch.cat(segs, dim=-1),
                side + "scale": s.to(torch.bfloat16)[..., None]}

    def decode(self, side: str, leaves: Dict[str, torch.Tensor],
               rank: int) -> torch.Tensor:
        """Unpack and dequantize gathered key pages to float32 (..., R)."""
        if side == "v":
            return self._int8.decode(side, leaves, rank)
        n8, n4, n2 = _split_bits(self.resolve_bits(rank))
        data = leaves[side + "c"]
        s = leaves[side + "scale"].float()                      # (..., 1)
        segs = [(data[..., :n8].float() - 127.0) * s]
        off = n8
        if n4:
            w4 = -(-n4 // 2)
            u = unpack_nibbles(data[..., off:off + w4], n4)
            segs.append((u.float() - 7.0) * (s * (127.0 / 7.0)))
            off += w4
        if n2:
            u = unpack_crumbs(data[..., off:], n2)
            segs.append((u.float() - 1.0) * (s * 127.0))
        return torch.cat(segs, dim=-1)

    def token_bytes(self, side: str, rank: int, fp_bytes: int = 2) -> int:
        """Packed bytes plus the bf16 scale per entry per kv head."""
        if side == "v":
            return self._int8.token_bytes(side, rank, fp_bytes)
        return packed_width(self.resolve_bits(rank)) + 2


def get_layout(cfg):
    """The page layout a model config's ``cache_quant`` selects (``cfg``
    needs ``cache_quant`` and, for svdq, ``svdq_bits``)."""
    quant = cfg.cache_quant
    if quant == "int8":
        return Int8Layout()
    if quant == "svdq":
        return SvdqLayout(tuple(cfg.svdq_bits) or None)
    if quant != "none":
        raise ValueError(f"unknown cache_quant {quant!r} "
                         f"(one of {VALID_CACHE_QUANT})")
    return FpLayout()
