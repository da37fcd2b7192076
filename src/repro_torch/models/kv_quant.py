"""Int8 KV-cache quantization — the port of the JAX package's
``models/kv_quant.py``, bit-equal to it.

The cache at rest stores int8 payloads and per-(token, head) float32
absmax scales (1/(2·Dh) overhead: about half the bytes of a bf16 cache, a
quarter of a float32 one). Rounding is half to even in both packages
(``torch.round``, ``jnp.round``). It stands alone, as in the JAX package:
``models/decode.py`` keeps its caches in the params' type.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, Dh) → (q int8 of the same shape, scale float32 (B, S, H))."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def init_quant_cache(batch: int, max_seq: int, kv_heads: int, head_dim: int,
                     device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_seq, kv_heads, head_dim)
    return {
        "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
        "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        "v_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
    }


def update_quant_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                       v_new: torch.Tensor, index: int) -> Dict[str, torch.Tensor]:
    """Write S new KV positions at ``index``, quantized, into the cache's
    tensors in place; returns the cache."""
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    S = k_new.shape[1]
    for name, new in (("k_q", kq), ("v_q", vq), ("k_s", ks), ("v_s", vs)):
        cache[name][:, index:index + S] = new
    return cache


def read_quant_cache(cache: Dict[str, torch.Tensor], dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantize the whole cache (small contexts; the reference path)."""
    return (dequantize_kv(cache["k_q"], cache["k_s"], dtype),
            dequantize_kv(cache["v_q"], cache["v_s"], dtype))


def cache_bytes(batch: int, max_seq: int, kv_heads: int, head_dim: int,
                quantized: bool) -> int:
    """Bytes at rest of one layer's K and V cache."""
    n = batch * max_seq * kv_heads
    if quantized:
        return 2 * n * head_dim * 1 + 2 * n * 4        # int8 + f32 scales
    return 2 * n * head_dim * 2                        # bf16
