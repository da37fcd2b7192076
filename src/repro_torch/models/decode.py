"""KV-cache and recurrent-state serving path: ``init_cache``, ``prefill``,
``decode_step`` — the port of the JAX package's ``models/decode.py``.

A cache is ``{"layers": [one dict a block of the stack], "index": int}``,
and for a config with ``first_k_dense`` also ``"first"``: one dense dict a
first block. A layer's dict holds what its family carries: attention
``{"k", "v"}`` of (B, max_seq, Hkv, Dh) in the params' type (dense, audio,
vlm, moe, hybrid), the SSM heads' float32 (B, H, Dh, N) state (hybrid), or
the RWKV time mix's ``{"shift" (B, 1, D), "wkv" (B, H, Dh, Dh) float32}``
and channel mix's ``{"shift"}`` (ssm). The JAX package stacks each leaf of
the stack's layers on a leading L axis and keeps ``index`` as a device
int32; here the layers are a list, the tensors live on the model's device,
and ``index`` is a host int, so a decode tick reads nothing back from the
card. A cache is consumed by the call that takes it, as the JAX serve
loop donates its cache: the K/V tensors are written in place, while the
recurrent states and ``index`` come back new, so after ``prefill`` or
``decode_step`` only the cache it returned is valid, and an older one must
not be passed again.

Attention with a cache runs the dense or chunked path, never flash, and
the RWKV and SSM states run token by token in PyTorch, as the JAX package
computes them: no kernel of the port is launched here.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.model import (ModelConfig, _apply_block, _tree, embed_inputs,
                                      logits_from_hiddens)


def _layer_cache(cfg: ModelConfig, B: int, max_seq: int, device,
                 dense_override: bool = False) -> Dict[str, Any]:
    """One block's zero cache for a batch of B sequences of up to max_seq."""
    dt = cfg.dtype
    fam = "dense" if dense_override else cfg.family
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    c: Dict[str, Any] = {}
    if fam in ("dense", "audio", "vlm", "moe", "hybrid"):
        c["attn"] = {"k": torch.zeros((B, max_seq, Hkv, Dh), dtype=dt, device=device),
                     "v": torch.zeros((B, max_seq, Hkv, Dh), dtype=dt, device=device)}
    if fam == "hybrid":
        c["ssm"] = torch.zeros((B, H, D // H, cfg.ssm_state), dtype=torch.float32,
                               device=device)
    if fam == "ssm":
        c["time"] = {"shift": torch.zeros((B, 1, D), dtype=dt, device=device),
                     "wkv": torch.zeros((B, H, D // H, D // H), dtype=torch.float32,
                                        device=device)}
        c["channel"] = {"shift": torch.zeros((B, 1, D), dtype=dt, device=device)}
    return c


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, device=None) -> Dict[str, Any]:
    """A zero cache at index 0 on ``device``."""
    cache: Dict[str, Any] = {
        "layers": [_layer_cache(cfg, batch_size, max_seq, device)
                   for _ in range(cfg.num_layers - cfg.first_k_dense)],
        "index": 0,
    }
    if cfg.first_k_dense:
        cache["first"] = [_layer_cache(cfg, batch_size, max_seq, device, dense_override=True)
                          for _ in range(cfg.first_k_dense)]
    return cache


def _run_with_cache(cfg: ModelConfig, params, cache, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Push S new input embeddings (B, S, D) through the stack at positions
    ``index + arange(S)``, updating the cache → (final-normed hiddens, cache)."""
    params = _tree(params)
    B, S, _ = x.shape
    idx = cache["index"]
    positions = (idx + torch.arange(S, dtype=torch.int32, device=x.device)).expand(B, S)
    is_local = cfg.is_local_pattern()
    new_cache: Dict[str, Any] = {"index": idx + S}
    if cfg.first_k_dense:
        firsts = []
        for p, c in zip(params["first_blocks"], cache["first"]):
            x, nc = _apply_block(cfg, p, x, positions, False, dense_override=True,
                                 cache=c, cache_index=idx)
            firsts.append(nc)
        new_cache["first"] = firsts
    layers = []
    for i, (p, c) in enumerate(zip(params["blocks"], cache["layers"])):
        x, nc = _apply_block(cfg, p, x, positions, bool(is_local[cfg.first_k_dense + i]),
                             cache=c, cache_index=idx)
        layers.append(nc)
    new_cache["layers"] = layers
    return L.rms_norm(x, params["final_norm"], cfg.rms_eps), new_cache


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, max_seq: int
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Fill a fresh cache from a whole prompt batch → (logits of the last
    position (B, 1, V), cache)."""
    x, _, _ = embed_inputs(cfg, params, batch)
    cache = init_cache(cfg, x.shape[0], max_seq, x.device)
    h, cache = _run_with_cache(cfg, params, cache, x)
    return logits_from_hiddens(cfg, params, h[:, -1:, :]), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One autoregressive step. tokens: (B, 1) int → (logits (B, 1, V), cache)."""
    x = torch.nn.functional.embedding(tokens.long(), _tree(params)["embed"]).to(cfg.dtype)
    h, cache = _run_with_cache(cfg, params, cache, x)
    return logits_from_hiddens(cfg, params, h), cache
