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

Under ``sharding_rules`` (a port ``Mesh``, or the dry run's recording
mesh) the path runs as JAX's jitted ``prefill`` and ``decode_step`` lay it
out under the same rules. ``init_cache`` gives this rank's part of the
cache, each leaf cut by its logical axes (``CACHE_LOGICAL``, JAX's
``cache_logical``): its rows over ``act_batch``, the K/V positions over
``act_kv_seq`` (decode_32k's and long_500k's rules split them), and
``"layout"`` (a ``sharding.CacheLayout``) says where it lies. The caller
takes the cache's rows, as the train step's caller takes its rows:
``prefill`` is given the cache's layout (``sharding.cache_layout`` of the
whole batch) and its rows of the prompts (tokens, frames, or patches and
tokens), ``decode_step`` the tokens of the cache's rows; both return the
logits of those rows. Under the ``default`` preset the prefill's residual
stream runs sequence-parallel over the positions the model embeds
(``sharding.SeqParallel``; a rank's frames, or its part of the patches
and tokens), the MLP and the RWKV channel mix over their ``d_ff`` slice,
the RWKV time mix and the SSM heads over the rank's heads of their state
(``wkv`` and ``ssm`` over ``act_heads``, the token-shift carry whole),
and the logits come from this rank's slice of the vocabulary, gathered.
A tick's one position is computed on every model rank, the partial sums
``psum``-ed. Where the cache's positions split over ranks, each rank
attends its slice and the ranks combine their online-softmax states
(``models/layers.py``). ``check_serve_rules`` says which rules the path
runs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models import layers as L
from repro_torch.models.model import (ModelConfig, _apply_block, _tree, embed_inputs,
                                      logits_from_hiddens, sequence_layout)

# each cache leaf's logical axes, by its name (JAX's ``_cache_leaf_logical``)
CACHE_LOGICAL = {
    "k": ("act_batch", "act_kv_seq", "act_kv_heads", None),
    "v": ("act_batch", "act_kv_seq", "act_kv_heads", None),
    "wkv": ("act_batch", "act_heads", None, None),
    "ssm": ("act_batch", "act_heads", None, None),
    "shift": ("act_batch", None, None),
}


def check_serve_rules(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless the serve path runs the active
    ``sharding_rules`` for ``cfg``'s model: ``sharding.check_rules`` for its
    family and frontend (the ``fsdp`` layout, and the ``default`` one for
    every family, with or without a frontend), and no MoE: a decode tick's
    dropless groups are its rows, which the train step's expert layout does
    not cover."""
    act = sh.active()
    if act is None:
        return
    sh.check_rules(*act, cfg.family, cfg.frontend, cfg.moe_local_groups)
    if cfg.family == "moe":
        raise ValueError(f"{cfg.name}: sharded serving of the moe family: the dropless decode's "
                         "groups are a tick's rows and the prefill's its prompts, whose expert "
                         "parallelism the port has not laid out (ROADMAP.md A14s)")


def _layer_cache(cfg: ModelConfig, B: int, max_seq: int, device,
                 dense_override: bool = False) -> Dict[str, Any]:
    """One block's zero cache for a batch of B sequences of up to max_seq:
    under ``sharding_rules`` each leaf this rank's part (``CACHE_LOGICAL``)."""
    act = sh.active()

    def zeros(name, shape, dtype):
        if act is not None:
            shape = sh.leaf_sharding(shape, CACHE_LOGICAL[name], *act).local_shape
        return torch.zeros(shape, dtype=dtype, device=device)

    dt = cfg.dtype
    fam = "dense" if dense_override else cfg.family
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    c: Dict[str, Any] = {}
    if fam in ("dense", "audio", "vlm", "moe", "hybrid"):
        c["attn"] = {"k": zeros("k", (B, max_seq, Hkv, Dh), dt),
                     "v": zeros("v", (B, max_seq, Hkv, Dh), dt)}
    if fam == "hybrid":
        c["ssm"] = zeros("ssm", (B, H, D // H, cfg.ssm_state), torch.float32)
    if fam == "ssm":
        c["time"] = {"shift": zeros("shift", (B, 1, D), dt),
                     "wkv": zeros("wkv", (B, H, D // H, D // H), torch.float32)}
        c["channel"] = {"shift": zeros("shift", (B, 1, D), dt)}
    return c


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, device=None) -> Dict[str, Any]:
    """A zero cache at index 0 on ``device`` for ``batch_size`` sequences of
    up to ``max_seq`` positions; under ``sharding_rules`` this rank's part
    of it, with its ``"layout"``."""
    cache: Dict[str, Any] = {
        "layers": [_layer_cache(cfg, batch_size, max_seq, device)
                   for _ in range(cfg.num_layers - cfg.first_k_dense)],
        "index": 0,
    }
    if cfg.first_k_dense:
        cache["first"] = [_layer_cache(cfg, batch_size, max_seq, device, dense_override=True)
                          for _ in range(cfg.first_k_dense)]
    kv = sh.cache_layout(batch_size, max_seq)
    if kv is not None:
        cache["layout"] = kv
    return cache


def _run_with_cache(cfg: ModelConfig, params, cache, x: torch.Tensor,
                    sp: Optional[sh.SeqParallel] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Push S new input embeddings (B, S, D) through the stack at positions
    ``index + arange(S)``, updating the cache → (final-normed hiddens, cache).
    ``sp``: x holds this rank's positions ``[sp.start, sp.stop)`` of the
    ``sp.length`` new ones."""
    params = _tree(params)
    B, S, _ = x.shape
    idx = cache["index"]
    start = idx + (sp.start if sp is not None else 0)
    positions = (start + torch.arange(S, dtype=torch.int32, device=x.device)).expand(B, S)
    is_local = cfg.is_local_pattern()
    kv = cache.get("layout")
    new_cache: Dict[str, Any] = {"index": idx + (sp.length if sp is not None else S)}
    if kv is not None:
        new_cache["layout"] = kv
    if cfg.first_k_dense:
        firsts = []
        for p, c in zip(params["first_blocks"], cache["first"]):
            x, nc = _apply_block(cfg, p, x, positions, False, dense_override=True,
                                 cache=c, cache_index=idx, sp=sp, kv=kv)
            firsts.append(nc)
        new_cache["first"] = firsts
    layers = []
    for i, (p, c) in enumerate(zip(params["blocks"], cache["layers"])):
        x, nc = _apply_block(cfg, p, x, positions, bool(is_local[cfg.first_k_dense + i]),
                             cache=c, cache_index=idx, sp=sp, kv=kv)
        layers.append(nc)
    new_cache["layers"] = layers
    return L.rms_norm(x, params["final_norm"], cfg.rms_eps), new_cache


def _last_position(h: torch.Tensor, sp: Optional[sh.SeqParallel]) -> torch.Tensor:
    """The hiddens (B, 1, D) of the last position: under ``sp`` from the
    rank that holds it (a psum of its row and the others' zeros)."""
    last = h[:, -1:, :]
    if sp is None or sp.size == 1:
        return last
    mine = last if sp.index == sp.size - 1 else torch.zeros_like(last)
    return sh.psum(mine, sp.mesh, sp.axes)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, max_seq: int,
            layout: Optional[sh.CacheLayout] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Fill a fresh cache from a prompt batch → (logits of the last
    position (B, 1, V), cache). Under ``sharding_rules`` ``layout`` is the
    cache's (``sharding.cache_layout`` of the whole batch's rows and
    ``max_seq``) and ``batch`` holds its rows (``layout.take_rows``)."""
    check_serve_rules(cfg)
    B = next(iter(batch.values())).shape[0]
    if (layout is None) != (sh.active() is None):
        raise ValueError("prefill takes the cache's layout under sharding_rules, and only "
                         "there")
    if layout is not None and B != layout.row_stop - layout.row_start:
        raise ValueError(f"prefill: {B} rows of prompts for a cache of rows "
                         f"[{layout.row_start}, {layout.row_stop})")
    sp = sequence_layout(cfg, batch)
    x, _, _ = embed_inputs(cfg, params, batch, sp)
    cache = init_cache(cfg, B if layout is None else layout.rows, max_seq, x.device)
    h, cache = _run_with_cache(cfg, params, cache, x, sp)
    return logits_from_hiddens(cfg, params, _last_position(h, sp), sp=sp), cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One autoregressive step. tokens: (B, 1) int, the cache's rows →
    (logits (B, 1, V), cache)."""
    check_serve_rules(cfg)
    sp = sequence_layout(cfg, {"tokens": tokens})
    x = sh.materialize_rows(_tree(params)["embed"], tokens.long()).to(cfg.dtype)
    h, cache = _run_with_cache(cfg, params, cache, x, sp)
    return logits_from_hiddens(cfg, params, h, sp=sp), cache
