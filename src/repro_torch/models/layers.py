"""Transformer building blocks: RMSNorm, RoPE, GQA attention (sliding
window, logit softcap, QKV bias, KV cache), gated MLP, and the
capacity-factor MoE.

Functional like the JAX package: every block is ``f(cfg, params, x, ...)``
with ``params`` a dict of tensors, in the JAX layouts (``wq`` (D,H,Dh),
``wk``/``wv`` (D,Hkv,Dh), ``wo`` (H,Dh,D)), so weights cross between the
packages without transposes.

Attention runs one of three backends: ``flash`` (the hand-written Hopper
kernels of ``kernels/flash_attention.py``, one forward launch per layer and
a dQ and a dK/dV launch in its backward), or the dense or KV-chunked path
as plain tensor ops, which is what the JAX package leaves to XLA outside
the flash kernel. With a KV cache (prefill into the cache and decode) it
always runs the dense or chunked path, as the JAX package does: the flash
kernels assume positions from zero. ``moe`` is the capacity-factor MoE
layer with sort-based dispatch; ``dropless=True`` (a one-token decode step)
sets each expert's capacity to the group size.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as flash_lib


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int32."""
    half = x.shape[-1] // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freq      # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),  # jax.nn.gelu
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

_FLASH_BLOCKS = (128, 64, 32, 16, 8)


def _flash_blocks(S: int, T: int):
    """Largest of the JAX kernel's tile sizes dividing the q/kv lengths
    (None = none fit) — the JAX package's block rule."""
    bq = next((b for b in _FLASH_BLOCKS if S % b == 0), None)
    bk = next((b for b in _FLASH_BLOCKS if T % b == 0), None)
    return bq, bk


def _flash_feasible(cfg, S: int, T: int) -> bool:
    """The JAX block rule plus the Hopper kernels' own limits (head dim,
    shared memory, bf16/f32). The JAX package's 12 MB VMEM guard on the
    whole K/V stream is not copied: the Hopper kernels tile KV, so T is not
    limited, and a shape the TPU would route to chunked can go to flash here."""
    bq, bk = _flash_blocks(S, T)
    return (bq is not None and bk is not None and flash_lib.supports(cfg.head_dim)
            and cfg.param_dtype in ("bfloat16", "float32"))


def resolve_attn_backend(cfg, S: int, T: int, device) -> str:
    """Training backend for this shape on ``device`` → flash | chunked | dense.

    "auto" takes flash on a CUDA device when the shape is feasible, as the
    JAX package does on the TPU, and the dense/chunked paths on the CPU (the
    plain flash version is slower there than the dense path); explicit
    "flash" runs the kernels on CUDA tensors and their plain versions on CPU
    tensors, and falls back to the chunked/dense path only when the shape is
    not feasible.
    """
    b = getattr(cfg, "attn_backend", "auto")
    chunked = "chunked" if cfg.attn_chunk and T > cfg.attn_chunk else "dense"
    if b == "dense":
        return "dense"
    if b == "chunked":
        return chunked
    if b == "flash":
        return "flash" if _flash_feasible(cfg, S, T) else chunked
    if b == "auto":
        if torch.device(device).type == "cuda" and _flash_feasible(cfg, S, T):
            return "flash"
        return chunked
    raise ValueError(f"unknown attn_backend: {b!r}")


def _flash_attention(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     is_local: bool) -> torch.Tensor:
    """One flash launch per layer. q (B,S,H,Dh) pre-scaled (kernel scale 1);
    k/v (B,S,Hkv,Dh). Streams fold head-major (a copy) so q stream i reads kv
    stream i // group without repeating K/V. Assumes contiguous from-zero
    positions (``forward_hiddens``' layout)."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]

    def fold(x, heads):
        return x.transpose(1, 2).contiguous().view(B * heads, S, Dh)

    window = cfg.sliding_window if cfg.sliding_window is not None and is_local else None
    out = flash_lib.flash_attention(
        fold(q, H), fold(k, Hkv), fold(v, Hkv), causal=True, window=window,
        softcap=cfg.attn_logit_softcap, group=H // Hkv, scale=1.0)
    return out.view(B, H, S, Dh).transpose(1, 2)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, H, K = w.shape
    return (x @ w.reshape(D, H * K)).reshape(*x.shape[:-1], H, K)


def attention(cfg, p, x: torch.Tensor, positions: torch.Tensor,
              *, is_local: bool = False, cache: Optional[dict] = None,
              cache_index: int = 0) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA attention. x: (B, S, D) → ``(out, new cache or None)``.

    Without ``cache``: self-attention over the S positions with a causal
    (+ sliding window on a local layer) mask. With ``cache`` (``{"k", "v"}``
    of (B, max_seq, Hkv, Dh)): the new keys and values are written into the
    cache IN PLACE at ``cache_index`` and the S queries attend over the
    whole cache with per-query absolute causality (and the window on a local
    layer), by dense scores, or chunked when ``attn_chunk`` is set and below
    ``max_seq``; the returned cache holds the same tensors."""
    B, S, D = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cfg.query_scale is not None:
        q = q * cfg.query_scale
    else:
        q = q / torch.tensor(math.sqrt(Dh), dtype=torch.float32,
                             device=q.device).to(q.dtype)

    new_cache = None
    if cache is not None:
        cache["k"][:, cache_index:cache_index + S] = k
        cache["v"][:, cache_index:cache_index + S] = v
        new_cache = {"k": cache["k"], "v": cache["v"]}
        k, v = cache["k"], cache["v"]
        T = k.shape[1]
        kv_pos = torch.arange(T, device=x.device)[None, :]                     # (1,T)
        q_abs = cache_index + torch.arange(S, device=x.device)[:, None]        # (S,1)
        mask = kv_pos <= q_abs                                                 # (S,T)
        if cfg.sliding_window is not None and is_local:
            mask = mask & (kv_pos > q_abs - cfg.sliding_window)
        mask = mask.expand(B, S, T)
        backend = "chunked" if cfg.attn_chunk and T > cfg.attn_chunk else "dense"
    else:
        backend = resolve_attn_backend(cfg, S, S, x.device)
        if backend == "flash":
            out = _flash_attention(cfg, q, k, v, is_local)
            return out.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, D), None
        qpos, kpos = positions[:, :, None], positions[:, None, :]
        mask = kpos <= qpos                                             # (B,S,T)
        if cfg.sliding_window is not None and is_local:
            mask = mask & (kpos > qpos - cfg.sliding_window)

    group = H // Hkv
    qg = q.reshape(B, S, Hkv, group, Dh)
    if backend == "chunked":
        out = _chunked_attention(cfg, qg, k, v, mask)
    else:
        logits = torch.einsum("bskgh,btkh->bkgst", qg, k)          # (B,Hkv,g,S,T)
        logits = softcap(logits, cfg.attn_logit_softcap)
        logits = torch.where(mask[:, None, None], logits.to(torch.float32),
                             torch.tensor(-1e30, device=x.device))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    out = out.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, D)
    return out, new_cache


def _chunked_attention(cfg, qg: torch.Tensor, k_all: torch.Tensor,
                       v_all: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``cfg.attn_chunk``.

    qg: (B,S,Hkv,g,Dh); k/v: (B,T,Hkv,Dh); mask: (B,S,T) bool. Returns
    (B,S,Hkv,g,Dh) in v's dtype. A chunk whose mask row is all false keeps
    ``m`` at -1e30 and contributes p = 0 (the masked-row guard).
    """
    B, S, Hkv, g, Dh = qg.shape
    T = k_all.shape[1]
    C = cfg.attn_chunk
    if T % C:
        raise ValueError(f"sequence {T} is not a multiple of attn_chunk {C}")
    m = torch.full((B, Hkv, g, S), -1e30, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, Hkv, g, S), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, Hkv, g, S, Dh), dtype=torch.float32, device=qg.device)
    neg = torch.tensor(-1e30, device=qg.device)
    for c0 in range(0, T, C):
        k_i, v_i, mask_i = k_all[:, c0:c0 + C], v_all[:, c0:c0 + C], mask[..., c0:c0 + C]
        s = torch.einsum("bskgh,btkh->bkgst", qg, k_i)
        s = softcap(s, cfg.attn_logit_softcap).to(torch.float32)
        s = torch.where(mask_i[:, None, None], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(m_new[..., None] > -0.5e30,
                        torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkh->bkgsh", p.to(v_i.dtype), v_i).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(v_all.dtype)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU per cfg.mlp_activation)."""
    act = _activation(cfg.mlp_activation)
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-factor dispatch, sort-based)
# ---------------------------------------------------------------------------

def moe_shapes(cfg, dtype: torch.dtype):
    """Name → (shape, dtype) of the MoE params: the router (D, E) in
    float32, the experts' (E, D, F) and (E, F, D) in the params' type."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": ((D, E), torch.float32), "w_gate": ((E, D, Fd), dtype),
            "w_up": ((E, D, Fd), dtype), "w_down": ((E, Fd, D), dtype)}


class _Route(torch.autograd.Function):
    """``out[g, i] = x[g, index[g, i]]`` where ``valid[g, i]``, else 0 —
    a row gather whose backward is a gather too: ``grad_x[g, r]`` adds
    ``grad_out[g, inv_index[g, r, m]]`` over the ``m`` with
    ``inv_valid[g, r, m]``, in float32 and in order of ``m``, then casts.
    PyTorch's own gather backward scatter-adds with atomics on the card, so
    its sums change order from run to run; this one does not."""

    @staticmethod
    def forward(ctx, x, index, valid, inv_index, inv_valid):
        ctx.save_for_backward(inv_index, inv_valid)
        ctx.dtype = x.dtype
        return _gather_rows(x, index, valid)

    @staticmethod
    def backward(ctx, grad):
        inv_index, inv_valid = ctx.saved_tensors
        g = grad.to(torch.float32)
        acc = None
        for m in range(inv_index.shape[2]):
            term = _gather_rows(g, inv_index[:, :, m], inv_valid[:, :, m])
            acc = term if acc is None else acc + term
        return acc.to(ctx.dtype), None, None, None, None


def _gather_rows(x: torch.Tensor, index: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(G, N, D) rows at (G, M) indices, zero where not ``valid``."""
    rows = torch.gather(x, 1, index[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where(valid[..., None], rows, torch.zeros((), dtype=x.dtype, device=x.device))


class Routing(NamedTuple):
    """One MoE layer's token ↔ buffer assignment over G groups of gs tokens,
    k slots a token (flat index f = token·k + slot), E experts of capacity
    C: ``gate`` (G, gs, k) float32 (normalized over the k), ``ids`` (G, gs,
    k) the experts, ``keep`` (G, gs·k) the assignments within capacity,
    ``slot_of`` (G, gs·k) the buffer slot e·C + c of each kept assignment
    (0 if dropped), ``token_of_slot`` / ``src_flat`` / ``slot_valid`` (G,
    E·C) each buffer slot's token, flat assignment and whether it is
    filled."""
    gate: torch.Tensor
    ids: torch.Tensor
    keep: torch.Tensor
    slot_of: torch.Tensor
    token_of_slot: torch.Tensor
    src_flat: torch.Tensor
    slot_valid: torch.Tensor


def moe_capacity(cfg, tokens: int, dropless: bool = False) -> Tuple[int, int]:
    """(group size, capacity per (group, expert)) for ``tokens`` tokens;
    ``dropless``: the capacity is the group size, so no token is dropped."""
    gs = min(cfg.moe_group_size, tokens)
    if dropless:
        return gs, gs
    return gs, int(gs * cfg.num_experts_per_tok / cfg.num_experts * cfg.moe_capacity_factor) + 1


def moe_groups(cfg, x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(B, S, D) → ((G, gs, D) token groups, chunk-major or not): flat by
    default; under ``moe_local_groups`` (and S a multiple of gs) contiguous
    sequence chunks ordered (chunk, batch)."""
    B, S, D = x.shape
    gs, _ = moe_capacity(cfg, B * S)
    G = B * S // gs
    if cfg.moe_local_groups and S % gs == 0 and S >= gs:
        return x.reshape(B, S // gs, gs, D).transpose(0, 1).reshape(G, gs, D), True
    return x.reshape(G, gs, D), False


def moe_routing(cfg, router: torch.Tensor, xt: torch.Tensor,
                dropless: bool = False) -> Routing:
    """The top-k routing and the sort-based dispatch plan of token groups
    ``xt`` (G, gs, D). The top k come from a stable descending sort, so
    that equal probabilities go to the lower expert index as
    ``jax.lax.top_k`` gives them; each expert's queue is a stable argsort
    of the expert ids, and the assignments past its capacity are dropped in
    queue order."""
    G, gs, _ = xt.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    _, cap = moe_capacity(cfg, G * gs, dropless)
    dev = xt.device
    logits = xt @ router.to(xt.dtype)                               # (G, gs, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    ids = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    gate = torch.gather(probs, -1, ids)
    gate = gate / (torch.sum(gate, -1, keepdim=True) + 1e-9)

    Fk = gs * k
    ids_flat = ids.reshape(G, Fk)
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, ids_flat, torch.ones_like(ids_flat))
    starts = torch.cumsum(counts, dim=1) - counts                   # (G, E) exclusive
    order = torch.argsort(ids_flat, dim=1, stable=True)
    pos_sorted = torch.arange(Fk, device=dev) - torch.gather(
        starts, 1, torch.gather(ids_flat, 1, order))
    pos_flat = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = pos_flat < cap                                           # (G, Fk)

    b_e = torch.arange(E * cap, device=dev) // cap
    b_c = torch.arange(E * cap, device=dev) % cap
    slot_valid = b_c < torch.clamp(counts[:, b_e], max=cap)         # (G, E·C)
    src_flat = torch.gather(order, 1, torch.clamp(starts[:, b_e] + b_c, 0, Fk - 1))
    return Routing(gate=gate, ids=ids, keep=keep,
                   slot_of=torch.where(keep, ids_flat * cap + pos_flat, 0),
                   token_of_slot=torch.where(slot_valid, src_flat // k, 0),
                   src_flat=src_flat, slot_valid=slot_valid)


def moe(cfg, p, x: torch.Tensor, dropless: bool = False) -> torch.Tensor:
    """Top-k routed MoE with static capacity, sort-based dispatch — the twin
    of the JAX package's ``moe``. x: (B, S, D) → (B, S, D).

    Tokens form groups of ``moe_group_size`` (``moe_groups``); each (group,
    expert) pair has capacity ``int(gs·k/E·cf) + 1`` (``moe_routing``). No
    (tokens × E × C) one-hot is built: the dispatch and the combine are row
    gathers, and the expert products batched matmuls. The combine gathers
    each token's k slot outputs from the token side and adds them in
    float32 in slot order (the JAX package scatter-adds them in float32 in
    buffer order), so that it is the same from run to run on the card.
    ``dropless`` (the decode step's) makes the capacity the group size.
    """
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xt, chunk_major = moe_groups(cfg, x)
    G, gs, _ = xt.shape
    _, cap = moe_capacity(cfg, B * S, dropless)
    r = moe_routing(cfg, p["router"], xt, dropless)

    expert_in = _Route.apply(xt, r.token_of_slot, r.slot_valid,
                             r.slot_of.reshape(G, gs, k), r.keep.reshape(G, gs, k))
    xe = expert_in.reshape(G, E, cap, D).transpose(0, 1).reshape(E, G * cap, D)
    act = _activation(cfg.mlp_activation)
    h = act(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"])                                  # (E, G·C, D)
    flat_out = ye.reshape(E, G, cap, D).transpose(0, 1).reshape(G, E * cap, D)

    w = (r.gate.reshape(G, gs * k) * r.keep).to(x.dtype)
    slot_out = _Route.apply(flat_out, r.slot_of, r.keep, r.src_flat[..., None],
                            r.slot_valid[..., None])                # (G, gs·k, D)
    contrib = (slot_out * w[..., None]).to(torch.float32).reshape(G, gs, k, D)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    out = out.to(x.dtype)
    if chunk_major:
        return out.reshape(S // gs, B, gs, D).transpose(0, 1).reshape(B, S, D)
    return out.reshape(B, S, D)
