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
always runs the dense or chunked path, as the JAX package does; where
the cache's positions split over ranks (``sharding.CacheLayout``) each
rank attends its slice and the ranks combine (the split-KV path). Under the
``default`` preset (``sp``, a ``sharding.SeqParallel``) a rank's queries
are a slice of the sequence, and the flash kernels take its first
position as their query offset. ``moe`` is the capacity-factor MoE
layer with sort-based dispatch; ``dropless=True`` (a one-token decode step)
sets each expert's capacity to the group size. Under either preset
(``ep``, a ``sharding.ExpertLayout``) a rank routes its groups of the
global batch and runs its own experts, and the ranks' float32 partials
are summed (expert parallelism).
"""
from __future__ import annotations

import collections
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.analysis import smem
from repro_torch.core.numerics import device_scalar
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import build
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

def _flash_feasible(cfg, S: int, T: int) -> bool:
    """The JAX block rule (``analysis/smem.py`` ``FLASH_BLOCKS``) plus the
    Hopper kernels' own limits (head dim, shared memory, bf16/f32). The JAX
    package's 12 MB VMEM guard on the whole K/V stream is not copied: the
    Hopper kernels tile KV, so T is not limited, and a shape the TPU would
    route to chunked can go to flash here."""
    return smem.flash_feasible(S, T, cfg.head_dim, cfg.param_dtype)


def resolve_attn_backend(cfg, S: int, T: int, device) -> str:
    """Training backend for this shape on ``device`` (a device, or the
    tensor the attention runs on: ``kernels/build.py`` ``on_card``) → flash |
    chunked | dense.

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
        if build.on_card(device) and _flash_feasible(cfg, S, T):
            return "flash"
        return chunked
    raise ValueError(f"unknown attn_backend: {b!r}")


def _flash_attention(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     is_local: bool, q_offset: int = 0) -> torch.Tensor:
    """One flash launch per layer. q (B,Sq,H,Dh) pre-scaled (kernel scale 1);
    k/v (B,T,Hkv,Dh). Streams fold head-major (a copy) so q stream i reads kv
    stream i // group without repeating K/V. Assumes contiguous positions,
    the keys' from zero and the queries' from ``q_offset``
    (``forward_hiddens``' layout; a sequence-parallel rank's slice)."""
    B, Sq, H, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]

    def fold(x, heads, n):
        return x.transpose(1, 2).contiguous().view(B * heads, n, Dh)

    window = cfg.sliding_window if cfg.sliding_window is not None and is_local else None
    out = flash_lib.flash_attention(
        fold(q, H, Sq), fold(k, Hkv, T), fold(v, Hkv, T), causal=True, window=window,
        softcap=cfg.attn_logit_softcap, group=H // Hkv, scale=1.0, q_offset=q_offset)
    return out.view(B, H, Sq, Dh).transpose(1, 2)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, H, K = w.shape
    return (x @ w.reshape(D, H * K)).reshape(*x.shape[:-1], H, K)


def attention(cfg, p, x: torch.Tensor, positions: torch.Tensor,
              *, is_local: bool = False, cache: Optional[dict] = None,
              cache_index: int = 0, sp=None, kv=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """GQA attention. x: (B, S, D) → ``(out, new cache or None)``.

    Without ``cache``: self-attention over the S positions with a causal
    (+ sliding window on a local layer) mask. With ``cache`` (``{"k", "v"}``
    of (B, max_seq, Hkv, Dh)): the new keys and values are written into the
    cache IN PLACE at ``cache_index`` and the S queries attend over the
    whole cache with per-query absolute causality (and the window on a local
    layer), by dense scores, or chunked when ``attn_chunk`` is set and below
    ``max_seq``; the returned cache holds the same tensors.

    ``sp`` (a ``sharding.SeqParallel``, the ``default`` preset): x and
    ``positions`` are this rank's positions ``[sp.start, sp.stop)`` of the
    sequence. The queries come from them (JAX's ``act_q_seq``), the keys and
    values from x gathered over the sequence (``act_seq``: whole), each at
    its global position; the kernels mask with the query offset
    ``sp.start`` and ``wo`` maps the local rows back to the residual's
    layout. The backend is chosen on the whole sequence, as JAX's
    ``resolve_attn_backend(cfg, S, kv_len)`` sees it.

    ``kv`` (a ``sharding.CacheLayout``): the cache holds this rank's
    positions ``[kv.start, kv.stop)`` of ``kv.length``; see
    ``_cached_attention``."""
    B, S, D = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    xkv, kv_positions, q_offset = x, positions, 0
    if sp is not None and sp.size > 1:
        xkv, q_offset = sp.gather(x), sp.start
        first = cache_index if cache is not None else 0
        kv_positions = (first + torch.arange(sp.length, dtype=positions.dtype,
                                             device=positions.device)).expand(B, sp.length)
    q, k, v = _proj(x, p["wq"]), _proj(xkv, p["wk"]), _proj(xkv, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, kv_positions, cfg.rope_theta)
    if cfg.query_scale is not None:
        q = q * cfg.query_scale
    else:
        q = q / device_scalar(math.sqrt(Dh), torch.float32, q.device).to(q.dtype)

    if cache is not None:
        out, new_cache = _cached_attention(cfg, q, k, v, positions[0], is_local, cache,
                                           cache_index, sp, kv)
        return out.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, D), new_cache

    T = k.shape[1]
    backend = resolve_attn_backend(cfg, T, T, x)
    if backend == "flash":
        out = _flash_attention(cfg, q, k, v, is_local, q_offset)
        return out.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, D), None
    qpos, kpos = positions[:, :, None], kv_positions[:, None, :]
    mask = kpos <= qpos                                             # (B,S,T)
    if cfg.sliding_window is not None and is_local:
        mask = mask & (kpos > qpos - cfg.sliding_window)
    qg = q.reshape(B, S, Hkv, H // Hkv, Dh)
    out = (_chunked_attention(cfg, qg, k, v, mask) if backend == "chunked"
           else _dense_attention(cfg, qg, k, v, mask))
    return out.reshape(B, S, H * Dh) @ p["wo"].reshape(H * Dh, D), None


def _cached_attention(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, is_local: bool, cache: dict, cache_index: int,
                      sp, kv) -> Tuple[torch.Tensor, dict]:
    """The cached branch of ``attention``: q (B, S, H, Dh) at global
    positions ``q_pos`` (S,), k/v (B, S_new, Hkv, Dh) the new positions
    ``[cache_index, cache_index + S_new)`` → ((B, S, Hkv, g, Dh), cache).

    ``kv`` (a ``sharding.CacheLayout``): this rank's cache holds positions
    ``[kv.start, kv.stop)``. It writes the new positions that fall in its
    slice (a decode tick's one position on the rank that owns it; the host
    int ``cache_index`` decides, with no sync) and masks with global key
    positions, so that a sliding window crosses the ranks' slices. Where
    the positions split over ranks (the split-KV path) each rank attends
    its slice and the ranks combine: the chunked branch keeps the
    online-softmax state (m, l, acc) that ``_chunked_attention`` keeps,
    through the masked-row guard (a slice that lies wholly past a query
    gives m = -1e30 and p = 0, never a local softmax's uniform weights),
    and combines the states (``_combine``); the dense branch runs one
    softmax across the ranks (``_split_dense_attention``), so that it
    rounds where one process's does. The peers along the split hold the
    same rows; under ``sp`` their queries are different positions, so the
    queries are gathered over the sequence first and each rank keeps
    its own rows of the result."""
    B, _, H, Dh = q.shape
    Hkv = k.shape[2]
    t0 = kv.start if kv is not None else 0
    T = cache["k"].shape[1]
    lo, hi = max(cache_index, t0), min(cache_index + k.shape[1], t0 + T)
    if lo < hi:
        cache["k"][:, lo - t0:hi - t0] = k[:, lo - cache_index:hi - cache_index]
        cache["v"][:, lo - t0:hi - t0] = v[:, lo - cache_index:hi - cache_index]
    new_cache = {"k": cache["k"], "v": cache["v"]}
    k, v = cache["k"], cache["v"]
    split = kv is not None and kv.split
    gathered = split and sp is not None and sp.size > 1
    if gathered:
        q = sp.gather(q)
        q_pos = cache_index + torch.arange(sp.length, dtype=q_pos.dtype, device=q.device)
    S = q.shape[1]
    kv_pos = t0 + torch.arange(T, device=q.device)[None, :]                  # (1,T)
    q_abs = q_pos[:, None]                                                   # (S,1)
    mask = kv_pos <= q_abs                                                   # (S,T)
    if cfg.sliding_window is not None and is_local:
        mask = mask & (kv_pos > q_abs - cfg.sliding_window)
    mask = mask.expand(B, S, T)
    length = kv.length if kv is not None else T
    chunked = bool(cfg.attn_chunk) and length > cfg.attn_chunk
    qg = q.reshape(B, S, Hkv, H // Hkv, Dh)
    if split:
        if chunked:
            m, l, acc = _attention_state(cfg, qg, k, v, mask, min(cfg.attn_chunk, T))
            out = _combine(m, l, acc, kv)
        else:
            out = _split_dense_attention(cfg, qg, k, v, mask, kv)
        out = out.to(v.dtype)
        return (sp.take(out) if gathered else out), new_cache
    if chunked:
        return _chunked_attention(cfg, qg, k, v, mask), new_cache
    return _dense_attention(cfg, qg, k, v, mask), new_cache


def _dense_attention(cfg, qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Dense scores and one softmax. qg: (B,S,Hkv,g,Dh); k/v: (B,T,Hkv,Dh);
    mask: (B,S,T) bool → (B,S,Hkv,g,Dh) in v's dtype."""
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k)          # (B,Hkv,g,S,T)
    logits = softcap(logits, cfg.attn_logit_softcap)
    logits = torch.where(mask[:, None, None], logits.to(torch.float32),
                         device_scalar(-1e30, torch.float32, qg.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v)


def _attention_state(cfg, qg: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                     mask: torch.Tensor, C: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The online-softmax state over KV chunks of C: the running max ``m``
    and sum ``l`` (B,Hkv,g,S) and the unnormalized output ``acc``
    (B,Hkv,g,S,Dh), float32. qg: (B,S,Hkv,g,Dh); k/v: (B,T,Hkv,Dh); mask:
    (B,S,T) bool. A chunk whose mask row is all false keeps ``m`` at -1e30
    and contributes p = 0 (the masked-row guard)."""
    B, S, Hkv, g, Dh = qg.shape
    T = k_all.shape[1]
    if T % C:
        raise ValueError(f"sequence {T} is not a multiple of attn_chunk {C}")
    m = torch.full((B, Hkv, g, S), -1e30, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, Hkv, g, S), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, Hkv, g, S, Dh), dtype=torch.float32, device=qg.device)
    neg = device_scalar(-1e30, torch.float32, qg.device)
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
    return m, l, acc


def _chunked_attention(cfg, qg: torch.Tensor, k_all: torch.Tensor,
                       v_all: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``cfg.attn_chunk``
    (``_attention_state``), normalized. Returns (B,S,Hkv,g,Dh) in v's
    dtype."""
    _, l, acc = _attention_state(cfg, qg, k_all, v_all, mask, cfg.attn_chunk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(v_all.dtype)


def _split_dense_attention(cfg, qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, kv) -> torch.Tensor:
    """``_dense_attention`` over this rank's slice of a cache split over
    ``kv.seq_axes``, as one softmax across the ranks: the scores' max by a
    ``pmax`` and their exponentials' sum by a ``psum`` (a slice wholly past
    a query adds exp(-1e30 − m) = 0: the masked-row guard), p normalized
    and rounded to v's dtype as one process's softmax is, and the products
    summed in float32 over the slice and then over the ranks (a ``psum``).
    The output, float32 (B,S,Hkv,g,Dh), then rounds once, as one process's
    product does: the split changes only the order of float32 sums."""
    mesh, axes = kv.mesh, kv.seq_axes
    s = softcap(torch.einsum("bskgh,btkh->bkgst", qg, k), cfg.attn_logit_softcap)
    s = torch.where(mask[:, None, None], s.to(torch.float32),
                    device_scalar(-1e30, torch.float32, qg.device))
    m = mesh.pmax(s.amax(dim=-1), axes)[..., None]
    e = torch.where(m > -0.5e30, torch.exp(s - m), 0.0)
    l = mesh.psum(e.sum(dim=-1), axes)[..., None]
    p = (e / torch.clamp(l, min=1e-30)).to(v.dtype)
    return mesh.psum(torch.einsum("bkgst,btkh->bskgh", p.float(), v.float()), axes)


def _combine(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, kv) -> torch.Tensor:
    """The split-KV combine of every rank's online-softmax state over
    ``kv.seq_axes``: the global max by a ``pmax``, each state rescaled by
    exp(m_r − m), then one ``psum`` of l and acc together → the normalized
    output (B,S,Hkv,g,Dh), float32. A rank whose slice is wholly masked
    (m_r = -1e30) adds nothing."""
    mesh, axes = kv.mesh, kv.seq_axes
    top = mesh.pmax(m, axes)
    alpha = torch.exp(m - top)
    both = mesh.psum(torch.cat([acc * alpha[..., None], (l * alpha)[..., None]], dim=-1), axes)
    out = both[..., :-1] / torch.clamp(both[..., -1:], min=1e-30)
    return out.permute(0, 3, 1, 2, 4)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

def mlp(cfg, p, x: torch.Tensor, sp=None) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU per cfg.mlp_activation).

    ``sp`` (a ``sharding.SeqParallel``): x is this rank's positions and the
    weights are the block's leaves as stored (``ShardedParam``s or
    tensors). Where ``d_ff`` splits over ``act_mlp``'s axes (JAX's
    tensor-parallel hidden) x is gathered over the sequence, the rank
    computes its ``d_ff`` slice with its columns of ``w_gate``/``w_up`` and
    rows of ``w_down`` and the partial sums are reduce-scattered back onto
    the sequence (psum-ed where the sequence does not split, as a decode
    tick's one position); else the rank runs its own positions with the
    whole weights (the same values, without the gather)."""
    act = _activation(cfg.mlp_activation)
    if sp is None:
        p = sh.materialize_tree(p)
        return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    Fd = p["w_gate"].shape[1]
    axes = sp.split("act_mlp", Fd)
    if not axes:
        return mlp(cfg, p, x)
    part = sp.part("act_mlp", Fd)
    w_gate = sh.materialize_part(p["w_gate"], 1, part, axes)
    w_up = sh.materialize_part(p["w_up"], 1, part, axes)
    w_down = sh.materialize_part(p["w_down"], 0, part, axes)
    h = sp.gather(x)
    return sp.scatter((act(h @ w_gate) * (h @ w_up)) @ w_down, axes)


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
                dropless: bool = False, capacity: Optional[int] = None) -> Routing:
    """The top-k routing and the sort-based dispatch plan of token groups
    ``xt`` (G, gs, D). The top k come from a stable descending sort, so
    that equal probabilities go to the lower expert index as
    ``jax.lax.top_k`` gives them; each expert's queue is a stable argsort
    of the expert ids, and the assignments past its capacity are dropped in
    queue order. ``capacity``: the global batch's (``moe_capacity``), where
    ``xt`` holds some of its groups; else ``xt``'s own."""
    G, gs, _ = xt.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity if capacity is not None else moe_capacity(cfg, G * gs, dropless)[1]
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


# (the global batch's tokens, the groups' axes, the experts' axes) of each
# sharded MoE forward, counted: the regimes a fleet's ranks report
EXPERT_RUNS: collections.Counter = collections.Counter()


def moe(cfg, p, x: torch.Tensor, dropless: bool = False,
        ep: Optional[sh.ExpertLayout] = None) -> torch.Tensor:
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

    ``ep`` (a ``sharding.ExpertLayout``, a sharded train step): x is this
    rank's rows (and positions) and ``p`` the layer's leaves as stored. The
    rank routes the tokens of its groups (``ep.dispatch``), with the global
    batch's group size and capacity, runs its experts ``ep.expert_range``
    on their slots with those experts' weights gathered over their other
    axes, adds its slots' outputs in float32 in slot order, and the ranks'
    partials are summed (``ep.combine``) before the one cast.
    """
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    if ep is None:
        xt, chunk_major = moe_groups(cfg, x)
        cap = moe_capacity(cfg, B * S, dropless)[1]
        e0, e1 = 0, E
        router, w_gate, w_up, w_down = p["router"], p["w_gate"], p["w_up"], p["w_down"]
    else:
        if dropless:
            raise ValueError("the dropless MoE under sharding_rules: its groups are a decode "
                             "tick's rows (ROADMAP.md A14s)")
        xt, chunk_major, cap = ep.dispatch(x), False, ep.capacity
        e0, e1 = ep.expert_range
        EXPERT_RUNS[(ep.tokens, ep.group_axes, ep.expert_axes)] += 1
        router = sh.materialize(p["router"])
        w_gate, w_up, w_down = (sh.materialize_part(p[n], 0, (e0, e1), ep.expert_axes)
                                for n in ("w_gate", "w_up", "w_down"))
    G, gs, _ = xt.shape
    r = moe_routing(cfg, router, xt, dropless, cap)
    # this rank's experts [e0, e1): their slots of the buffer, and each
    # (token, slot) assignment that lands in one of them
    lo, hi = e0 * cap, e1 * cap
    ids_flat = r.ids.reshape(G, gs * k)
    local = r.keep & (ids_flat >= e0) & (ids_flat < e1)
    slot_of = torch.where(local, r.slot_of - lo, 0)
    valid = r.slot_valid[:, lo:hi]

    expert_in = _Route.apply(xt, r.token_of_slot[:, lo:hi], valid,
                             slot_of.reshape(G, gs, k), local.reshape(G, gs, k))
    El = e1 - e0
    xe = expert_in.reshape(G, El, cap, D).transpose(0, 1).reshape(El, G * cap, D)
    act = _activation(cfg.mlp_activation)
    h = act(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down)                                       # (El, G·C, D)
    flat_out = ye.reshape(El, G, cap, D).transpose(0, 1).reshape(G, El * cap, D)

    w = (r.gate.reshape(G, gs * k) * r.keep).to(x.dtype)
    slot_out = _Route.apply(flat_out, slot_of, local, r.src_flat[:, lo:hi, None],
                            valid[..., None])                       # (G, gs·k, D)
    contrib = (slot_out * w[..., None]).to(torch.float32).reshape(G, gs, k, D)
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    if ep is not None:
        return ep.combine(out, x.shape).to(x.dtype)
    out = out.to(x.dtype)
    if chunk_major:
        return out.reshape(S // gs, B, gs, D).transpose(0, 1).reshape(B, S, D)
    return out.reshape(B, S, D)
