"""Recurrent blocks: the RWKV6 ("Finch") time mix and channel mix, and
Hymba's selective SSM heads — the twin of the JAX package's
``repro/models/ssm.py`` for train and prefill.

The WKV recurrence goes through ``kernels/rwkv_scan.py``: the hand-written
forward and backward kernels for CUDA tensors, the plain per-step loop for
CPU tensors (where the JAX package runs ``lax.scan``; its Pallas kernel
computes the same function). Layouts and dtypes are the JAX package's:
``w0``, ``u`` and ``ln_x_scale`` float32, everything else in the params'
type; the recurrence runs in float32 on (B·H, S, Dh) streams with
``Dh = D // H``.

``ssm_heads`` runs its recurrence as a PyTorch loop over the sequence with
a float32 (B, H, Dh, N) state, where the JAX package runs ``lax.scan``
(neither has a kernel for it).

With a decode ``state`` (``models/decode.py``: prefill into the cache and
each decode step) every block starts from the carried state and returns the
state after its last token: the token shift from its (B, 1, D) carry, the
WKV recurrence from a float32 (B, H, Dh, Dh) state, the SSM heads from a
float32 (B, H, Dh, N) state. The WKV recurrence then runs as a PyTorch loop
over the tokens, as the JAX package's ``lax.scan`` does: the RWKV kernels
take no state in and give none out, and the training path keeps them.

Under JAX's ``default`` preset (``sp``, a ``sharding.SeqParallel``) the
time mix and the SSM heads run head-parallel over the gathered sequence
(the rank's heads, through the same kernels for the time mix; the output
projection's partial sums reduce-scattered onto the rank's positions) and
the channel mix tensor-parallel over ``d_ff``, as the JAX package's
``constrain`` calls declare them. With a decode state as well (a sharded
prefill or decode tick) each block starts from the rank's heads of the
state (``CACHE_LOGICAL``: ``wkv`` and ``ssm`` over ``act_heads``) and
returns them, and the token-shift carry is the gathered sequence's last
position, whole on every rank. A tick's one position is computed on every
model rank, its head-parallel partial sums ``psum``-ed.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as sh
from repro_torch.kernels import rwkv_scan as rwkv_lib

def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift the sequence right by one → (shifted, the last token (B,1,D)).
    The first position takes ``last`` (the decode carry), else zero."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1), x[:, -1:]


def _wkv_steps(r, k, v, w, u, S0: torch.Tensor):
    """The WKV recurrence token by token from the state ``S0`` (B,H,Dh,Dh):
    r, k, v, w (B,S,H,Dh) float32, u (H,Dh) → (out (B,S,H,Dh), final state).
    The JAX package's ``lax.scan`` step, in its order."""
    state, outs = S0, []
    for rt, kt, vt, wt in zip(r.unbind(1), k.unbind(1), v.unbind(1), w.unbind(1)):
        kv = kt[..., :, None] * vt[..., None, :]                     # (B,H,Dh,Dh)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, state + u[None, :, :, None] * kv))
        state = state * wt[..., :, None] + kv
    return torch.stack(outs, dim=1), state


def _lora_mix(x, shifted, mu, A, B_):
    """RWKV6 data-dependent lerp: x + (shifted - x) * (mu + tanh(xA)B)."""
    dyn = torch.tanh(x @ A) @ B_
    return x + (shifted - x) * (mu + dyn)


def lora_rank(cfg) -> int:
    return max(32, cfg.d_model // 64)


# the heads [start, stop) of each head-parallel time mix or SSM heads (the
# ``default`` preset), counted: what a fleet's ranks report
HEAD_RUNS: collections.Counter = collections.Counter()

# the time-mix leaves whose columns (or, for ``wo``, rows) are the heads',
# with that dim: the rank of a head-parallel time mix takes its heads' part
_HEAD_LEAVES = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "decay_B": 1, "w0": 0, "u": 0,
                "ln_x_scale": 0, "wo": 0}
# the SSM heads' leaves over the heads, with that dim: ``w_in``'s columns and
# ``w_out``'s rows (``ssm_inner``, Dh a head), the others' heads (one a head)
_SSM_HEAD_LEAVES = {"w_in": 1, "w_out": 0, "w_B": 1, "w_C": 1, "w_delta": 1,
                    "delta_bias": 0, "A_log": 0, "D_skip": 0}


def rwkv_time_mix(cfg, p, x: torch.Tensor, state: Optional[dict] = None,
                  sp: Optional[sh.SeqParallel] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """RWKV6 attention-free token mixing. x: (B, S, D) → (out, new state).
    ``state`` (decode): ``{"shift": (B,1,D), "wkv": (B,H,Dh,Dh) float32}``;
    the new state is None without one.

    ``sp`` (a ``sharding.SeqParallel``, the ``default`` preset): x is this
    rank's positions and ``p`` the leaves as stored (``ShardedParam``s or
    tensors). JAX constrains r, k and v to ``("act_batch", "act_seq",
    "act_heads", None)``: the sequence whole, the heads over "model". So x
    is gathered over the sequence once, the token shift and the five LoRA
    lerps run on the whole of it (replicated compute over "model": each
    rank's gradient of them is its heads' part, and the ranks' parts sum),
    the rank takes its heads' columns of ``wr``, ``wk``, ``wv``, ``wg``,
    ``decay_B`` and ``w0`` and its heads of ``u`` and ``ln_x_scale``, runs
    the WKV on its B·H/n streams (the kernels' grids are the streams, so
    one launch each way as before), the group norm and the gate, multiplies
    by its rows of ``wo`` and reduce-scatters the partial sums onto its
    positions (``act_res_seq``). Where the heads do not divide the axes,
    each rank runs the whole heads on the gathered sequence and keeps its
    own positions of the output (a recurrence needs every earlier one).
    With ``state`` (a sharded prefill or tick) ``wkv`` is the rank's heads
    of the state, or the whole where the heads do not divide, and the new
    state likewise; its ``shift`` is whole."""
    if sp is None:
        return _time_mix(cfg, sh.materialize_tree(p), x, state)
    return _head_parallel(cfg, p, x, state, sp, _time_mix, _HEAD_LEAVES)


def _head_parallel(cfg, p, x: torch.Tensor, state, sp: sh.SeqParallel, mix, leaves
                   ) -> Tuple[torch.Tensor, Optional[dict]]:
    """``mix(cfg, leaves, sequence, state)`` head-parallel under ``sp``: x
    (this rank's positions) gathered over the sequence; the rank's heads of
    each leaf named in ``leaves`` (name → the dim of its heads, H of them
    or H·Dh) and the whole of the others; the
    output's partial sums reduce-scattered onto the rank's positions
    (``psum``-ed where the sequence does not split, as a tick's one
    position). Where the heads do not divide, the whole heads on every
    rank, its own positions of the output kept."""
    H = cfg.num_heads
    axes = sp.split("act_heads", H)
    h = sp.gather(x)
    if not axes:
        out, new_state = mix(cfg, sh.materialize_tree(p), h, state)
        return sp.take(out), new_state
    h0, h1 = sp.part("act_heads", H)
    HEAD_RUNS[(h0, h1)] += 1

    def part(n, t):                     # a head is t.shape[dim] // H wide on its dim
        k = t.shape[leaves[n]] // H
        return sh.materialize_part(t, leaves[n], (h0 * k, h1 * k), axes)
    w = {n: part(n, t) if n in leaves else sh.materialize(t) for n, t in p.items()}
    out, new_state = mix(cfg, w, h, state)
    return sp.scatter(out, axes), new_state


def _time_mix(cfg, p, x: torch.Tensor, state: Optional[dict]
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """``rwkv_time_mix`` over whole leaves ``p``, whose head leaves
    (``_HEAD_LEAVES``) may hold some of the heads: the WKV runs on those."""
    B, S, D = x.shape
    Dh = D // cfg.num_heads
    H = p["u"].shape[0] // Dh

    shifted, new_shift = _token_shift(x, None if state is None else state["shift"])
    xr, xk, xv, xw, xg = (_lora_mix(x, shifted, p[f"mu_{n}"], p["lora_A"], p[f"lora_B_{n}"])
                          for n in "rkvwg")
    r, k, v = (t @ p[name] for t, name in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(xg @ p["wg"])
    # data-dependent per-channel decay in (0, 1): w = exp(-exp(w0 + f(x)))
    wlog = p["w0"] + torch.tanh(xw @ p["decay_A"]) @ p["decay_B"]
    w = torch.exp(-torch.exp(wlog.to(torch.float32)))

    new_state = None
    if state is not None:
        def heads(t):                                    # (B,S,D) → (B,S,H,Dh) f32
            return t.to(torch.float32).reshape(B, S, H, Dh)
        wkv, wkv_state = _wkv_steps(heads(r), heads(k), heads(v), heads(w),
                                    p["u"].reshape(H, Dh).to(torch.float32), state["wkv"])
        new_state = {"shift": new_shift, "wkv": wkv_state}
    else:
        def streams(t):                                  # (B,S,H·Dh) → (B·H, S, Dh) f32
            return t.to(torch.float32).reshape(B, S, H, Dh).transpose(1, 2) \
                .reshape(B * H, S, Dh).contiguous()

        u = p["u"].reshape(1, H, Dh).expand(B, H, Dh).reshape(B * H, Dh)
        wkv = rwkv_lib.rwkv_scan(streams(r), streams(k), streams(v), streams(w),
                                 u.to(torch.float32).contiguous())
        wkv = wkv.reshape(B, H, S, Dh).transpose(1, 2)   # (B,S,H,Dh)

    # per-head group norm (population variance, as jnp.var) then gate
    mean = torch.mean(wkv, dim=-1, keepdim=True)
    var = torch.var(wkv, dim=-1, keepdim=True, correction=0)
    wkv = (wkv - mean) * torch.rsqrt(var + 1e-5)
    wkv = (wkv * p["ln_x_scale"].reshape(H, Dh)).reshape(B, S, H * Dh).to(x.dtype)
    return (wkv * g) @ p["wo"], new_state


def rwkv_channel_mix(cfg, p, x: torch.Tensor, state: Optional[dict] = None,
                     sp: Optional[sh.SeqParallel] = None
                     ) -> Tuple[torch.Tensor, Optional[dict]]:
    """RWKV FFN with token shift and squared ReLU. ``state`` (decode):
    ``{"shift": (B,1,D)}``.

    ``sp`` (a ``sharding.SeqParallel``, the ``default`` preset): x is this
    rank's positions and ``p`` the leaves as stored. JAX constrains k over
    ``act_mlp`` and ``r * kv`` to ``act_res_seq``: x is gathered over the
    sequence for the shift; where ``d_ff`` splits over ``act_mlp``'s axes
    the rank computes k from its columns of ``w_key`` on the whole
    sequence, kv's partial sums from its rows of ``w_value``, and
    reduce-scatters them onto its positions; r comes from its positions
    and the whole ``w_recept``. Where ``d_ff`` does not divide, the rank
    runs its positions with the whole weights. With ``state`` the shift
    starts from its carry and the new one is the gathered sequence's last
    position, whole."""
    if sp is None:
        p = sh.materialize_tree(p)
        shifted, new_shift = _token_shift(x, None if state is None else state["shift"])
        xk = x + (shifted - x) * p["mu_k"]
        xr = x + (shifted - x) * p["mu_r"]
        k = torch.square(F.relu(xk @ p["w_key"]))
        r = torch.sigmoid(xr @ p["w_recept"])
        return r * (k @ p["w_value"]), None if state is None else {"shift": new_shift}
    h = sp.gather(x)
    shifted_all, new_shift = _token_shift(h, None if state is None else state["shift"])
    new_state = None if state is None else {"shift": new_shift}
    shifted = sp.take(shifted_all)
    mu_k, mu_r = sh.materialize(p["mu_k"]), sh.materialize(p["mu_r"])
    r = torch.sigmoid((x + (shifted - x) * mu_r) @ sh.materialize(p["w_recept"]))
    Fd = p["w_key"].shape[1]
    axes = sp.split("act_mlp", Fd)
    if not axes:
        k = torch.square(F.relu((x + (shifted - x) * mu_k) @ sh.materialize(p["w_key"])))
        return r * (k @ sh.materialize(p["w_value"])), new_state
    part = sp.part("act_mlp", Fd)
    k = torch.square(F.relu((h + (shifted_all - h) * mu_k)
                            @ sh.materialize_part(p["w_key"], 1, part, axes)))
    kv = sp.scatter(k @ sh.materialize_part(p["w_value"], 0, part, axes), axes)
    return r * kv, new_state


def ssm_heads(cfg, p, x: torch.Tensor, state: Optional[torch.Tensor] = None,
              sp: Optional[sh.SeqParallel] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Selective SSM over H heads of dim Dh = D // H with diagonal state N:

    h_t = exp(-softplus(Δ_t) A) ⊙ h_{t-1} + Δ_t · (x̃_t ⊗ B_t)
    y_t = (h_t · C_t) + D_skip ⊙ x̃_t

    x: (B, S, D) → (out (B, S, D), the state after the last token, or None
    without a decode ``state`` (B,H,Dh,N) float32 to start from).

    ``sp`` (a ``sharding.SeqParallel``, the ``default`` preset): x is this
    rank's positions and ``p`` the leaves as stored. JAX constrains x̃ to
    ``("act_batch", "act_seq", "act_heads", None)`` and the output to
    ``act_res_seq``: x is gathered over the sequence, the rank takes its
    heads' columns of ``w_in`` and rows of ``w_out`` (``ssm_inner``) and its
    heads of ``w_B``, ``w_C``, ``w_delta``, ``delta_bias``, ``A_log`` and
    ``D_skip``, runs the loop on its heads and reduce-scatters the output
    projection's partial sums onto its positions. Where the heads do not
    divide the axes, each rank runs the whole heads on the gathered
    sequence and keeps its own positions. ``state`` is then the rank's
    heads of the state (or the whole), and so is the new one."""
    if sp is None:
        return _ssm_heads(cfg, sh.materialize_tree(p), x, state)
    return _head_parallel(cfg, p, x, state, sp, _ssm_heads, _SSM_HEAD_LEAVES)


def _ssm_heads(cfg, p, x: torch.Tensor, state: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``ssm_heads`` over whole leaves ``p``, whose head leaves
    (``_SSM_HEAD_LEAVES``) may hold some of the heads: the loop runs on
    those."""
    B, S, D = x.shape
    H, N = p["A_log"].shape
    Dh = D // cfg.num_heads
    f32 = torch.float32

    def proj(w):                                          # "bsd,dhn->bshn"
        return (x @ w.reshape(D, -1)).reshape(B, S, *w.shape[1:])

    xtf = (x @ p["w_in"]).reshape(B, S, H, Dh).to(f32)
    Bm, Cm = proj(p["w_B"]).to(f32), proj(p["w_C"]).to(f32)             # (B,S,H,N)
    z = (x @ p["w_delta"]).to(f32) + p["delta_bias"]
    delta = torch.logaddexp(z, torch.zeros((), dtype=f32, device=x.device))  # softplus
    A = -torch.exp(p["A_log"].to(f32))                                  # (H,N)
    decay = torch.exp(delta[..., None] * A)                             # (B,S,H,N)

    # the input term Δ_t·(x̃_t ⊗ B_t) of every step at once; the loop is then
    # one multiply and one add a step. The steps are taken apart by unbind,
    # whose backward is one stack: indexing a step out of the whole
    # sequence would make each step's backward write a sequence-sized
    # gradient, O(S²) work.
    inp = (delta[..., None, None] * xtf[..., :, None]) * Bm[:, :, :, None, :]  # (B,S,H,Dh,N)
    h = torch.zeros((B, H, Dh, N), dtype=f32, device=x.device) if state is None else state
    hs = []
    for dec_t, inp_t in zip(decay.unbind(1), inp.unbind(1)):
        h = h * dec_t[:, :, None, :] + inp_t
        hs.append(h)
    y = torch.einsum("bshdn,bshn->bshd", torch.stack(hs, dim=1), Cm)   # (B,S,H,Dh)
    y = y + p["D_skip"].to(f32)[None, None, :, None] * xtf
    out = y.reshape(B, S, H * Dh).to(x.dtype) @ p["w_out"]
    return out, None if state is None else h


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

Shapes = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def rwkv_time_shapes(cfg, dtype: torch.dtype) -> Shapes:
    """Name → (shape, dtype) of the time-mix params (JAX layouts)."""
    D, R, f32 = cfg.d_model, lora_rank(cfg), torch.float32
    out: Shapes = {n: ((D, D), dtype) for n in ("wr", "wk", "wv", "wg", "wo")}
    out["lora_A"] = ((D, R), dtype)
    out.update({f"lora_B_{n}": ((R, D), dtype) for n in "rkvwg"})
    out.update({f"mu_{n}": ((D,), dtype) for n in "rkvwg"})
    out.update({"decay_A": ((D, R), dtype), "decay_B": ((R, D), dtype),
                "w0": ((D,), f32), "u": ((D,), f32), "ln_x_scale": ((D,), f32)})
    return out


def rwkv_channel_shapes(cfg, dtype: torch.dtype) -> Shapes:
    D, Fd = cfg.d_model, cfg.d_ff
    return {"w_key": ((D, Fd), dtype), "w_value": ((Fd, D), dtype),
            "w_recept": ((D, D), dtype), "mu_k": ((D,), dtype), "mu_r": ((D,), dtype)}


def ssm_shapes(cfg, dtype: torch.dtype) -> Shapes:
    """Name → (shape, dtype) of Hymba's SSM head params."""
    D, H, N, f32 = cfg.d_model, cfg.num_heads, cfg.ssm_state, torch.float32
    return {"w_in": ((D, D), dtype), "w_out": ((D, D), dtype),
            "w_B": ((D, H, N), dtype), "w_C": ((D, H, N), dtype),
            "w_delta": ((D, H), dtype), "delta_bias": ((H,), f32),
            "A_log": ((H, N), f32), "D_skip": ((H,), f32)}


def _normal_(p: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=p.device)
    p.copy_((x * scale).to(p.dtype))


@torch.no_grad()
def init_rwkv_time_params(p, cfg, generator: torch.Generator) -> None:
    """Fill the time-mix params ``p`` (name → tensor, ``rwkv_time_shapes``)
    in place with the JAX package's distributions: projections and
    ``lora_A``/``decay_A`` normal × D^-0.5, ``decay_B`` normal × 0.01,
    ``lora_B_*`` zero, ``mu_*`` and ``w0`` 0.5, ``u`` normal × 0.1,
    ``ln_x_scale`` one."""
    s = cfg.d_model ** -0.5
    for name in ("wr", "wk", "wv", "wg", "wo", "lora_A", "decay_A"):
        _normal_(p[name], s, generator)
    _normal_(p["decay_B"], 0.01, generator)
    _normal_(p["u"], 0.1, generator)
    for n in "rkvwg":
        p[f"lora_B_{n}"].zero_()
        p[f"mu_{n}"].fill_(0.5)
    p["w0"].fill_(0.5)                    # exp(-exp(0.5)) ≈ 0.19 decay
    p["ln_x_scale"].fill_(1.0)


@torch.no_grad()
def init_rwkv_channel_params(p, cfg, generator: torch.Generator) -> None:
    """Fill the channel-mix params in place: ``w_key``/``w_recept`` normal ×
    D^-0.5, ``w_value`` normal × d_ff^-0.5, ``mu_*`` 0.5."""
    _normal_(p["w_key"], cfg.d_model ** -0.5, generator)
    _normal_(p["w_value"], cfg.d_ff ** -0.5, generator)
    _normal_(p["w_recept"], cfg.d_model ** -0.5, generator)
    p["mu_k"].fill_(0.5)
    p["mu_r"].fill_(0.5)


@torch.no_grad()
def init_ssm_params(p, cfg, generator: torch.Generator) -> None:
    """Fill the SSM head params in place: the projections normal × D^-0.5,
    ``delta_bias`` zero, ``A_log = log(1..N)`` per head, ``D_skip`` one."""
    s = cfg.d_model ** -0.5
    for name in ("w_in", "w_out", "w_B", "w_C", "w_delta"):
        _normal_(p[name], s, generator)
    p["delta_bias"].zero_()
    p["A_log"].copy_(torch.log(torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32))
                     .expand(cfg.num_heads, cfg.ssm_state))
    p["D_skip"].fill_(1.0)
