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
(neither has a kernel for it). The decode state (``state`` not None) is not
ported (``ROADMAP.md``, A7).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import rwkv_scan as rwkv_lib

_NO_DECODE = ("the decode state of the recurrent blocks (models/decode.py, serving) is "
              "not ported to repro_torch yet (see ROADMAP.md, A7)")


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """Shift the sequence right by one, zero first (train/prefill)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _lora_mix(x, shifted, mu, A, B_):
    """RWKV6 data-dependent lerp: x + (shifted - x) * (mu + tanh(xA)B)."""
    dyn = torch.tanh(x @ A) @ B_
    return x + (shifted - x) * (mu + dyn)


def lora_rank(cfg) -> int:
    return max(32, cfg.d_model // 64)


def rwkv_time_mix(cfg, p, x: torch.Tensor, state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, None]:
    """RWKV6 attention-free token mixing. x: (B, S, D) → (out, None)."""
    if state is not None:
        raise NotImplementedError(_NO_DECODE)
    B, S, D = x.shape
    H = cfg.num_heads
    Dh = D // H

    shifted = _token_shift(x)
    xr, xk, xv, xw, xg = (_lora_mix(x, shifted, p[f"mu_{n}"], p["lora_A"], p[f"lora_B_{n}"])
                          for n in "rkvwg")
    r, k, v = (t @ p[name] for t, name in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(xg @ p["wg"])
    # data-dependent per-channel decay in (0, 1): w = exp(-exp(w0 + f(x)))
    wlog = p["w0"] + torch.tanh(xw @ p["decay_A"]) @ p["decay_B"]
    w = torch.exp(-torch.exp(wlog.to(torch.float32)))

    def streams(t):                                      # (B,S,D) → (B·H, S, Dh) f32
        return t.to(torch.float32).reshape(B, S, H, Dh).transpose(1, 2) \
            .reshape(B * H, S, Dh).contiguous()

    u = p["u"].reshape(1, H, Dh).expand(B, H, Dh).reshape(B * H, Dh)
    wkv = rwkv_lib.rwkv_scan(streams(r), streams(k), streams(v), streams(w),
                             u.to(torch.float32).contiguous())
    wkv = wkv.reshape(B, H, S, Dh).transpose(1, 2)       # (B,S,H,Dh)

    # per-head group norm (population variance, as jnp.var) then gate
    mean = torch.mean(wkv, dim=-1, keepdim=True)
    var = torch.var(wkv, dim=-1, keepdim=True, correction=0)
    wkv = (wkv - mean) * torch.rsqrt(var + 1e-5)
    wkv = (wkv * p["ln_x_scale"].reshape(H, Dh)).reshape(B, S, D).to(x.dtype)
    return (wkv * g) @ p["wo"], None


def rwkv_channel_mix(cfg, p, x: torch.Tensor, state: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, None]:
    """RWKV FFN with token shift and squared ReLU."""
    if state is not None:
        raise NotImplementedError(_NO_DECODE)
    shifted = _token_shift(x)
    xk = x + (shifted - x) * p["mu_k"]
    xr = x + (shifted - x) * p["mu_r"]
    k = torch.square(F.relu(xk @ p["w_key"]))
    r = torch.sigmoid(xr @ p["w_recept"])
    return r * (k @ p["w_value"]), None


def ssm_heads(cfg, p, x: torch.Tensor, state=None) -> Tuple[torch.Tensor, None]:
    """Selective SSM over H heads of dim Dh = D // H with diagonal state N:

    h_t = exp(-softplus(Δ_t) A) ⊙ h_{t-1} + Δ_t · (x̃_t ⊗ B_t)
    y_t = (h_t · C_t) + D_skip ⊙ x̃_t

    x: (B, S, D) → (out (B, S, D), None)."""
    if state is not None:
        raise NotImplementedError(_NO_DECODE)
    B, S, D = x.shape
    H, N = cfg.num_heads, cfg.ssm_state
    Dh = D // H
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
    h = torch.zeros((B, H, Dh, N), dtype=f32, device=x.device)
    hs = []
    for dec_t, inp_t in zip(decay.unbind(1), inp.unbind(1)):
        h = h * dec_t[:, :, None, :] + inp_t
        hs.append(h)
    y = torch.einsum("bshdn,bshn->bshd", torch.stack(hs, dim=1), Cm)   # (B,S,H,Dh)
    y = y + p["D_skip"].to(f32)[None, None, :, None] * xtf
    return y.reshape(B, S, D).to(x.dtype) @ p["w_out"], None


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
