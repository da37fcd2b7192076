"""The port's flash attention (``repro_torch/kernels/flash_attention.py``)
against the JAX package's Pallas kernels in interpret mode, on the CPU,
where the port runs its plain PyTorch versions.

The cases mirror ``tests/test_kernels.py``' flash tests: causal, softcap,
sliding window, bidirectional, GQA 2 and 4, ``window=0`` (every row fully
masked), head dims 12 and 16, bf16. Tolerances are the JAX tests' own: the
output atol 2e-5 and lse atol 1e-5 in float32 (the port sums the dense
softmax, the kernel online over KV tiles), gradients atol 5e-4 (the
recompute backward adds one more reassociated product), bf16 atol 3e-2
(the output is rounded to bf16 on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as tfa

# name: (BHkv, group, S, Dh, causal, window, softcap)
CASES = {
    "causal": (2, 1, 128, 32, True, None, None),
    "softcap": (1, 1, 128, 64, True, None, 50.0),
    "window": (3, 1, 128, 32, True, 48, None),
    "bidirectional": (2, 1, 128, 64, False, None, None),
    "gqa2_window_softcap": (2, 2, 128, 32, True, 48, 30.0),
    "gqa4": (2, 4, 64, 16, True, None, None),
    "window0": (2, 1, 64, 32, True, 0, None),
    "dh12": (4, 1, 16, 12, True, None, None),
    "dh16_gqa2_window": (2, 2, 32, 16, True, 16, 50.0),
}


def _block(S):
    return next(b for b in (128, 64, 32, 16, 8) if S % b == 0)


def _inputs(name, seed=0):
    BHkv, group, S, Dh, causal, window, softcap = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BHkv * group, S, Dh)).astype(np.float32)
    k = rng.normal(size=(BHkv, S, Dh)).astype(np.float32)
    v = rng.normal(size=(BHkv, S, Dh)).astype(np.float32)
    do = rng.normal(size=(BHkv * group, S, Dh)).astype(np.float32)
    opts = dict(causal=causal, window=window, softcap=softcap, group=group)
    return q, k, v, do, opts


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax_kernel(name):
    q, k, v, _, opts = _inputs(name)
    S, Dh = q.shape[1], q.shape[2]
    w = jnp.full((1,), S if opts["window"] is None else opts["window"], jnp.int32)
    jo, jlse = jfa._forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w, block_q=_block(S),
        block_k=_block(S), causal=opts["causal"], use_window=opts["window"] is not None,
        softcap=opts["softcap"], scale=Dh ** -0.5, group=opts["group"],
        bound_loop=True, interpret=True)
    to, tlse = tfa.flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **opts)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5)
    jlse = np.asarray(jlse)
    np.testing.assert_array_equal(np.isinf(tlse.numpy()), np.isinf(jlse))
    fin = np.isfinite(jlse)
    np.testing.assert_allclose(tlse.numpy()[fin], jlse[fin], atol=1e-5)
    if name == "window0":
        assert torch.equal(to, torch.zeros_like(to))
        assert bool(torch.all(torch.isinf(tlse) & (tlse > 0)))


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax_kernel(name):
    q, k, v, do, opts = _inputs(name, seed=1)
    S = q.shape[1]

    def jloss(q, k, v):
        o = jfa.flash_attention_pallas(q, k, v, block_q=_block(S), block_k=_block(S),
                                       interpret=True, **opts)
        return jnp.sum(o * jnp.asarray(do))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, **opts)
    (o * torch.from_numpy(do)).sum().backward()
    for got, want, what in zip((tq.grad, tk.grad, tv.grad), jg, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                                   err_msg=f"{what} ({name})")


@pytest.mark.parametrize("name", ["causal", "gqa2_window_softcap"])
def test_bf16_matches_jax_kernel(name):
    q, k, v, do, opts = _inputs(name, seed=2)
    S = q.shape[1]
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    jdo = jnp.asarray(do).astype(jnp.bfloat16)

    def jloss(q, k, v):
        o = jfa.flash_attention_pallas(q, k, v, block_q=_block(S), block_k=_block(S),
                                       interpret=True, **opts)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32)), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)

    def bf16(x):      # the same bf16 values, through their bits
        return torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)

    tq, tk, tv = (bf16(a).requires_grad_() for a in (jq, jk, jv))
    o = tfa.flash_attention(tq, tk, tv, **opts)
    assert o.dtype == torch.bfloat16
    (o.float() * bf16(jdo).float()).sum().backward()
    np.testing.assert_allclose(o.detach().float().numpy(),
                               np.asarray(jo, np.float32), atol=3e-2)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert got.dtype == torch.bfloat16
        scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=3e-2 * scale)


def test_cpu_tensors_launch_nothing_and_other_devices_raise():
    q, k, v, do, opts = _inputs("gqa2_window_softcap")
    before = (tfa.flash_attention.forward_launches, tfa.flash_attention.dq_launches,
              tfa.flash_attention.dkv_launches)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tfa.flash_attention(tq, tk, tv, **opts).sum().backward()
    assert (tfa.flash_attention.forward_launches, tfa.flash_attention.dq_launches,
            tfa.flash_attention.dkv_launches) == before
    meta = torch.empty(q.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfa.flash_forward(meta, torch.empty(k.shape, device="meta"),
                          torch.empty(v.shape, device="meta"), **opts)
    with pytest.raises(ValueError, match="GQA"):
        tfa.flash_attention(tq, tk, tv, group=3)


def test_smem_plan_covers_every_config_head_dim():
    """Head dims of the JAX package's configs (12 minicpm smoke, 16, 64
    minicpm, 112, 128 gemma2, 160 stablelm, 256) fit the float32 kernels'
    shared-memory plans; above 256 they are refused. ``analysis/smem.py``
    sums the plans; the card holds them to the CUDA source's own
    (``tests/test_torch_cuda.py::test_flash_smem_plans_fit_one_block``)."""
    from repro_torch.analysis import smem

    def supports(dh, dtype="bfloat16"):
        return smem.flash_attention_report(64, 64, dh, dtype).ok

    for dh in (12, 16, 64, 112, 128, 160, 256):
        assert supports(dh, "float32") and supports(dh), dh
    assert not supports(257)
    # every head dim up to 256 fits one block
    assert all(supports(dh, dt) for dh in range(1, tfa.MAX_HEAD_DIM + 1)
               for dt in ("float32", "bfloat16"))
    # float32: tiles of 64 (32 above 160), 3 staged operands + P
    assert smem.flash_smem("fwd", 64, "float32").total == 4 * (3 * 64 + 64) * 68
    assert smem.flash_smem("dkv", 256, "float32").total == 4 * ((4 * 256 + 64) * 36 + 64)


# Small versions of the card cases of tests/test_torch_cuda.py (FLASH_CASES):
# (B·Hkv, group, S, Dh, causal, window, softcap)
EMULATED = {
    "slice": (4, 1, 256, 64, True, None, None),
    "gemma2_like": (2, 2, 192, 128, True, 96, 50.0),
    "stablelm_dh160_gqa4": (1, 4, 128, 160, True, None, None),
    "smoke_dh12_gqa2": (3, 2, 16, 12, True, None, None),
    "ragged_dh256_window": (2, 1, 200, 256, True, 96, None),
    "bidirectional": (2, 1, 192, 64, False, None, None),
    "causal_1024": (2, 1, 1024, 64, True, None, None),
}


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _emulated_kernels(q, k, v, do, causal, window, softcap, group):
    """The bf16 tensor-core kernels' arithmetic, densely: scores from bf16
    inputs with exact products and float32 sums, times the scale after the
    product; P rounded to bf16 once before the P·V and Pᵀ·dO products; dS
    split into bf16 hi + lo (lo = bf16(dS − hi)) for dS·K and dSᵀ·Q, two
    products each; m, l, lse, delta and the accumulators in float32; dQ and dK
    times the scale at the end; outputs rounded to bf16."""
    scale = q.shape[-1] ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    s = (qf @ kf.transpose(1, 2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = tfa._mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(mask, s, tfa._MASK)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m > tfa._MASK_GUARD, torch.exp(s - m), 0.0)
    l = p.sum(-1)
    o = (_bf16(p) @ vf) / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, float("inf")))
    o = o.to(torch.bfloat16)
    delta = (o.float() * dof).sum(-1)
    p = torch.exp(s - lse[..., None])
    ds = p * (dof @ vf.transpose(1, 2) - delta[..., None])
    if softcap is not None:
        t = s / softcap
        ds = ds * torch.where(mask, 1.0 - t * t, 0.0)
    BHkv, T, Dh = k.shape
    dv = (_bf16(p).transpose(1, 2) @ dof).view(BHkv, group, T, Dh).sum(1)
    ds_hi = _bf16(ds)
    ds_lo = _bf16(ds - ds_hi)
    dk = (ds_hi.transpose(1, 2) @ qf + ds_lo.transpose(1, 2) @ qf
          ).view(BHkv, group, T, Dh).sum(1) * scale
    dq = (ds_hi @ kf + ds_lo @ kf) * scale
    return (o, lse, delta, dq.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


@pytest.mark.parametrize("name", list(EMULATED))
def test_bf16_rounding_points_stay_within_card_tolerance(name):
    """Rounding P to bf16 before its products and splitting dS into hi + lo
    (what the tensor-core kernels do) keeps the forward's o and lse, dQ and
    dK/dV within the card tests' unchanged bf16 tolerance of the plain
    versions: 2⁻⁷·max|plain| (lse 1e-4). Rounding P adds at most
    2⁻⁹·Σ pⱼ|vⱼ| to o before its own rounding to bf16; for random inputs far
    less. dQ = Σⱼ dSⱼ kⱼ and dK = Σᵢ dSᵢ qᵢ cancel heavily (Σⱼ dSⱼ ≈ 0 on
    each row), so dS goes into both products as hi + lo: rounded once, dQ
    comes close to the line at 1024 tokens and dK at 0.96 of it on seed 8
    (gemma2_like)."""
    _check_rounding_points(name, seed=7)


@pytest.mark.parametrize("name", list(EMULATED))
def test_bf16_rounding_points_hold_on_seed_8(name):
    """The same bound on the inputs of seed 8, where a single bf16 rounding
    of dS in dSᵀ·Q put dK at 0.96 of the tolerance (gemma2_like)."""
    _check_rounding_points(name, seed=8)


def _check_rounding_points(name, seed):
    BHkv, group, S, Dh, causal, window, softcap = EMULATED[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(n, S, Dh)).astype(np.float32))
                   .to(torch.bfloat16) for n in (BHkv * group, BHkv, BHkv, BHkv * group))
    opts = dict(causal=causal, window=window, softcap=softcap, group=group)
    o, lse, delta, dq, dk, dv = _emulated_kernels(q, k, v, do, **opts)
    o_r, lse_r = tfa.flash_forward_reference(q, k, v, **opts)
    dq_r = tfa.flash_dq_reference(q, k, v, do, lse, delta, **opts)
    dk_r, dv_r = tfa.flash_dkv_reference(q, k, v, do, lse, delta, **opts)
    for got, want, what in ((o, o_r, "o"), (dq, dq_r, "dq"), (dk, dk_r, "dk"),
                            (dv, dv_r, "dv")):
        assert got.dtype == want.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        tol = 2.0 ** -7 * want.float().abs().max().item()
        assert err <= tol, f"{what} ({name}): max|diff| {err:.3g} > {tol:.3g}"
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_r))
    fin = torch.isfinite(lse_r)
    assert (lse[fin] - lse_r[fin]).abs().max().item() <= 1e-4
