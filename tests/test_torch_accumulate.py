"""Gradient accumulation and ``remat="dots"`` in the port against the JAX
package, on the CPU.

* ``split_microbatches`` splits as the JAX function does and raises on an
  indivisible batch; ``accumulated_grads`` sums each microbatch's gradient
  in the parameter's dtype and takes the mean in float32, as JAX does: on
  inputs whose gradients are exact in float32 (dyadic values), its loss and
  its bf16 and float32 gradients are bit-equal to JAX's — where a float32
  accumulator would round the bf16 sums differently.
* The baseline step with ``microbatches`` 2 and 4 against
  ``jax.jit(make_train_step)``: losses rtol 1e-4 over 4 steps (AdamW
  compounds the matmuls' reassociation), and the first step's loss equal
  to the unsplit step's to float32 rounding (rtol 1e-6).
* ``remat="dots"``: the loss and every gradient bit-equal to
  ``remat="full"`` (the kept matrix products are the values the full
  recompute computes again), on dense, moe, hybrid and ssm smoke models
  and under the flash path's plain version; counted with a
  ``TorchDispatchMode``, the backward pass under ``dots`` runs exactly the
  blocks' forward GEMMs fewer mm / bmm / addmm / baddbmm than under
  ``full`` with the checkpoint's early stop off (which then re-runs each
  once), and as many as with no remat at all; and a 4-step GRAFT run with
  ``remat="dots"`` against JAX's (losses rtol 1e-4, ranks and pivots
  exactly equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.distributed import accumulate as jacc
from repro.launch import steps as jsteps
from repro.optim import OptimizerConfig as JOptCfg
from repro.selection.base import GraftConfig as JGraftConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.distributed import accumulate as tacc
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.optim import OptimizerConfig as TOptCfg
from repro_torch.selection.base import GraftConfig as TGraftConfig

T = torch.from_numpy
OPT = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8,
           warmup_steps=1)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_split_microbatches_matches_jax_and_refuses_indivisible():
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, 9, size=(8, 5)).astype(np.int32),
         "labels": rng.normal(size=(8, 5, 3)).astype(np.float32)}
    want = jacc.split_microbatches({k: jnp.asarray(v) for k, v in b.items()}, 4)
    got = tacc.split_microbatches({k: T(v) for k, v in b.items()}, 4)
    assert len(got) == 4
    for i, mb in enumerate(got):
        for k in b:
            np.testing.assert_array_equal(mb[k].numpy(), np.asarray(want[k][i]))
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        jacc.split_microbatches({k: jnp.asarray(v) for k, v in b.items()}, 3)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        tacc.split_microbatches({k: T(v) for k, v in b.items()}, 3)


@pytest.mark.parametrize("num_micro", [2, 4])
def test_accumulated_grads_match_jax_bit_for_bit(num_micro):
    """loss = Σ_leaf mean(x · p.f32)² over a microbatch: the gradient
    2·Σ_rows x·(x·p) is a sum of dyadic products, exact in float32 in any
    order, so the only roundings are the casts and the accumulation's."""
    rng = np.random.default_rng(1)
    x = (rng.integers(-8, 9, size=(8, 6)) / 16).astype(np.float32)
    pa = (rng.integers(-64, 65, size=(6, 3)) / 64).astype(np.float32)   # bf16 leaf
    pb = (rng.integers(-64, 65, size=(6,)) / 64).astype(np.float32)     # f32 leaf
    jparams = {"a": jnp.asarray(pa).astype(jnp.bfloat16), "b": jnp.asarray(pb)}

    def jloss(p, mb):
        return (jnp.sum((mb["x"] @ p["a"].astype(jnp.float32)) ** 2)
                + jnp.sum((mb["x"] * p["b"]) ** 2)) * 0.5

    jl, jg = jacc.accumulated_grads(jloss, jparams, {"x": jnp.asarray(x)}, num_micro)
    tparams = [T(pa).to(torch.bfloat16).requires_grad_(), T(pb.copy()).requires_grad_()]

    def tloss(mb):
        return (torch.sum((mb["x"] @ tparams[0].to(torch.float32)) ** 2)
                + torch.sum((mb["x"] * tparams[1]) ** 2)) * 0.5

    tl, tg = tacc.accumulated_grads(tloss, tparams, {"x": T(x)}, num_micro)
    assert tl.dtype == torch.float32 and float(tl) == float(jl)
    assert tg[0].dtype == torch.bfloat16 and tg[1].dtype == torch.float32
    np.testing.assert_array_equal(_bits(tg[0]),
                                  np.asarray(jg["a"]).view(np.int16))
    np.testing.assert_array_equal(tg[1].numpy(), np.asarray(jg["b"]))
    # the bf16 leaf's sums did round: over 4 microbatches a float32
    # accumulator gives another mean (over 2, bf16(a + b) · 0.5 is exact)
    f32_mean = (sum(torch.autograd.grad(tloss(mb), tparams[0])[0].float()
                    for mb in tacc.split_microbatches({"x": T(x)}, num_micro))
                * (1 / num_micro)).to(torch.bfloat16)
    assert torch.equal(f32_mean, tg[0]) == (num_micro == 2)


@pytest.mark.parametrize("num_micro", [2, 4])
def test_baseline_step_with_microbatches_matches_jax(num_micro):
    jm = jsmoke("minicpm-2b", param_dtype="float32")
    tm = tsmoke("minicpm-2b", param_dtype="float32")
    jt = jsteps.TrainConfig(optimizer=JOptCfg(**OPT), microbatches=num_micro)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(**OPT), microbatches=num_micro)
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=16, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                              tmodel.Model(tm))
    tstate = tsteps.state_for_model(tm, tt, model, 8)
    one = tsteps.state_for_model(tm, tsteps.TrainConfig(optimizer=TOptCfg(**OPT)),
                                 params_from_numpy(jax.tree_util.tree_map(
                                     np.asarray, jstate["params"]), tmodel.Model(tm)), 8)
    jfn, tfn = jax.jit(jsteps.make_train_step(jm, jt)), tsteps.make_train_step(tm, tt)
    for step in range(4):
        b = data.batch_at(step)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, {k: T(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        assert tmet["healthy"] == 1.0
        if step == 0:
            _, m1 = tsteps.make_train_step(tm, tsteps.TrainConfig(optimizer=TOptCfg(**OPT)))(
                one, {k: T(v) for k, v in b.items()})
            np.testing.assert_allclose(float(tmet["loss"]), float(m1["loss"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# remat = dots
# ---------------------------------------------------------------------------

GEMMS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


class _CountGemms(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in GEMMS
        return func(*args, **(kwargs or {}))


CASES = {"dense": ("minicpm-2b", {}),
         "flash_plain": ("minicpm-2b", {"attn_backend": "flash"}),
         "moe": ("qwen3-moe-235b-a22b", {}),
         "hybrid": ("hymba-1.5b", {}),
         "ssm": ("rwkv6-7b", {})}


def _loss_and_grads(arch, ov, remat, count=False, early_stop=True):
    cfg = tsmoke(arch, param_dtype="float32", remat=remat, **ov)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    b = {k: T(rng.integers(0, cfg.vocab_size, size=(4, 16)).astype(np.int32))
         for k in ("tokens", "labels")}
    w = torch.tensor([0.5, 0.25, 0.25, 0.0])
    params = list(model.parameters())
    counter = _CountGemms()
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        loss = torch.sum(tmodel.per_example_loss(cfg, model, b) * w)
        if count:
            with counter:
                grads = torch.autograd.grad(loss, params)
        else:
            grads = torch.autograd.grad(loss, params)
    return loss, grads, counter.n, (cfg, model, b)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_dots_is_bit_equal_to_full(case):
    arch, ov = CASES[case]
    lf, gf, _, _ = _loss_and_grads(arch, ov, "full")
    ld, gd, _, _ = _loss_and_grads(arch, ov, "dots")
    assert torch.equal(lf, ld)
    assert all(torch.equal(a, b) for a, b in zip(gf, gd))


@pytest.mark.parametrize("case", ["dense", "moe", "hybrid"])
def test_remat_dots_backward_reruns_none_of_the_blocks_forward_gemms(case):
    """With the checkpoint's early stop off, ``full`` re-runs the whole
    block (by default it stops once the last tensor the backward needs is
    recomputed, which skips a block's closing GEMM when no backward reads
    its output)."""
    arch, ov = CASES[case]
    kw = dict(count=True, early_stop=False)
    _, _, bwd_full, (cfg, model, b) = _loss_and_grads(arch, ov, "full", **kw)
    _, _, bwd_dots, _ = _loss_and_grads(arch, ov, "dots", **kw)
    _, _, bwd_none, _ = _loss_and_grads(arch, ov, "none", **kw)
    blocks_fwd = _CountGemms()
    with blocks_fwd:                      # the stack's forward alone, kept for grad
        tmodel.forward_hiddens(dataclasses.replace(cfg, remat="none"), model, b)
    assert blocks_fwd.n > 0
    assert bwd_full - bwd_dots == blocks_fwd.n
    assert bwd_dots == bwd_none


def test_remat_dots_training_matches_jax():
    gc = dict(rset=(2, 4), eps=0.25, refresh_every=2, use_pallas=True)
    jm = jsmoke("minicpm-2b", param_dtype="float32", remat="dots")
    tm = tsmoke("minicpm-2b", param_dtype="float32", remat="dots")
    jt = jsteps.TrainConfig(optimizer=JOptCfg(**OPT), graft=JGraftConfig(**gc),
                            probe_positions=8)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(**OPT), graft=TGraftConfig(**gc),
                            probe_positions=8)
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=16, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                              tmodel.Model(tm))
    tstate = tsteps.state_for_model(tm, tt, model, 8)
    jfn, tfn = jax.jit(jsteps.make_train_step(jm, jt)), tsteps.make_train_step(tm, tt)
    for step in range(4):
        b = data.batch_at(step)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, {k: T(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        assert int(tmet["rank"]) == int(jmet["rank"])
        np.testing.assert_array_equal(tstate["graft"].pivots.numpy(),
                                      np.asarray(jstate["graft"].pivots))
