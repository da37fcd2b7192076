"""The port's RWKV6 family and its WKV recurrence against the JAX package,
on the CPU.

* ``ops.rwkv_scan`` (the plain version for CPU tensors) against
  ``rwkv_scan_pallas`` in interpret mode at the JAX kernel test's four
  shapes: atol 2e-4, the JAX test's own tolerance against its oracle.
* The gradient — ``rwkv_scan_backward_reference`` and autograd through
  ``_RwkvScan`` — against ``jax.vjp`` of ``ref.rwkv_chunk_ref`` per stream:
  atol 1e-5 (float32 sums of up to T·D products in another order; the
  gradients are O(1)).
* ``rwkv_time_mix`` / ``rwkv_channel_mix`` against the JAX functions with
  the same params: float32 rtol/atol 1e-5; bfloat16 atol 2e-2 (a few bf16
  ulps: both round the same float32 values at slightly different places).
* The rwkv6-7b smoke model's hiddens, per-example loss and gradients with
  the JAX init carried across by the bridge, under remat none and full:
  hiddens 1e-5; grads within 1e-4 of each leaf's largest gradient. That is
  looser per element than the dense model's rtol 1e-4 / atol 1e-6 because
  XLA:CPU's float32 tanh is ~7 times less exact than PyTorch's (2.3e-7 vs
  3.2e-8 on N(0, 4) inputs) and the per-head group norm divides by a
  small standard deviation; the recurrence's own gradient is held at atol
  1e-5 above, and the explicit backward agrees with autograd through the
  plain loop to ~1e-6 of each leaf's largest gradient.
* An 8-step GRAFT run against ``jax.jit(make_train_step)`` (no mesh): loss
  rtol 1e-4 (AdamW compounds the reassociation over 8 updates), ranks,
  pivots and weights EXACTLY equal, under ``use_pallas`` true and false.
* The card kernels' order of sums (``csrc/rwkv_scan.cu``), emulated in
  float32, against ``rwkv_chunk_ref`` and its ``jax.vjp`` at the card's
  tolerances (o 1e-5·max + 1e-6, gradients 1e-4·max + 1e-6), and the
  backward block's shared-memory plan.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv_scan import rwkv_scan_pallas
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.optim import OptimizerConfig as JOptCfg
from repro.selection.base import GraftConfig as JGraftConfig
from repro_torch.api import cli as tcli
from repro_torch.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv_scan as trw
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.optim import OptimizerConfig as TOptCfg
from repro_torch.selection.base import GraftConfig as TGraftConfig
from torch_cases import RWKV_SHAPES, rwkv_case

T = torch.from_numpy


def _jax_error(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,T_,D,chunk", RWKV_SHAPES)
def test_ops_rwkv_scan_matches_pallas_kernel(BH, T_, D, chunk):
    r, k, v, w, u, _ = rwkv_case(BH, T_, D)
    want = np.asarray(rwkv_scan_pallas(*map(jnp.asarray, (r, k, v, w, u)),
                                       chunk=chunk, interpret=True))
    before = trw.rwkv_scan.launches
    got = ops.rwkv_scan(T(r), T(k), T(v), T(w), T(u), chunk=chunk)
    assert trw.rwkv_scan.launches == before      # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (BH, T_, D)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    np.testing.assert_allclose(trw.rwkv_scan_reference(T(r), T(k), T(v), T(w), T(u)).numpy(),
                               want, atol=2e-4)


def test_ops_rwkv_scan_chunk_invariance_and_casts():
    r, k, v, w, u, _ = rwkv_case(2, 64, 32, seed=1)
    outs = [ops.rwkv_scan(T(r), T(k), T(v), T(w), T(u), chunk=c) for c in (8, 16, 64)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    # bf16 inputs are cast to float32, as the JAX wrapper casts them
    bf = [T(a).to(torch.bfloat16) for a in (r, k, v, w, u)]
    got = ops.rwkv_scan(*bf, chunk=16)
    want = ops.rwkv_scan(*[t.float() for t in bf], chunk=16)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    jwant = np.asarray(jops.rwkv_scan(*[jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                                        for t in bf], chunk=16))
    np.testing.assert_allclose(got.numpy(), jwant, atol=2e-4)


def test_ops_rwkv_scan_raises_the_jax_message():
    z, o = np.zeros((1, 30, 8), np.float32), np.ones((1, 30, 8), np.float32)
    uz = np.zeros((1, 8), np.float32)
    want = _jax_error(rwkv_scan_pallas, jnp.asarray(z), jnp.asarray(z), jnp.asarray(z),
                      jnp.asarray(o), jnp.asarray(uz), chunk=16, interpret=True)
    assert want == "T=30 not divisible by chunk=16"
    assert _jax_error(ops.rwkv_scan, T(z), T(z), T(z), T(o), T(uz), chunk=16) == want
    # the kernel module itself takes any T
    assert trw.rwkv_scan(T(z), T(z), T(z), T(o), T(uz)).shape == (1, 30, 8)


def _jax_vjp(r, k, v, w, u, do):
    """Per-stream jax.vjp of the oracle → (dr, dk, dv, dw, du per stream)."""
    def one(r_, k_, v_, w_, u_, do_):
        _, f = jax.vjp(jref.rwkv_chunk_ref, r_, k_, v_, w_, u_)
        return f(do_)
    return [np.asarray(g) for g in jax.vmap(one)(*map(jnp.asarray, (r, k, v, w, u, do)))]


@pytest.mark.parametrize("BH,T_,D,w_low", [(1, 32, 16, 0.4), (4, 64, 32, 0.4),
                                          (2, 40, 12, 0.0), (3, 33, 64, 0.4)])
def test_backward_reference_matches_jax_vjp(BH, T_, D, w_low):
    """Includes w near 0 (w_low 0), where dividing by w would blow up, and
    T that is not a multiple of the kernels' time tile."""
    r, k, v, w, u, do = rwkv_case(BH, T_, D, seed=2, w_low=w_low)
    want = _jax_vjp(r, k, v, w, u, do)
    got = trw.rwkv_scan_backward_reference(*map(T, (r, k, v, w, u, do)))
    for name, g, e in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        np.testing.assert_allclose(g.numpy(), e, atol=1e-5, err_msg=name)
    # the CPU wrapper runs the plain version and counts no launch
    before = trw.rwkv_scan_backward.launches
    again = trw.rwkv_scan_backward(*map(T, (r, k, v, w, u, do)))
    assert trw.rwkv_scan_backward.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_autograd_through_rwkv_scan_matches_jax_vjp():
    """One u shared by every stream, expanded as the model does: its
    gradient is the per-stream du summed over the streams."""
    BH, T_, D = 4, 48, 16
    r, k, v, w, u, do = rwkv_case(BH, T_, D, seed=3)
    u1 = u[0]
    want = _jax_vjp(r, k, v, w, np.broadcast_to(u1, (BH, D)).copy(), do)
    leaves = [T(a).requires_grad_() for a in (r, k, v, w, u1)]
    o = trw.rwkv_scan(*leaves[:4], leaves[4].expand(BH, D).contiguous())
    np.testing.assert_allclose(o.detach().numpy(), np.stack([
        np.asarray(jref.rwkv_chunk_ref(*map(jnp.asarray, (r[b], k[b], v[b], w[b], u1))))
        for b in range(BH)]), atol=2e-5)
    grads = torch.autograd.grad(o, leaves, T(do))
    for name, g, e in zip(("dr", "dk", "dv", "dw"), grads[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), e, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(grads[4].numpy(), want[4].sum(0), atol=1e-5)


def test_rwkv_scan_refuses_what_jax_cannot_hold():
    with pytest.raises(ValueError, match="u shape"):
        trw.rwkv_scan(*[torch.zeros(2, 8, 4)] * 4, torch.zeros(1, 4))
    with pytest.raises(ValueError, match="VMEM budget"):
        trw.rwkv_scan_forward(*[torch.zeros(1, 1, 2048)] * 4, torch.zeros(1, 2048))
    assert trw.vmem_bytes(64) == 4 * (4 * 32 * 64 + 64 * 64 + 32 * 64)
    assert trw.vmem_bytes(1024) <= trw.VMEM_BUDGET_BYTES


# ---------------------------------------------------------------------------
# the blocks and the model
# ---------------------------------------------------------------------------

def _smoke_pair(dtype="float32", **ov):
    jm = jsmoke("rwkv6-7b", param_dtype=dtype, **ov)
    tm = tsmoke("rwkv6-7b", param_dtype=dtype, **ov)
    jparams = jmodel.init_params(jm, jax.random.PRNGKey(1))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tmodel.Model(tm))
    return jm, tm, jparams, model


def _perturb(jparams, seed=5):
    """Nonzero lora_B (zero at init), so that the data-dependent lerp and
    decay take part."""
    rng = np.random.default_rng(seed)
    blocks = dict(jparams["blocks"])
    time = dict(blocks["time"])
    for n in "rkvwg":
        x = time[f"lora_B_{n}"]
        time[f"lora_B_{n}"] = jnp.asarray(rng.normal(size=x.shape) * 0.1).astype(x.dtype)
    blocks["time"] = time
    return dict(jparams, blocks=blocks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_match_jax(dtype):
    jm, tm, jparams, _ = _smoke_pair(dtype)
    jparams = _perturb(jparams)
    pt = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])
    tp = {sec: {n: torch.from_numpy(np.asarray(a, np.float32)).to(tm.dtype if
                np.asarray(a).dtype != np.float32 else torch.float32)
                for n, a in pt[sec].items()} for sec in ("time", "channel")}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 20, jm.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jm.dtype)
    tx = T(x).to(tm.dtype)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=0, atol=2e-2)
    for jfn, tfn, sec in ((jssm.rwkv_time_mix, tssm.rwkv_time_mix, "time"),
                          (jssm.rwkv_channel_mix, tssm.rwkv_channel_mix, "channel")):
        jo, jstate = jfn(jm, pt[sec], jx)
        to, tstate = tfn(tm, tp[sec], tx)
        assert jstate is None and tstate is None and to.dtype == tm.dtype
        np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                                   err_msg=sec, **tol)


def _batch(B=4, S=12, V=256, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, V, size=(B, S)).astype(np.int32),
            "labels": rng.integers(0, V, size=(B, S)).astype(np.int32)}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_model_forward_and_grads_match_jax(remat):
    jm, tm, jparams, _ = _smoke_pair(remat=remat)
    jparams = _perturb(jparams)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tmodel.Model(tm))
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: T(v) for k, v in b.items()}
    jh, _ = jmodel.forward_hiddens(jm, jparams, jb)
    with torch.no_grad():
        th, _ = tmodel.forward_hiddens(tm, model, tb)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    w = np.asarray([0.5, 0.25, 0.25, 0.0], np.float32)
    jg = jax.grad(lambda p: jnp.sum(jmodel.per_example_loss(jm, p, jb) * w))(jparams)
    loss = torch.sum(tmodel.per_example_loss(tm, model, tb) * T(w))
    np.testing.assert_allclose(float(loss), float(jnp.sum(
        jmodel.per_example_loss(jm, jparams, jb) * w)), rtol=1e-5)
    leaves, spec = torch.utils._pytree.tree_flatten(model.tree())
    grads = torch.autograd.grad(loss, leaves)
    tg = params_to_numpy(torch.utils._pytree.tree_unflatten(list(grads), spec))
    flat_t, tdef = jax.tree_util.tree_flatten(tg)
    flat_j, jdef = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert tdef == jdef
    for a, e in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-4 * np.abs(e).max())
    # the recurrence's own parameters get a gradient
    assert np.abs(tg["blocks"]["time"]["u"]).sum() > 0
    assert np.abs(tg["blocks"]["time"]["decay_B"]).sum() > 0


def test_bridge_round_trip_and_block_layout():
    jm, tm, jparams, model = _smoke_pair("bfloat16")
    back = params_to_numpy(model)
    flat_b, bdef = jax.tree_util.tree_flatten(back)
    flat_j, jdef = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, jparams))
    assert bdef == jdef
    for a, e in zip(flat_b, flat_j):
        np.testing.assert_array_equal(a, np.asarray(e, np.float32))
    blk = model.blocks[0].tree()
    assert set(blk) == {"ln1", "time", "ln2", "channel"}
    assert blk["time"]["w0"].dtype == torch.float32 and blk["time"]["wr"].dtype == torch.bfloat16
    assert blk["time"]["lora_A"].shape == (64, 32)         # lora_r = max(32, D // 64)
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["blocks"]["time"]["u"] = bad["blocks"]["time"]["u"][:, :8]
    with pytest.raises(ValueError, match="blocks/time/u"):
        params_from_numpy(bad, tmodel.Model(tm))


def test_init_params_distributions():
    cfg = tsmoke("rwkv6-7b", d_model=128, d_ff=256)
    m = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    t, c = m.blocks[0].time, m.blocks[0].channel
    assert abs(t["wr"].float().std().item() - 128 ** -0.5) < 0.01
    assert abs(t["decay_B"].float().std().item() - 0.01) < 0.002
    assert abs(t["u"].std().item() - 0.1) < 0.03 and t["u"].dtype == torch.float32
    assert abs(c["w_value"].float().std().item() - 256 ** -0.5) < 0.01
    assert all(torch.all(t[f"lora_B_{n}"] == 0) for n in "rkvwg")
    assert torch.all(t["w0"] == 0.5) and torch.all(t["ln_x_scale"] == 1)
    assert torch.all(c["mu_k"].float() == 0.5) and torch.all(m.blocks[1].ln2 == 0)
    m2 = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(m2.blocks[1].time["u"], m.blocks[1].time["u"])


def test_decode_state_and_ssm_heads_are_refused():
    """The decode states were refused before the serving path was ported:
    now each mix and the SSM heads take a state and return the state after
    the last token, and one token at a time from it equals the whole
    sequence at once (float32, rtol 1e-5; the sequence runs the RWKV
    kernel's plain version, the steps the state loop); the vlm family
    builds."""
    for arch in ("rwkv6-7b", "hymba-1.5b"):
        tm = tsmoke(arch, param_dtype="float32")
        blk = tmodel.init_params(tm, torch.Generator().manual_seed(0)).tree()["blocks"][0]
        x = torch.randn(2, 5, tm.d_model, generator=torch.Generator().manual_seed(1))
        H, Dh = tm.num_heads, tm.d_model // tm.num_heads
        if arch == "rwkv6-7b":
            fns = [(lambda s, xx: tssm.rwkv_time_mix(tm, blk["time"], xx, state=s),
                    {"shift": torch.zeros(2, 1, tm.d_model), "wkv": torch.zeros(2, H, Dh, Dh)}),
                   (lambda s, xx: tssm.rwkv_channel_mix(tm, blk["channel"], xx, state=s),
                    {"shift": torch.zeros(2, 1, tm.d_model)})]
        else:
            fns = [(lambda s, xx: tssm.ssm_heads(tm, blk["ssm"], xx, state=s),
                    torch.zeros(2, H, Dh, tm.ssm_state))]
        with torch.no_grad():
            for fn, state in fns:
                whole, none = fn(None, x)
                assert none is None
                outs = []
                for t in range(5):
                    out, state = fn(state, x[:, t:t + 1])
                    outs.append(out)
                np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                                           rtol=1e-5, atol=1e-5 * float(whole.abs().max()))
        if arch == "rwkv6-7b":
            assert torch.equal(state["shift"], x[:, -1:])
    tmodel.Model(dataclasses.replace(tsmoke("rwkv6-7b"), family="vlm"))


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

OPT = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8,
           warmup_steps=1)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_eight_steps_match_jax_step_functions(use_pallas):
    gc = dict(rset=(2, 4), eps=0.25, refresh_every=2, use_pallas=use_pallas)
    jm = jsmoke("rwkv6-7b", param_dtype="float32")
    tm = tsmoke("rwkv6-7b", param_dtype="float32")
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
    ranks = []
    for step in range(8):
        b = data.batch_at(step)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, {k: T(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        assert int(tmet["rank"]) == int(jmet["rank"])
        np.testing.assert_array_equal(tstate["graft"].pivots.numpy(),
                                      np.asarray(jstate["graft"].pivots))
        np.testing.assert_array_equal(tstate["graft"].weights.numpy(),
                                      np.asarray(jstate["graft"].weights))
        assert tmet["healthy"] == 1.0
        ranks.append(int(tmet["rank"]))
        if step == 0:
            np.testing.assert_allclose(float(tmet["loss"]), 5.828477, rtol=1e-5)
    assert ranks == [2, 2, 4, 4, 4, 4, 2, 2]


def test_selection_inputs_match_jax():
    """The selection forward (probe grads on the untied lm_head) needs no
    ssm-specific code: V up to column sign, G, ḡ and scores agree."""
    gc = dict(rset=(2, 4), eps=0.25)
    jm, tm, jparams, model = _smoke_pair()
    jt = jsteps.TrainConfig(graft=JGraftConfig(**gc), probe_positions=8)
    tt = tsteps.TrainConfig(graft=TGraftConfig(**gc), probe_positions=8)
    b = SyntheticLM(DataConfig(vocab_size=256, seq_len=16, global_batch=8)).batch_at(3)
    jV, jG, jg, js = (np.asarray(x) for x in jsteps.selection_inputs(
        jm, jt, jparams, {k: jnp.asarray(v) for k, v in b.items()}))
    tV, tG, tg, ts = (x.numpy() for x in tsteps.selection_inputs(
        tm, tt, model, {k: T(v) for k, v in b.items()}))
    assert not tm.tie_embeddings and tG.shape == jG.shape == (tm.d_model, 8)
    sign = np.sign(np.sum(tV * jV, axis=0))
    np.testing.assert_allclose(tV * sign, jV, atol=1e-4)
    for got, want in ((tG, jG), (tg, jg), (ts, js)):   # the hiddens' 1e-5, scaled
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("overrides", [
    ["model.arch=rwkv6-7b"],
    ["model.arch=rwkv6-7b", "model.smoke=false", 'model.overrides={"num_layers": 16}',
     "graft.rset=[2,4,8]", "train.batch=16", "train.seq=256", "train.steps=6"],
])
def test_config_hash_and_model_match_jax(overrides):
    from repro.api.config import ExperimentConfig as JExperimentConfig
    from repro_torch.api import ExperimentConfig
    t = ExperimentConfig().apply_overrides(overrides)
    j = JExperimentConfig().apply_overrides(overrides)
    assert t.config_hash() == j.config_hash()
    assert t.finalized().to_json() == j.finalized().to_json()
    tm, jm = t.model.build(), j.model.build()
    assert tm.family == "ssm" and dataclasses.asdict(tm) == dataclasses.asdict(jm)


def test_cli_trains_rwkv_on_cpu(capsys):
    assert tcli.main(["--device=cpu", "--model.arch=rwkv6-7b", "--train.steps=3",
                      "--train.batch=8", "--train.seq=16", "--graft.rset=[2,4]",
                      "--graft.refresh_every=2", "--train.log_every=0"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["steps"] == 3 and np.isfinite(report["final_loss"])
    assert report["device"] == "cpu"


# ---------------------------------------------------------------------------
# the kernels' order of sums, emulated in float32 on the CPU
# ---------------------------------------------------------------------------

_F = np.float32


def _fma(a, b, c):
    """a·b + c rounded to float32 (the product is exact in float64; the sum
    rounds there first, which can differ from one rounding in the last bit)."""
    return (np.float64(1) * a * b + c).astype(_F)


def _tree(x, masks):
    """The kernels' shuffle sums over the last axis (lanes): at each mask m
    every lane adds lane ``l ^ m``; float32 addition commutes, so every lane
    ends with the same value. Returns lane 0's."""
    lanes = np.arange(x.shape[-1])
    for m in masks:
        x = (x + x[..., lanes ^ m]).astype(_F)
    return x[..., 0]


def _fwd_rows(rg):
    return [4 * rg + a for a in range(4)] + [32 + 4 * rg + a for a in range(4)]


def _bwd_cols(cg):
    return [4 * cg + a for a in range(4)] + [32 + 4 * cg + a for a in range(4)]


def _emulate_forward(r, k, v, w, u):
    """``csrc/rwkv_scan.cu``'s forward order of sums: per 64-row pass, each
    of 8 row groups sums its 8 rows by FMA; the groups add by lane bits 2, 1,
    0; the bonus Σ r u k is summed in 16 groups of 4 rows (lane bits 0-3);
    o = fma(bonus, v, sum); passes add in order."""
    BH, T, D = r.shape
    o = np.zeros((BH, T, D), _F)
    for i0 in range(0, D, 64):
        rows = min(64, D - i0)
        pad = lambda x: np.pad(x[..., i0:i0 + rows], [(0, 0)] * (x.ndim - 1) + [(0, 64 - rows)])
        rp, kp, wp, up = pad(r), pad(k), pad(w), pad(u)
        S = np.zeros((BH, 64, D), _F)
        for t in range(T):
            part = np.zeros((BH, D, 8), _F)
            for rg in range(8):
                for i in _fwd_rows(rg):
                    part[..., rg] = _fma(rp[:, t, i, None], S[:, i, :], part[..., rg])
            total = _tree(part, (4, 2, 1))
            ru = (rp[:, t] * up).astype(_F)
            bon = np.zeros((BH, 16), _F)
            for lane in range(16):
                i = 4 * lane
                bon[:, lane] = (ru[:, i] * kp[:, t, i]).astype(_F)
                for a in range(1, 4):
                    bon[:, lane] = _fma(ru[:, i + a], kp[:, t, i + a], bon[:, lane])
            bonus = _tree(bon, (1, 2, 4, 8))
            val = _fma(bonus[:, None], v[:, t], total)
            o[:, t] = val if i0 == 0 else (val + o[:, t]).astype(_F)
            kv = (kp[:, t, :, None] * v[:, t, None, :]).astype(_F)
            S = _fma(S, wp[:, t, :, None], kv)
    return o


def _emulate_backward(r, k, v, w, u, do):
    """The backward's order of sums: per (64-row, 64-column) pass, dr, dk, dw
    summed over a lane's 8 columns by FMA, then over the row's 8 lanes (lane
    bits 0, 1, 2); dv over a lane's 2 rows, then its warp's 4 row groups
    (lane bits 4, 3), then the 8 warps in order, then + (Σ r u k)·do; c and
    Σ r u k by warp-wide sums (lane bits 4 to 0); passes add in order."""
    BH, T, D = r.shape
    dr, dk, dv, dw = (np.zeros((BH, T, D), _F) for _ in range(4))
    du = np.zeros((BH, D), _F)
    # c_t = v_t · do_t over all D: lane l sums columns l, l + 32, ...
    cl = np.zeros((BH, T, 32), _F)
    for lane in range(32):
        for j in range(lane, max(D, 64), 32):
            if j < D:
                cl[..., lane] = _fma(v[..., j], do[..., j], cl[..., lane])
    c = _tree(cl, (16, 8, 4, 2, 1))
    for i0 in range(0, D, 64):
        nr = min(64, D - i0)
        du_acc = np.zeros((BH, 64), _F)
        for j0 in range(0, D, 64):
            nc = min(64, D - j0)

            def pad(x, lo, n, axis=-1):
                x = np.take(x, np.arange(lo, lo + n), axis=axis)
                widths = [(0, 0)] * x.ndim
                widths[axis] = (0, 64 - n)
                return np.pad(x, widths)
            rp, kp, wp = (pad(x, i0, nr) for x in (r, k, w))
            up = pad(u, i0, nr)
            vp, dop = pad(v, j0, nc), pad(do, j0, nc)
            # the states S_{t-1} of the pass, by the forward's expression
            prev, S = [], np.zeros((BH, 64, 64), _F)
            for t in range(T):
                prev.append(S)
                S = _fma(S, wp[:, t, :, None], (kp[:, t, :, None] * vp[:, t, None, :]).astype(_F))
            ru = (rp * up[:, None, :]).astype(_F)
            bl = np.zeros((BH, T, 32), _F)
            for lane in range(32):
                bl[..., lane] = (ru[..., lane] * kp[..., lane]).astype(_F)
                bl[..., lane] = _fma(ru[..., lane + 32], kp[..., lane + 32], bl[..., lane])
            bonus = _tree(bl, (16, 8, 4, 2, 1))
            dS = np.zeros((BH, 64, 64), _F)
            for t in reversed(range(T)):
                P = prev[t]
                parts = np.zeros((3, BH, 64, 8), _F)
                for cg in range(8):
                    for j in _bwd_cols(cg):
                        parts[0, ..., cg] = _fma(P[:, :, j], dop[:, t, None, j], parts[0, ..., cg])
                        parts[1, ..., cg] = _fma(dS[:, :, j], vp[:, t, None, j], parts[1, ..., cg])
                        parts[2, ..., cg] = _fma(dS[:, :, j], P[:, :, j], parts[2, ..., cg])
                drp, dkp, dwp = _tree(parts, (1, 2, 4))
                # dv: thread (warp wp, row group rg) holds rows 8 wp + rg and 8 wp + rg + 4
                q = np.zeros((BH, 8, 4, 64), _F)
                for wpi in range(8):
                    for rg in range(4):
                        i_a, i_b = 8 * wpi + rg, 8 * wpi + rg + 4
                        x = (dS[:, i_a] * kp[:, t, i_a, None]).astype(_F)
                        q[:, wpi, rg] = _fma(dS[:, i_b], kp[:, t, i_b, None], x)
                per_warp = ((q[:, :, 0] + q[:, :, 2]).astype(_F)
                            + (q[:, :, 1] + q[:, :, 3]).astype(_F)).astype(_F)
                acc = per_warp[:, 0]
                for wpi in range(1, 8):
                    acc = (acc + per_warp[:, wpi]).astype(_F)
                dvt = _fma(bonus[:, t, None], dop[:, t], acc)[:, :nc]
                dv[:, t, j0:j0 + nc] = dvt if i0 == 0 else (dv[:, t, j0:j0 + nc] + dvt).astype(_F)
                if j0 == 0:
                    ct = c[:, t, None]
                    drp = _fma((up * kp[:, t]).astype(_F), ct, drp)
                    dkp = _fma((up * rp[:, t]).astype(_F), ct, dkp)
                    du_acc = _fma((rp[:, t] * kp[:, t]).astype(_F), ct, du_acc)
                for out, val in ((dr, drp), (dk, dkp), (dw, dwp)):
                    val = val[:, :nr]
                    out[:, t, i0:i0 + nr] = val if j0 == 0 else (out[:, t, i0:i0 + nr] + val).astype(_F)
                dS = _fma(dS, wp[:, t, :, None], (rp[:, t, :, None] * dop[:, t, None, :]).astype(_F))
        du[:, i0:i0 + nr] = du_acc[:, :nr]
    return dr, dk, dv, dw, du


@pytest.mark.parametrize("BH,T_,D,w_low", [(2, 40, 12, 0.0), (3, 33, 64, 0.4),
                                          (2, 48, 64, 0.0), (1, 20, 100, 0.4)])
def test_kernel_order_of_sums_within_card_tolerance(BH, T_, D, w_low):
    """The card's kernels sum in another order than the JAX oracle: their
    order, emulated in float32, holds o within 1e-5·max + 1e-6 and every
    gradient within 1e-4·max + 1e-6 of ``rwkv_chunk_ref`` and its
    ``jax.vjp`` (phase rwkv's tolerances), with decays down to 0 (w_low 0),
    a T that is no multiple of the tiles, and D over one 64-row pass."""
    r, k, v, w, u, do = rwkv_case(BH, T_, D, seed=4, w_low=w_low)
    want_o = np.stack([np.asarray(jref.rwkv_chunk_ref(*map(jnp.asarray, (r[b], k[b], v[b], w[b],
                                                                         u[b]))))
                       for b in range(BH)])
    got_o = _emulate_forward(r, k, v, w, u)
    assert np.abs(got_o - want_o).max() <= 1e-5 * np.abs(want_o).max() + 1e-6
    for name, g, e in zip(("dr", "dk", "dv", "dw", "du"), _emulate_backward(r, k, v, w, u, do),
                          _jax_vjp(r, k, v, w, u, do)):
        assert g.shape == e.shape
        assert np.abs(g - e).max() <= 1e-4 * np.abs(e).max() + 1e-6, name


def test_backward_shared_memory_plan_fits_one_block():
    """The backward block's shared memory (``BwdSmem``): two buffers of 16
    steps of r, k, w (float4 rows), v and do, two 64 × 64 start states, the
    8 warps' dv partial sums and the tile's dr, dk, dw; under the 227 KB a
    block can take, over the 48 KB of static shared memory."""
    n = trw.backward_smem_bytes()
    assert n == 2 * 16 * 64 * 16 + 2 * 2 * 16 * 64 * 4 + 2 * 64 * 64 * 4 + 2 * 16 * 8 \
        + 64 * 4 + 16 * 8 * 64 * 4 + 3 * 16 * 64 * 4 == 127488
    assert 48 * 1024 < n <= 232448
    assert trw.TIME_TILE == 16 and trw.n_tiles(256) == 16 and trw.n_tiles(250) == 16
