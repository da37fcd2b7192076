"""The port's moe and hybrid families and the dense qwen1.5-32b against the
JAX package, on the CPU at smoke size with float32 params.

* ``moe`` alone: expert ids (in top-k order) and keep masks EXACTLY equal
  to the JAX layer's routing — with drops (capacity factor 0.5), with
  exact ties among the router's probabilities (duplicated router columns
  over dyadic inputs, so that every sum is exact: the top k must take the
  lower expert index, as ``jax.lax.top_k`` does) and with
  ``moe_local_groups``; the output and the input and parameter gradients
  at rtol 1e-5 with atol 1e-5 of the leaf's largest value (float32 sums of
  the expert products in another order; the combine adds a token's k slot
  outputs in slot order where JAX scatter-adds them in buffer order).
* The port's twins of ``TestMoEInvariants``: with no drops the layer is
  exactly the gate-weighted mixture of each token's k experts (the gates
  sum to one); with drops a token loses its dropped slots' share, and a
  token dropped from every slot gets zero.
* ``ssm_heads`` forward and backward: rtol 1e-5, atol 1e-5 of the largest
  value (the S-step float32 recurrence in the same order; the projections'
  sums in another).
* Per arch (qwen1.5-32b, qwen3-moe, kimi-k2 with its dense first block,
  hymba): hiddens, per-example loss, mean loss and pooled features at rtol
  1e-5 (hiddens and pooled features also atol 1e-5 of their largest value:
  hymba's hiddens carry the SSM recurrence's exp and softplus, which
  XLA:CPU rounds less exactly than PyTorch, through three layers), with the
  JAX init carried across by the bridge; the weighted subset loss's gradients
  within rtol 1e-4 and 1e-5 of each leaf's largest gradient.
* A 6-step GRAFT run against ``jax.jit(make_train_step)`` for qwen3-moe and
  hymba: losses rtol 1e-4, ranks and pivots exactly equal.
* Checkpoints both ways for kimi-k2 (``first_blocks``, a list of unstacked
  blocks) and qwen3-moe (4-D stacked expert leaves), under AdamW and
  Adafactor (whose factored state of a stacked expert leaf is (L, E, D) and
  (L, E, F)): the port's leaf paths, shapes and dtypes are the JAX train
  state's; a JAX checkpoint restores in the port and a port checkpoint in
  JAX, every leaf bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api.config import ExperimentConfig as JExperimentConfig
from repro.backend import resolve as jresolve_backend
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.optim import OptimizerConfig as JOptCfg
from repro.selection.base import GraftConfig as JGraftConfig
from repro_torch import configs as tconfigs
from repro_torch.api import ExperimentConfig, Trainer
from repro_torch.checkpoint import (CheckpointManager, load_train_state, params_from_numpy,
                                    params_to_numpy, train_state_spec, train_state_to_host)
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.optim import OptimizerConfig as TOptCfg
from repro_torch.selection.base import GraftConfig as TGraftConfig

T = torch.from_numpy
ARCHS = ["qwen1.5-32b", "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b", "hymba-1.5b"]
MOE = "qwen3-moe-235b-a22b"


def _close(got, want, rtol=1e-5, scale=1e-5, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=scale * max(float(np.abs(want).max()), 1e-30), err_msg=msg)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _jax_routing(cfg, p, x):
    """(ids (G,gs,k), keep (G,gs·k)) as the JAX ``moe`` computes them: its
    routing lines (``repro/models/layers.py``), which the layer does not
    return."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    gs = min(cfg.moe_group_size, B * S)
    G = B * S // gs
    cap = int(gs * k / E * cfg.moe_capacity_factor) + 1
    if cfg.moe_local_groups and S % gs == 0 and S >= gs:
        xt = x.reshape(B, S // gs, gs, D).transpose(1, 0, 2, 3).reshape(G, gs, D)
    else:
        xt = x.reshape(G, gs, D)
    logits = jnp.einsum("gsd,de->gse", xt, p["router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    F = gs * k
    ids_flat = ids.reshape(G, F)
    counts = jax.vmap(lambda i: jnp.zeros((E,), jnp.int32).at[i].add(1))(ids_flat)
    starts = jnp.cumsum(counts, axis=1) - counts
    order = jnp.argsort(ids_flat, axis=1)
    pos_sorted = (jnp.arange(F, dtype=jnp.int32)[None, :] -
                  jnp.take_along_axis(starts, jnp.take_along_axis(ids_flat, order, axis=1),
                                      axis=1))
    pos_flat = jax.vmap(lambda o, ps: jnp.zeros((F,), jnp.int32).at[o].set(ps))(
        order, pos_sorted)
    return ids, pos_flat < cap


def _jax_value_and_vjp(fn, params, x, do):
    """fn(params, x) and its vjp of ``do``, jitted (compiling once is faster
    than JAX's op-by-op dispatch here)."""
    def both(p, xx, g):
        out, vjp = jax.vjp(fn, p, xx)
        return out, vjp(g)
    return jax.jit(both)({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                         jnp.asarray(do))


def _moe_case(case, seed=0):
    """(JAX cfg, port cfg, JAX params, port params, x) for one MoE case, float32."""
    ov = {"param_dtype": "float32"}
    B, S = 2, 32
    if case == "drop":
        ov["moe_capacity_factor"] = 0.5
    elif case == "local_groups":
        ov["moe_local_groups"] = True
        B, S = 2, 128                    # two chunks of the group size 64 a sequence
    elif case == "no_drops":
        ov["moe_capacity_factor"] = 8.0
    elif case == "drops_quarter":
        ov["moe_capacity_factor"] = 0.25
    jm, tm = jsmoke(MOE, **ov), tsmoke(MOE, **ov)
    jp = jlayers.init_moe_params(jax.random.PRNGKey(seed), jm, jnp.float32)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, jm.d_model)).astype(np.float32)
    if case == "ties":
        # dyadic inputs and router: every logit is exact in any summation
        # order; columns 0-2 and 4-5 equal, so top-2 must break ties low
        x = (rng.integers(-4, 5, size=x.shape) * 0.25).astype(np.float32)
        router = (rng.integers(-2, 3, size=jp["router"].shape) * 0.125).astype(np.float32)
        router[:, 1] = router[:, 2] = router[:, 0]
        router[:, 5] = router[:, 4]
        jp["router"] = router
    tp = {k: T(v.copy()).requires_grad_() for k, v in jp.items()}
    return jm, tm, jp, tp, x


@pytest.mark.parametrize("case", ["plain", "drop", "ties", "local_groups"])
def test_moe_matches_jax(case):
    jm, tm, jp, tp, x = _moe_case(case)
    jids, jkeep = (np.asarray(a) for a in jax.jit(functools.partial(_jax_routing, jm))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x)))
    tx = T(x).requires_grad_()
    xt, _ = tlayers.moe_groups(tm, tx)
    r = tlayers.moe_routing(tm, tp["router"], xt)
    np.testing.assert_array_equal(r.ids.numpy(), jids)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    if case == "drop":
        assert not jkeep.all()
    if case == "ties":        # where columns 0-2 lead, the top 2 are 0 then 1, never 2
        probs = torch.softmax(xt.detach() @ tp["router"].detach(), -1)
        lead = probs[..., 0] == probs.max(-1).values
        assert bool(lead.any()) and bool((probs[..., 2] == probs[..., 0]).all())
        assert bool((r.ids[lead] == torch.tensor([0, 1])).all())

    do = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jout, (jgp, jgx) = _jax_value_and_vjp(lambda p, xx: jlayers.moe(jm, p, xx),
                                          jp, x, do)
    tout = tlayers.moe(tm, tp, tx)
    names = sorted(tp)
    grads = torch.autograd.grad(tout, [tx] + [tp[n] for n in names], T(do))
    _close(tout.detach().numpy(), jout, msg="out")
    _close(grads[0].numpy(), jgx, msg="dx")
    for n, g in zip(names, grads[1:]):
        _close(g.numpy(), jgp[n], msg=n)


def _dense_mixture(tm, tp, x):
    """Σ_j gate_j · expert_{ids_j}(x_t) for every token, expert by expert."""
    xt, _ = tlayers.moe_groups(tm, x)
    r = tlayers.moe_routing(tm, tp["router"], xt)
    tok = xt.reshape(-1, tm.d_model)
    ids, gate = r.ids.reshape(tok.shape[0], -1), r.gate.reshape(tok.shape[0], -1)
    out = torch.zeros_like(tok)
    for j in range(ids.shape[1]):
        wg, wu, wd = (tp[n][ids[:, j]] for n in ("w_gate", "w_up", "w_down"))
        h = torch.nn.functional.silu(torch.einsum("td,tdf->tf", tok, wg)) * \
            torch.einsum("td,tdf->tf", tok, wu)
        out = out + gate[:, j:j + 1] * torch.einsum("tf,tfd->td", h, wd)
    return out.reshape(x.shape), r


def test_moe_without_drops_is_the_gate_weighted_mixture():
    """Mass conservation: every assignment kept, the k gates sum to one."""
    _, tm, _, tp, x = _moe_case("no_drops")
    with torch.no_grad():
        want, r = _dense_mixture(tm, tp, T(x))
        got = tlayers.moe(tm, tp, T(x))
    assert bool(r.keep.all())
    np.testing.assert_allclose(r.gate.sum(-1).numpy(), 1.0, rtol=1e-6)
    _close(got.numpy(), want.numpy())


def test_moe_capacity_drops_reduce_the_output():
    _, tm, _, tp, x = _moe_case("drops_quarter")
    with torch.no_grad():
        full, r = _dense_mixture(tm, tp, T(x))
        got = tlayers.moe(tm, tp, T(x))
    keep = r.keep.reshape(-1, tm.num_experts_per_tok)
    assert not bool(keep.all())
    assert float((got - full).abs().max()) > 1e-4
    dropped = ~keep.any(-1)
    assert bool(dropped.any()) and bool((got.reshape(-1, tm.d_model)[dropped] == 0).all())
    kept = keep.all(-1)
    _close(got.reshape(-1, tm.d_model)[kept].numpy(), full.reshape(-1, tm.d_model)[kept].numpy())


def test_moe_refuses_the_dropless_decode_path():
    """The dropless path was refused before the serving path was ported:
    now it keeps every assignment (capacity = the group size) and equals the
    gate-weighted mixture, where the capacity rule at 0.25 drops."""
    _, tm, _, tp, x = _moe_case("drops_quarter")
    with torch.no_grad():
        want, r = _dense_mixture(tm, tp, T(x))
        got = tlayers.moe(tm, tp, T(x), dropless=True)
        dropping = tlayers.moe(tm, tp, T(x))
    assert not bool(r.keep.all())
    xt, _ = tlayers.moe_groups(tm, T(x))
    assert bool(tlayers.moe_routing(tm, tp["router"], xt, dropless=True).keep.all())
    _close(got.numpy(), want.numpy())
    assert float((got - dropping).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the SSM heads
# ---------------------------------------------------------------------------

def test_ssm_heads_forward_and_backward_match_jax():
    jm = jsmoke("hymba-1.5b", param_dtype="float32")
    tm = tsmoke("hymba-1.5b", param_dtype="float32")
    jp = {k: np.asarray(v) for k, v in
          jssm.init_ssm_params(jax.random.PRNGKey(2), jm, jnp.float32).items()}
    rng = np.random.default_rng(4)
    jp["delta_bias"] = rng.normal(size=jp["delta_bias"].shape).astype(np.float32)
    jp["D_skip"] = (1 + 0.1 * rng.normal(size=jp["D_skip"].shape)).astype(np.float32)
    x = rng.normal(size=(3, 20, jm.d_model)).astype(np.float32)
    do = rng.normal(size=x.shape).astype(np.float32)
    jout, (jgp, jgx) = _jax_value_and_vjp(lambda p, xx: jssm.ssm_heads(jm, p, xx)[0],
                                          jp, x, do)
    assert jssm.ssm_heads(jm, {k: jnp.asarray(v) for k, v in jp.items()},
                          jnp.asarray(x[:, :2]))[1] is None
    tp = {k: T(v.copy()).requires_grad_() for k, v in jp.items()}
    tx = T(x).requires_grad_()
    tout, tstate = tssm.ssm_heads(tm, tp, tx)
    assert tstate is None
    names = sorted(tp)
    grads = torch.autograd.grad(tout, [tx] + [tp[n] for n in names], T(do))
    _close(tout.detach().numpy(), jout, msg="out")
    _close(grads[0].numpy(), jgx, msg="dx")
    for n, g in zip(names, grads[1:]):
        _close(g.numpy(), jgp[n], msg=n)


# ---------------------------------------------------------------------------
# the four architectures
# ---------------------------------------------------------------------------

def _pair(arch, **ov):
    ov = dict(ov, param_dtype="float32")
    jm, tm = jsmoke(arch, **ov), tsmoke(arch, **ov)
    jparams = jmodel.init_params(jm, jax.random.PRNGKey(1))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tmodel.Model(tm))
    return jm, tm, jparams, model


def _batch(B=4, S=32, V=256, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, V, size=(B, S)).astype(np.int32),
            "labels": rng.integers(0, V, size=(B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_losses_and_pooled_features_match_jax(arch):
    jm, tm, jparams, model = _pair(arch)
    b = _batch()
    jh, jl, jloss, jpool = jax.jit(lambda p, jb: (
        jmodel.forward_hiddens(jm, p, jb)[0], jmodel.per_example_loss(jm, p, jb),
        jmodel.loss_fn(jm, p, jb)[0], jmodel.pooled_features(jm, p, jb)))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: T(v) for k, v in b.items()}
    with torch.no_grad():
        th, tmask = tmodel.forward_hiddens(tm, model, tb)
        tl = tmodel.per_example_loss(tm, model, tb)
        tloss, _ = tmodel.loss_fn(tm, model, tb)
        tpool = tmodel.pooled_hiddens(th, tmask)     # what selection_inputs factors
    _close(th.numpy(), jh, msg="hiddens")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _close(tpool.numpy(), jpool, msg="pooled")


@pytest.mark.parametrize("arch", ARCHS)
def test_weighted_subset_loss_grads_match_jax(arch):
    jm, tm, jparams, model = _pair(arch)
    b = _batch(seed=3)
    w = np.asarray([0.5, 0.25, 0.25, 0.0], np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jmodel.per_example_loss(
        jm, p, {k: jnp.asarray(v) for k, v in b.items()}) * jnp.asarray(w))))(jparams)
    loss = torch.sum(tmodel.per_example_loss(tm, model, {k: T(v) for k, v in b.items()}) * T(w))
    leaves, spec = torch.utils._pytree.tree_flatten(model.tree())
    grads = torch.autograd.grad(loss, leaves)
    tg = params_to_numpy(torch.utils._pytree.tree_unflatten(list(grads), spec))
    flat_t, tdef = jax.tree_util.tree_flatten(tg)
    flat_j, jdef = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, jg))
    assert tdef == jdef
    for a, e in zip(flat_t, flat_j):
        _close(a, e, rtol=1e-4, scale=1e-5)


OPT = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8,
           warmup_steps=1)


@pytest.mark.parametrize("arch", [MOE, "hymba-1.5b"])
def test_six_steps_match_jax_step_functions(arch):
    gc = dict(rset=(2, 4), eps=0.25, refresh_every=2, use_pallas=True)
    jm = jsmoke(arch, param_dtype="float32")
    tm = tsmoke(arch, param_dtype="float32")
    jt = jsteps.TrainConfig(optimizer=JOptCfg(**OPT), graft=JGraftConfig(**gc),
                            probe_positions=8)
    tt = tsteps.TrainConfig(optimizer=TOptCfg(**OPT), graft=TGraftConfig(**gc),
                            probe_positions=8)
    data = SyntheticLM(DataConfig(vocab_size=jm.vocab_size, seq_len=32, global_batch=8))
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                              tmodel.Model(tm))
    tstate = tsteps.state_for_model(tm, tt, model, 8)
    jfn, tfn = jax.jit(jsteps.make_train_step(jm, jt)), tsteps.make_train_step(tm, tt)
    for step in range(6):
        b = data.batch_at(step)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tmet = tfn(tstate, {k: T(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-4)
        assert int(tmet["rank"]) == int(jmet["rank"])
        np.testing.assert_array_equal(tstate["graft"].pivots.numpy(),
                                      np.asarray(jstate["graft"].pivots))
        assert tmet["healthy"] == 1.0


# ---------------------------------------------------------------------------
# checkpoints of the new trees
# ---------------------------------------------------------------------------

_TORCH_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                      torch.int32: "int32"}
SMALL = ["train.batch=8", "train.seq=16", "graft.rset=[2,4]", "graft.refresh_every=2",
         "graft.use_pallas=true", "train.log_every=0"]


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _scramble(tree, seed=0):
    """Every float leaf of a JAX state replaced by random values of its
    dtype, so that no leaf is zero or equal to another."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.dtype.kind != "f" and a.dtype.name != "bfloat16":
            return jnp.asarray(a)
        return jnp.asarray(rng.normal(size=a.shape).astype(np.float32)).astype(a.dtype)
    return jax.tree_util.tree_map(f, tree)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", MOE])
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoints_cross_both_ways(tmp_path, arch, opt):
    overrides = SMALL + [f"model.arch={arch}", f"optimizer.name={opt}", "train.steps=2",
                         f"train.checkpoint_dir={tmp_path / 'port'}"]
    mcfg, tcfg, _ = ExperimentConfig().apply_overrides(overrides).build()
    jm, jt, _ = JExperimentConfig().apply_overrides(overrides).build()
    jstate = jsteps.init_train_state(jm, jt, jax.random.PRNGKey(0), 8)
    jflat = _flatten_with_paths(jstate)
    tstate = tsteps.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(0), 8)
    spec = {k: (tuple(s), _TORCH_DTYPE_NAMES[d]) for k, (s, d) in
            train_state_spec(tstate).items()}
    assert spec == {k: (tuple(a.shape), a.dtype.name) for k, a in jflat.items()}
    if arch == MOE:
        L, E, D, F = (mcfg.num_layers, mcfg.num_experts, mcfg.d_model, mcfg.d_ff)
        assert spec["params/blocks/moe/w_gate"][0] == (L, E, D, F)
        if opt == "adafactor":
            assert spec["opt/v/blocks/moe/w_gate/vr"][0] == (L, E, D)
            assert spec["opt/v/blocks/moe/w_gate/vc"][0] == (L, E, F)
    else:
        assert spec["params/first_blocks/0/mlp/w_up"][0] == (mcfg.d_model, mcfg.d_ff_dense)

    # JAX → port
    jstate = _scramble(jstate)
    JCheckpointManager(str(tmp_path / "jax")).save(4, jstate)
    step, flat, _ = CheckpointManager(str(tmp_path / "jax")).restore_latest_good(
        train_state_spec(tstate))
    load_train_state(tstate, flat)
    host = train_state_to_host(tstate)
    want = _flatten_with_paths(jstate)
    assert step == 4 and set(host) == set(want)
    for k in host:
        if not k.startswith("health/"):           # the port keeps the EMA on the host
            np.testing.assert_array_equal(_bits(host[k]), _bits(want[k]), err_msg=k)

    # port → JAX
    trainer = Trainer(ExperimentConfig().apply_overrides(overrides), device="cpu")
    trainer.fit()
    tree = JCheckpointManager(str(tmp_path / "port")).restore(
        2, jsteps.init_train_state(jm, jt, jax.random.PRNGKey(1), 8), verify=True,
        backend=jresolve_backend(None))
    got = _flatten_with_paths(tree)
    port = train_state_to_host(trainer.state)
    assert set(got) == set(port)
    for k in port:
        np.testing.assert_array_equal(_bits(got[k]), _bits(port[k]), err_msg=k)


def test_first_blocks_are_dense_global_and_unstacked():
    jm, tm, jparams, model = _pair("kimi-k2-1t-a32b")
    tree = model.tree()
    assert len(tree["first_blocks"]) == 1 and len(tree["blocks"]) == tm.num_layers - 1
    assert set(tree["first_blocks"][0]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(tree["blocks"][0]) == {"ln1", "attn", "ln2", "moe"}
    assert tree["first_blocks"][0]["mlp"]["w_gate"].shape == (tm.d_model, tm.d_ff_dense)
    back = params_to_numpy(model)
    flat_b, bdef = jax.tree_util.tree_flatten(back)
    flat_j, jdef = jax.tree_util.tree_flatten(jax.tree_util.tree_map(np.asarray, jparams))
    assert bdef == jdef
    for a, e in zip(flat_b, flat_j):
        np.testing.assert_array_equal(a, np.asarray(e, np.float32))
    paths = [p for p, _ in tmodel.stacked_leaves(model)]
    assert "first_blocks/0/attn/wq" in paths and "blocks/moe/router" in paths


def test_init_params_distributions():
    cfg = tsmoke(MOE, d_model=128)
    m = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    moe = m.blocks[0].moe
    assert moe["router"].dtype == torch.float32 and moe["w_gate"].dtype == cfg.dtype
    assert abs(moe["router"].std().item() - 128 ** -0.5) < 0.02
    assert abs(moe["w_down"].float().std().item() - cfg.d_ff ** -0.5) < 0.01
    cfg = tsmoke("hymba-1.5b")
    ssm = tmodel.init_params(cfg, torch.Generator().manual_seed(0)).blocks[1].ssm
    assert torch.equal(ssm["A_log"][3], torch.log(torch.arange(1.0, cfg.ssm_state + 1)))
    assert torch.all(ssm["D_skip"] == 1) and torch.all(ssm["delta_bias"] == 0)
    assert ssm["w_B"].shape == (cfg.d_model, cfg.num_heads, cfg.ssm_state)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_model_match_jax(arch):
    assert dataclasses.asdict(tsmoke(arch)) == dataclasses.asdict(jsmoke(arch))
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
