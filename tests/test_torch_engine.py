"""The port's selection engine (``repro_torch.selection.engine``) and the
multi-batch slice against the JAX package, on the CPU.

* Engine parity: the same numpy stack through the JAX
  ``engine.select_multi_batch`` (the ``use_pallas`` stack runs the batched
  Pallas kernel in interpret mode) and the port's (its plain versions):
  pivots and ranks EXACT, weights atol 1e-6, ``last_error``/``alignment``
  atol 1e-5 — the tolerances of the JAX package's own engine tests; the
  errors are Gram-Schmidt sums taken in another order.
* Within the port, the batched path equals a loop of ``select_batch``
  exactly: the same plain functions run on the same rows.
* The slice at smoke size: minicpm-2b smoke with the JAX init carried
  across, ``microbatch_stack`` → ``selection_inputs`` per microbatch →
  ``select_multi_batch``, against the same JAX pipeline: pivots and ranks
  exact, weights atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.selection import engine as jengine
from repro.selection.base import GraftConfig as JGraftConfig
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import graft_select as tgs
from repro_torch.launch import steps as tsteps
from repro_torch.models.model import Model
from repro_torch.selection import engine, registry
from repro_torch.selection.base import GraftConfig, Sampler, SelectionState
from repro_torch.selection.graft import graft_select

T = torch.from_numpy
GC = dict(rset=(2, 4, 8), eps=0.25)


def _stack(seed, B=4, K=24, d=16, R=8):
    rng = np.random.default_rng(seed)
    Vs = rng.normal(size=(B, K, R)).astype(np.float32)
    Gs = rng.normal(size=(B, d, K)).astype(np.float32)
    return Vs, Gs, Gs.mean(axis=2).astype(np.float32)


def _assert_state_close(t: SelectionState, j, B):
    np.testing.assert_array_equal(t.pivots.numpy(), np.asarray(j.pivots))
    np.testing.assert_array_equal(t.rank.numpy(), np.asarray(j.rank))
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights), atol=1e-6)
    np.testing.assert_allclose(t.last_error.numpy(), np.asarray(j.last_error), atol=1e-5)
    np.testing.assert_allclose(t.alignment.numpy(), np.asarray(j.alignment), atol=1e-5)
    assert t.pivots.shape == (B, 8) and t.step.shape == (B,)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("B", [3, 4])
def test_multi_batch_matches_jax_engine(use_pallas, B):
    Vs, Gs, gbs = _stack(B, B=B)
    jstate, _ = jengine.select_multi_batch(
        JGraftConfig(**GC, use_pallas=use_pallas), "graft",
        jnp.asarray(Vs), jnp.asarray(Gs), jnp.asarray(gbs), step=3)
    before = (tgs.graft_select.launches, tgs.graft_select_batched.launches)
    tstate, carry = engine.select_multi_batch(
        GraftConfig(**GC, use_pallas=use_pallas), "graft", T(Vs), T(Gs), T(gbs), step=3)
    assert (tgs.graft_select.launches, tgs.graft_select_batched.launches) == before
    assert carry == {}
    _assert_state_close(tstate, jstate, B)
    assert tstate.step.tolist() == [3] * B


@pytest.mark.parametrize("use_pallas", [False, True])
def test_multi_batch_equals_loop_of_select_batch(use_pallas):
    Vs, Gs, gbs = _stack(5)
    cfg = GraftConfig(**GC, use_pallas=use_pallas)
    multi, _ = engine.select_multi_batch(cfg, "graft", T(Vs), T(Gs), T(gbs), step=1)
    for b in range(Vs.shape[0]):
        single, carry = engine.select_batch(cfg, "graft", T(Vs[b]), T(Gs[b]),
                                            T(gbs[b]), step=1)
        assert carry == {}
        direct = graft_select(cfg, T(Vs[b]), T(Gs[b]), T(gbs[b]), torch.tensor(1))
        for field in SelectionState._fields:
            assert torch.equal(getattr(multi, field)[b], getattr(single, field)), field
            assert torch.equal(getattr(single, field), getattr(direct, field)), field


@pytest.fixture
def toy_samplers():
    """A stateful and a score-needing sampler, registered for one test."""
    def init_carry(cfg, spec):
        return {"count": torch.tensor(0, dtype=torch.int32),
                "ema": torch.zeros(spec.grad_dim)}

    def select_fn(cfg, inputs, carry, step):
        state = graft_select(cfg, inputs.V, inputs.G, inputs.g_bar, step)
        return state, {"count": carry["count"] + 1,
                       "ema": 0.5 * carry["ema"] + 0.5 * inputs.g_bar}

    def by_score(cfg, inputs, step):
        return graft_select(cfg, inputs.V, inputs.G, inputs.g_bar, step)

    made = [registry.register(Sampler("toy_stateful", select_fn=select_fn,
                                      init_carry_fn=init_carry)),
            registry.register(Sampler("toy_scored", by_score, needs_scores=True))]
    yield {s.name: s for s in made}
    for s in made:
        registry._REGISTRY.pop(s.name)


def test_stateful_carry_stacks_per_lane_and_round_trips(toy_samplers):
    B, d = 3, 16
    Vs, Gs, gbs = _stack(6, B=B, d=d)
    cfg = GraftConfig(**GC)
    multi, carry = engine.select_multi_batch(cfg, "toy_stateful", T(Vs), T(Gs), T(gbs))
    assert multi.pivots.shape == (B, 8)
    assert carry["count"].shape == (B,) and carry["ema"].shape == (B, d)
    assert carry["count"].tolist() == [1] * B
    np.testing.assert_allclose(carry["ema"].numpy(), 0.5 * gbs, rtol=1e-6)
    multi2, carry2 = engine.select_multi_batch(cfg, "toy_stateful", T(Vs), T(Gs),
                                               T(gbs), carry=carry, step=1)
    assert carry2["count"].tolist() == [2] * B
    np.testing.assert_allclose(carry2["ema"].numpy(), 0.75 * gbs, rtol=1e-6)
    # each lane streams on its own: lane b equals select_batch on lane b
    _, c_lane = engine.select_batch(cfg, "toy_stateful", T(Vs[1]), T(Gs[1]), T(gbs[1]),
                                    carry={k: v[1] for k, v in carry.items()}, step=1)
    assert torch.equal(c_lane["ema"], carry2["ema"][1])
    assert torch.equal(multi2.pivots, multi.pivots)
    assert "toy_stateful" in registry.available()


def test_needs_scores_raises_and_scores_pass_through(toy_samplers):
    Vs, Gs, gbs = _stack(7, B=2)
    cfg = GraftConfig(**GC)
    with pytest.raises(ValueError, match="requires SelectionInputs.scores"):
        engine.select_multi_batch(cfg, "toy_scored", T(Vs), T(Gs), T(gbs))
    with pytest.raises(ValueError, match="requires SelectionInputs.scores"):
        engine.select_batch(cfg, "toy_scored", T(Vs[0]), T(Gs[0]), T(gbs[0]))
    scores = torch.ones(2, Vs.shape[1])
    multi, _ = engine.select_multi_batch(cfg, "toy_scored", T(Vs), T(Gs), T(gbs),
                                         scores=scores)
    assert multi.pivots.shape == (2, 8)


def test_sharded_engine_is_not_ported():
    V = torch.zeros(16, 8)
    with pytest.raises(NotImplementedError, match="A10"):
        engine.select_sharded(GraftConfig(**GC), None, V, torch.zeros(4, 16))
    with pytest.raises(NotImplementedError, match="A10"):
        engine.make_sharded_selector(GraftConfig(**GC), None)


@pytest.mark.parametrize("step,num_micro", [(0, 3), (6, 4)])
def test_microbatch_stack_byte_identical_to_jax(step, num_micro):
    kw = dict(vocab_size=97, seq_len=12, global_batch=5, seed=3)
    want = JSyntheticLM(JDataConfig(**kw)).microbatch_stack(step, num_micro)
    src = SyntheticLM(DataConfig(**kw))
    got = src.microbatch_stack(step, num_micro)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (num_micro, 5, 12)
        assert got[k].tobytes() == want[k].tobytes()
    assert src.microbatch_stack(step, num_micro)["tokens"].tobytes() == \
        got["tokens"].tobytes()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_multi_batch_slice_matches_jax_pipeline(use_pallas):
    """minicpm-2b smoke: microbatch stack → selection inputs per microbatch
    → one multi-batch selection, in both packages from the same init."""
    gc = dict(rset=(2, 4), eps=0.25, use_pallas=use_pallas)
    jm = jsmoke("minicpm-2b", param_dtype="float32")
    tm = tsmoke("minicpm-2b", param_dtype="float32")
    jt = jsteps.TrainConfig(graft=JGraftConfig(**gc), probe_positions=8)
    tt = tsteps.TrainConfig(graft=GraftConfig(**gc), probe_positions=8)
    jparams = jmodel.init_params(jm, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), Model(tm))
    kw = dict(vocab_size=jm.vocab_size, seq_len=16, global_batch=8)
    stack = SyntheticLM(DataConfig(**kw)).microbatch_stack(0, 3)
    jstack = JSyntheticLM(JDataConfig(**kw)).microbatch_stack(0, 3)
    assert all(stack[k].tobytes() == jstack[k].tobytes() for k in stack)
    B = 3
    jin = [jsteps.selection_inputs(jm, jt, jparams,
                                   {k: jnp.asarray(v[b]) for k, v in jstack.items()})
           for b in range(B)]
    tin = [tsteps.selection_inputs(tm, tt, model,
                                   {k: T(np.ascontiguousarray(v[b])) for k, v in stack.items()})
           for b in range(B)]
    jV, jG, jg, js = (jnp.stack(x) for x in zip(*jin))
    tV, tG, tg, ts = (torch.stack(x) for x in zip(*tin))
    jstate, _ = jengine.select_multi_batch(jt.graft, "graft", jV, jG, jg, scores=js)
    tstate, _ = engine.select_multi_batch(tt.graft, "graft", tV, tG, tg, scores=ts)
    np.testing.assert_array_equal(tstate.pivots.numpy(), np.asarray(jstate.pivots))
    np.testing.assert_array_equal(tstate.rank.numpy(), np.asarray(jstate.rank))
    np.testing.assert_allclose(tstate.weights.numpy(), np.asarray(jstate.weights),
                               atol=1e-6)
    assert tstate.pivots.shape == (B, 4)
    # the other path of the port agrees with this one exactly in pivots
    other, _ = engine.select_multi_batch(
        dataclasses.replace(tt.graft, use_pallas=not use_pallas), "graft", tV, tG, tg)
    assert torch.equal(other.pivots, tstate.pivots) and torch.equal(other.rank, tstate.rank)
