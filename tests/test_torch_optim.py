"""The port's four optimizers against the JAX package's on the CPU.

Each of adamw, sgd, lion and adafactor, with float32 and bfloat16 state,
takes 4 steps on the same seeded leaves and gradients in both packages
(``repro.optim.make_optimizer`` and ``repro_torch.optim.make_optimizer``).
Tolerances are those of ``test_adamw_update_matches_jax``: the grad norm
and the learning rate rtol 1e-6, a float32 leaf rtol 1e-6 (atol 1e-7), a
bfloat16 leaf rtol 1e-2 (one bf16 rounding may land on either side). The
same holds for the state leaves. Adafactor takes a 1-D, a 2-D and a 3-D
leaf, and a leaf the port keeps as one tensor per block, factored across
the stack as the JAX tree's stacked leaf is.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import OptimizerConfig as JOptCfg
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.optim import OptimizerConfig as TOptCfg
from repro_torch.optim import make_optimizer as tmake_optimizer

SHAPES = {"vec": ((7,), np.float32), "mat": ((6, 5), np.float32),
          "bmat": ((4, 9), ml_dtypes.bfloat16), "cube": ((3, 4, 5), np.float32)}


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got: torch.Tensor, want, what):
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                   rtol=1e-2, err_msg=what)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=what)


def _draw(rng, shapes):
    return {k: rng.normal(size=s).astype(d) for k, (s, d) in shapes.items()}


def _run_both(name, state_dtype, shapes, rng, steps=4):
    kw = dict(name=name, learning_rate=1e-2, schedule="cosine", total_steps=10,
              warmup_steps=2, clip_norm=0.5, state_dtype=state_dtype)
    jopt, topt = jmake_optimizer(JOptCfg(**kw)), tmake_optimizer(TOptCfg(**kw))
    p = _draw(rng, shapes)
    keys = list(shapes)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = [_t(p[k]) for k in keys]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(steps):
        g = _draw(rng, shapes)
        jp, jstate, jm = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jnp.int32(step))
        tm = topt.apply(tp, [_t(g[k]) for k in keys], tstate, step)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        for i, k in enumerate(keys):
            _close(tp[i], jp[k], f"{name} step {step} param {k}")
    return keys, jstate, tstate


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "sgd", "lion", "adafactor"])
def test_optimizer_matches_jax(rng, name, state_dtype):
    keys, jstate, tstate = _run_both(name, state_dtype, SHAPES, rng)
    if name == "adafactor":
        assert tstate["groups"] == list(range(len(keys)))
        for i, k in enumerate(keys):
            want = jstate["v"][k]
            assert set(tstate["v"][i]) == set(want)
            for leaf, t in tstate["v"][i].items():
                assert t.dtype == getattr(torch, state_dtype)
                _close(t, want[leaf], f"adafactor {k}/{leaf}")
        return
    for moment in ("m", "v") if name == "adamw" else ("m",):
        assert set(tstate) == set(jstate)
        for i, k in enumerate(keys):
            assert tstate[moment][i].dtype == getattr(torch, state_dtype)
            _close(tstate[moment][i], jstate[moment][k], f"{name} {moment} {k}")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adafactor_factors_a_stacked_leaf_across_the_stack(rng, state_dtype):
    """Two per-block (D,) scales and two (D, F) matrices, grouped as the
    JAX tree stacks them: (2, D) is factored over both axes and (2, D, F)
    over its trailing two, and the update's RMS clip spans the stack."""
    kw = dict(name="adafactor", learning_rate=1e-2, schedule="constant", clip_norm=1.0,
              state_dtype=state_dtype)
    jopt, topt = jmake_optimizer(JOptCfg(**kw)), tmake_optimizer(TOptCfg(**kw))
    ln = rng.normal(size=(2, 6)).astype(np.float32)
    w = rng.normal(size=(2, 6, 4)).astype(np.float32)
    jp = {"ln": jnp.asarray(ln), "w": jnp.asarray(w)}
    tp = [_t(ln[0]), _t(ln[1]), _t(w[0]), _t(w[1])]
    groups = [[0, 1], [2, 3]]
    jstate, tstate = jopt.init(jp), topt.init(tp, groups)
    assert tuple(tstate["v"][0]["vr"].shape) == (2,) and tuple(tstate["v"][1]["vc"].shape) == (2, 4)
    for step in range(4):
        g_ln = rng.normal(size=(2, 6)).astype(np.float32)
        g_w = rng.normal(size=(2, 6, 4)).astype(np.float32)
        jp, jstate, _ = jopt.apply(jp, {"ln": jnp.asarray(g_ln), "w": jnp.asarray(g_w)},
                                   jstate, jnp.int32(step))
        topt.apply(tp, [_t(g_ln[0]), _t(g_ln[1]), _t(g_w[0]), _t(g_w[1])], tstate, step)
        for b in range(2):
            _close(tp[b], np.asarray(jp["ln"])[b], f"ln[{b}] step {step}")
            _close(tp[2 + b], np.asarray(jp["w"])[b], f"w[{b}] step {step}")
    for gi, k in enumerate(("ln", "w")):
        for leaf, t in tstate["v"][gi].items():
            _close(t, jstate["v"][k][leaf], f"{k}/{leaf}")


@pytest.mark.parametrize("name", ["adamw", "sgd", "lion"])
def test_update_after_preprocess_equals_apply(rng, name):
    """``preprocess`` then ``update`` (the train step's two halves, the
    sentinel's veto between them) is ``apply``, bit for bit."""
    kw = dict(name=name, learning_rate=1e-2, schedule="constant", clip_norm=0.5)
    opt = tmake_optimizer(TOptCfg(**kw))
    p = _draw(rng, SHAPES)
    g = [_t(x) for x in _draw(rng, SHAPES).values()]
    runs = []
    for split in (True, False):
        tp = [_t(x) for x in p.values()]
        st = opt.init(tp)
        if split:
            clipped, met = opt.preprocess(g)
            met["lr"] = opt.update(tp, clipped, st, 3)
        else:
            met = opt.apply(tp, g, st, 3)
        runs.append((tp, st, met))
    (a, sa, ma), (b, sb, mb) = runs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for k in sa for x, y in zip(sa[k], sb[k]))
    assert torch.equal(ma["grad_norm"], mb["grad_norm"]) and ma["lr"] == mb["lr"]


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tmake_optimizer(TOptCfg(name="lamb"))
