"""The port's model, weight bridge, optimizer, schedules and data against the
JAX package's, on the CPU at smoke size with float32 params.

Tolerances: forward hiddens and per-example losses rtol 1e-5 — the
matmuls sum in another order; the hiddens also atol 1e-5, since they are
RMS-normalized to O(1) and an entry near zero carries the absolute
rounding of the O(1) sums that produced it; gradients of
the weighted subset loss rtol 1e-4 (atol 1e-6) — the backward adds one
more reassociated sum per layer. The optimizer update and the schedules
agree to rtol 1e-6 (float32 elementwise arithmetic, transcendental ulps).
Data batches and bf16 checkpoint leaves are compared bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager
from repro.configs import get_smoke_config as jsmoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as jmodel
from repro.optim import OptimizerConfig as JOptCfg
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import schedules as jsched
from repro_torch.checkpoint import load_jax_checkpoint, params_from_numpy, params_to_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.data.pipeline import DataConfig as TDataConfig
from repro_torch.data.pipeline import SyntheticLM as TSyntheticLM
from repro_torch.models import model as tmodel
from repro_torch.optim import OptimizerConfig as TOptCfg
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.optim import schedules as tsched

# smoke minicpm variants: the default, KV-chunked attention, a gemma-like
# block (sliding window on alternate layers, logit softcaps, post-norms,
# QKV bias, GELU), GQA with an untied head; and the flash backend on three
# of them (the JAX side runs its Pallas kernels in interpret mode, the port
# its plain flash versions)
VARIANTS = {
    "default": {},
    "chunked": {"attn_backend": "chunked", "attn_chunk": 4},
    "window_softcap": {"sliding_window": 3, "layer_pattern": ("local", "global"),
                       "attn_logit_softcap": 20.0, "final_logit_softcap": 15.0,
                       "post_block_norm": True, "qkv_bias": True,
                       "mlp_activation": "gelu", "query_scale": 0.3},
    "gqa_untied": {"num_kv_heads": 2, "tie_embeddings": False, "remat": "full"},
}
for _name in ("default", "window_softcap", "gqa_untied"):
    VARIANTS[f"flash_{_name}"] = dict(VARIANTS[_name], attn_backend="flash")


def _batch(B=4, S=8, V=257, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, V, size=(B, S)).astype(np.int32),
            "labels": rng.integers(0, V, size=(B, S)).astype(np.int32)}


def _pair(variant):
    ov = dict(VARIANTS[variant], param_dtype="float32")
    jcfg = jsmoke("minicpm-2b", **ov)
    tcfg = tsmoke("minicpm-2b", **ov)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    tm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                           tmodel.Model(tcfg))
    return jcfg, tcfg, jparams, tm


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_and_per_example_loss_match_jax(variant):
    jcfg, tcfg, jparams, tm = _pair(variant)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jh, _ = jmodel.forward_hiddens(jcfg, jparams, jb)
    with torch.no_grad():
        th, _ = tmodel.forward_hiddens(tcfg, tm, tb)
        tl = tmodel.per_example_loss(tcfg, tm, tb)
        tloss, _ = tmodel.loss_fn(tcfg, tm, tb)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jmodel.per_example_loss(jcfg, jparams, jb)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jmodel.loss_fn(jcfg, jparams, jb)[0]),
                               rtol=1e-5)


@pytest.mark.parametrize("variant", ["default", "window_softcap", "gqa_untied",
                                     "flash_default", "flash_window_softcap",
                                     "flash_gqa_untied"])
def test_weighted_subset_loss_grads_match_jax(variant):
    jcfg, tcfg, jparams, tm = _pair(variant)
    b = _batch(seed=3)
    w = np.asarray([0.5, 0.25, 0.25, 0.0], np.float32)

    def jloss(p):
        return jnp.sum(jmodel.per_example_loss(jcfg, p, {k: jnp.asarray(v) for k, v in b.items()})
                       * jnp.asarray(w))

    jg = jax.grad(jloss)(jparams)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss = torch.sum(tmodel.per_example_loss(tcfg, tm, tb) * torch.from_numpy(w))
    tree = tm.tree()
    leaves, spec = torch.utils._pytree.tree_flatten(tree)
    grads = torch.autograd.grad(loss, leaves)
    tg = params_to_numpy(torch.utils._pytree.tree_unflatten(list(grads), spec))
    jg_np = jax.tree_util.tree_map(np.asarray, jg)
    flat_t, _ = jax.tree_util.tree_flatten(tg)
    flat_j, _ = jax.tree_util.tree_flatten(jg_np)
    assert len(flat_t) == len(flat_j)
    for a, e in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-6)


def test_bridge_round_trip_and_shape_check():
    jcfg, tcfg, jparams, tm = _pair("gqa_untied")
    back = params_to_numpy(tm)
    for a, e in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams))):
        np.testing.assert_array_equal(a, e)
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, tmodel.Model(tcfg))


def test_bf16_params_bridge_by_bits():
    jcfg = jsmoke("minicpm-2b")                      # bf16 params
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(2))
    tm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                           tmodel.Model(tsmoke("minicpm-2b")))
    assert tm.embed.dtype == torch.bfloat16
    want = np.asarray(jparams["embed"]).view(np.uint16)
    np.testing.assert_array_equal(tm.embed.detach().view(torch.int16).numpy().view(np.uint16), want)


def test_load_jax_checkpoint_bf16_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    bf = rng.normal(size=(5, 7)).astype(ml_dtypes.bfloat16)
    tree = {"params": {"w": jnp.asarray(bf), "b": jnp.arange(4, dtype=jnp.float32)},
            "step": jnp.int32(7)}
    CheckpointManager(str(tmp_path), async_save=False).save(3, tree)
    got = load_jax_checkpoint(str(tmp_path))
    w = got["params"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.view(torch.int16).numpy().view(np.uint16),
                                  bf.view(np.uint16))
    np.testing.assert_array_equal(got["params"]["b"].numpy(), np.arange(4, dtype=np.float32))
    assert int(got["step"]) == 7
    # a flipped byte fails the checksum
    f = next(tmp_path.glob("step_*/params_w.npy"))
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        load_jax_checkpoint(str(tmp_path))


def test_attention_backend_routing():
    """flash runs on CPU tensors through its plain versions (no launch, close
    to the dense path); the audio and vlm families build, an unknown family
    raises."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    m = tmodel.init_params(tsmoke("minicpm-2b", param_dtype="float32"),
                           torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    launches = (fa.forward_launches, fa.dq_launches, fa.dkv_launches)
    with torch.no_grad():
        hf, _ = tmodel.forward_hiddens(
            tsmoke("minicpm-2b", param_dtype="float32", attn_backend="flash"), m, b)
        hd, _ = tmodel.forward_hiddens(
            tsmoke("minicpm-2b", param_dtype="float32", attn_backend="dense"), m, b)
    assert (fa.forward_launches, fa.dq_launches, fa.dkv_launches) == launches
    np.testing.assert_allclose(hf.numpy(), hd.numpy(), rtol=1e-5, atol=1e-5)
    # the audio and vlm families and their frontends build (they were
    # refused before the classification task was ported); unknown ones raise
    assert set(tmodel.Model(tsmoke("minicpm-2b", family="audio")).tree()["blocks"][0]) == \
        {"ln1", "attn", "ln2", "mlp"}
    tmodel.Model(tsmoke("minicpm-2b", frontend="vision_patches"))
    from repro import configs as jconfigs
    from repro_torch import configs
    assert dataclasses.asdict(configs.get_config("musicgen-medium")) == \
        dataclasses.asdict(jconfigs.get_config("musicgen-medium"))
    with pytest.raises(ValueError, match="family"):
        tmodel.Model(tsmoke("minicpm-2b", family="encoder"))


@pytest.mark.parametrize("backend,overrides,S,device,want", [
    ("auto", {}, 16, "cpu", "dense"),
    ("auto", {"attn_chunk": 4}, 16, "cpu", "chunked"),
    ("auto", {}, 16, "cuda", "flash"),
    ("auto", {"attn_chunk": 4}, 16, "cuda", "flash"),
    ("auto", {}, 12, "cuda", "dense"),              # no JAX block size divides 12
    ("auto", {"head_dim": 320}, 16, "cuda", "dense"),   # above the kernels' 256
    ("auto", {"param_dtype": "float16"}, 16, "cuda", "dense"),
    ("flash", {}, 16, "cpu", "flash"),
    ("flash", {"attn_chunk": 4}, 12, "cpu", "chunked"),
    ("dense", {}, 16, "cuda", "dense"),
    ("chunked", {"attn_chunk": 4}, 16, "cuda", "chunked"),
    ("auto", {"head_dim": 128}, 65536, "cuda", "flash"),  # no VMEM guard
])
def test_resolve_attn_backend_by_device(backend, overrides, S, device, want):
    """auto → flash on the card when feasible (as the JAX package on the
    TPU), dense/chunked on the CPU; explicit flash falls back only on an
    infeasible shape. The JAX VMEM guard is not copied (the Hopper kernels
    tile KV): 65536 tokens at head_dim 128 are flash."""
    from repro_torch.models.layers import resolve_attn_backend
    cfg = tsmoke("minicpm-2b", attn_backend=backend, **overrides)
    assert resolve_attn_backend(cfg, S, S, torch.device(device)) == want


def test_init_params_distributions():
    cfg = tsmoke("minicpm-2b", d_model=64, num_heads=4, head_dim=16, d_ff=256, vocab_size=512)
    m = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    assert m.embed.dtype == torch.bfloat16 and m.final_norm.dtype == torch.float32
    assert abs(m.embed.float().std().item() - 0.02) < 0.002
    assert abs(m.blocks[0].attn["wq"].float().std().item() - 64 ** -0.5) < 0.01
    assert torch.all(m.blocks[1].ln1 == 0)
    m2 = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(m.embed, m2.embed)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(rng, state_dtype):
    kw = dict(name="adamw", learning_rate=1e-2, schedule="cosine", total_steps=10,
              warmup_steps=2, clip_norm=0.5, state_dtype=state_dtype)
    jopt, topt = jmake_optimizer(JOptCfg(**kw)), tmake_optimizer(TOptCfg(**kw))
    p = {"a": rng.normal(size=(6, 5)).astype(np.float32),
         "b": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = [torch.from_numpy(p["a"].copy()),
          torch.from_numpy(p["b"].view(np.int16).copy()).view(torch.bfloat16)]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = {"a": rng.normal(size=(6, 5)).astype(np.float32),
             "b": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16)}
        jp, jstate, jm = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jnp.int32(step))
        tm = topt.apply(tp, [torch.from_numpy(g["a"]),
                             torch.from_numpy(g["b"].view(np.int16).copy()).view(torch.bfloat16)],
                        tstate, step)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp["a"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tp[1].float().numpy(),
                                   np.asarray(jp["b"]).astype(np.float32), rtol=1e-2)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tmake_optimizer(TOptCfg(name="lamb"))


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd", "linear"])
def test_schedules_match_jax(name):
    args = (3e-4,) if name == "constant" else (3e-4, 50, 5)
    jf, tf = jsched.SCHEDULES[name](*args), tsched.SCHEDULES[name](*args)
    for step in (0, 1, 4, 5, 6, 20, 44, 45, 46, 49, 50, 60):
        np.testing.assert_allclose(tf(step), float(jf(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=257, seq_len=16, global_batch=8),
    dict(vocab_size=1000, seq_len=33, global_batch=6, seed=5, num_clusters=7),
    dict(vocab_size=257, seq_len=16, global_batch=8, num_hosts=2, host_index=1),
])
def test_synthetic_lm_batches_are_byte_identical(kw):
    jd, td = JSyntheticLM(JDataConfig(**kw)), TSyntheticLM(TDataConfig(**kw))
    assert dataclasses.asdict(JDataConfig(**kw)) == dataclasses.asdict(TDataConfig(**kw))
    for step in (0, 1, 7):
        jb, tb = jd.batch_at(step), td.batch_at(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].tobytes() == tb[k].tobytes()
    assert td.spec() == jd.spec()
