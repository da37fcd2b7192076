"""The port's serving path against the JAX package, on the CPU at smoke size
with float32 params carried across by the bridge: the KV cache and the
recurrent decode states (``models/decode.py``), int8 KV quantization,
token sampling and the wave-scheduled serve loop.

* Decode: ``prefill`` and every ``decode_step`` of a 2-sequence batch
  against ``repro.models.decode`` called directly (no mesh) for the smoke
  configs of every family: logits at rtol 1e-5 with 1e-5 of their largest
  value, and every cache leaf (the JAX cache's stacked ``(L, …)`` leaves
  taken apart by ``_port_cache``) at the same tolerance; gemma2 at
  max_seq 32, so that its window of 16 bites; qwen3-moe at capacity 4.0 and
  at its default 1.25, where the one-token steps are dropless and the
  prefill drops; kimi-k2 with its dense first block's ``first`` cache.
* Decode against teacher forcing on the port alone, as the JAX package's
  ``TestDecodeParity``: within ``0.02·max(scale, 1) + 1e-3`` of the
  full-sequence forward.
* kv_quant bit-equal to JAX's (both round half to even).
* Sampling: greedy and the filtered logits equal to JAX's; the draw equal
  to ``jax.random.categorical`` with JAX's Gumbel noise added.
* Serve: ``serve_model`` against the same wave loop over JAX's
  ``prefill``/``decode_step`` on the same weights: the same tokens for every
  request; the JAX report keys; two runs with one seed equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.launch import sampling as jsampling
from repro.models import decode as jdecode
from repro.models import kv_quant as jkv
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.checkpoint import params_from_numpy
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch import sampling as tsampling
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as tdecode
from repro_torch.models import kv_quant as tkv
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

T = torch.from_numpy
# (case id, arch, config overrides, max_seq)
DECODE_CASES = [
    ("minicpm", "minicpm-2b", {}, 24),
    ("stablelm", "stablelm-12b", {}, 24),
    ("gemma2_window", "gemma2-27b", {}, 32),
    ("qwen15", "qwen1.5-32b", {}, 24),
    ("rwkv6", "rwkv6-7b", {}, 24),
    ("hymba", "hymba-1.5b", {}, 24),
    ("qwen3_moe_cf4", "qwen3-moe-235b-a22b", {"moe_capacity_factor": 4.0}, 24),
    ("qwen3_moe_dropless", "qwen3-moe-235b-a22b", {}, 24),
    ("kimi_k2_first", "kimi-k2-1t-a32b", {}, 24),
    ("minicpm_chunked", "minicpm-2b", {"attn_chunk": 8}, 24),
]
PREFILL = 8


def _close(got, want, rtol=1e-5, scale=1e-5, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=scale * max(float(np.abs(want).max()), 1e-30), err_msg=msg)


def _pair(arch, **ov):
    ov = dict(ov, param_dtype="float32")
    jm, tm = jsmoke(arch, **ov), tsmoke(arch, **ov)
    jparams = jmodel.init_params(jm, jax.random.PRNGKey(1))
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), tmodel.Model(tm))
    return jm, tm, jparams, model


def _port_cache(jcache):
    """The JAX cache in the port's layout: the stacked (L, …) leaves of
    ``layers`` as one dict a layer, ``first`` as it is, ``index`` an int."""
    layers = jax.tree_util.tree_map(np.asarray, jcache["layers"])
    L = jax.tree_util.tree_leaves(layers)[0].shape[0]
    out = {"layers": [jax.tree_util.tree_map(lambda a: a[i], layers) for i in range(L)],
           "index": int(jcache["index"])}
    if "first" in jcache:
        out["first"] = jax.tree_util.tree_map(np.asarray, jcache["first"])
    return out


def _assert_cache_equal(tcache, jcache, msg):
    want = _port_cache(jcache)
    assert tcache["index"] == want["index"]
    got = jax.tree_util.tree_map(lambda t: t.numpy(), {k: v for k, v in tcache.items()
                                                       if k != "index"})
    flat_t, tdef = jax.tree_util.tree_flatten(got)
    flat_j, jdef = jax.tree_util.tree_flatten({k: v for k, v in want.items() if k != "index"})
    assert tdef == jdef, msg
    for a, e in zip(flat_t, flat_j):
        _close(a, e, msg=msg)


def _tokens(V, B=2, S=24, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


@pytest.mark.parametrize("case,arch,ov,max_seq", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_prefill_and_decode_match_jax(case, arch, ov, max_seq):
    jm, tm, jparams, model = _pair(arch, **ov)
    toks = _tokens(jm.vocab_size, S=max_seq)
    pb = toks[:, :PREFILL]
    jl, jc = jax.jit(lambda p, b: jdecode.prefill(jm, p, b, max_seq))(
        jparams, {"tokens": jnp.asarray(pb), "labels": jnp.asarray(pb)})
    tl, tc = tdecode.prefill(tm, model, {"tokens": T(pb), "labels": T(pb)}, max_seq)
    _close(tl.numpy(), jl, msg="prefill logits")
    _assert_cache_equal(tc, jc, "prefill cache")
    step = jax.jit(lambda p, c, t: jdecode.decode_step(jm, p, c, t))
    for t in range(PREFILL, max_seq):
        jl, jc = step(jparams, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tdecode.decode_step(tm, model, tc, T(toks[:, t:t + 1]))
        _close(tl.numpy(), jl, msg=f"decode logits at {t}")
    _assert_cache_equal(tc, jc, "final cache")
    assert tc["index"] == max_seq


def test_cached_attention_never_routes_to_flash():
    """With a cache, attention runs the dense path whatever ``attn_backend``
    says, as in JAX: flash's plain version would round differently, so the
    decode logits under "flash" are bit-equal to those under "dense"."""
    toks = T(_tokens(257, S=12, seed=2))
    runs = []
    for backend in ("dense", "flash"):
        tm = tsmoke("minicpm-2b", param_dtype="float32", attn_backend=backend)
        model = tmodel.init_params(tm, torch.Generator().manual_seed(0))
        lg, cache = tdecode.prefill(tm, model, {"tokens": toks[:, :8], "labels": toks[:, :8]}, 12)
        outs = [lg]
        for t in range(8, 12):
            lg, cache = tdecode.decode_step(tm, model, cache, toks[:, t:t + 1])
            outs.append(lg)
        runs.append(torch.cat(outs, 1))
    assert torch.equal(runs[0], runs[1])


def test_cache_layout_per_family():
    for arch, keys in (("minicpm-2b", {"attn"}), ("hymba-1.5b", {"attn", "ssm"}),
                       ("rwkv6-7b", {"time", "channel"}), ("kimi-k2-1t-a32b", {"attn"})):
        tm = tsmoke(arch)
        c = tdecode.init_cache(tm, 3, 16)
        assert c["index"] == 0 and len(c["layers"]) == tm.num_layers - tm.first_k_dense
        assert set(c["layers"][0]) == keys
        assert ("first" in c) == bool(tm.first_k_dense)
        if "attn" in keys:
            assert c["layers"][0]["attn"]["k"].shape == (3, 16, tm.num_kv_heads, tm.head_dim)
            assert c["layers"][0]["attn"]["k"].dtype == tm.dtype
        if arch == "rwkv6-7b":
            Dh = tm.d_model // tm.num_heads
            assert c["layers"][0]["time"]["wkv"].shape == (3, tm.num_heads, Dh, Dh)
            assert c["layers"][0]["time"]["wkv"].dtype == torch.float32


def test_moe_decode_step_is_dropless():
    """At capacity factor 0.25 the 4 tokens of one step drop assignments
    under the capacity rule; the decode step's dropless layer keeps every
    one (capacity = group size) and equals JAX's dropless layer."""
    jm, tm, jparams, model = _pair("qwen3-moe-235b-a22b", moe_capacity_factor=0.25)
    p = model.tree()["blocks"][0]["moe"]
    x = torch.randn(4, 1, tm.d_model, generator=torch.Generator().manual_seed(0))
    xt, _ = tlayers.moe_groups(tm, x)
    assert not bool(tlayers.moe_routing(tm, p["router"], xt).keep.all())
    assert bool(tlayers.moe_routing(tm, p["router"], xt, dropless=True).keep.all())
    assert tlayers.moe_capacity(tm, 4, dropless=True) == (4, 4)
    with torch.no_grad():
        got = tlayers.moe(tm, p, x, dropless=True)
    want = jax.jit(lambda pp, xx: jlayers.moe(jm, pp, xx, dropless=True))(
        {k: jnp.asarray(v.detach().numpy()) for k, v in p.items()}, jnp.asarray(x.numpy()))
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", ["stablelm-12b", "gemma2-27b", "rwkv6-7b", "hymba-1.5b",
                                  "qwen3-moe-235b-a22b"])
def test_decode_matches_teacher_forcing(arch):
    """The port alone, as the JAX package's TestDecodeParity (bf16 params)."""
    ov = {"moe_capacity_factor": 4.0} if arch == "qwen3-moe-235b-a22b" else {}
    tm = tsmoke(arch, **ov)
    model = tmodel.init_params(tm, torch.Generator().manual_seed(1))
    toks = T(_tokens(tm.vocab_size, S=24, seed=3))
    with torch.no_grad():
        h, _ = tmodel.forward_hiddens(tm, model, {"tokens": toks, "labels": toks})
        ref = tmodel.logits_from_hiddens(tm, model, h)[:, PREFILL - 1:].float()
    lg, cache = tdecode.prefill(tm, model, {"tokens": toks[:, :PREFILL],
                                            "labels": toks[:, :PREFILL]}, 24)
    outs = [lg[:, 0]]
    for t in range(PREFILL, 24):
        lg, cache = tdecode.decode_step(tm, model, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1).float()
    err, scale = float((dec - ref).abs().max()), float(ref.abs().max())
    assert err < 0.02 * max(scale, 1.0) + 1e-3, (arch, err, scale)


# ---------------------------------------------------------------------------
# int8 KV quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_kv_quant_is_bit_equal_to_jax(scale):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 6, 3, 16)) * scale).astype(np.float32)
    x[0, 0, 0, :] = 0.0                                  # an all-zero row
    x[1, 2, 1, 3] = 127.5 * np.abs(x[1, 2, 1]).max() / 127.0   # near a half step
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(T(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tkv.dequantize_kv(tq, ts, dt).float().numpy()
        np.testing.assert_array_equal(got, np.asarray(jkv.dequantize_kv(jq, js, jdt), np.float32))


def test_kv_quant_round_half_to_even():
    x = T(np.asarray([[[[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]]]], np.float32))
    q, _ = tkv.quantize_kv(x)
    jq, _ = jkv.quantize_kv(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_quant_cache_update_read_and_bytes_match_jax():
    rng = np.random.default_rng(1)
    k1, v1 = (rng.normal(size=(2, 8, 4, 16)).astype(np.float32) for _ in range(2))
    k2, v2 = (rng.normal(size=(2, 1, 4, 16)).astype(np.float32) * 3 for _ in range(2))
    jc = jkv.update_quant_cache(jkv.init_quant_cache(2, 32, 4, 16), jnp.asarray(k1),
                                jnp.asarray(v1), 0)
    jc = jkv.update_quant_cache(jc, jnp.asarray(k2), jnp.asarray(v2), 8)
    tc = tkv.update_quant_cache(tkv.init_quant_cache(2, 32, 4, 16), T(k1), T(v1), 0)
    tc = tkv.update_quant_cache(tc, T(k2), T(v2), 8)
    assert set(tc) == set(jc)
    for name in tc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    for a, b in zip(tkv.read_quant_cache(tc, torch.float32),
                    jkv.read_quant_cache(jc, jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for quantized in (False, True):
        assert tkv.cache_bytes(4, 128, 8, 64, quantized) == \
            jkv.cache_bytes(4, 128, 8, 64, quantized)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _jax_filtered(logits, temperature, top_k, top_p):
    """The logits ``repro.launch.sampling.sample_tokens`` draws from: its
    filtering lines (the function returns only the draw)."""
    logits = logits.astype(jnp.float32) / max(temperature, 1e-6)
    B, V = logits.shape
    if top_k is not None and top_k < V:
        kth = jnp.sort(logits, axis=-1)[:, V - top_k][:, None]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
        cum = jnp.cumsum(jax.nn.softmax(sorted_logits, axis=-1), axis=-1)
        cutoff_idx = jnp.sum((cum < top_p).astype(jnp.int32), axis=-1)
        cutoff_val = jnp.take_along_axis(sorted_logits, cutoff_idx[:, None], axis=-1)
        logits = jnp.where(logits < cutoff_val, -jnp.inf, logits)
    return logits


SAMPLING = [(1.0, None, None), (0.7, 5, None), (1.3, None, 0.9), (0.5, 8, 0.6), (2.0, 50, 0.99)]


@pytest.mark.parametrize("temperature,top_k,top_p", SAMPLING)
def test_sampling_matches_jax_with_its_noise(temperature, top_k, top_p):
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(6, 50)) * 3).astype(np.float32)
    masked = tsampling.filter_logits(T(logits), temperature, top_k, top_p)
    np.testing.assert_array_equal(masked.numpy(),
                                  np.asarray(_jax_filtered(jnp.asarray(logits), temperature,
                                                           top_k, top_p)))
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        noise = np.array(jax.random.gumbel(key, logits.shape))
        want = np.asarray(jsampling.sample_tokens(key, jnp.asarray(logits),
                                                  temperature=temperature, top_k=top_k,
                                                  top_p=top_p))
        got = tsampling.gumbel_argmax(masked, T(noise))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32


def test_sampling_greedy_and_draws():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 30)).astype(np.float32)
    got = tsampling.sample_tokens(torch.Generator(), T(logits), temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsampling.sample_tokens(
        jax.random.PRNGKey(0), jnp.asarray(logits), temperature=0.0)))
    a = tsampling.sample_tokens(torch.Generator().manual_seed(3), T(logits), top_k=3)
    b = tsampling.sample_tokens(torch.Generator().manual_seed(3), T(logits), top_k=3)
    assert torch.equal(a, b)
    top3 = np.argsort(-logits, axis=-1)[:, :3]
    assert all(int(a[i]) in top3[i] for i in range(4))
    noise = tsampling.gumbel(torch.Generator().manual_seed(0), (20000,), "cpu")
    assert abs(float(noise.mean()) - 0.5772) < 0.03 and torch.isfinite(noise).all()


# ---------------------------------------------------------------------------
# the serve loop
# ---------------------------------------------------------------------------

def _jax_wave_loop(jm, jparams, *, slots, max_seq, max_new_tokens, eos_token, requests, seed):
    """``repro.launch.serve.serve``'s wave loop over JAX's prefill and
    decode_step, without its mesh (which jax 0.9 refuses)."""
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(2, jm.vocab_size, size=8)) for _ in range(requests)]
    prefill = jax.jit(lambda p, b: jdecode.prefill(jm, p, b, max_seq))
    decode = jax.jit(lambda p, c, t: jdecode.decode_step(jm, p, c, t))
    results, start = [], 0
    while start < len(prompts):
        wave = prompts[start:start + slots]
        ids = list(range(start, start + len(wave)))
        start += len(wave)
        plen = min(len(p) for p in wave)
        toks = np.stack([p[:plen] for p in wave]).astype(np.int32)
        if len(wave) < slots:
            toks = np.concatenate([toks, np.zeros((slots - len(wave), plen), np.int32)])
        logits, cache = prefill(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
        last = np.asarray(logits[:, 0, :]).argmax(-1).astype(np.int32)
        outs = [[int(last[i])] for i in range(len(wave))]
        done = [last[i] == eos_token for i in range(len(wave))]
        cur = last[:, None]
        for _ in range(max_new_tokens - 1):
            if all(done):
                break
            logits, cache = decode(jparams, cache, jnp.asarray(cur))
            nxt = np.asarray(logits[:, 0, :]).argmax(-1).astype(np.int32)
            for i in range(len(wave)):
                if not done[i]:
                    outs[i].append(int(nxt[i]))
                    done[i] = nxt[i] == eos_token
            cur = nxt[:, None]
        results += [{"request_id": rid, "tokens": outs[i]} for i, rid in enumerate(ids)]
    return results


@pytest.mark.parametrize("arch,slots,requests,eos", [
    ("minicpm-2b", 4, 8, 1), ("minicpm-2b", 3, 7, 1), ("rwkv6-7b", 2, 3, 1),
    ("hymba-1.5b", 3, 4, 1), ("qwen3-moe-235b-a22b", 2, 3, 1)])
def test_serve_matches_jax_wave_loop(arch, slots, requests, eos):
    jm, tm, jparams, model = _pair(arch)
    kw = dict(slots=slots, max_seq=32, max_new_tokens=6, eos_token=eos, requests=requests,
              seed=11)
    want = _jax_wave_loop(jm, jparams, **kw)
    report = tserve.serve_model(tm, model, **kw)
    assert set(report) == {"requests", "decode_ticks", "total_new_tokens", "wall_s",
                           "tokens_per_s", "results"}
    assert report["requests"] == requests
    assert report["results"] == want
    assert report["total_new_tokens"] == sum(len(r["tokens"]) for r in want)
    assert report == dict(report, **{k: v for k, v in tserve.serve_model(tm, model, **kw).items()
                                     if k not in ("wall_s", "tokens_per_s")})


def test_serve_eos_stops_a_request():
    """With every first token declared EOS each request gets one token."""
    jm, tm, jparams, model = _pair("minicpm-2b")
    first = tserve.serve_model(tm, model, slots=2, requests=2, max_new_tokens=5, max_seq=32)
    eos = first["results"][0]["tokens"][0]
    report = tserve.serve_model(tm, model, slots=2, requests=2, max_new_tokens=5, max_seq=32,
                                eos_token=eos)
    assert report["results"][0]["tokens"] == [eos]
    assert report["results"] == _jax_wave_loop(jm, jparams, slots=2, requests=2,
                                                max_new_tokens=5, max_seq=32, eos_token=eos,
                                                seed=0)


def test_serve_entry_point_runs_on_the_cpu_and_is_deterministic(capsys):
    r1 = tserve.serve(arch="minicpm-2b", slots=3, requests=7, max_new_tokens=6, max_seq=64,
                      device="cpu")
    r2 = tserve.serve(arch="minicpm-2b", slots=3, requests=7, max_new_tokens=6, max_seq=64,
                      device="cpu")
    assert sorted(r["request_id"] for r in r1["results"]) == list(range(7))
    assert all(1 <= len(r["tokens"]) <= 6 for r in r1["results"])
    assert [r["tokens"] for r in r1["results"]] == [r["tokens"] for r in r2["results"]]
    tserve.main(["--device=cpu", "--requests=2", "--slots=2", "--max-new=3"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"requests": 2' in out and "results" not in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.serve(requests=1)
    assert dataclasses.asdict(tsmoke("minicpm-2b")) == dataclasses.asdict(jsmoke("minicpm-2b"))
