"""JAX's ``default`` sharding preset on the port (every family): a
sequence-parallel residual stream over the tokens, frames or patches and
tokens a model embeds, sequence-sharded attention queries through the
flash kernels' query offset, a tensor-parallel MLP, a head-parallel RWKV
time mix and SSM heads and a tensor-parallel channel mix, expert
parallelism and a vocabulary-parallel loss; the MoE family under ``fsdp``
too, and Adafactor on a sharded state; sharded serving under both presets;
against the JAX package on the CPU.

* One 4-rank gloo fleet on a (2, 2) ``("data", "model")`` mesh (``python -m
  repro_torch.backend --worker --job``, task kind ``tp``) runs 3 float32
  steps of ``graft_train_step`` (AdamW, a refresh every 2) under
  ``sharding_rules(mesh, RULE_PRESETS["default"])`` for three cases
  (``CASES``), each from the same weights (seed 0, JAX's layout as numpy,
  through ``jax_bridge.sharded_params_from_numpy``): the minicpm-2b smoke
  config (vocabulary 257: the logits stay whole, one model replica
  counted), the stablelm-12b smoke config (vocabulary 256: the
  vocabulary-parallel loss; GQA 4/2; here with ``remat="full"`` and
  ``loss_chunk=8``, so that the blocks' and the loss chunks' recompute
  replays the sequence collectives) and the gemma2-27b smoke config at 32
  positions (alternating windows of 16 that the query offset must honour,
  both softcaps, the post-block norms); then the baseline step on the
  stablelm case under Lion, and the minicpm case with the ``logit_embed``
  grad source under SGD; then the MoE family (``preset`` per case):
  qwen3-moe smoke at 32 positions under ``fsdp`` (the refresh's 4 groups
  over both axes, every expert on every rank; the subset's 2 over
  ``"data"``, the experts over ``"model"``) and under ``default``, and
  kimi-k2 smoke (its dense first block) under Adafactor with each preset
  (the subset's one group on every rank, ``"data"``'s second rank adding
  zeros); then the frontends and the ssm family: the musicgen-medium smoke
  config (each rank's frames), the internvl2-26b smoke config with 8
  patches and 16 tokens (rank 0's 12 positions hold patches and text), the
  minicpm-2b smoke config given the ``audio_frames`` frontend (the
  classification task) and the rwkv6-7b smoke config with ``remat="full"``
  (the time mix over 2 of its 4 heads a rank, through the RWKV plain
  versions; the channel mix over ``d_ff``); then the hybrid family: the
  hymba-1.5b smoke config at 32 positions (its SSM heads over 2 of its 4
  heads a rank; the window of 16 met at rank 1's query offset on layer
  1). Each is held against
  ``jax.jit(repro.launch.steps.make_train_step)`` with no mesh on the same
  global batches: pivots and ranks EXACT, losses at rtol 1e-4, the grad
  norm at rtol 1e-5, each leaf of step 0's first moment at rtol 1e-4 /
  atol 1e-4 of its largest element; each rank's resident params and
  moments exactly its shards (Adafactor's factors: the shard's rows and
  columns); launches as ``expected_launches(..., sharded=True)`` reckons;
  the layout each rank reports (the sequence, the MLP hidden and, but for
  minicpm-2b's 257 words, the vocabulary over ``"model"``), the MoE
  regimes its forwards ran and the heads of its RWKV time mixes and SSM
  heads. Under
  Adafactor, which keeps no first
  moment, each leaf's change over the run is held instead.
* The same fleet serves (task kind ``serve``, ``SERVE_CASES``): sharded
  ``prefill_step`` and ``decode_step`` on the (2, 2) mesh, float32, smoke
  configs, weights from seed 0 through ``jax_bridge``, against
  ``jax.jit(repro.models.decode.prefill / decode_step)`` with no mesh on the
  same whole prompt batch: (a) minicpm-2b under ``default`` with
  decode_32k's rules (the cache's positions over ``"model"``: the split-KV
  combine), a prefill of 4 × 16 into 32 positions and 6 greedy ticks; (b)
  the same under prefill_32k's rules (the whole cache on each model rank);
  (c) stablelm-12b with ``attn_chunk=8`` (the combine across chunks and
  ranks; the logits from the vocabulary's slices); (d) gemma2-27b at 64
  positions after a prefill of 30, so that the window of 16 straddles the
  ranks' slices; (e) under ``fsdp`` with decode_32k's rules, rwkv6-7b with
  4 rows (the rows over both axes) and hymba-1.5b with 2 (the rows over
  ``"data"``, the KV cache's positions over ``"model"``, the SSM state by
  rows); (f) one ``serve_model`` wave under ``default``; (g) under
  ``default`` with decode_32k's rules the other families: rwkv6-7b and
  hymba-1.5b (their decode states' heads over ``"model"``, 2 of 4 a rank;
  the token-shift carry whole), musicgen-medium (a prompt of 16 frames)
  and internvl2-26b (8 patches and 16 tokens, rank 0's 12 positions
  straddling them). The bars: greedy
  tokens EXACT at every tick; each rank's logits (its rows) at rtol 1e-4
  / atol 1e-4 of their largest; each rank's cache after the prefill and
  after the last tick within 1e-5 (of the largest) of its rows,
  positions and heads of JAX's cache, and its resident bytes exactly that
  slice's; the layout each rank reports derived here from its
  coordinates.
* The split-KV combine over two threads standing in for two ranks equals
  the whole cache's dense and chunked attention, a slice wholly masked
  among the cases; the cache's logical axes equal JAX's ``cache_logical``;
  the serve path's refusals (MoE, A14s; ``head_tp``), and the ssm,
  hybrid, audio and vlm families' serve steps (once refused) under
  ``default`` over two threads against one process; the serve entry
  points taking the cache's rows (``prefill`` given the cache's layout,
  ``serve_model`` a sharded model); the dry run's dense serve cells
  sharded below the replicated state's peak, its sharded prefill cells
  passing one device's rows of the prompts.
* The flash plain versions with ``q_offset``: each half and sixteenth of a
  sequence equals the matching rows of the full-sequence plain version and
  of JAX's Pallas kernel in interpret mode, forward and gradients (the
  slices' dK/dV summed).
* ``vocab_parallel_nll`` over two threads standing in for two ranks (a
  mesh whose collectives meet at a barrier) equals ``_nll`` of the whole
  logits, values and gradients. Over the same threads the expert-parallel
  ``moe`` equals JAX's ``moe`` with no mesh in each regime (forward, the
  gradients of x and of the four leaves, the router's summed), and three
  sharded Adafactor steps equal the same steps on the whole leaves.
* ``embed_inputs(sp=)`` over threads standing in for the ranks of "model"
  equals each rank's positions of the whole (frames; patches and tokens
  straddling a rank, or patches alone), and the pooled features under the
  layout equal one process's; the head-parallel time mix and SSM heads
  and the tensor-parallel channel mix over two threads (and, where
  neither divides, three) equal the whole mix, output and gradients, with
  and without a decode state (a prefill's and a tick's new state each
  rank's heads of the whole).
* The dry run on the CPU stand-in at smoke size: the four dense archs'
  ``default`` train cells, the ssm, audio, vlm and hybrid archs' (and
  their decode_32k and prefill_32k cells) and the MoE archs' under both
  presets, report ``"state": "sharded"`` and a peak below the replicated
  state's on the same (2, 2) mesh (rwkv6-7b's WKV cost at a device's
  streams); the serve cells of the MoE archs keep the state replicated
  and say why (A14s); a dense arch given a frontend traces sharded, its
  serve cells too.
* The loss chunks' recompute: a chunked loss's backward saves no (B, C, V)
  float32 tensor, and its loss and gradients are bit-equal to the chunked
  loss without recompute.
"""
import dataclasses
import pickle
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig, SyntheticLM
from repro.kernels import flash_attention as jfa
from repro_torch import configs as tconfigs
from repro_torch.backend import fleet
from repro_torch.checkpoint import params_to_numpy
from repro_torch.core.numerics import take_last
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

CARD = dict(stand_in=not torch.cuda.is_available())
OPT = dict(name="adamw", learning_rate=3e-4, schedule="cosine", total_steps=8, warmup_steps=1)
GC = dict(rset=(2, 4), eps=0.25, refresh_every=2, use_pallas=True)
STEPS, K = 3, 8
F32 = dict(param_dtype="float32")
STABLELM = dict(F32, remat="full", loss_chunk=8)
MOE, KIMI = "qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"
ADAFACTOR = dict(OPT, name="adafactor")
# arch, model overrides, sequence length, optimizer, GRAFT config (None: the
# baseline step), the rules preset (default: "default"), and the axes each
# rank's layout reports: (sequence, MLP hidden, vocabulary); "axes" the
# batch's and the subset's axes (default: "data" both); "moe" the MoE
# regimes its forwards ran (tokens, the groups' axes, the experts' axes)
CASES = {
    "minicpm-2b": dict(arch="minicpm-2b", model=F32, seq=16, opt=OPT, graft=GC,
                       layout=(["model"], ["model"], [])),
    "stablelm-12b": dict(arch="stablelm-12b", model=STABLELM, seq=16, opt=OPT, graft=GC,
                         layout=(["model"], ["model"], ["model"])),
    "gemma2-27b": dict(arch="gemma2-27b", model=F32, seq=32, opt=OPT, graft=GC,
                       layout=(["model"], ["model"], ["model"])),
    "stablelm-12b-baseline-lion": dict(arch="stablelm-12b", model=STABLELM, seq=16,
                                       opt=dict(OPT, name="lion", learning_rate=1e-4),
                                       graft=None, layout=(["model"], ["model"], ["model"])),
    "minicpm-2b-logit-embed-sgd": dict(arch="minicpm-2b", model=F32, seq=16,
                                       opt=dict(OPT, name="sgd", learning_rate=1e-2),
                                       graft=dict(GC, grad_mode="logit_embed"),
                                       layout=(["model"], ["model"], [])),
    # the refresh's 8 × 32 tokens in G = 4 groups over both axes (the experts
    # whole on every rank), the subset's 4 × 32 in G = 2 over "data" alone
    # (the experts over "model", each rank gathering its group's rows)
    "qwen3-moe-fsdp": dict(arch=MOE, model=F32, seq=32, opt=OPT, graft=GC, preset="fsdp",
                           layout=([], [], []), axes=(["data", "model"], ["data", "model"]),
                           moe=[[128, ["data"], ["model"]], [256, ["data", "model"], []]]),
    "qwen3-moe-default": dict(arch=MOE, model=F32, seq=32, opt=OPT, graft=GC,
                              layout=(["model"], ["model"], ["model"]),
                              moe=[[128, ["data"], ["model"]], [256, ["data"], ["model"]]]),
    # kimi-k2 (its dense first block) under Adafactor; the subset's one group
    # on every rank, the experts over "model", data 1's partials zeros
    "kimi-k2-fsdp-adafactor": dict(arch=KIMI, model=F32, seq=16, opt=ADAFACTOR, graft=GC,
                                   preset="fsdp", layout=([], [], []),
                                   axes=(["data", "model"], ["data", "model"]),
                                   moe=[[64, [], ["model"]], [128, ["data"], ["model"]]]),
    "kimi-k2-default-adafactor": dict(arch=KIMI, model=F32, seq=16, opt=ADAFACTOR, graft=GC,
                                      layout=(["model"], ["model"], ["model"]),
                                      moe=[[64, [], ["model"]], [128, ["data"], ["model"]]]),
    # the frontends: each rank's frames; the vlm's 8 patches and 16 tokens,
    # rank 0's 12 positions holding patches and text; minicpm-2b given the
    # audio frames (the classification task)
    "musicgen-medium": dict(arch="musicgen-medium", model=F32, seq=16, opt=OPT, graft=GC,
                            layout=(["model"], ["model"], ["model"])),
    "internvl2-26b": dict(arch="internvl2-26b", model=F32, seq=24, opt=OPT, graft=GC,
                          layout=(["model"], ["model"], ["model"])),
    "minicpm-2b-audio-frames": dict(arch="minicpm-2b", model=dict(F32, frontend="audio_frames"),
                                    seq=16, opt=OPT, graft=GC,
                                    layout=(["model"], ["model"], [])),
    # rwkv6-7b: the time mix over its 4 heads, 2 a rank ("heads"), the channel
    # mix over d_ff; the recompute replays the gathers and reduce-scatters
    "rwkv6-7b": dict(arch="rwkv6-7b", model=dict(F32, remat="full"), seq=16, opt=OPT, graft=GC,
                     layout=(["model"], ["model"], ["model"]), heads=2),
    # hymba-1.5b: the SSM heads over its 4 heads, 2 a rank ("heads"), beside
    # the attention at the rank's query offset, whose window of 16 rank 1's
    # queries meet on layer 1 (layers 0 and 2 are global)
    "hymba-1.5b": dict(arch="hymba-1.5b", model=F32, seq=32, opt=OPT, graft=GC,
                       layout=(["model"], ["model"], ["model"]), heads=2),
}
FLEET_TIMEOUT_S = 240
# the serve cases: arch, model overrides, shape (its SHAPE_RULES), preset,
# the prompt batch (rows × positions: tokens, frames, or a vlm's patches
# then tokens), the cache's positions, greedy ticks after the prefill, and
# the axes each rank's cache layout reports (rows, positions); "heads": the
# decode states' heads (wkv, ssm) over "model"; "wave": serve_model's
# keywords instead of the ticks
SERVE_CASES = {
    "a_minicpm_split_kv": dict(arch="minicpm-2b", model=F32, shape="decode_32k",
                               preset="default", rows=4, plen=16, max_seq=32, ticks=6,
                               layout=(["data"], ["model"])),
    "b_minicpm_whole_cache": dict(arch="minicpm-2b", model=F32, shape="prefill_32k",
                                  preset="default", rows=4, plen=16, max_seq=32, ticks=6,
                                  layout=(["data"], [])),
    "c_stablelm_chunked": dict(arch="stablelm-12b", model=dict(F32, attn_chunk=8),
                               shape="decode_32k", preset="default", rows=4, plen=16,
                               max_seq=32, ticks=6, layout=(["data"], ["model"])),
    "d_gemma2_window": dict(arch="gemma2-27b", model=F32, shape="decode_32k", preset="default",
                            rows=4, plen=30, max_seq=64, ticks=6, layout=(["data"], ["model"])),
    "e_rwkv6_fsdp": dict(arch="rwkv6-7b", model=F32, shape="decode_32k", preset="fsdp", rows=4,
                         plen=16, max_seq=32, ticks=6, layout=(["data", "model"], [])),
    "e_hymba_fsdp": dict(arch="hymba-1.5b", model=F32, shape="decode_32k", preset="fsdp",
                         rows=2, plen=16, max_seq=32, ticks=6, layout=(["data"], ["model"])),
    "f_wave": dict(arch="minicpm-2b", model=F32, shape="decode_32k", preset="default",
                   wave=dict(slots=4, requests=4, max_new_tokens=6, max_seq=32, seed=0)),
    # the default preset on the other families: the states' heads over
    # "model" (2 of 4 a rank), the token-shift carry whole; hymba's window
    # of 16 crossing the cache's slices; a prompt of frames; the vlm's 8
    # patches and 16 tokens, rank 0's 12 positions straddling them
    "g_rwkv6_default": dict(arch="rwkv6-7b", model=F32, shape="decode_32k", preset="default",
                            rows=4, plen=16, max_seq=32, ticks=6, layout=(["data"], ["model"]),
                            heads=True),
    "g_hymba_default": dict(arch="hymba-1.5b", model=F32, shape="decode_32k", preset="default",
                            rows=4, plen=16, max_seq=32, ticks=6, layout=(["data"], ["model"]),
                            heads=True),
    "g_musicgen_default": dict(arch="musicgen-medium", model=F32, shape="decode_32k",
                               preset="default", rows=4, plen=16, max_seq=32, ticks=6,
                               layout=(["data"], ["model"])),
    "g_internvl2_default": dict(arch="internvl2-26b", model=F32, shape="decode_32k",
                                preset="default", rows=4, plen=24, max_seq=32, ticks=6,
                                layout=(["data"], ["model"])),
}

_JAX_SCRIPT = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch import steps
from repro.optim import OptimizerConfig
from repro.selection.base import GraftConfig
from repro.models import decode


def serve(job):
    # decode.prefill and greedy decode_steps, or the wave loop of
    # repro.launch.serve without its mesh
    jm = configs.get_smoke_config(job["arch"], **job["model"])
    params = jax.tree_util.tree_map(jnp.asarray, job["params"])
    w = job.get("wave")
    max_seq = w["max_seq"] if w else job["max_seq"]
    prefill = jax.jit(lambda p, b: decode.prefill(jm, p, b, max_seq))
    step = jax.jit(lambda p, c, t: decode.decode_step(jm, p, c, t))

    def greedy(logits):
        return np.asarray(logits[:, 0, :]).argmax(-1).astype(np.int32)[:, None]
    if w:
        rng = np.random.default_rng(w["seed"])
        prompts = [list(rng.integers(2, jm.vocab_size, size=8)) for _ in range(w["requests"])]
        results, start = [], 0
        while start < len(prompts):
            wave = prompts[start:start + w["slots"]]
            ids = list(range(start, start + len(wave)))
            start += len(wave)
            plen = min(len(p) for p in wave)
            toks = np.stack([p[:plen] for p in wave]).astype(np.int32)
            if len(wave) < w["slots"]:
                toks = np.concatenate([toks, np.zeros((w["slots"] - len(wave), plen), np.int32)])
            logits, cache = prefill(params, {"tokens": jnp.asarray(toks),
                                             "labels": jnp.asarray(toks)})
            cur = greedy(logits)
            outs = [[int(cur[i, 0])] for i in range(len(wave))]
            done = [cur[i, 0] == 1 for i in range(len(wave))]
            for _ in range(w["max_new_tokens"] - 1):
                if all(done):
                    break
                logits, cache = step(params, cache, jnp.asarray(cur))
                cur = greedy(logits)
                for i in range(len(wave)):
                    if not done[i]:
                        outs[i].append(int(cur[i, 0]))
                        done[i] = cur[i, 0] == 1
            results += [{"request_id": rid, "tokens": outs[i]} for i, rid in enumerate(ids)]
        return {"results": results}
    logits, cache = prefill(params, {k: jnp.asarray(v) for k, v in job["batch"].items()})
    res = {"prefill_cache": jax.tree_util.tree_map(np.asarray, cache["layers"]),
           "logits": [np.asarray(logits)], "tokens": []}
    cur = greedy(logits)
    for _ in range(job["ticks"]):
        res["tokens"].append(cur)
        logits, cache = step(params, cache, jnp.asarray(cur))
        res["logits"].append(np.asarray(logits))
        cur = greedy(logits)
    res["tokens"].append(cur)
    res["cache"] = jax.tree_util.tree_map(np.asarray, cache["layers"])
    return res


for path in sys.argv[1:]:
    with open(path + ".pkl", "rb") as f:
        job = pickle.load(f)
    if job.get("serve"):
        with open(path + ".out", "wb") as f:
            pickle.dump(serve(job), f)
        continue
    jm = configs.get_smoke_config(job["arch"], **job["model"])
    graft = GraftConfig(**job["graft"]) if job["graft"] else None
    jt = steps.TrainConfig(optimizer=OptimizerConfig(**job["opt"]), graft=graft,
                           probe_positions=8)
    state = jax.jit(lambda k: steps.init_train_state(jm, jt, k, job["K"]))(jax.random.PRNGKey(0))
    state["params"] = jax.tree_util.tree_map(jnp.asarray, job["params"])
    fn = jax.jit(steps.make_train_step(jm, jt))
    res = {"losses": [], "grad_norms": [], "ranks": [], "pivots": {}}
    for step, b in enumerate(job["batches"]):
        state, met = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        res["losses"].append(float(met["loss"]))
        res["grad_norms"].append(float(met["grad_norm"]))
        if step == 0 and "m" in state["opt"]:
            res["m0"] = jax.tree_util.tree_map(np.asarray, state["opt"]["m"])
        if graft is not None:
            res["ranks"].append(int(met["rank"]))
            if step % graft.refresh_every == 0:
                res["pivots"][step] = np.asarray(state["graft"].pivots).tolist()
    res["params"] = jax.tree_util.tree_map(np.asarray, state["params"])
    res["init"] = job["params"]
    with open(path + ".out", "wb") as f:
        pickle.dump(res, f)
"""
JAX_PROCESSES = 3


def _leaves(tree, path=()):
    if not isinstance(tree, (dict, list)):
        return [(path, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [x for k, v in items for x in _leaves(v, path + (k,))]


class _Fleet:
    """The fleet and JAX's runs, started when the module starts and run
    beside its other tests."""

    def __init__(self, work):
        self.work, self.got, self.errors = work, {}, []
        self.threads = [threading.Thread(target=self._run, args=("prep", self._start))]
        self.threads[0].start()

    def _start(self):
        work, job, jax_jobs = self.work, [], []
        for name, case in CASES.items():
            mcfg = tconfigs.get_smoke_config(case["arch"], **case["model"])
            init = params_to_numpy(tmodel.init_params(mcfg, torch.Generator().manual_seed(0)))
            if mcfg.frontend is None:
                data = SyntheticLM(DataConfig(vocab_size=mcfg.vocab_size, seq_len=case["seq"],
                                              global_batch=K))
                batches = [data.batch_at(s) for s in range(STEPS)]
            else:
                batches = [_frontend_batch(mcfg, K, case["seq"], seed=s) for s in range(STEPS)]
            job.append({"kind": "tp", "preset": case.get("preset", "default"),
                        "mesh": ((2, 2), ("data", "model")),
                        "arch": case["arch"], "smoke": True, "model": case["model"],
                        "steps": STEPS,
                        "tcfg": {"optimizer": case["opt"], "graft": case["graft"],
                                 "probe_positions": 8},
                        "params": jax.tree_util.tree_map(torch.from_numpy, init),
                        "batches": [{k: torch.from_numpy(v) for k, v in b.items()}
                                    for b in batches]})
            with open(work / f"jax_{name}.pkl", "wb") as f:
                graft = case["graft"] and dict(case["graft"], use_pallas=False)
                pickle.dump({"arch": case["arch"], "model": case["model"], "opt": case["opt"],
                             "graft": graft, "K": K, "params": init, "batches": batches}, f)
            jax_jobs.append(str(work / f"jax_{name}"))
        for name, case in SERVE_CASES.items():
            mcfg = tconfigs.get_smoke_config(case["arch"], **case["model"])
            init = params_to_numpy(tmodel.init_params(mcfg, torch.Generator().manual_seed(0)))
            task = {"kind": "serve", "mesh": ((2, 2), ("data", "model")), "arch": case["arch"],
                    "smoke": True, "model": case["model"], "shape": case["shape"],
                    "preset": case["preset"],
                    "params": jax.tree_util.tree_map(torch.from_numpy, init)}
            want = {"serve": True, "arch": case["arch"], "model": case["model"], "params": init}
            if "wave" in case:
                task["wave"] = want["wave"] = case["wave"]
            else:
                if mcfg.frontend is None:
                    toks = np.random.default_rng(1).integers(
                        0, mcfg.vocab_size, (case["rows"], case["plen"])).astype(np.int32)
                    prompts = {"tokens": toks, "labels": toks}
                else:
                    prompts = _frontend_batch(mcfg, case["rows"], case["plen"], seed=1)
                task.update(batch={k: torch.from_numpy(v) for k, v in prompts.items()},
                            max_seq=case["max_seq"], ticks=case["ticks"], return_cache=True)
                want.update(batch=prompts, max_seq=case["max_seq"], ticks=case["ticks"])
            job.append(task)
            with open(work / f"jax_{name}.pkl", "wb") as f:
                pickle.dump(want, f)
            jax_jobs.append(str(work / f"jax_{name}"))
        torch.save(job, work / "job.pt")
        port = fleet.free_port()
        cmds = [fleet.mesh_worker_command(str(work / "job.pt"), str(work / "out"),
                                          fleet.backend_overrides(4, r, port), device="cpu")
                for r in range(4)]
        jax_cmds = [[sys.executable, "-c", _JAX_SCRIPT, *jax_jobs[i::JAX_PROCESSES]]
                    for i in range(JAX_PROCESSES)]
        jax_env = fleet.fleet_env(JAX_PROCESSES, {"JAX_PLATFORMS": "cpu"})
        more = [threading.Thread(target=self._run, args=(
                    "fleet", lambda: fleet.launch(cmds, timeout=FLEET_TIMEOUT_S))),
                threading.Thread(target=self._run, args=(
                    "jax", lambda: fleet.launch(jax_cmds, timeout=FLEET_TIMEOUT_S,
                                                env=jax_env)))]
        for t in more:
            t.start()
        self.threads += more

    def _run(self, key, fn):
        try:
            self.got[key] = fn()
        except BaseException as e:                  # noqa: BLE001 — raised in result()
            self.errors.append(e)

    def join(self):
        self.threads[0].join()              # it starts the others
        for t in self.threads[1:]:
            t.join()

    def result(self):
        self.join()
        if self.errors:
            raise self.errors[0]
        summaries = [r.last_json() for r in self.got["fleet"]]
        assert [s["rank"] for s in summaries] == [0, 1, 2, 3]
        ranks = [torch.load(s["path"], weights_only=True)["tasks"] for s in summaries]
        jax_runs = {}
        for name in list(CASES) + list(SERVE_CASES):
            with open(self.work / f"jax_{name}.out", "rb") as f:
                jax_runs[name] = pickle.load(f)
        return ranks, jax_runs


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    bg = _Fleet(tmp_path_factory.mktemp("tp"))
    yield bg
    bg.join()


@pytest.fixture(scope="module")
def runs(background):
    return background.result()


@pytest.mark.parametrize("case", list(CASES))
def test_fleet_matches_jax_step(case, runs):
    ranks, jax_runs = runs
    want = jax_runs[case]
    task = list(CASES).index(case)
    spec = CASES[case]
    seq, mlp, vocab = spec["layout"]
    for rank_i, rank in enumerate(ranks):
        got = rank[task]
        assert got["gather_exact"]
        assert got["layout"] == {"seq": seq, "mlp": mlp, "vocab": vocab}
        assert (got["batch_axes"], got["subset_axes"]) == spec.get("axes", (["data"], ["data"]))
        assert got["moe"] == spec.get("moe", [])
        n = spec.get("heads")           # the rank's heads of the RWKV time mix
        assert got["heads"] == ([[rank_i % 2 * n, rank_i % 2 * n + n]] if n else [])
        assert got["ranks"] == want["ranks"]
        assert {int(k): v for k, v in got["pivots"].items()} == want["pivots"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-5)
        assert got["resident_bytes"] == got["shard_bytes"]
        assert got["launches"] == {k: v for k, v in got["launches_expected"].items() if v}
    if spec["opt"]["name"] == "adafactor":
        # no first moment: each leaf's change over the run against JAX's
        init = dict(_leaves(want["init"]))
        want_leaves = {k: v - init[k] for k, v in _leaves(want["params"])}
        got_leaves = [(k, v - init[k])
                      for k, v in _leaves(params_to_numpy(ranks[0][task]["params"]))]
    else:
        want_leaves = dict(_leaves(want["m0"]))
        got_leaves = _leaves(params_to_numpy(ranks[0][task]["m0"]))
    assert len(got_leaves) == len(want_leaves)
    for path, g in got_leaves:
        w = want_leaves[path]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=str(path))


def _part(n, axes, coords):
    """The ``[start, stop)`` of a dim of ``n`` split over ``axes`` (each of
    size 2, the first major) at a rank's ``coords``."""
    index, k = 0, 1
    for a in axes:
        index, k = index * 2 + coords[a], k * 2
    return index * n // k, (index + 1) * n // k


def _port_layers(jlayers):
    """JAX's stacked (L, …) cache leaves as one dict a layer."""
    L = jax.tree_util.tree_leaves(jlayers)[0].shape[0]
    return [jax.tree_util.tree_map(lambda a: a[i], jlayers) for i in range(L)]


def _slices(got_layers, want_layers, rows, seq, heads):
    """(got, want) leaf pairs: each rank leaf beside its rows (and, for k/v,
    positions; for the decode states wkv and ssm, ``heads``) of JAX's."""
    pairs = []
    for g, w in zip(got_layers, _port_layers(want_layers)):
        for path, leaf in _leaves(g):
            want = w
            for key in path:
                want = want[key]
            want = want[rows[0]:rows[1]]
            if path[-1] in ("k", "v"):
                want = want[:, seq[0]:seq[1]]
            if path[-1] in ("wkv", "ssm"):
                want = want[:, heads[0]:heads[1]]
            pairs.append((path, leaf.numpy(), want))
    return pairs


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_serving_matches_jax(case, runs):
    ranks, jax_runs = runs
    want = jax_runs[case]
    spec = SERVE_CASES[case]
    task = len(CASES) + list(SERVE_CASES).index(case)
    for r, rank in enumerate(ranks):
        got = rank[task]
        if "wave" in spec:
            assert got["wave"]["results"] == want["results"]
            assert got["wave"]["requests"] == spec["wave"]["requests"]
            continue
        coords = {"data": r // 2, "model": r % 2}
        batch_axes, seq_axes = spec["layout"]
        rows = _part(spec["rows"], batch_axes, coords)
        seq = _part(spec["max_seq"], seq_axes, coords)
        mcfg = tconfigs.get_smoke_config(spec["arch"])
        heads = _part(mcfg.num_heads, ["model"] if spec.get("heads") else [], coords)
        assert got["layout"] == {"rows": list(rows), "seq": list(seq),
                                 "batch_axes": batch_axes, "seq_axes": seq_axes}
        assert len(got["tokens"]) == spec["ticks"] + 1
        for t, (a, b) in enumerate(zip(got["tokens"], want["tokens"])):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"rank {r} tick {t}")
        for t, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            b = b[rows[0]:rows[1]]
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max(),
                                       err_msg=f"rank {r} logits at tick {t}")
        for key in ("prefill_cache", "cache"):
            pairs = _slices(got[key], want[key], rows, seq, heads)
            for path, a, b in pairs:
                assert a.shape == b.shape, (key, path)
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                           err_msg=f"rank {r} {key} {path}")
        assert got["resident_bytes"] == sum(b.nbytes for _, _, b in pairs)


# ---------------------------------------------------------------------------
# the split-KV combine over two threads, the cache's axes, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [5, 20, 31])
@pytest.mark.parametrize("arch,over", [("minicpm-2b", {}), ("minicpm-2b", {"attn_chunk": 8}),
                                       ("gemma2-27b", {})])
def test_split_kv_combine_equals_the_whole_cache(arch, over, index):
    """One decode position against a cache of 32 split over two threads
    standing in for the ranks of ``"model"``: the combine of the two slices'
    states equals the whole cache's attention (dense, chunked; gemma2's
    local layer, whose window of 16 crosses the slices), and each slice is
    written as the whole cache's. At index 5 the second slice is wholly
    masked; at 31 the first lies wholly outside the window."""
    from repro_torch.distributed import sharding as tsharding
    cfg = tconfigs.get_smoke_config(arch, param_dtype="float32", **over)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    p = model.blocks[0].tree()["attn"]
    gen = torch.Generator().manual_seed(2)
    B, T, n = 2, 32, 2
    x = torch.randn((B, 1, cfg.d_model), generator=gen)
    whole = {name: torch.randn((B, T, cfg.num_kv_heads, cfg.head_dim), generator=gen)
             for name in ("k", "v")}
    pos = torch.full((B, 1), index, dtype=torch.int32)
    local = arch == "gemma2-27b"
    parts = [{k: v[:, r * T // n:(r + 1) * T // n].clone() for k, v in whole.items()}
             for r in range(n)]
    want, _ = tlayers.attention(cfg, p, x, pos, is_local=local, cache=whole, cache_index=index)
    slots, barrier, got = [None] * n, threading.Barrier(n), [None] * n

    def rank(r):
        kv = tsharding.CacheLayout(_ThreadMesh(r, n, slots, barrier), B, T, (), ("model",),
                                   0, B, r * T // n, (r + 1) * T // n)
        got[r], _ = tlayers.attention(cfg, p, x, pos, is_local=local, cache=parts[r],
                                      cache_index=index, kv=kv)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in range(n):
        torch.testing.assert_close(got[r], want, rtol=1e-5, atol=1e-6)
        for k in ("k", "v"):
            assert torch.equal(parts[r][k], whole[k][:, r * T // n:(r + 1) * T // n])


FAMILY_ARCHS = ["minicpm-2b", "rwkv6-7b", "hymba-1.5b", "qwen3-moe-235b-a22b",
                "kimi-k2-1t-a32b", "musicgen-medium"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_logical_equals_jax(arch):
    from repro.configs import get_smoke_config as jsmoke
    from repro.launch import specs as jspecs
    from repro.models import decode as jdecode
    from repro_torch.models import decode as tdecode
    jl = jspecs.cache_logical(jax.eval_shape(lambda: jdecode.init_cache(jsmoke(arch), 2, 8)))
    tl = tspecs.cache_logical(tdecode.init_cache(tconfigs.get_smoke_config(arch), 2, 8))
    assert tl["index"] == jl["index"] == ()
    assert tl.get("first") == jl.get("first")
    for layer in tl["layers"]:                       # JAX's without its ``layers`` axis
        assert layer == jax.tree_util.tree_map(lambda t: t[1:], jl["layers"],
                                               is_leaf=lambda t: isinstance(t, tuple))


def _serve_over_threads(mcfg, batch, max_seq, n=2):
    """A prefill of ``batch`` and one greedy tick on ``n`` threads standing
    in for the ranks of "model" under ``default`` with decode_32k's rules →
    each rank's (prefill logits, tick logits), beside one process's."""
    from repro_torch.distributed import sharding as tsharding
    from repro_torch.launch import steps as tsteps
    model = tmodel.init_params(mcfg, torch.Generator().manual_seed(0))
    want, cache = tsteps.prefill_step(mcfg, model, batch, max_seq)
    tok = want[:, 0].argmax(-1).to(torch.int32)[:, None]
    want_tick, _ = tsteps.decode_step(mcfg, model, cache, tok)
    rules = dict(tspecs.SHAPE_RULES["decode_32k"], **tspecs.RULE_PRESETS["default"])
    rows = next(iter(batch.values())).shape[0]

    def rank(mesh):
        with tsharding.sharding_rules(mesh, rules):      # a model of its own to cut
            sharded = tmodel.shard_model(
                tmodel.init_params(mcfg, torch.Generator().manual_seed(0)), mesh)
            kv = tsharding.cache_layout(rows, max_seq)
            logits, c = tsteps.prefill_step(mcfg, sharded, {k: kv.take_rows(v)
                                                            for k, v in batch.items()},
                                            max_seq, kv)
            tick, _ = tsteps.decode_step(mcfg, sharded, c, kv.take_rows(tok))
        return logits, tick

    return _threads(n, rank), (want, want_tick)


@pytest.mark.parametrize("arch,preset,label", [
    ("qwen3-moe-235b-a22b", "default", "A14"), ("qwen3-moe-235b-a22b", "fsdp", "A14"),
    ("rwkv6-7b", "default", None), ("hymba-1.5b", "default", None),
    ("musicgen-medium", "default", None), ("internvl2-26b", "default", None),
    ("minicpm-2b", "head_tp", "A13")])
def test_serving_refuses_what_it_does_not_shard(arch, preset, label):
    """The serve steps refuse the MoE family under a preset (A14s) and
    ``head_tp`` (A13). The ssm, hybrid, audio and vlm families' serve steps
    (refused until A12b and A12s) run under ``default`` with decode_32k's
    rules: over two threads standing in for the ranks of "model" a prefill
    (tokens, frames, or 8 patches and 16 tokens, rank 0's 12 positions
    straddling them) and a greedy tick equal one process's logits."""
    from repro_torch.distributed import sharding as tsharding
    from repro_torch.launch import steps as tsteps
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    mcfg = tconfigs.get_smoke_config(arch, param_dtype="float32")
    toks = torch.zeros((4, 8), dtype=torch.int32)
    rules = dict(tspecs.SHAPE_RULES["decode_32k"], **tspecs.RULE_PRESETS[preset])
    if label is None:
        if tmodel.input_kind(mcfg) == "tokens":
            batch = {"tokens": torch.randint(0, mcfg.vocab_size, (4, 16),
                                             generator=torch.Generator().manual_seed(1))}
        else:
            S = 24 if tmodel.input_kind(mcfg) == "patches" else 16
            batch = {k: torch.from_numpy(v) for k, v in _frontend_batch(mcfg, 4, S).items()}
        got, want = _serve_over_threads(mcfg, batch, 32)
        for r, pair in enumerate(got):
            for a, b in zip(pair, want):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()),
                                           msg=f"rank {r}")
        return
    with tsharding.sharding_rules(mesh, rules):
        with pytest.raises(ValueError, match=label):
            tsteps.prefill_step(mcfg, None, {"tokens": toks, "labels": toks}, 16)
        with pytest.raises(ValueError, match=label):
            tsteps.decode_step(mcfg, None, None, toks[:, :1])


def test_serve_entry_points_take_the_cache_rows():
    """Under ``sharding_rules`` the caller takes the cache's rows, as the
    train step's caller takes its rows: ``prefill`` refuses prompts without
    the cache's layout, prompts whose rows are not the layout's, and a
    layout without rules; ``serve_model`` on a mesh refuses a model not yet
    sharded."""
    from repro_torch.distributed import sharding as tsharding
    from repro_torch.launch import serve as tserve
    from repro_torch.models import decode as tdecode
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    mcfg = tconfigs.get_smoke_config("minicpm-2b")
    toks = torch.zeros((4, 8), dtype=torch.int32)
    rules = dict(tspecs.SHAPE_RULES["decode_32k"], **tspecs.RULE_PRESETS["default"])
    with tsharding.sharding_rules(mesh, rules):
        kv = tsharding.cache_layout(4, 16)
        assert (kv.row_start, kv.row_stop, kv.batch_axes) == (0, 2, ("data",))
        with pytest.raises(ValueError, match="layout under sharding_rules"):
            tdecode.prefill(mcfg, None, {"tokens": toks, "labels": toks}, 16)
        with pytest.raises(ValueError, match=r"4 rows of prompts for a cache of rows \[0, 2\)"):
            tdecode.prefill(mcfg, None, {"tokens": toks, "labels": toks}, 16, kv)
    with pytest.raises(ValueError, match="only there"):
        tdecode.prefill(mcfg, None, {"tokens": toks[:2], "labels": toks[:2]}, 16, kv)
    model = tmodel.init_params(mcfg, torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="ShardedModel"):
        tserve.serve_model(mcfg, model, mesh=mesh, rules=rules)


@pytest.mark.parametrize("preset", ["default", "fsdp"])
def test_sharded_prefill_cell_takes_the_device_rows(preset):
    """The dry run's sharded prefill cell passes one device's rows of the
    prompts, as a rank of the fleet does, and its cache is that device's
    part."""
    from repro_torch.distributed import sharding as tsharding
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    rules = dict(tsharding.DEFAULT_RULES, **tspecs.SHAPE_RULES["prefill_32k"],
                 **tspecs.RULE_PRESETS[preset])
    shards = dryrun.batch_shards(mesh, 4, rules)
    backend = dryrun.RecordingBackend(mesh.size)
    cell = tspecs.build_cell("minicpm-2b", "prefill_32k", variant="serve", smoke=True,
                             batch_shards=shards, backend=backend,
                             mesh=dryrun.RecordingMesh(mesh, backend), rules=rules, **CARD)
    assert shards > 1 and cell.batch == 4 // shards
    assert all(t.shape[0] == cell.batch for t in cell.abstract_args[1].values())
    res = dryrun.trace(cell, backend)
    assert res["memory"]["peak_bytes"] > 0


def test_default_refuses_a_dense_model_with_a_frontend():
    """A dense arch given a frontend (the classification task) runs the
    ``default`` preset's layout over the frames it embeds (the refusals
    this test was named for are lifted; ``fsdp`` runs it too), and its
    dry-run train and serve cells trace sharded; its serve steps run under
    ``default`` (a prefill of frames over two threads equals one
    process's), and so does the hybrid family's train step."""
    from repro_torch.distributed import sharding as tsharding
    from repro_torch.launch import steps as tsteps
    from repro_torch.selection.base import GraftConfig as TGraftConfig
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    mcfg = tconfigs.get_smoke_config("minicpm-2b", frontend="audio_frames")
    assert tsharding.check_rules(mesh, {}, "dense", "audio_frames") == "default"
    assert tsharding.check_rules(mesh, {}, "dense") == "default"
    assert tsharding.check_rules(mesh, tspecs.RULE_PRESETS["fsdp"], "dense",
                                 "audio_frames") == "fsdp"
    for family in ("ssm", "audio", "vlm", "hybrid"):
        assert tsharding.check_rules(mesh, {}, family) == "default"
    tcfg = tsteps.TrainConfig(graft=TGraftConfig(rset=(2, 4)))
    with tsharding.sharding_rules(mesh, {}):
        tsteps.make_train_step(mcfg, tcfg)
        frames = torch.zeros((4, 16, mcfg.d_model))
        sp = tmodel.sequence_layout(mcfg, {"frame_embeds": frames})
        assert (sp.length, sp.axes) == (16, ("model",))
        assert callable(tsteps.make_train_step(tconfigs.get_smoke_config("hymba-1.5b"), tcfg))
    f32 = dataclasses.replace(mcfg, param_dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in _frontend_batch(f32, 4, 16).items()}
    got, want = _serve_over_threads(f32, batch, 32)
    for pair in got:
        for a, b in zip(pair, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    # the dry run's cells whose data source pins the frontend shard
    for shape, variant in (("train_4k", "graft"), ("decode_32k", "serve"),
                           ("prefill_32k", "serve")):
        res = dryrun.run_cell("minicpm-2b", shape, "t", variant, smoke=True,
                              mesh_override=mesh, rules_preset="default",
                              data_source="synthetic_classification", **CARD)
        assert res["state"] == "sharded" and "replicated_why" not in res, shape


@pytest.mark.parametrize("preset", ["default", "fsdp"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dense_serve_cells_run_sharded_below_replicated(shape, preset):
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    res = dryrun.run_cell("minicpm-2b", shape, "t", "serve", smoke=True, mesh_override=mesh,
                          rules_preset=preset, **CARD)
    assert res["state"] == "sharded" and "replicated_why" not in res
    coll = res["full"]["collectives"]["count_by_op"]
    assert coll["all-gather"] > 0                    # the weights' just-in-time gathers
    if shape == "decode_32k" and preset == "default":
        assert coll["all-reduce"] > 0                # the combine, the MLP's partial sums
    backend = dryrun.RecordingBackend(res["batch_shards"])       # the state replicated
    cell = tspecs.build_cell("minicpm-2b", shape, variant="serve", smoke=True,
                             batch_shards=res["batch_shards"], backend=backend, **CARD)
    replicated = dryrun.trace(cell, backend)
    assert res["full"]["memory"]["peak_bytes"] < replicated["memory"]["peak_bytes"]


def test_long_context_cache_splits_over_both_axes():
    """long_500k's rules split the cache's positions over ``("data",
    "model")`` where the rows leave both free (its smoke cell's 4 rows do
    not divide the 8 of "data"): hymba-1.5b's cell under ``fsdp`` runs its
    combine over both axes."""
    from repro_torch.distributed import sharding as tsharding
    mesh = tmesh.make_mesh((8, 2), ("data", "model"))
    rules = dict(tspecs.SHAPE_RULES["long_500k"], **tspecs.RULE_PRESETS["fsdp"])
    kv = tsharding.cache_layout(4, 64, mesh, rules)
    assert (kv.batch_axes, kv.seq_axes, kv.start, kv.stop) == ((), ("data", "model"), 0, 4)
    res = dryrun.run_cell("hymba-1.5b", "long_500k", "t", "serve", smoke=True,
                          mesh_override=mesh, rules_preset="fsdp", **CARD)
    assert res["state"] == "sharded" and res["local_batch"] == 4
    assert res["full"]["collectives"]["count_by_op"]["all-reduce"] > 0


# ---------------------------------------------------------------------------
# the query offset of the flash plain versions
# ---------------------------------------------------------------------------

# name: (BHkv, group, T, Dh, window, softcap)
OFFSET_CASES = {
    "causal": (2, 1, 64, 32, None, None),
    "gqa2_window_softcap": (2, 2, 64, 16, 24, 30.0),
}


@pytest.mark.parametrize("parts", [2, 16])
@pytest.mark.parametrize("name", list(OFFSET_CASES))
def test_flash_query_offset_is_the_rows_of_the_whole(name, parts):
    BHkv, group, T, Dh, window, softcap = OFFSET_CASES[name]
    rng = np.random.default_rng(3)
    q, do = (rng.normal(size=(BHkv * group, T, Dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(BHkv, T, Dh)).astype(np.float32) for _ in range(2))
    opts = dict(causal=True, window=window, softcap=softcap, group=group)
    blk = 16 if T % 16 == 0 else 8

    def jloss(q, k, v):
        o = jfa.flash_attention_pallas(q, k, v, block_q=blk, block_k=blk, interpret=True,
                                       **opts)
        return (o * do).sum(), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    whole = tfa.flash_forward(*(torch.from_numpy(a) for a in (q, k, v)), **opts)
    tk, tv = (torch.from_numpy(a).requires_grad_() for a in (k, v))
    n = T // parts
    for i in range(parts):
        rows = slice(i * n, (i + 1) * n)
        tq = torch.from_numpy(q[:, rows].copy()).requires_grad_()
        o, lse = tfa.flash_forward(tq.detach(), tk.detach(), tv.detach(), q_offset=i * n,
                                   **opts)
        assert torch.equal(o, whole[0][:, rows]) and torch.equal(lse, whole[1][:, rows])
        np.testing.assert_allclose(o.numpy(), np.asarray(jo)[:, rows], atol=2e-5)
        out = tfa.flash_attention(tq, tk, tv, q_offset=i * n, **opts)
        (out * torch.from_numpy(do[:, rows].copy())).sum().backward()
        np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg[0])[:, rows], atol=5e-4)
    for got, want in zip((tk.grad, tv.grad), jg[1:]):            # the slices' sum
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    work = sum(tfa.unmasked_pairs(n, T, True, window, i * n) for i in range(parts))
    assert work == tfa.unmasked_pairs(T, T, True, window)


def test_dense_attention_takes_the_offset():
    """``layers.attention``'s dense path with a query slice: the rows of the
    whole sequence's output."""
    cfg = tconfigs.get_smoke_config("gemma2-27b", param_dtype="float32")
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    p = model.blocks[0].tree()["attn"]
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(32, dtype=torch.int32).expand(2, 32)
    whole, _ = tlayers.attention(cfg, p, x, pos, is_local=True)

    class Half:                                   # a SeqParallel stand-in, rank 1 of 2
        size, start, length = 2, 16, 32

        def gather(self, h):
            return x
    got, _ = tlayers.attention(cfg, p, x[:, 16:], pos[:, 16:], is_local=True, sp=Half())
    torch.testing.assert_close(got, whole[:, 16:], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the vocabulary-parallel loss over two threads
# ---------------------------------------------------------------------------

class _ThreadMesh:
    """Rank ``rank`` of ``n`` threads whose collectives meet at a barrier:
    the ranks of a (1, n) ``("data", "model")`` mesh."""

    axis_names = ("data", "model")

    def __init__(self, rank, n, slots, barrier):
        self.rank, self.n, self.slots, self.barrier = rank, n, slots, barrier
        self.shape = {"data": 1, "model": n}
        self.coords = {"data": 0, "model": rank}

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes):
        return self.rank if self.size(axes) > 1 else 0

    def _all(self, x):
        self.slots[self.rank] = x
        self.barrier.wait()
        every = list(self.slots)
        self.barrier.wait()
        return every

    def psum(self, x, axes):
        return sum(self._all(x)) if self.size(axes) > 1 else x

    def pmax(self, x, axes):
        return torch.stack(self._all(x)).amax(dim=0)

    def all_gather(self, x, axes, dim=0):
        return torch.cat(self._all(x), dim=dim) if self.size(axes) > 1 else x

    def psum_scatter(self, x, axes, dim=0):
        if self.size(axes) == 1:
            return x
        k = x.shape[dim] // self.n
        return sum(self._all(x)).narrow(dim, self.rank * k, k).clone()


def _threads(n, fn):
    """``fn(mesh)`` on each of ``n`` threads standing in for the ranks of a
    (1, n) mesh → their results in rank order (the first error raised)."""
    slots, barrier, got, errors = [None] * n, threading.Barrier(n), [None] * n, []

    def rank(r):
        try:
            got[r] = fn(_ThreadMesh(r, n, slots, barrier))
        except BaseException as e:          # noqa: BLE001 — raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return got


def test_vocab_parallel_nll_equals_nll():
    V, n = 12, 2
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((3, 5, V), generator=gen)
    labels = torch.randint(0, V, (3, 5), generator=gen)
    labels[0, 0] = V + 3                          # outside the vocabulary: NaN
    weight = torch.rand((3, 5), generator=gen)
    weight[0, 0] = 0.0
    whole = logits.clone().requires_grad_()
    want = -take_last(torch.log_softmax(whole, dim=-1), labels)
    torch.nan_to_num(want * weight).sum().backward()
    slots, barrier, got = [None] * n, threading.Barrier(n), [None] * n

    def rank(r):
        mesh = _ThreadMesh(r, n, slots, barrier)
        part = logits[..., r * V // n:(r + 1) * V // n].clone().requires_grad_()
        vs = tmodel.VocabSlice(mesh, ("model",), r * V // n, (r + 1) * V // n, V)
        nll = tmodel.vocab_parallel_nll(part, labels, vs)
        # rank 0 counts the replicated nll; the psums' backward reach both
        (torch.nan_to_num(nll * weight).sum() * (1.0 if r == 0 else 0.0)).backward()
        got[r] = (nll.detach(), part.grad)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for nll, _ in got:
        torch.testing.assert_close(nll, want.detach(), rtol=1e-6, atol=1e-6, equal_nan=True)
    torch.testing.assert_close(torch.cat([g for _, g in got], dim=-1), whole.grad,
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# expert parallelism and Adafactor's means over two threads
# ---------------------------------------------------------------------------

# name: (preset, rows, positions, the axes the rows split over, then the
# axes the MoE's groups and its experts split over on the (1, 2) mesh)
EP_CASES = {
    # G = 2 groups over ("data", "model"): every rank runs every expert
    "fsdp_experts_whole": ("fsdp", 4, 32, ("data", "model"), ("data", "model"), ()),
    # the same groups, the rows whole on each rank: each takes its group
    "fsdp_rows_whole": ("fsdp", 2, 64, (), ("data", "model"), ()),
    # G = 3 does not divide over "model": the experts go there, and each
    # rank gathers its group's rows from its peer
    "fsdp_experts_split": ("fsdp", 2, 96, ("data", "model"), ("data",), ("model",)),
    # G = 3 over "data" alone, the rows whole on each rank: the experts over
    # "model" and the ranks' partials summed by a psum
    "fsdp_rows_whole_experts_split": ("fsdp", 1, 192, (), ("data",), ("model",)),
    # the default preset: the sequence gathered, the experts over "model"
    "default": ("default", 2, 64, ("data",), ("data",), ("model",)),
}


def _rank_part(n, axes, mesh):
    """``[start, stop)`` of a dim of ``n`` split over ``axes`` at ``mesh``'s rank."""
    k, i = mesh.size(axes) if axes else 1, mesh.axis_index(axes) if axes else 0
    return i * n // k, (i + 1) * n // k


@pytest.mark.parametrize("case", list(EP_CASES))
def test_expert_parallel_moe_equals_jax(case):
    """The expert-parallel ``moe`` over two threads standing in for the
    ranks of "model" against JAX's ``moe`` with no mesh: each rank's output
    is its rows and positions of JAX's; the gradients of x (the ranks'
    summed where they hold the same rows) and of the four leaves (the
    router's partial on each rank and summed; the experts' each rank's
    shard) at rtol 1e-5, atol 1e-5 of the largest value."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import layers as jlayers
    from repro_torch.distributed import sharding as tsharding
    import jax.numpy as jnp
    preset, B, S, rows, groups, experts = EP_CASES[case]
    arch = "qwen3-moe-235b-a22b"
    jm = jsmoke(arch, param_dtype="float32")
    tm = tconfigs.get_smoke_config(arch, param_dtype="float32")
    jp = {k: np.asarray(v) for k, v in
          jlayers.init_moe_params(jax.random.PRNGKey(0), jm, jnp.float32).items()}
    rng = np.random.default_rng(0)
    x, dy = (rng.normal(size=(B, S, jm.d_model)).astype(np.float32) for _ in range(2))

    def both(p, xx, g):
        out, vjp = jax.vjp(lambda p, xx: jlayers.moe(jm, p, xx), p, xx)
        return out, vjp(g)
    jout, (jgp, jgx) = (jax.tree_util.tree_map(np.asarray, t) for t in jax.jit(both)(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x), jnp.asarray(dy)))
    names = sorted(jp)

    def rank(mesh):
        with tsharding.sharding_rules(mesh, tspecs.RULE_PRESETS[preset]):
            shardings = tsharding.param_shardings(jp, tmodel._MOE_LOGICAL, mesh)
            shards = {k: tsharding.shard_tensor(torch.from_numpy(jp[k].copy()),
                                                s).requires_grad_()
                      for k, s in shardings.items()}
            p = {k: tsharding.ShardedParam(shards[k], s) if s.is_sharded else shards[k]
                 for k, s in shardings.items()}
            r0, r1 = _rank_part(B, rows, mesh)
            sp = tmodel.sequence_layout(tm, {"tokens": torch.zeros((r1 - r0, S))})
            s0, s1 = (sp.start, sp.stop) if sp is not None else (0, S)
            xr = torch.from_numpy(x[r0:r1, s0:s1].copy()).requires_grad_()
            with tsharding.batch_rows(rows):
                ep = tmodel.expert_layout(tm, xr, sp)
            y = tlayers.moe(tm, p, xr, ep=ep)
            # rows whole on every rank: rank 0 counts them (the step's rule)
            weight = 1.0 if rows or sp is not None or mesh.rank == 0 else 0.0
            loss = (y * torch.from_numpy(dy[r0:r1, s0:s1].copy())).sum() * weight
            grads = torch.autograd.grad(loss, [xr] + [shards[k] for k in names])
            return ((ep.group_axes, ep.expert_axes), (r0, r1, s0, s1), y.detach(), grads,
                    shardings)

    got = _threads(2, rank)
    gx = np.zeros_like(x)
    for (layout, (r0, r1, s0, s1), y, grads, _) in got:
        assert layout == (groups, experts), layout
        want = jout[r0:r1, s0:s1]
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        gx[r0:r1, s0:s1] += grads[0].numpy()
    np.testing.assert_allclose(gx, jgx, rtol=1e-5, atol=1e-5 * np.abs(jgx).max())
    for i, k in enumerate(names):
        s = got[0][4][k]
        parts = [g[3][1 + i].numpy() for g in got]
        whole = np.concatenate(parts, axis=0) if s.is_sharded else sum(parts)
        np.testing.assert_allclose(whole, jgp[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(jgp[k]).max(), err_msg=k)


# ---------------------------------------------------------------------------
# the frontends' positions and the RWKV mixes over threads
# ---------------------------------------------------------------------------

def _frontend_batch(cfg, B, S, seed=0):
    """A numpy batch of B rows of ``cfg``'s input: S frames (audio), or
    ``cfg.num_patches`` patches and S - P tokens (vlm)."""
    rng = np.random.default_rng(seed)
    D, V = cfg.d_model, cfg.vocab_size
    if tmodel.input_kind(cfg) == "frames":
        return {"frame_embeds": rng.normal(size=(B, S, D)).astype(np.float32),
                "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    P = cfg.num_patches
    toks = rng.integers(0, V, (B, S - P)).astype(np.int32)
    return {"patch_embeds": rng.normal(size=(B, P, D)).astype(np.float32),
            "tokens": toks, "labels": np.roll(toks, -1, 1)}


# name: (arch, threads, positions): the vlm's 8 patches end inside rank 0's
# 12 positions of 24, or fill rank 0's 6 and end inside rank 1's
EMBED_CASES = {"audio": ("musicgen-medium", 2, 24), "vlm_straddle": ("internvl2-26b", 2, 24),
               "vlm_patches_alone": ("internvl2-26b", 4, 24)}


@pytest.mark.parametrize("case", list(EMBED_CASES))
def test_embed_inputs_takes_the_rank_positions(case):
    """``embed_inputs(sp=)`` on each thread standing in for a rank of
    "model" equals its positions of the whole ``embed_inputs`` (the input,
    the positions, the loss mask: 0 on the patches, 1 on the text), and the
    pooled features of the whole forward under the ``default`` layout equal
    one process's (a vlm batch pools its text positions only)."""
    from repro_torch.distributed import sharding as tsharding
    arch, n, S = EMBED_CASES[case]
    cfg = tconfigs.get_smoke_config(arch, param_dtype="float32")
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _frontend_batch(cfg, 2, S).items()}
    whole = tmodel.embed_inputs(cfg, model, batch)
    pooled = tmodel.pooled_features(cfg, model, batch)

    def rank(mesh):
        with tsharding.sharding_rules(mesh, {}):
            sp = tmodel.sequence_layout(cfg, batch)
            return ((sp.start, sp.stop), tmodel.embed_inputs(cfg, model, batch, sp),
                    tmodel.pooled_features(cfg, model, batch).detach())

    got = _threads(n, rank)
    assert [g[0] for g in got] == [(r * S // n, (r + 1) * S // n) for r in range(n)]
    for (s0, s1), part, feats in got:
        for a, b in zip(part, whole):
            assert torch.equal(a, b[:, s0:s1]), (s0, s1)
        torch.testing.assert_close(feats, pooled, rtol=1e-5, atol=1e-6)
    if tmodel.input_kind(cfg) == "patches":
        masks = [part[2][0] for _, part, _ in got]
        assert [int(m.sum()) for m in masks] == [
            max(0, s1 - max(s0, cfg.num_patches)) for s0, s1 in (g[0] for g in got)]


# name: (mix, threads, positions, whether a decode state goes in): on two
# the heads (4, 2 a rank) and d_ff split over "model"; on three neither
# divides, and each rank runs the whole heads or weights on its positions.
# "ssm" is hymba's SSM heads. With a state the mix is a prefill (12
# positions, each rank's 6 or 4) or a tick (one position on every rank)
MIX_CASES = {"time_heads": ("time", 2, 12, False), "channel_d_ff": ("channel", 2, 12, False),
             "time_whole_heads": ("time", 3, 12, False),
             "channel_whole_d_ff": ("channel", 3, 12, False),
             "ssm_heads": ("ssm", 2, 12, False), "ssm_whole_heads": ("ssm", 3, 12, False),
             "time_heads_prefill": ("time", 2, 12, True),
             "channel_d_ff_prefill": ("channel", 2, 12, True),
             "ssm_heads_prefill": ("ssm", 2, 12, True),
             "ssm_whole_heads_prefill": ("ssm", 3, 12, True),
             "time_heads_tick": ("time", 2, 1, True), "ssm_heads_tick": ("ssm", 2, 1, True),
             "channel_d_ff_tick": ("channel", 2, 1, True)}
MIX_FNS = {"time": "rwkv_time_mix", "channel": "rwkv_channel_mix", "ssm": "ssm_heads"}


def _mix_state(mix, cfg, B, gen):
    """A random decode state of ``mix`` for B rows: the token-shift carry
    (B, 1, D), the WKV state (B, H, Dh, Dh) or the SSM heads' (B, H, Dh, N)."""
    D, H = cfg.d_model, cfg.num_heads
    if mix == "ssm":
        return torch.randn((B, H, D // H, cfg.ssm_state), generator=gen)
    state = {"shift": torch.randn((B, 1, D), generator=gen)}
    if mix == "time":
        state["wkv"] = torch.randn((B, H, D // H, D // H), generator=gen) * 0.1
    return state


def _state_heads(state, heads):
    """The heads ``[start, stop)`` of a decode state's per-head leaves
    (``wkv``, the SSM state; ``CACHE_LOGICAL``'s ``act_heads``), the
    token-shift carry whole."""
    if isinstance(state, dict):
        return {k: (v if k == "shift" else _state_heads(v, heads)) for k, v in state.items()}
    return state[:, heads[0]:heads[1]]


@pytest.mark.parametrize("case", list(MIX_CASES))
def test_rwkv_mixes_over_threads_equal_the_whole(case):
    """The head-parallel RWKV time mix and SSM heads and the
    tensor-parallel channel mix on threads standing in for the ranks of
    "model", each given its positions and its shards (the ``default``
    preset's ``params_logical`` layout), equal the whole mix: each rank's
    output its positions of the whole, the input's gradient and every
    leaf's (a sharded leaf's shards joined, a replicated one's partials
    summed, as the step sums them) at rtol 1e-5. With a decode state each
    rank starts from its heads of it (``CACHE_LOGICAL``; the whole where
    the heads do not divide) and its new state is its heads of the whole
    one, the token-shift carry whole; a tick's one position is every
    rank's (the partial sums psum-ed; its gradient is not taken: serving
    takes none)."""
    from repro_torch.distributed import sharding as tsharding
    from repro_torch.models import ssm as tssm
    mix, n, S, with_state = MIX_CASES[case]
    arch = "hymba-1.5b" if mix == "ssm" else "rwkv6-7b"
    cfg = tconfigs.get_smoke_config(arch, param_dtype="float32")
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    p = {k: v.detach().clone() for k, v in model.blocks[0].tree()[mix].items()}
    for k in p:                         # the zero-initialised leaves made to matter
        if k.startswith("lora_B") or k == "delta_bias":
            p[k] = torch.randn(p[k].shape, generator=gen) * 0.1
    fn = getattr(tssm, MIX_FNS[mix])
    B = 2
    x, dy = (torch.randn((B, S, cfg.d_model), generator=gen) for _ in range(2))
    state = _mix_state(mix, cfg, B, gen) if with_state else None
    grads = S > 1
    names = sorted(p)
    xw = x.clone().requires_grad_()
    pw = {k: v.clone().requires_grad_() for k, v in p.items()}
    want, want_state = fn(cfg, pw, xw, state=state)
    if grads:
        want_g = torch.autograd.grad((want * dy).sum(), [xw] + [pw[k] for k in names])
    logical = tmodel._tree_logical({mix: p})[mix]
    tssm.HEAD_RUNS.clear()

    def rank(mesh):
        with tsharding.sharding_rules(mesh, {}):
            sp = tmodel.sequence_layout(cfg, {"tokens": torch.zeros((B, S))})
            heads = sp.part("act_heads", cfg.num_heads)
            shardings = tsharding.param_shardings(p, logical, mesh)
            shards = {k: tsharding.shard_tensor(p[k].clone(), s).requires_grad_()
                      for k, s in shardings.items()}
            leaves = {k: tsharding.ShardedParam(shards[k], s) if s.is_sharded else shards[k]
                      for k, s in shardings.items()}
            xr = x[:, sp.start:sp.stop].clone().requires_grad_()
            mine = None if state is None else _state_heads(state, heads)
            y, new_state = fn(cfg, leaves, xr, state=mine, sp=sp)
            g = (torch.autograd.grad((y * dy[:, sp.start:sp.stop]).sum(),
                                     [xr] + [shards[k] for k in names]) if grads else None)
        return (sp.start, sp.stop), y.detach(), g, shardings, heads, new_state

    got = _threads(n, rank)
    gx = torch.zeros_like(x)
    for (s0, s1), y, g, _, heads, new_state in got:
        torch.testing.assert_close(y, want[:, s0:s1].detach(), rtol=1e-5, atol=1e-6)
        if with_state:
            for a, b in zip(_leaves(new_state), _leaves(_state_heads(want_state, heads))):
                assert a[0] == b[0] and a[1].shape == b[1].shape, (a[0], b[0])
                torch.testing.assert_close(a[1], b[1].detach(), rtol=1e-5, atol=1e-6)
        else:
            assert new_state is None
        if grads:
            gx[:, s0:s1] = g[0]
    if grads:
        # the SSM heads' input gradient reaches ~27 at smoke size, where the
        # ranks' sum rounds in float32 at ~3e-6
        atol = 1e-7 * float(want_g[0].abs().max()) if mix == "ssm" else 1e-6
        torch.testing.assert_close(gx, want_g[0], rtol=1e-5, atol=atol)
        for i, k in enumerate(names):
            s = got[0][3][k]
            parts = [r[2][1 + i] for r in got]
            dim = next((d for d in range(len(s.shape)) if s.local_shape[d] != s.shape[d]), None)
            joined = sum(parts) if dim is None else torch.cat(parts, dim=dim)
            torch.testing.assert_close(joined, want_g[1 + i], rtol=1e-5,
                                       atol=1e-5 * float(want_g[1 + i].abs().max()), msg=k)
    if mix != "channel" and n == 2:     # the rank's heads, their leaves' shards
        assert dict(tssm.HEAD_RUNS) == {(0, 2): 1, (2, 4): 1}
        assert [r[4] for r in got] == [(0, 2), (2, 4)]
        wide = ("wr", "wo") if mix == "time" else ("w_in", "w_out")
        assert got[0][3][wide[0]].dim_axes(1) == ("model",)
        assert got[0][3][wide[1]].dim_axes(0) == ("model",)
    elif mix == "channel" and n == 2:
        assert got[0][3]["w_key"].dim_axes(1) == ("model",)
    else:
        assert not tssm.HEAD_RUNS


def test_moe_needs_its_rows_axes_under_rules():
    """Under ``sharding_rules`` a MoE forward that is not told its rows'
    axes (``batch_rows``) refuses: its groups span the global batch."""
    from repro_torch.distributed import sharding as tsharding
    tm = tconfigs.get_smoke_config("qwen3-moe-235b-a22b", param_dtype="float32")
    mesh = tmesh.make_mesh((1, 2), ("data", "model"))
    with tsharding.sharding_rules(mesh, tspecs.RULE_PRESETS["fsdp"]):
        with pytest.raises(ValueError, match="batch_rows"):
            tmodel.expert_layout(tm, torch.zeros((2, 32, tm.d_model)))


# name: (full shape, logical axes) of the leaves of the sharded Adafactor
# step; "stack" is two blocks' (8, 6) leaves stacked as one JAX leaf
ADAFACTOR_LEAVES = {
    "w_in": ((6, 8), ("embed", "mlp")),             # the columns over "model"
    "w_out": ((8, 6), ("mlp", "embed")),            # the rows over "model"
    "experts": ((4, 6, 10), ("experts", "embed", "mlp")),   # split on neither
    "norm": ((6,), (None,)),
    "stack0": ((8, 6), ("mlp", "embed")),
    "stack1": ((8, 6), ("mlp", "embed")),
}


def test_sharded_adafactor_equals_the_whole_leaves():
    """Three Adafactor steps on two threads' shards (fsdp rules on a (1, 2)
    mesh, the global clip by kernel A's split) equal the same steps on the
    whole leaves, leaf by leaf: the factored moments' rows and columns over
    a split dim and the update's RMS span the whole leaf."""
    from repro_torch.distributed import sharding as tsharding
    from repro_torch.optim import OptimizerConfig as TOptCfg
    from repro_torch.optim import make_optimizer
    cfg = TOptCfg(name="adafactor", learning_rate=1e-2, schedule="constant", clip_norm=0.5)
    names = list(ADAFACTOR_LEAVES)
    groups = [0, 1, 2, 3, [4, 5]]
    rng = np.random.default_rng(0)
    full = {k: rng.normal(size=shape).astype(np.float32)
            for k, (shape, _) in ADAFACTOR_LEAVES.items()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * (0.1 + i)
              for k, v in full.items()} for i in range(3)]
    opt = make_optimizer(cfg)
    params = [torch.from_numpy(full[k].copy()) for k in names]
    state = opt.init(params, groups)
    for g in grads:
        opt.apply(params, [torch.from_numpy(g[k]) for k in names], state, 0)

    def rank(mesh):
        with tsharding.sharding_rules(mesh, tspecs.RULE_PRESETS["fsdp"]):
            sh = [tsharding.leaf_sharding(ADAFACTOR_LEAVES[k][0], ADAFACTOR_LEAVES[k][1], mesh)
                  for k in names]
        mine = [tsharding.shard_tensor(torch.from_numpy(full[k].copy()), s)
                for k, s in zip(names, sh)]
        st = opt.init(mine, groups)
        for step, g in enumerate(grads):
            gs = [tsharding.shard_tensor(torch.from_numpy(g[k].copy()), s)
                  for k, s in zip(names, sh)]
            gs, _ = opt.preprocess(gs, [s.counted() for s in sh],
                                   lambda t: mesh.psum(t, ("data", "model")))
            opt.update(mine, gs, st, 0, sh)
        return mine, sh

    got = _threads(2, rank)
    assert got[0][1][0].dim_axes(1) == ("model",) and got[0][1][1].dim_axes(0) == ("model",)
    for i, k in enumerate(names):
        s = got[0][1][i]
        dim = next((d for d in range(len(s.shape)) if s.local_shape[d] != s.shape[d]), None)
        whole = (got[0][0][i] if dim is None
                 else torch.cat([g[0][i] for g in got], dim=dim))
        torch.testing.assert_close(whole, params[i], rtol=1e-5, atol=1e-6, msg=k)


# ---------------------------------------------------------------------------
# the dry run's default cells
# ---------------------------------------------------------------------------

DENSE = ["minicpm-2b", "stablelm-12b", "gemma2-27b", "qwen1.5-32b"]


@pytest.mark.parametrize("arch", DENSE)
def test_default_cell_runs_sharded_below_replicated(arch):
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    res = dryrun.run_cell(arch, "train_4k", "t", "graft", smoke=True, mesh_override=mesh,
                          rules_preset="default", **CARD)
    assert res["state"] == "sharded" and res["batch_shards"] == 2 and res["local_batch"] == 2
    assert "replicated_why" not in res
    coll = res["full"]["collectives"]["count_by_op"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    backend = dryrun.RecordingBackend(2)             # the state replicated, the batch over data
    cell = tspecs.build_cell(arch, "train_4k", smoke=True, batch_shards=2, backend=backend,
                             **CARD)
    replicated = dryrun.trace(cell, backend)
    assert res["full"]["memory"]["peak_bytes"] < replicated["memory"]["peak_bytes"]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "musicgen-medium", "internvl2-26b",
                                  "hymba-1.5b"])
def test_default_cells_of_other_families_run_sharded(arch):
    """The ssm, audio, vlm and hybrid families' ``default`` train cells and
    their decode_32k and prefill_32k cells trace sharded below the
    replicated state's peak on the same (2, 2) mesh (the rwkv6-7b smoke
    cell's 4 heads, 2 a device: the WKV at a device's streams; hymba's SSM
    heads likewise, 2 of 4 a device)."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    res = dryrun.run_cell(arch, "train_4k", "t", "graft", smoke=True, mesh_override=mesh,
                          rules_preset="default", **CARD)
    assert res["state"] == "sharded" and "replicated_why" not in res
    coll = res["full"]["collectives"]["count_by_op"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    backend = dryrun.RecordingBackend(2)             # the state replicated, the batch over data
    cell = tspecs.build_cell(arch, "train_4k", smoke=True, batch_shards=2, backend=backend,
                             **CARD)
    replicated = dryrun.trace(cell, backend)
    assert res["full"]["memory"]["peak_bytes"] < replicated["memory"]["peak_bytes"]
    kernels = res["full"]["kernels"]
    if arch == "rwkv6-7b":              # a device's streams: its rows × its 2 of 4 heads
        from repro_torch.kernels import rwkv_scan as trs
        cfg = tconfigs.get_smoke_config(arch)
        L, Dh = cfg.num_layers, cfg.d_model // cfg.num_heads

        def ops(kind, rows):
            return trs.cost(kind, rows * 2, 64, Dh)[0]
        # the selection forward's 2 rows a device, the subset's 1 (its 2 of 4
        # over "data"), one launch a layer each way
        assert kernels["rwkv_scan"]["launches"] == 2 * L
        assert kernels["rwkv_scan"]["flops"] == L * (ops("fwd", 2) + ops("fwd", 1))
        assert kernels["rwkv_scan_backward"]["flops"] == L * ops("bwd", 1)
    for shape in ("decode_32k", "prefill_32k"):
        serve = dryrun.run_cell(arch, shape, "t", "serve", smoke=True, mesh_override=mesh,
                                rules_preset="default", **CARD)
        assert serve["state"] == "sharded" and "replicated_why" not in serve, shape
        assert serve["full"]["collectives"]["count_by_op"]["all-reduce"] > 0, shape
        backend = dryrun.RecordingBackend(serve["batch_shards"])   # the state replicated
        cell = tspecs.build_cell(arch, shape, variant="serve", smoke=True,
                                 batch_shards=serve["batch_shards"], backend=backend, **CARD)
        replicated = dryrun.trace(cell, backend)
        assert serve["full"]["memory"]["peak_bytes"] < replicated["memory"]["peak_bytes"], shape


@pytest.mark.parametrize("preset", ["default", "fsdp"])
@pytest.mark.parametrize("arch", [MOE, KIMI])
def test_moe_train_cell_runs_sharded_below_replicated(arch, preset):
    """The MoE archs' train cells (kimi-k2's under Adafactor) trace sharded
    under both presets, below the replicated state's peak on the same mesh;
    their serve cells keep the state replicated under ``default`` and
    refuse under ``fsdp``, each naming A14s."""
    mesh = tmesh.make_mesh((2, 2), ("data", "model"))
    res = dryrun.run_cell(arch, "train_4k", "t", "graft", smoke=True, mesh_override=mesh,
                          rules_preset=preset, **CARD)
    assert res["state"] == "sharded" and "replicated_why" not in res
    coll = res["full"]["collectives"]["count_by_op"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    # the replicated state with the batch over data, as the cell ran before
    backend = dryrun.RecordingBackend(2)
    cell = tspecs.build_cell(arch, "train_4k", smoke=True, batch_shards=2, backend=backend,
                             **CARD)
    assert cell.tcfg.optimizer.name == ("adafactor" if arch == KIMI else "adamw")
    replicated = dryrun.trace(cell, backend)
    for key in ("peak_bytes", "argument_size_in_bytes"):
        assert res["full"]["memory"][key] < replicated["memory"][key], key
    if preset == "fsdp":
        with pytest.raises(ValueError, match="A14s"):
            dryrun.run_cell(arch, "decode_32k", "t", "serve", smoke=True, mesh_override=mesh,
                            rules_preset=preset, **CARD)
    else:
        serve = dryrun.run_cell(arch, "decode_32k", "t", "serve", smoke=True,
                                mesh_override=mesh, rules_preset=preset, **CARD)
        assert serve["state"] == "replicated" and "A14s" in serve["replicated_why"]


# ---------------------------------------------------------------------------
# the loss chunks' recompute
# ---------------------------------------------------------------------------

def _chunked_without_recompute(cfg, params, h, labels):
    """``_nll`` as it was before the chunks were recomputed."""
    head = tmodel.unembedding(cfg, params)
    C = cfg.loss_chunk
    return torch.cat([-take_last(torch.log_softmax(
        tmodel.logits_from_hiddens(cfg, params, h[:, c0:c0 + C], head).to(torch.float32),
        dim=-1), labels[:, c0:c0 + C]) for c0 in range(0, h.shape[1], C)], dim=1)


def test_loss_chunks_save_no_log_softmax():
    base = tconfigs.get_smoke_config("minicpm-2b", param_dtype="float32")
    cfg = dataclasses.replace(base, loss_chunk=8)
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    params = list(model.parameters())

    def run(loss_of):
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size()
                         if t.dtype == torch.float32 and t.dim() == 3
                         and t.shape[-1] == cfg.vocab_size else 0)
            return t
        h, mask = tmodel.forward_hiddens(cfg, model, batch)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            nll = loss_of(h)
            loss = torch.sum(nll * mask) / torch.sum(mask)
        return loss, torch.autograd.grad(loss, params), sum(saved)

    new = run(lambda h: tmodel._nll(cfg, model, h, batch["labels"]))
    old = run(lambda h: _chunked_without_recompute(cfg, model.tree(), h, batch["labels"]))
    whole = run(lambda h: tmodel._nll(base, model, h, batch["labels"]))
    # before: at least each chunk's float32 log-softmax, (4, 8, V) a chunk
    assert new[2] == 0 and old[2] >= 4 * 32 * cfg.vocab_size * 4 and whole[2] > 0
    assert torch.equal(new[0], old[0]) and torch.equal(new[0], whole[0])
    assert all(torch.equal(a, b) for a, b in zip(new[1], old[1]))
    names = [n for n, _ in model.named_parameters()]
    for name, a, b in zip(names, new[1], whole[1]):
        # the head's gradient adds the chunks' products, the whole loss one
        if name == "embed":
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
        else:
            assert torch.equal(a, b), name
