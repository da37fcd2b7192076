"""Batched serving: wave-scheduled static batching — the port of the
JAX package's ``launch/serve.py``.

Requests are grouped into waves of up to ``slots``; each wave is prefilled
together (one ``prefill``) and decoded in lock-step (one ``decode_step`` a
tick for the whole slot batch). Finished slots idle until the wave drains,
then the next wave is admitted. The prompts of a wave are cut to its
shortest, so that the shared cache index stays exact, and idle slots are
padded with zero prompts whose tokens are discarded. The next token is the
greedy argmax, read to the host each tick, as in the JAX package's serve.

    python -m repro_torch.launch.serve [--arch minicpm-2b] [--requests 8]
        [--slots 4] [--max-new 16] [--device cpu]

It runs on the GPU unless ``--device`` says otherwise, with the smoke
config of ``--arch`` and random weights from the seed.

``serve_model`` also runs on a port ``Mesh`` under sharding rules (JAX's
serve runs under ``sharding_rules(mesh)``): the ``fsdp`` preset for every
non-MoE family, the ``default`` one for the dense family, each with a
shape's ``SHAPE_RULES`` (decode_32k's split the cache's positions over
``"model"``). Every rank draws the same prompts and prefills its rows of
each wave; the cache and the logits are its rows' (``models/decode.py``).
The next tokens are gathered over the batch's axes each tick, so that every
rank reads the same tokens, makes the same ticks (their collectives must
meet) and reports the same results.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs as config_lib
from repro_torch.api.trainer import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.models import decode as decode_lib
from repro_torch.models import model as model_lib


def serve(arch: str = "minicpm-2b", smoke: bool = True, slots: int = 4,
          max_seq: int = 128, max_new_tokens: int = 16, eos_token: int = 1,
          requests: int = 8, seed: int = 0, device: Optional[str] = None) -> Dict:
    """Serve ``requests`` random prompts of 8 tokens with a model of
    ``arch`` whose weights are drawn from ``seed``, on ``device`` (default:
    the GPU)."""
    mcfg = config_lib.get_smoke_config(arch) if smoke else config_lib.get_config(arch)
    dev = resolve_device(device)
    model = model_lib.init_params(mcfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return serve_model(mcfg, model, slots=slots, max_seq=max_seq,
                       max_new_tokens=max_new_tokens, eos_token=eos_token,
                       requests=requests, seed=seed)


def serve_model(mcfg: model_lib.ModelConfig, model, *, slots: int = 4,
                max_seq: int = 128, max_new_tokens: int = 16, eos_token: int = 1,
                requests: int = 8, seed: int = 0, mesh=None, rules=None) -> Dict:
    """The wave loop over an existing model (on its device). Prompts come
    from ``np.random.default_rng(seed)``, as in the JAX package's serve.
    With ``mesh`` (a port ``Mesh``) the loop runs under
    ``sharding_rules(mesh, rules)`` over ``model``'s shards there (a
    ``ShardedModel``: ``shard_model`` under the same rules)."""
    if mesh is not None and not isinstance(model, model_lib.ShardedModel):
        raise TypeError("serve_model on a mesh takes a ShardedModel (models.model.shard_model)")
    scope = sh.sharding_rules(mesh, rules) if mesh is not None else contextlib.nullcontext()
    with scope:
        return _waves(mcfg, model, slots=slots, max_seq=max_seq,
                      max_new_tokens=max_new_tokens, eos_token=eos_token, requests=requests,
                      seed=seed)


def _waves(mcfg, model, *, slots, max_seq, max_new_tokens, eos_token, requests, seed) -> Dict:
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(2, mcfg.vocab_size, size=8)) for _ in range(requests)]
    params = model.tree()
    dev = model.embed.device

    def host_argmax(logits: torch.Tensor, kv) -> np.ndarray:
        """The greedy tokens of every slot: this rank's rows' gathered over
        the batch's axes."""
        ids = logits[:, 0, :].argmax(-1).to(torch.int32)
        return (ids if kv is None else kv.gather_rows(ids)).cpu().numpy()

    results: List[Dict] = []
    t0 = time.perf_counter()
    ticks = 0
    wave_start = 0
    while wave_start < len(prompts):
        wave = prompts[wave_start:wave_start + slots]
        ids = list(range(wave_start, wave_start + len(wave)))
        wave_start += len(wave)
        plen = min(len(p) for p in wave)
        toks = np.stack([p[:plen] for p in wave]).astype(np.int32)
        if len(wave) < slots:            # idle slots decode zeros, discarded
            toks = np.concatenate([toks, np.zeros((slots - len(wave), plen), np.int32)])
        kv = sh.cache_layout(slots, max_seq)
        t = torch.from_numpy(toks).to(dev)
        t = t if kv is None else kv.take_rows(t)
        logits, cache = decode_lib.prefill(mcfg, params, {"tokens": t, "labels": t}, max_seq,
                                           kv)
        last = host_argmax(logits, kv)
        outs: List[List[int]] = [[int(last[i])] for i in range(len(wave))]
        done = [last[i] == eos_token for i in range(len(wave))]
        cur = last[:, None]
        for _ in range(max_new_tokens - 1):
            if all(done):
                break
            tok = torch.from_numpy(cur).to(dev)
            logits, cache = decode_lib.decode_step(mcfg, params, cache,
                                                   tok if kv is None else kv.take_rows(tok))
            ticks += 1
            nxt = host_argmax(logits, kv)
            for i in range(len(wave)):
                if not done[i]:
                    outs[i].append(int(nxt[i]))
                    done[i] = nxt[i] == eos_token
            cur = nxt[:, None]
        for i, rid in enumerate(ids):
            results.append({"request_id": rid, "tokens": outs[i]})
    wall = time.perf_counter() - t0

    total = sum(len(r["tokens"]) for r in results)
    return {"requests": len(results), "decode_ticks": ticks,
            "total_new_tokens": total, "wall_s": round(wall, 3),
            "tokens_per_s": round(total / max(wall, 1e-9), 1),
            "results": results}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; refuses to start without a GPU "
                         "unless this says cpu)")
    args = ap.parse_args(argv)
    report = serve(arch=args.arch, slots=args.slots, max_new_tokens=args.max_new,
                   requests=args.requests, device=args.device)
    print(json.dumps({k: v for k, v in report.items() if k != "results"}))


if __name__ == "__main__":
    main()
