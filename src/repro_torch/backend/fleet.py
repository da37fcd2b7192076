"""Running a fleet of ranks on one host, and the worker each rank runs —
shared by the 2-rank harness (``python -m repro_torch.backend``), the tests
and the card's smoke script.

``launch`` starts one process per rank and waits for all of them under one
time limit; on a timeout it kills the whole fleet and raises with every
rank's stderr, so that no caller can hang. Each rank gets an even share of
the host's cores (``OMP_NUM_THREADS``), since ranks that each spin on every
core run an order of magnitude slower.

``run_worker`` trains one experiment under the launch audit and returns
what a fleet is held to: per-step losses, grad norms and ranks, the pivots
of every refresh, a digest of the final parameters, each kernel's
launches, the backend's topology and collectives, its gradient-reduce
seconds, and a probe of the host-side ``all_reduce``.

``run_mesh_job`` runs a job file's tasks on a port ``Mesh`` over the
rank's backend (``mesh_worker_command``: ``python -m repro_torch.backend
--worker --job=F --out=D``), and writes everything the tasks produced to
``D/rank<r>.pt``. A task is a dict with a ``kind``:

  * ``"sharded"`` — the sharded selection engine: ``mesh`` (shape, axis
    names), ``gcfg`` (``GraftConfig`` fields), ``samplers``, ``inputs`` (a
    list of global ``(V, G, scores)``, one a step, the carry threaded), and
    optionally ``carry_in`` (sampler → step → a carry to run that step from
    as well). Each rank selects on its own rows of the batch;
  * ``"unequal"`` — every rank passes a different number of rows: each must
    refuse with ``ValueError``;
  * ``"pipeline"`` — ``pipeline_forward`` over ``mesh`` along ``axis``:
    ``layer`` ``"tanh"`` (``tanh(h @ W)``, ``W`` (S, D, D)) or ``"blocks"``
    (``arch``'s first ``layers`` residual blocks at full width from
    ``seed``, ``per_stage`` a stage), on the microbatches ``x``;
  * ``"collectives"`` — every collective of ``mesh`` over each tuple of
    ``axes``, on a tensor that names the rank;
  * ``"fsdp"`` — the sharded train step (ZeRO-3, the ``fsdp`` preset) on
    ``mesh``: ``arch`` (``smoke`` for its smoke config) with the ``model``
    overrides, the train config ``tcfg`` (``optimizer``, ``graft`` — None
    for the baseline step — and ``TrainConfig`` fields), weights from
    ``params`` (a JAX tree, through ``jax_bridge.sharded_params_from_numpy``)
    or drawn from ``seed`` on the device, ``steps`` steps over the global
    ``batches`` (cycled), each rank taking its rows. Rank 0 reports the
    gathered final parameters and the first moment after step 0 (the
    step's clipped gradient times 1 - beta1 under AdamW; none under
    Adafactor, whose state is factored), each in the parameter tree's
    layout (a leaf larger than ``max_leaf_bytes``, where given, its
    leading rows: ``models/model.py`` ``values_tree``). Each rank reports
    its layout, the MoE regimes its forwards ran (``moe``: the tokens, the
    groups' and the experts' axes), its resident and shard bytes and its
    launches;
  * ``"tp"`` — the same under ``preset`` (default: JAX's ``default``
    preset): the batch over ``("pod", "data")``, each row's sequence (the
    frames, or the patches and tokens, a frontend embeds), the MLP hidden,
    the RWKV and SSM heads, the experts and the vocabulary over
    ``"model"``; the model peers of a batch shard take the same rows. Each
    rank also reports the heads of its head-parallel RWKV time mixes and
    SSM heads (``heads``);
  * ``"serve"`` — sharded serving on ``mesh`` under ``preset``'s rules with
    ``shape``'s ``SHAPE_RULES``: ``arch`` (``smoke``, ``model``) with
    weights from ``params`` or ``seed``; a prefill of the rank's rows of the
    prompt batch ``batch`` (tokens, frames, or patches and tokens) into a
    cache of ``max_seq``, then ``ticks`` decode ticks
    (greedy, or fed the whole batch's ``feed`` tokens a tick), or with
    ``wave`` (``serve_model``'s keywords) one ``serve_model`` run. Each rank
    reports its cache's layout, its rows' logits, the whole batch's greedy
    tokens, its cache (with ``return_cache``) after the prefill and the
    last tick, the cache's resident bytes, the seconds and, on the card,
    its peak.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# seconds a fleet may take before it is killed
DEFAULT_TIMEOUT_S = 120
# what every rank's process group waits for a peer (REPRO_TORCH_DIST_TIMEOUT_S)
DIST_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_overrides(world: int, rank: int, port: int, *extra: str) -> List[str]:
    """The ``backend`` overrides of rank ``rank`` of a ``world``-rank fleet
    that meets at ``127.0.0.1:port``."""
    return ["backend.kind=multiprocess", f"backend.coordinator=127.0.0.1:{port}",
            f"backend.num_processes={world}", f"backend.process_id={rank}", *extra]


def fleet_env(world: int, extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // max(1, world))))
    env.setdefault("REPRO_TORCH_DIST_TIMEOUT_S", str(DIST_TIMEOUT_S))
    if extra:
        env.update(extra)
    return env


@dataclasses.dataclass
class RankResult:
    rank: int
    returncode: int
    stdout: str
    stderr: str

    def last_json(self) -> Dict[str, Any]:
        """The JSON object on the last line of stdout."""
        lines = [ln for ln in self.stdout.splitlines() if ln.strip()]
        if not lines:
            raise ValueError(f"rank {self.rank} printed nothing")
        return json.loads(lines[-1])


class FleetError(RuntimeError):
    """A fleet that timed out (and was killed) or whose ranks failed."""


def _tails(results: Sequence[RankResult]) -> str:
    return "\n".join(f"--- rank {r.rank} (rc {r.returncode}) stderr ---\n{r.stderr[-3000:]}"
                     f"\n--- rank {r.rank} stdout ---\n{r.stdout[-1500:]}" for r in results)


def launch(commands: Sequence[Sequence[str]], *, timeout: float = DEFAULT_TIMEOUT_S,
           env: Optional[Dict[str, str]] = None, check: bool = True,
           cwd: Optional[str] = None) -> List[RankResult]:
    """Run one process per rank (``commands[r]`` is rank r's argv) and wait
    for all of them, ``timeout`` seconds in all. A timeout kills every rank
    and raises :class:`FleetError` with their stderr; with ``check`` a
    nonzero exit of any rank raises it too."""
    env = env if env is not None else fleet_env(len(commands))
    procs = [subprocess.Popen(list(cmd), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=cwd) for cmd in commands]
    results: List[Optional[RankResult]] = [None] * len(procs)
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
            results[r] = RankResult(r, p.returncode, out, err)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        got = []
        for r, p in enumerate(procs):
            out, err = p.communicate()
            got.append(RankResult(r, p.returncode, out, err))
        raise FleetError(f"fleet timed out after {timeout:.0f} s and was killed\n"
                         + _tails(got)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if check and any(r.returncode != 0 for r in results):
        raise FleetError("fleet rank(s) failed\n" + _tails(results))
    return results


def mesh_worker_command(job: str, out: str, overrides: Sequence[str],
                        device: Optional[str] = None) -> List[str]:
    """argv of one rank running :func:`run_mesh_job` on ``job``, writing to
    the directory ``out``; ``overrides`` name the rank's backend
    (``backend_overrides``)."""
    cmd = [sys.executable, "-m", "repro_torch.backend", "--worker", f"--job={job}",
           f"--out={out}"]
    if device is not None:
        cmd.append(f"--device={device}")
    return cmd + [f"--{o}" for o in overrides]


def worker_command(overrides: Sequence[str], device: Optional[str] = None) -> List[str]:
    """argv of one rank running :func:`run_worker` (``python -m
    repro_torch.backend --worker``)."""
    cmd = [sys.executable, "-m", "repro_torch.backend", "--worker"]
    if device is not None:
        cmd.append(f"--device={device}")
    return cmd + [f"--{o}" for o in overrides]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

# the host-side all_reduce probe: rank r's leaves, a function of r alone
def all_reduce_probe_inputs(rank: int) -> Dict[str, Any]:
    x = np.linspace(-1.0, 1.0, 300, dtype=np.float32) * (rank + 1) + 0.01 * rank
    return {"vec": x, "scalar": np.float32(0.5 + rank)}


def params_digest(params) -> str:
    """sha256 of the parameters' bytes, in order: equal on every rank of a
    fleet whose replicated state stayed equal."""
    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def run_worker(overrides: Sequence[str], device=None) -> Dict[str, Any]:
    """Train the experiment of ``overrides`` under the launch audit; the
    result dict is JSON-ready."""
    from repro_torch.analysis import launch_audit
    from repro_torch.api import Callback, ExperimentConfig, Trainer
    from repro_torch.models.layers import resolve_attn_backend

    class PivotRecorder(Callback):
        priority = 94

        def __init__(self):
            self.pivots: Dict[int, List[int]] = {}
            self.all_reduce: List[Any] = []

        def on_step_end(self, trainer, step, metrics) -> None:
            gcfg = trainer.tcfg.graft
            if gcfg is not None and step % gcfg.refresh_every == 0:
                self.pivots[step] = trainer.state["graft"].pivots.tolist()

        def on_train_end(self, trainer, report) -> None:
            # two calls, so that the compressed reduce's error carry shows
            probe = all_reduce_probe_inputs(trainer.backend.process_index)
            self.all_reduce = [
                {k: np.asarray(v).tolist() for k, v in trainer.backend.all_reduce(probe).items()}
                for _ in range(2)]

    cfg = ExperimentConfig().apply_overrides(list(overrides))
    rec = PivotRecorder()
    trainer = Trainer(cfg, callbacks=[rec], device=device)
    with launch_audit.recording() as trace:
        report = trainer.fit()
    backend = trainer.backend          # torn down: its counts come from its config
    rows = report["history"]
    out: Dict[str, Any] = {
        "process_index": backend.process_index,
        "backend": backend.name,
        "collectives": getattr(backend, "collectives", None),
        "topology": backend.topology(),
        "losses": {str(i + trainer.start_step): r["loss"] for i, r in enumerate(rows)},
        "ranks": {str(i + trainer.start_step): r.get("rank") for i, r in enumerate(rows)},
        "grad_norms": {str(i + trainer.start_step): r["grad_norm"] for i, r in enumerate(rows)},
        "params_sha256": params_digest(trainer.state["params"]),
        "step_s": [r["step_time_s"] for r in rows],
        "pivots": {str(k): v for k, v in rec.pivots.items()},
        "launches": dict(trace.counts),
        "final_loss": report["final_loss"],
        "rollbacks": report.get("resilience", {}).get("rollbacks", []),
        "start_step": trainer.start_step,
        "reduce_s": list(getattr(backend, "reduce_seconds", [])),
        "all_reduce": rec.all_reduce,
        "device": str(trainer.device),
    }
    run_cfg = dataclasses.replace(trainer.config, train=dataclasses.replace(
        trainer.config.train, steps=len(rows)))
    flash = resolve_attn_backend(trainer.mcfg, cfg.train.seq, cfg.train.seq,
                                 trainer.device) == "flash"
    if trainer.tcfg.use_graft:
        out["launches_expected"] = launch_audit.expected_launches(
            trainer.mcfg, run_cfg, launch_audit.optim_groups(trainer.state["params"]),
            flash=flash, card=trainer.device.type == "cuda")
    return out


# ---------------------------------------------------------------------------
# mesh jobs: the sharded selection engine and the pipeline executor
# ---------------------------------------------------------------------------

def _host(tree):
    """A state or carry as plain containers of CPU tensors (NamedTuples as
    dicts), ready for ``torch.save``."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if hasattr(tree, "_asdict"):
        return {k: _host(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree


def _to_device(tree, like, device):
    """``tree`` (plain containers) in the structure of the carry ``like``,
    on ``device``."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(tree).to(device)
    if hasattr(like, "_asdict"):
        return type(like)(**{k: _to_device(tree[k], v, device)
                             for k, v in like._asdict().items()})
    if isinstance(like, dict):
        return {k: _to_device(tree[k], v, device) for k, v in like.items()}
    return like


def _counters() -> Dict[str, int]:
    """The kernel wrappers' launch counters that moved since the last
    ``zero_counts`` (kernel launches on the card; none on the CPU)."""
    from repro_torch.analysis import launch_audit
    return {k: v for k, v in launch_audit.read_counts().items() if v}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _sharded_task(task, backend, device) -> Dict[str, Any]:
    from repro_torch.analysis import launch_audit
    from repro_torch.backend.mesh import make_mesh
    from repro_torch.selection import CarrySpec, GraftConfig, engine, get_sampler

    mesh = make_mesh(*task["mesh"], backend)
    cfg = GraftConfig(**task["gcfg"])
    axes = engine._batch_axes(mesh, "act_batch", None)
    n, shard = mesh.size(axes), mesh.axis_index(axes)
    out: Dict[str, Any] = {"axes": list(axes), "shard": shard, "calls": {}}

    def rows(V, G, scores):
        k = V.shape[0] // n
        sl = slice(shard * k, (shard + 1) * k)
        return (V[sl].to(device), G[:, sl].to(device), scores[sl].to(device))

    def call(name, step, V, G, scores, carry):
        launch_audit.zero_counts()
        with launch_audit.recording() as trace:
            _sync(device)
            t0 = time.perf_counter()
            state, carry = engine.select_sharded(cfg, mesh, V, G, sampler=name,
                                                 scores=scores, carry=carry, step=step)
            _sync(device)
            seconds = time.perf_counter() - t0
        return state, carry, {"state": _host(state), "carry": _host(carry),
                              "launches": dict(trace.counts), "counters": _counters(),
                              "seconds": seconds}

    for name in task["samplers"]:
        carry = None
        for step, (V, G, scores) in enumerate(task["inputs"]):
            V_s, G_s, sc_s = rows(V, G, scores)
            _, carry, rec = call(name, step, V_s, G_s, sc_s, carry)
            out["calls"][f"{name}/{step}"] = rec
            given = task.get("carry_in", {}).get(name, {}).get(step)
            if given is not None:
                like = get_sampler(name).init_carry(cfg, CarrySpec(
                    V.shape[0], G.shape[0], device))
                _, _, rec = call(name, step, V_s, G_s, sc_s, _to_device(given, like, device))
                out["calls"][f"{name}@carry_in/{step}"] = rec
    return out


def _unequal_task(task, backend, device) -> Dict[str, Any]:
    from repro_torch.backend.mesh import make_mesh
    from repro_torch.selection import GraftConfig, engine

    mesh = make_mesh(*task["mesh"], backend)
    cfg = GraftConfig(**task["gcfg"])
    k = task["rows"] + mesh.rank            # a different count on every rank
    V = torch.ones(k, cfg.r_max, device=device)
    G = torch.ones(task["d"], k, device=device)
    try:
        engine.select_sharded(cfg, mesh, V, G)
    except ValueError as e:
        return {"refused": str(e)}
    return {"refused": None}


def block_stages(arch: str, layers: int, per_stage: int, seed: int, device, seq: int):
    """``(layer_fn, stage_params, blocks, mcfg)`` for a pipeline of
    ``arch``'s first ``layers`` residual blocks at full width,
    ``per_stage`` a stage, weights drawn from ``seed`` on ``device``:
    ``stage_params`` stacks stage s's blocks on a leading stage axis;
    ``blocks`` are the blocks in order (the one-process reference)."""
    from repro_torch import configs
    from repro_torch.backend.base import flatten_tree
    from repro_torch.models import model as model_lib

    mcfg = configs.get_config(arch, num_layers=layers, attn_backend="auto")
    gen = torch.Generator(device=device).manual_seed(seed)
    blocks = model_lib.init_params(mcfg, gen, device).tree()["blocks"]
    stages = layers // per_stage
    stage_params = {"blocks": []}
    for j in range(per_stage):
        leaves = [flatten_tree(blocks[s * per_stage + j]) for s in range(stages)]
        stage_params["blocks"].append(leaves[0][1](
            [torch.stack([lv[i] for lv, _ in leaves]) for i in range(len(leaves[0][0]))]))

    def layer_fn(p, x):
        positions = torch.arange(seq, dtype=torch.int32, device=x.device).expand(x.shape[0], seq)
        for blk in p["blocks"]:
            x, _ = model_lib._apply_block(mcfg, blk, x, positions, False)
        return x

    return layer_fn, stage_params, blocks, mcfg


def _pipeline_task(task, backend, device) -> Dict[str, Any]:
    from repro_torch.analysis import launch_audit
    from repro_torch.backend.mesh import make_mesh
    from repro_torch.distributed.pipeline import pipeline_forward

    mesh = make_mesh(*task["mesh"], backend)
    x = task["x"].to(device)
    if task["layer"] == "tanh":
        stage_params = task["W"].to(device)

        def layer_fn(W, h):
            return torch.tanh(h @ W)
    else:
        layer_fn, stage_params, _, _ = block_stages(
            task["arch"], task["layers"], task["per_stage"], task["seed"], device,
            x.shape[2])
    stamps: List[float] = []

    def timed(p, h):
        stamps.append(time.perf_counter())
        return layer_fn(p, h)

    launch_audit.zero_counts()
    with torch.no_grad(), launch_audit.recording() as trace:
        _sync(device)
        t0 = time.perf_counter()
        y = pipeline_forward(timed, stage_params, x, mesh, axis=task["axis"])
        _sync(device)
        end = time.perf_counter()
    return {"y": y.cpu(), "launches": dict(trace.counts), "counters": _counters(),
            "seconds": end - t0,
            "tick_s": [b - a for a, b in zip(stamps, stamps[1:] + [end])],
            "p2p_s": list(mesh.p2p_seconds), "stage": mesh.axis_index(task["axis"])}


def _collectives_task(task, backend, device) -> Dict[str, Any]:
    """Rank r's ``[r, r + 0.5]`` through each collective over each tuple of
    ``task["axes"]`` (in bfloat16 too, for the ones that only move data):
    the shift moves index i to i + 1, so index 0 receives nothing; rank
    r's ``arange(6).reshape(2, 3) + 10 r`` gathered along dim 1 (bf16) and
    ``arange(24).reshape(3, 8) · (r + 1)`` reduce-scattered along dim 1."""
    from repro_torch.backend.mesh import make_mesh

    mesh = make_mesh(*task["mesh"], backend)
    x = torch.tensor([mesh.rank, mesh.rank + 0.5], device=device)
    # (2, 3) and (3, 8) blocks that name the rank, for the dim-1 gather and
    # reduce-scatter
    grid = torch.arange(6, dtype=torch.float32, device=device).reshape(2, 3) + 10 * mesh.rank
    wide = torch.arange(24, dtype=torch.float32, device=device).reshape(3, 8) * (mesh.rank + 1)
    out: Dict[str, Any] = {"coords": dict(mesh.coords)}
    for axes in task["axes"]:
        n = mesh.size(axes)
        out[",".join(axes)] = {
            "index": mesh.axis_index(axes), "size": n,
            "psum": mesh.psum(x, axes).cpu(), "pmean": mesh.pmean(x, axes).cpu(),
            "pmax": mesh.pmax(x, axes).cpu(), "gather": mesh.all_gather(x, axes).cpu(),
            "gather_bf16": mesh.all_gather(x.to(torch.bfloat16), axes).cpu(),
            "broadcast": mesh.broadcast(x.to(torch.bfloat16), axes, n - 1).cpu(),
            "shift": mesh.ppermute(x, axes, [(i, i + 1) for i in range(n - 1)]).cpu(),
            "ints": mesh.gather_ints(mesh.rank, axes),
            "gather_dim1": mesh.all_gather(grid.to(torch.bfloat16), axes, dim=1).cpu(),
            "scatter_dim1": mesh.psum_scatter(wide, axes, dim=1).cpu()}
    return out


def _fsdp_task(task, backend, device, preset: str = "fsdp") -> Dict[str, Any]:
    import types
    from repro_torch import configs
    from repro_torch.analysis import launch_audit
    from repro_torch.backend.mesh import make_mesh
    from repro_torch.checkpoint import jax_bridge
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs, steps
    from repro_torch.models import model as model_lib
    from repro_torch.models.layers import EXPERT_RUNS, resolve_attn_backend
    from repro_torch.models.ssm import HEAD_RUNS
    from repro_torch.optim import OptimizerConfig
    from repro_torch.selection.base import GraftConfig

    mesh = make_mesh(*task["mesh"], backend)
    get = configs.get_smoke_config if task.get("smoke") else configs.get_config
    mcfg = get(task["arch"], **task.get("model", {}))
    t = dict(task["tcfg"])
    graft = t.pop("graft")
    tcfg = steps.TrainConfig(optimizer=OptimizerConfig(**t.pop("optimizer")),
                             graft=GraftConfig(**graft) if graft else None, **t)
    rules = specs.RULE_PRESETS[preset]
    batches = task["batches"]
    K = next(iter(batches[0].values())).shape[0]
    out: Dict[str, Any] = {"losses": [], "grad_norms": [], "ranks": [], "pivots": {},
                           "step_s": []}
    with sh.sharding_rules(mesh, rules):
        if task.get("params") is not None:
            model = jax_bridge.sharded_params_from_numpy(task["params"],
                                                         model_lib.Model(mcfg, device), mesh)
            # every leaf gathered back, in JAX's layout, against the weights given
            back, given = dict(_paths(jax_bridge.params_to_numpy(model))), _paths(task["params"])
            out["gather_exact"] = len(back) == len(given) and all(
                np.array_equal(back[path], t.float().numpy()) for path, t in given)
        else:
            gen = torch.Generator(device=device).manual_seed(task["seed"])
            model = model_lib.init_params(mcfg, gen, device)
        state = steps.state_for_model(mcfg, tcfg, model, K)
        fn = steps.make_train_step(mcfg, tcfg, backend=backend)
    layout = state["layout"]
    sharded = state["model"]
    out["specs"] = [(".".join(map(str, path)), list(s.spec), list(s.shape), list(s.local_shape))
                    for path, s in _paths(sharded.shardings)]
    out["batch_axes"], out["subset_axes"] = list(layout.batch_axes), list(layout.subset_axes)
    # the resident params and moments: their storages, against the shards'
    # sizes (a shard that kept its full tensor's storage would show)
    out["resident_bytes"] = sum(x.untyped_storage().nbytes()
                                for x in state["params"] + _moments(state["opt"]))
    out["shard_bytes"] = sum(int(np.prod(s.local_shape)) * p.element_size()
                             for p, s in zip(state["params"], layout.shardings))
    out["shard_bytes"] += _moment_shard_bytes(state["opt"], layout.shardings)
    n, r = mesh.size(layout.batch_axes), mesh.axis_index(layout.batch_axes)
    k = K // n
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    launch_audit.zero_counts()
    EXPERT_RUNS.clear()
    HEAD_RUNS.clear()
    with launch_audit.recording() as trace:
        for i in range(task["steps"]):
            batch = {name: x[r * k:(r + 1) * k].to(device)
                     for name, x in batches[i % len(batches)].items()}
            _sync(device)
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            out["losses"].append(float(metrics["loss"]))
            _sync(device)
            out["step_s"].append(time.perf_counter() - t0)
            out["grad_norms"].append(float(metrics["grad_norm"]))
            if i == 0 and "m" in state["opt"]:          # kept on the host, off the peak
                m0 = [m.detach().to("cpu", copy=True) for m in state["opt"]["m"]]
            if tcfg.use_graft:
                out["ranks"].append(int(metrics["rank"]))
                if i % tcfg.graft.refresh_every == 0:
                    out["pivots"][i] = state["graft"].pivots.tolist()
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["launches"] = dict(trace.counts)
    with sh.sharding_rules(mesh, rules):             # the default preset's activation layout
        sp = model_lib.sequence_layout(mcfg, batch)
    out["layout"] = {name: list(sp.split(logical, n)) if sp is not None else []
                     for name, logical, n in (("seq", "act_res_seq", sp and sp.length),
                                              ("mlp", "act_mlp", mcfg.d_ff),
                                              ("vocab", "act_vocab", mcfg.vocab_size))}
    # the MoE regimes its forwards ran: (tokens, the groups' axes, the
    # experts' axes), the experts whole where they split over none
    out["moe"] = sorted([tokens, list(g), list(e)] for tokens, g, e in EXPERT_RUNS)
    # the heads [start, stop) of its head-parallel RWKV time mixes and SSM heads
    out["heads"] = sorted(list(k) for k in HEAD_RUNS)
    run = types.SimpleNamespace(train=types.SimpleNamespace(steps=task["steps"], eval_every=0),
                                graft=tcfg.graft)
    S = model_lib.input_length(mcfg, batch)
    flash = resolve_attn_backend(mcfg, S, S, device) == "flash"
    out["launches_expected"] = launch_audit.expected_launches(
        mcfg, run, launch_audit.optim_groups(state["params"]), flash=flash, card=cuda,
        sharded=True, optimizer=tcfg.optimizer.name)
    limit = task.get("max_leaf_bytes")
    final = sharded.gathered(limit)
    first_moment = model_lib.values_tree(sharded, m0, limit) if "m" in state["opt"] else None
    if backend.process_index == 0:
        out["params"], out["m0"] = _host(final), first_moment
    return out


def _moments(opt) -> List[torch.Tensor]:
    """The optimizer state's tensors: the moments ``m``/``v`` of the
    elementwise rules, Adafactor's factored ``vr``/``vc``/``v`` a leaf."""
    out: List[torch.Tensor] = []
    for key in ("m", "v"):
        for x in opt.get(key, []):
            out += list(x.values()) if isinstance(x, dict) else [x]
    return out


def _moment_shard_bytes(opt, shardings) -> int:
    """The bytes the optimizer state's shards take: a moment each param's
    shard's size; Adafactor's factors of each JAX leaf (the blocks of a
    ``groups`` list stacked) the rank's shard of it less a reduced dim."""
    total = 0
    for key in ("m", "v"):
        for i, x in enumerate(opt.get(key, [])):
            if not isinstance(x, dict):
                total += int(np.prod(shardings[i].local_shape)) * x.element_size()
    if "groups" in opt:
        for grp, factors in zip(opt["groups"], opt["v"]):
            local = tuple(shardings[grp[0] if isinstance(grp, list) else grp].local_shape)
            if isinstance(grp, list):
                local = (len(grp),) + local
            shapes = ({"vr": local[:-1], "vc": local[:-2] + local[-1:]} if len(local) >= 2
                      else {"v": local})
            total += sum(int(np.prod(shapes[k])) * t.element_size() for k, t in factors.items())
    return total


def _serve_task(task, backend, device) -> Dict[str, Any]:
    from repro_torch import configs
    from repro_torch.backend.mesh import make_mesh
    from repro_torch.checkpoint import jax_bridge
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import specs, steps
    from repro_torch.models import model as model_lib

    mesh = make_mesh(*task["mesh"], backend)
    get = configs.get_smoke_config if task.get("smoke") else configs.get_config
    mcfg = get(task["arch"], **task.get("model", {}))
    rules = dict(specs.SHAPE_RULES[task["shape"]], **specs.RULE_PRESETS[task["preset"]])
    with sh.sharding_rules(mesh, rules):
        if task.get("params") is not None:
            model = jax_bridge.sharded_params_from_numpy(task["params"],
                                                         model_lib.Model(mcfg, device), mesh)
        else:
            gen = torch.Generator(device=device).manual_seed(task["seed"])
            model = model_lib.shard_model(model_lib.init_params(mcfg, gen, device), mesh)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    out: Dict[str, Any] = {}
    if task.get("wave") is not None:
        out["wave"] = serve_lib.serve_model(mcfg, model, mesh=mesh, rules=rules, **task["wave"])
        return out

    def leaves(cache):
        return [t for layer in cache["layers"] for sub in layer.values()
                for t in (sub.values() if isinstance(sub, dict) else [sub])]

    def copy(cache):            # the K/V tensors are written in place by later ticks
        return model_lib._map_tree(lambda t: t.detach().to("cpu", copy=True), cache["layers"])

    def greedy(logits, kv):
        return kv.gather_rows(logits[:, 0].argmax(-1).to(torch.int32)).cpu()[:, None]

    with sh.sharding_rules(mesh, rules):
        kv = sh.cache_layout(next(iter(task["batch"].values())).shape[0], task["max_seq"])
        batch = {k: kv.take_rows(v).to(device) for k, v in task["batch"].items()}
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = steps.prefill_step(mcfg, model, batch, task["max_seq"], kv)
        _sync(device)
        out["prefill_s"] = time.perf_counter() - t0
        out["layout"] = {"rows": [kv.row_start, kv.row_stop], "seq": [kv.start, kv.stop],
                         "batch_axes": list(kv.batch_axes), "seq_axes": list(kv.seq_axes)}
        if task.get("return_cache"):
            out["prefill_cache"] = copy(cache)
        out["logits"], out["tokens"], out["tick_s"] = [logits.float().cpu()], [], []
        cur = greedy(logits, kv)
        for i in range(task["ticks"]):
            out["tokens"].append(cur)
            fed = cur if task.get("feed") is None else task["feed"][i]
            _sync(device)
            t0 = time.perf_counter()
            logits, cache = steps.decode_step(mcfg, model, cache, kv.take_rows(fed.to(device)))
            _sync(device)
            out["tick_s"].append(time.perf_counter() - t0)
            out["logits"].append(logits.float().cpu())
            cur = greedy(logits, kv)
        out["tokens"].append(cur)
    if task.get("return_cache"):
        out["cache"] = copy(cache)
    out["resident_bytes"] = sum(t.untyped_storage().nbytes() for t in leaves(cache))
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


_TASKS = {"sharded": _sharded_task, "unequal": _unequal_task, "pipeline": _pipeline_task,
          "collectives": _collectives_task, "fsdp": _fsdp_task,
          "tp": lambda task, backend, device: _fsdp_task(task, backend, device,
                                                         task.get("preset", "default")),
          "serve": _serve_task}


def run_mesh_job(job: str, out_dir: str, overrides: Sequence[str],
                 device=None) -> Dict[str, Any]:
    """Run the tasks of the job file ``job`` on this rank (its backend from
    ``overrides``), save what they produced to ``out_dir/rank<r>.pt`` and
    return a JSON-ready summary."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.backend import resolve

    tasks = torch.load(job, weights_only=True)
    backend = resolve(ExperimentConfig().apply_overrides(list(overrides)).backend)
    dev = backend.device(device)
    backend.setup()
    try:
        results = [_TASKS[t["kind"]](t, backend, dev) for t in tasks]
        rank = backend.process_index
    finally:
        backend.teardown()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    torch.save({"rank": rank, "device": str(dev),
                "collectives": getattr(backend, "collectives", None), "tasks": results}, path)
    return {"rank": rank, "device": str(dev), "collectives": getattr(backend, "collectives", None),
            "path": path, "tasks": [t["kind"] for t in tasks]}
