"""The decoder model of every family of the JAX package: dense, moe, ssm
(RWKV6), hybrid (Hymba), audio (dense blocks over frame embeddings, the
``audio_frames`` frontend) and vlm (dense blocks over patch embeddings and
text tokens, the ``vision_patches`` frontend): ``ModelConfig``, the
parameter module, init, forward, logits and losses.

``Model`` is an ``nn.Module`` that holds the parameters; the forward
functions are plain functions of ``(cfg, params, batch)`` like the JAX
package's, where ``params`` is the module's :meth:`Model.tree` — a nested
dict of tensors in the JAX layouts, with ``blocks`` a list of per-layer
dicts (the JAX package stacks them on a leading L axis;
``checkpoint/jax_bridge.py`` converts) and, for a config with
``first_k_dense``, ``first_blocks`` a list of dense per-layer dicts (a list
in the JAX tree too).

``_apply_block`` also runs one block against a decode cache
(``models/decode.py``), as the JAX block does.

``params_logical`` gives each leaf its logical axes, the twin of the JAX
package's (its ``layers`` axis aside: each block of the port's list takes
the JAX tuple without it). ``shard_model`` cuts a model's parameters to
this rank's shards on a mesh under those axes and the active rules
(``distributed/sharding.py``): the ``ShardedModel`` it returns gives a
tree whose sharded leaves are ``ShardedParam``s, and every forward
function gathers a leaf where it reads it (``sharding.materialize``): a
block's leaves inside the block, so that under ``remat`` only the shards
are saved and the recompute gathers again; the (tied) unembedding once
for all of a loss's chunks.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.numerics import take_last, take_rows, wrapped_index
from repro_torch.distributed import sharding as sh
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 512
    vocab_size: int = 1024
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    layer_pattern: Tuple[str, ...] = ("global",)   # cycled; "local"|"global"
    global_layer_indices: Tuple[int, ...] = ()     # explicit global islands (hymba)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    post_block_norm: bool = False                  # gemma2 post-norms
    mlp_activation: str = "silu"
    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 512
    moe_local_groups: bool = False
    first_k_dense: int = 0
    d_ff_dense: int = 0
    # ssm / hybrid
    ssm_state: int = 0
    # frontend stubs
    frontend: Optional[str] = None                 # audio_frames | vision_patches
    num_patches: int = 0
    # misc
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    # perf knobs
    remat: str = "full"                            # none | full | dots
    scan_layers: bool = True                       # JAX-only (layers always loop)
    attn_backend: str = "auto"                     # auto | dense | chunked | flash
    attn_chunk: int = 0
    loss_chunk: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def is_local_pattern(self) -> np.ndarray:
        """(L,) bool: which layers use the sliding window."""
        idx = np.arange(self.num_layers)
        if self.global_layer_indices:
            return ~np.isin(idx, np.asarray(self.global_layer_indices))
        pat = np.array([p == "local" for p in self.layer_pattern])
        return pat[idx % len(pat)]


_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
_FRONTENDS = (None, "audio_frames", "vision_patches")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown model family '{cfg.family}' ({' | '.join(_FAMILIES)})")
    if cfg.frontend not in _FRONTENDS:
        raise ValueError(f"unknown frontend '{cfg.frontend}' (audio_frames | vision_patches)")
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat '{cfg.remat}' (none | full | dots)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One residual block's parameters (JAX layouts): attention + MLP
    (dense, audio and vlm, or ``dense=True`` for a ``first_blocks`` layer of
    width ``d_ff_dense``), attention + MoE (moe), RWKV time mix + channel mix
    (ssm), or attention ∥ SSM heads + MLP (hybrid)."""

    def __init__(self, cfg: ModelConfig, device=None, dense: bool = False):
        super().__init__()
        D, H, Hkv, Dh, Fd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.d_ff)
        dt = cfg.dtype
        fam = "dense" if dense else cfg.family

        def w(*shape, dtype=dt):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))

        def pdict(shapes):
            return nn.ParameterDict({n: w(*shape, dtype=t) for n, (shape, t) in shapes.items()})

        self.ln1 = w(D, dtype=torch.float32)
        self.ln2 = w(D, dtype=torch.float32)
        if fam == "ssm":
            self.time = pdict(S.rwkv_time_shapes(cfg, dt))
            self.channel = pdict(S.rwkv_channel_shapes(cfg, dt))
            return
        self.attn = nn.ParameterDict({"wq": w(D, H, Dh), "wk": w(D, Hkv, Dh),
                                      "wv": w(D, Hkv, Dh), "wo": w(H, Dh, D)})
        if cfg.qkv_bias:
            self.attn.update({"bq": w(H, Dh), "bk": w(Hkv, Dh), "bv": w(Hkv, Dh)})
        if fam == "moe":
            self.moe = pdict(L.moe_shapes(cfg, dt))
            return
        if fam == "hybrid":
            self.ssm = pdict(S.ssm_shapes(cfg, dt))
        if dense and cfg.d_ff_dense:
            Fd = cfg.d_ff_dense
        self.mlp = nn.ParameterDict({"w_gate": w(D, Fd), "w_up": w(D, Fd),
                                     "w_down": w(Fd, D)})
        if cfg.post_block_norm and fam in ("dense", "audio", "vlm"):
            self.ln1_post = w(D, dtype=torch.float32)
            self.ln2_post = w(D, dtype=torch.float32)

    def tree(self) -> Dict[str, Any]:
        if hasattr(self, "time"):
            return {"ln1": self.ln1, "time": dict(self.time),
                    "ln2": self.ln2, "channel": dict(self.channel)}
        out: Dict[str, Any] = {"ln1": self.ln1, "attn": dict(self.attn), "ln2": self.ln2}
        for name in ("moe", "ssm", "mlp"):
            if hasattr(self, name):
                out[name] = dict(getattr(self, name))
        if hasattr(self, "ln1_post"):
            out["ln1_post"], out["ln2_post"] = self.ln1_post, self.ln2_post
        return out


class Model(nn.Module):
    """All parameters of one decoder. Values are uninitialized until
    :func:`init_params` draws them or the JAX bridge loads them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = nn.Parameter(torch.empty((V, D), dtype=cfg.dtype, device=device))
        self.final_norm = nn.Parameter(torch.empty(D, dtype=torch.float32, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((D, V), dtype=cfg.dtype, device=device))
        if cfg.first_k_dense:
            self.first_blocks = nn.ModuleList(Block(cfg, device, dense=True)
                                              for _ in range(cfg.first_k_dense))
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers - cfg.first_k_dense))

    def tree(self) -> Dict[str, Any]:
        """The parameter pytree the forward functions take."""
        out: Dict[str, Any] = {"embed": self.embed, "final_norm": self.final_norm,
                               "blocks": [b.tree() for b in self.blocks]}
        if not self.cfg.tie_embeddings:
            out["lm_head"] = self.lm_head
        if self.cfg.first_k_dense:
            out["first_blocks"] = [b.tree() for b in self.first_blocks]
        return out


def _leaf_paths(prefix: str, block: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """``(prefix/<name>[/<leaf>], value)`` for each leaf of one block dict."""
    out = []
    for name, sub in block.items():
        if isinstance(sub, dict):
            out += [(f"{prefix}/{name}/{leaf}", t) for leaf, t in sub.items()]
        else:
            out.append((f"{prefix}/{name}", sub))
    return out


def stacked_leaves(model: Model) -> List[Tuple[str, List[torch.Tensor]]]:
    """The JAX param tree's leaves as ``(path, tensors)``, paths as the JAX
    checkpointer flattens them: a ``blocks/<name>[/<leaf>]`` path holds one
    tensor per block (the JAX tree stacks them on a leading L axis), every
    other path one tensor — ``first_blocks/<i>/<name>[/<leaf>]`` among them
    (a list of unstacked blocks in the JAX tree)."""
    tree = model.tree()
    out = [(k, [v]) for k, v in tree.items() if k not in ("blocks", "first_blocks")]
    for i, blk in enumerate(tree.get("first_blocks", [])):
        out += [(path, [t]) for path, t in _leaf_paths(f"first_blocks/{i}", blk)]
    per_block = [_leaf_paths("blocks", b) for b in tree["blocks"]]
    out += [(path, [leaves[j][1] for leaves in per_block])
            for j, (path, _) in enumerate(per_block[0])]
    return out


# ---------------------------------------------------------------------------
# logical axes and sharded parameters
# ---------------------------------------------------------------------------

_LOGICAL = {
    # attention
    "wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed"),
    "bq": ("heads", None), "bk": ("kv_heads", None), "bv": ("kv_heads", None),
    # mlp
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed"),
    # moe (leaf names inside "moe" subtree get experts-first shapes)
    "router": ("embed", None),
    # rwkv
    "wr": ("embed", "ssm_inner"), "wg": ("embed", "ssm_inner"),
    "lora_A": ("embed", None), "decay_A": ("embed", None),
    "lora_B_r": (None, "embed"), "lora_B_k": (None, "embed"),
    "lora_B_v": (None, "embed"), "lora_B_w": (None, "embed"),
    "lora_B_g": (None, "embed"), "decay_B": (None, "embed"),
    # ssm heads
    "w_in": ("embed", "ssm_inner"), "w_out": ("ssm_inner", "embed"),
    "w_B": ("embed", "heads", None), "w_C": ("embed", "heads", None),
    "w_delta": ("embed", "heads"),
    # rwkv channel
    "w_key": ("embed", "mlp"), "w_value": ("mlp", "embed"),
    "w_recept": ("embed", "ssm_inner"),
}

_MOE_LOGICAL = {
    "w_gate": ("experts", "embed", "mlp"), "w_up": ("experts", "embed", "mlp"),
    "w_down": ("experts", "mlp", "embed"), "router": ("embed", None),
}


def _leaf_logical(path: Tuple[str, ...], leaf) -> Tuple[Optional[str], ...]:
    name = path[-1]
    # the RWKV time mix reuses attention's names for D×D projections: its
    # subtree is dispatched on BEFORE the generic table
    if "time" in path:
        if name in ("wk", "wv"):
            return ("embed", "ssm_inner")
        if name == "wo":
            return ("ssm_inner", "embed")
    table = _MOE_LOGICAL if "moe" in path else _LOGICAL
    if name in table:
        return table[name]
    return tuple(None for _ in leaf.shape)


def _tree_logical(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _tree_logical(v, prefix + (k,)) for k, v in tree.items()}
    return _leaf_logical(prefix, tree)


def params_logical(cfg: ModelConfig, params) -> Dict[str, Any]:
    """Logical-axis tree matching ``params`` (a ``Model``, a ``ShardedModel``
    or their tree): JAX's ``params_logical``, each block of ``blocks`` with
    the tuple of the JAX leaf stacked on ``layers`` without that axis
    (``layers`` maps to no mesh axis)."""
    params = _tree(params)
    out: Dict[str, Any] = {
        # vocab dim replicated: d_model shards over the fsdp axis instead
        "embed": (None, "embed"),
        "final_norm": (None,),
    }
    if "lm_head" in params:
        out["lm_head"] = ("embed", "vocab")
    if "first_blocks" in params:
        out["first_blocks"] = [_tree_logical(b) for b in params["first_blocks"]]
    out["blocks"] = [_tree_logical(b) for b in params["blocks"]]
    return out


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _zip_tree(fn, tree, other):
    """``fn(leaf, its match in other)`` over ``tree``'s leaves."""
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_tree(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def _wrap(tree, shardings):
    return _zip_tree(lambda t, s: sh.ShardedParam(t, s) if s.is_sharded else t, tree, shardings)


class ShardedModel:
    """A ``Model`` whose parameters hold this rank's shards, with each
    leaf's ``LeafSharding`` (``shardings``, a tree like ``Model.tree()``).
    ``tree()`` gives the forward functions the sharded leaves as
    ``ShardedParam``s and the replicated ones as they are;
    ``parameters()`` are the shards, in the ``Model``'s order."""

    def __init__(self, model: Model, shardings):
        self.model, self.shardings = model, shardings
        self.cfg = model.cfg

    @property
    def embed(self) -> torch.Tensor:
        return self.model.embed

    def parameters(self):
        return self.model.parameters()

    def tree(self) -> Dict[str, Any]:
        return _wrap(self.model.tree(), self.shardings)

    def gathered(self, max_leaf_bytes: Optional[int] = None) -> Dict[str, Any]:
        """The full parameter tree, every sharded leaf gathered (a
        collective on every rank of the mesh; see ``values_tree`` for
        ``max_leaf_bytes``)."""
        return values_tree(self, list(self.parameters()), max_leaf_bytes)

    def param_shardings(self) -> List[sh.LeafSharding]:
        """Each parameter's sharding, in ``parameters()``' order."""
        by_id = {id(p): s for p, s in zip(_leaves(self.model.tree()), _leaves(self.shardings))}
        return [by_id[id(p)] for p in self.model.parameters()]


@torch.no_grad()
def values_tree(model, values: List[torch.Tensor],
                max_leaf_bytes: Optional[int] = None) -> Dict[str, Any]:
    """``values``, one a parameter in ``model.parameters()``' order (the
    parameters themselves, or an optimizer's moments), placed as
    ``model.tree()`` places the parameters. Of a ``ShardedModel`` each
    value is this rank's shard and is gathered to the full tensor (a
    collective on every rank of the mesh). A leaf whose full tensor takes
    more than ``max_leaf_bytes`` is not gathered: it gives its value's
    leading rows along dim 0, as many as fit that size at the full leaf's
    row (the same count on every rank and in an unsharded model: rank 0's
    are the leaf's own, cut to its shard's other dims)."""
    plain = model.model if isinstance(model, ShardedModel) else model
    index = {id(p): i for i, p in enumerate(plain.parameters())}
    tree = plain.tree()
    shardings = (model.shardings if isinstance(model, ShardedModel)
                 else _map_tree(lambda p: None, tree))

    def place(p, s):
        v = values[index[id(p)]]
        shape = s.shape if s is not None else tuple(v.shape)
        row = int(np.prod(shape[1:], dtype=np.int64)) * v.element_size()
        if max_leaf_bytes is not None and row * shape[0] > max_leaf_bytes:
            return v[:max(1, max_leaf_bytes // row)]
        return sh.gather_tensor(v, s) if s is not None and s.is_sharded else v
    return _zip_tree(place, tree, shardings)


@torch.no_grad()
def shard_model(model: Model, mesh, rules=None) -> ShardedModel:
    """``model``'s parameters cut IN PLACE to this rank's shards on
    ``mesh`` under ``rules`` (default: the active ``sharding_rules``'),
    each leaf placed by ``params_logical``, ``logical_to_spec`` and
    ``drop_indivisible`` (a MoE layer's experts over ``"model"``, their
    ``embed`` over ``"data"``). The full tensors go with the last reference
    to them."""
    tree = model.tree()
    shardings = sh.param_shardings(tree, params_logical(model.cfg, tree), mesh, rules)
    for p, s in zip(_leaves(tree), _leaves(shardings)):
        if s.is_sharded:
            p.data = sh.shard_tensor(p.data, s)
    return ShardedModel(model, shardings)


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Model:
    """A ``Model`` with values drawn from ``generator`` (on ``device``) with
    the JAX package's distributions: normal weights scaled by fan-in
    (embed × 0.02; the MoE router, float32, × D^-0.5), zero norm scales and
    biases; the RWKV and SSM head params as ``models/ssm.py`` draws them. The draws differ from
    ``jax.random``'s; load JAX weights through ``checkpoint/jax_bridge.py``
    where bit-equal weights matter."""
    model = Model(cfg, device)
    D, H, Dh, Fd = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff

    def normal_(p: torch.Tensor, scale: float) -> None:
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=p.device)
        p.copy_((x * scale).to(p.dtype))

    normal_(model.embed, 0.02)
    model.final_norm.zero_()
    if not cfg.tie_embeddings:
        normal_(model.lm_head, D ** -0.5)
    for b in list(getattr(model, "first_blocks", [])) + list(model.blocks):
        b.ln1.zero_()
        b.ln2.zero_()
        if hasattr(b, "time"):
            S.init_rwkv_time_params(b.time, cfg, generator)
            S.init_rwkv_channel_params(b.channel, cfg, generator)
            continue
        for name in ("wq", "wk", "wv"):
            normal_(b.attn[name], D ** -0.5)
        normal_(b.attn["wo"], (H * Dh) ** -0.5)
        for name in ("bq", "bk", "bv"):
            if name in b.attn:
                b.attn[name].zero_()
        if hasattr(b, "moe"):
            normal_(b.moe["router"], D ** -0.5)
            normal_(b.moe["w_gate"], D ** -0.5)
            normal_(b.moe["w_up"], D ** -0.5)
            normal_(b.moe["w_down"], Fd ** -0.5)
            continue
        if hasattr(b, "ssm"):
            S.init_ssm_params(b.ssm, cfg, generator)
        normal_(b.mlp["w_gate"], D ** -0.5)
        normal_(b.mlp["w_up"], D ** -0.5)
        normal_(b.mlp["w_down"], b.mlp["w_down"].shape[0] ** -0.5)
        if hasattr(b, "ln1_post"):
            b.ln1_post.zero_()
            b.ln2_post.zero_()
    return model


def _tree(params) -> Dict[str, Any]:
    return params.tree() if isinstance(params, (Model, ShardedModel)) else params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _apply_block(cfg: ModelConfig, p, x, positions, is_local: bool,
                 dense_override: bool = False, cache=None, cache_index: int = 0, sp=None,
                 kv=None, ep=None):
    """One residual block of the config's family (dense for a
    ``first_blocks`` layer) → ``(x, new layer cache)``. With ``cache`` (the
    layer's dict of ``models/decode.py``) the block runs S new positions
    against it from ``cache_index`` and returns the updated cache, else
    ``None``; ``kv`` (a ``sharding.CacheLayout``) says where this rank's
    part of the cache lies. A one-token step through a MoE block is
    dropless, as in JAX. ``sp`` (a ``sharding.SeqParallel``): x holds this
    rank's positions of the sequence, and the attention and MLP, the RWKV
    time and channel mixes, or the SSM heads, lay out their work as the
    ``default`` preset declares it (``layers.attention``, ``layers.mlp``,
    ``ssm.rwkv_time_mix``, ``ssm.rwkv_channel_mix``, ``ssm.ssm_heads``). ``ep`` (a
    ``sharding.ExpertLayout``, a MoE block under ``sharding_rules``): the
    MoE takes its leaves as stored and runs this rank's experts on its
    groups (``layers.moe``)."""
    fam = "dense" if dense_override else cfg.family
    new_cache = None if cache is None else {}
    # a sharded block's weights, gathered here; under ``sp`` the MLP, the
    # RWKV mixes and the SSM heads, and under ``ep`` the MoE, take their
    # leaves as stored and gather their own slices
    own = {"mlp", "time", "channel", "ssm"} if sp is not None else set()
    if ep is not None and fam == "moe":
        own.add("moe")
    stored = {k: p[k] for k in own if k in p}
    p = sh.materialize_tree({k: v for k, v in p.items() if k not in own})
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    if fam == "ssm":
        t_out, t_state = S.rwkv_time_mix(cfg, stored.get("time", p.get("time")), h,
                                         state=None if cache is None else cache["time"], sp=sp)
        x = x + t_out
        c_out, c_state = S.rwkv_channel_mix(
            cfg, stored.get("channel", p.get("channel")), L.rms_norm(x, p["ln2"], cfg.rms_eps),
            state=None if cache is None else cache["channel"], sp=sp)
        if cache is not None:
            new_cache["time"], new_cache["channel"] = t_state, c_state
        return x + c_out, new_cache
    attn_out, attn_cache = L.attention(
        cfg, p["attn"], h, positions, is_local=is_local,
        cache=None if cache is None else cache["attn"], cache_index=cache_index, sp=sp, kv=kv)
    if fam == "hybrid":                 # attention and SSM heads in parallel
        ssm_out, ssm_state = S.ssm_heads(cfg, stored.get("ssm", p.get("ssm")), h,
                                         state=None if cache is None else cache["ssm"], sp=sp)
        attn_out = attn_out + ssm_out
        if cache is not None:
            new_cache["ssm"] = ssm_state
    if cfg.post_block_norm:
        attn_out = L.rms_norm(attn_out, p["ln1_post"], cfg.rms_eps)
    x = x + attn_out
    h2 = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    if fam == "moe":
        ff = L.moe(cfg, stored.get("moe", p.get("moe")), h2,
                   dropless=cache is not None and x.shape[1] == 1, ep=ep)
    else:
        ff = L.mlp(cfg, stored.get("mlp", p.get("mlp")), h2, sp)
    if cfg.post_block_norm:
        ff = L.rms_norm(ff, p["ln2_post"], cfg.rms_eps)
    if cache is not None:
        new_cache["attn"] = attn_cache
    return x + ff, new_cache


# the ops whose outputs ``remat="dots"`` keeps: PyTorch's matrix products,
# the twin of jax.checkpoint_policies.checkpoint_dots (dot_general)
_DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


# ---------------------------------------------------------------------------
# forward / loss / features
# ---------------------------------------------------------------------------

def input_kind(cfg: ModelConfig) -> str:
    """What a batch of ``cfg``'s input holds: ``"frames"`` (audio, or the
    ``audio_frames`` frontend), ``"patches"`` (patches then tokens: vlm, or
    ``vision_patches``) or ``"tokens"``."""
    if cfg.family == "audio" or cfg.frontend == "audio_frames":
        return "frames"
    if cfg.family == "vlm" or cfg.frontend == "vision_patches":
        return "patches"
    return "tokens"


def input_length(cfg: ModelConfig, batch) -> int:
    """The positions of the sequence ``embed_inputs`` builds from ``batch``:
    the frames' (audio), the patches' and the tokens' (vlm: the patches
    first), else the tokens' (a decode tick's, whatever the frontend)."""
    kind = input_kind(cfg)
    if kind == "frames" and "frame_embeds" in batch:
        return batch["frame_embeds"].shape[1]
    if kind == "patches" and "patch_embeds" in batch:
        return batch["patch_embeds"].shape[1] + batch["tokens"].shape[1]
    return batch["tokens"].shape[1]


def sequence_layout(cfg: ModelConfig, batch) -> Optional[sh.SeqParallel]:
    """The ``default`` preset's layout of ``batch``'s forward under the
    active ``sharding_rules`` (``sharding.sequence_parallel``) over the
    sequence the model embeds (``input_length``; JAX constrains the whole of
    it to ``act_res_seq``); else None."""
    return sh.sequence_parallel(input_length(cfg, batch))


def expert_layout(cfg: ModelConfig, x: torch.Tensor, sp: Optional[sh.SeqParallel] = None
                  ) -> Optional[sh.ExpertLayout]:
    """Where a MoE model's forward of this rank's embedded input ``x``
    (its rows, split over the enclosing ``sharding.batch_rows``' axes, and
    under ``sp`` its positions) runs its experts under the active
    ``sharding_rules``: the group size and capacity from the global
    batch's token count, the groups' and experts' axes by
    ``sharding.moe_axes``; None for another family or under no rules.
    Raises ``ValueError`` under rules without ``batch_rows``: the groups
    span the global batch, so the layer must know which rows it holds."""
    act = sh.active()
    if cfg.family != "moe" or act is None:
        return None
    mesh, rules = act
    rows_axes = sh.row_axes()
    if rows_axes is None:
        raise ValueError("a MoE forward under sharding_rules needs its rows' axes "
                         "(sharding.batch_rows): the groups span the global batch")
    tokens = x.shape[0] * (mesh.size(rows_axes) if rows_axes else 1) * (
        sp.length if sp is not None else x.shape[1])
    gs, cap = L.moe_capacity(cfg, tokens)
    g, e = sh.moe_axes(tokens // gs, cfg.num_experts, mesh, rules)
    if g[:len(rows_axes)] != rows_axes[:len(g)]:
        raise ValueError(f"the MoE groups over {g} and the rows over {rows_axes}: neither is "
                         "a prefix of the other")
    return sh.ExpertLayout(mesh, tokens, gs, cap, cfg.num_experts, rows_axes, g, e, sp)


def embed_inputs(cfg: ModelConfig, params, batch, sp: Optional[sh.SeqParallel] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (x (B,S,D), positions (B,S) int32, loss_mask (B,S) f32).

    The frontend decides the input: ``frame_embeds`` (audio: every position
    labeled), ``patch_embeds`` followed by the embedded ``tokens`` (vlm: the
    mask is 0 on the patches and 1 on the text), or the embedded ``tokens``.
    ``sp``: this rank's positions ``[sp.start, sp.stop)`` of that sequence
    (JAX's ``act_res_seq``), at their global positions: its frames, or its
    part of ``patches ‖ tokens`` (patches and tokens both where the slice
    straddles them), embedding only the tokens that fall in it."""
    _check_supported(cfg)
    params = _tree(params)
    lo, hi = (sp.start, sp.stop) if sp is not None else (0, input_length(cfg, batch))
    kind = input_kind(cfg)
    if kind == "frames":
        x = batch["frame_embeds"][:, lo:hi].to(cfg.dtype)
        B, Sq = x.shape[:2]
        mask = torch.ones((B, Sq), dtype=torch.float32, device=x.device)
    elif kind == "patches":
        P = batch["patch_embeds"].shape[1]
        patches = batch["patch_embeds"][:, min(lo, P):min(hi, P)].to(cfg.dtype)
        # every rank reads the table (its gather is a collective), with no
        # token where its slice holds patches alone
        tok = take_rows(sh.materialize(params["embed"]),
                        batch["tokens"][:, max(lo, P) - P:max(hi, P) - P])
        x = torch.cat([patches, tok], dim=1)
        B, Sq = x.shape[:2]
        mask = torch.cat([torch.zeros(patches.shape[:2], dtype=torch.float32, device=x.device),
                          torch.ones(tok.shape[:2], dtype=torch.float32, device=x.device)],
                         dim=1)
    else:
        x = take_rows(sh.materialize(params["embed"]), batch["tokens"][:, lo:hi])
        B, Sq = x.shape[:2]
        mask = torch.ones((B, Sq), dtype=torch.float32, device=x.device)
    positions = torch.arange(lo, lo + Sq, dtype=torch.int32, device=x.device).expand(B, Sq)
    return x, positions, mask


def forward_hiddens(cfg: ModelConfig, params, batch
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward through the stack → (hiddens (B,S,D), loss_mask (B,S)).
    Under the ``default`` preset (``sequence_layout``) both are this rank's
    positions of the sequence: the residual stream stays split through
    every block, its norms and ``final_norm``.

    The ``first_blocks`` run first, dense, global and never recomputed, as
    in the JAX package. Then each block of the stack: ``remat="full"``
    recomputes it in the backward pass (``torch.utils.checkpoint``,
    non-reentrant), the port of ``jax.checkpoint`` per scanned block;
    ``remat="dots"`` keeps the outputs of its matrix products and recomputes
    the rest (selective checkpointing), the port of ``checkpoint_dots``. A
    kernel called through an extension (flash, RWKV) is no matrix product to
    the dispatcher and is recomputed, as a ``pallas_call`` is under
    ``checkpoint_dots``.

    A MoE model under ``sharding_rules`` runs its experts where
    ``expert_layout`` puts them; the layout is fixed here, so that a
    block's recompute runs the same collectives as its forward."""
    params = _tree(params)
    sp = sequence_layout(cfg, batch)
    x, positions, mask = embed_inputs(cfg, params, batch, sp)
    ep = expert_layout(cfg, x, sp)
    is_local = cfg.is_local_pattern()
    for p in params.get("first_blocks", []):
        x, _ = _apply_block(cfg, p, x, positions, False, dense_override=True, sp=sp)
    remat = cfg.remat if torch.is_grad_enabled() else "none"
    for i, p in enumerate(params["blocks"]):
        local = bool(is_local[cfg.first_k_dense + i])
        if remat == "full":
            x, _ = checkpoint(_apply_block, cfg, p, x, positions, local,
                              use_reentrant=False, sp=sp, ep=ep)
        elif remat == "dots":
            x, _ = checkpoint(_apply_block, cfg, p, x, positions, local,
                              use_reentrant=False, context_fn=_DOTS_CONTEXT, sp=sp, ep=ep)
        else:
            x, _ = _apply_block(cfg, p, x, positions, local, sp=sp, ep=ep)
    x = L.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return x, mask


def unembedding(cfg: ModelConfig, params) -> torch.Tensor:
    """The (D, V) head: the tied embedding's transpose or ``lm_head``,
    gathered when sharded."""
    params = _tree(params)
    if cfg.tie_embeddings:
        return sh.materialize(params["embed"]).T
    return sh.materialize(params["lm_head"])


def logits_from_hiddens(cfg: ModelConfig, params, h: torch.Tensor,
                        head: Optional[torch.Tensor] = None,
                        sp: Optional[sh.SeqParallel] = None) -> torch.Tensor:
    """``h @ head`` softcapped; ``head`` the ``unembedding``, read from
    ``params`` when not given. ``sp`` (the ``default`` preset, no ``head``
    given): where the vocabulary splits (``loss_head``) each rank computes
    its columns and the whole logits are all-gathered over the
    vocabulary's axes, so that every rank holds them (JAX leaves them
    sharded over ``act_vocab``)."""
    vs = None
    if head is None:
        head, vs = loss_head(cfg, params, sp)
    logits = L.softcap(h @ head, cfg.final_logit_softcap)
    return logits if vs is None else vs.mesh.all_gather(logits, vs.axes, dim=logits.dim() - 1)


def _pad_labels(labels: torch.Tensor, S: int) -> torch.Tensor:
    """Labels of width S: a vlm batch's text labels are left-padded with 0
    over the patch positions (which the loss mask zeroes)."""
    if labels.shape[1] != S:
        pad = torch.zeros((labels.shape[0], S - labels.shape[1]), dtype=labels.dtype,
                          device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    return labels


class VocabSlice(NamedTuple):
    """A vocabulary-parallel head's layout: this rank's columns ``[start,
    stop)`` of ``size``, the rest on the ranks along ``axes`` of ``mesh``."""
    mesh: Any
    axes: Tuple[str, ...]
    start: int
    stop: int
    size: int


def loss_head(cfg: ModelConfig, params, sp: Optional[sh.SeqParallel] = None
              ) -> Tuple[torch.Tensor, Optional[VocabSlice]]:
    """The head a loss reads, gathered once for all of its chunks: the whole
    ``unembedding``, or under ``sp`` where the vocabulary splits over
    ``act_vocab``'s axes (JAX's vocab-parallel logits) this rank's columns
    of it and their ``VocabSlice``."""
    if sp is None:
        return unembedding(cfg, params), None
    V = cfg.vocab_size
    axes = sp.split("act_vocab", V)
    if not axes:
        return unembedding(cfg, params), None
    part = sp.part("act_vocab", V)
    params = _tree(params)
    if cfg.tie_embeddings:
        head = sh.materialize_part(params["embed"], 0, part, axes).T
    else:
        head = sh.materialize_part(params["lm_head"], 1, part, axes)
    return head, VocabSlice(sp.mesh, axes, part[0], part[1], V)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       vs: VocabSlice) -> torch.Tensor:
    """The next-token nll from each rank's columns ``logits`` (..., V/n) of
    the whole logits: the log-sum-exp from a ``pmax`` and a ``psum`` over
    ``vs.axes``, the label's logit from the rank whose columns hold it (a
    ``psum``); NaN at a label outside the vocabulary, as ``take_last``
    gives it. Every rank gets the same values; the psums' backward adds
    the ranks' gradients, so each rank's columns get their share."""
    lf = logits.to(torch.float32)
    with torch.no_grad():
        m = vs.mesh.pmax(lf.amax(dim=-1), vs.axes)
    se = sh.psum(torch.exp(lf - m[..., None]).sum(dim=-1), vs.mesh, vs.axes)
    lse = m + torch.log(se)
    safe, valid = wrapped_index(labels, vs.size)
    local = safe - vs.start
    owned = valid & (local >= 0) & (local < vs.stop - vs.start)
    picked = torch.gather(lf, -1, torch.where(owned, local, 0)[..., None])[..., 0]
    label_logit = sh.psum(torch.where(owned, picked, 0.0), vs.mesh, vs.axes)
    return (lse - label_logit).masked_fill(~valid, float("nan"))


def _chunk_nll(cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor, head: torch.Tensor,
               vs: Optional[VocabSlice]) -> torch.Tensor:
    """One loss chunk: logits → float32 log-softmax → nll."""
    logits = L.softcap(h @ head, cfg.final_logit_softcap)
    if vs is not None:
        return vocab_parallel_nll(logits, labels, vs)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -take_last(logp, labels)


def _nll(cfg: ModelConfig, params, h: torch.Tensor, labels: torch.Tensor,
         sp: Optional[sh.SeqParallel] = None) -> torch.Tensor:
    """(B, S) next-token negative log-likelihood, ``labels`` padded to S by
    ``_pad_labels``; seq-chunked with ``cfg.loss_chunk`` so the (B, S, V)
    float32 log-softmax never materializes whole. With more than one chunk
    each chunk runs under a non-reentrant ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint(body)``): the backward keeps the chunk's inputs and
    recomputes its logits, so no chunk's float32 log-softmax is saved.

    ``sp``: ``h`` holds this rank's positions; they are gathered over the
    sequence (JAX's logits: sequence whole), and every model rank returns
    the whole (B, S) nll — with the vocabulary split where it divides
    (``loss_head``), else from the whole logits (replicated compute: the
    step counts one replica, ``launch/steps.py``)."""
    if sp is not None:
        h = sp.gather(h)
    S = h.shape[1]
    labels = _pad_labels(labels, S)
    C = cfg.loss_chunk if cfg.loss_chunk and S > cfg.loss_chunk else S
    if S % C:
        raise ValueError(f"sequence {S} is not a multiple of loss_chunk {C}")
    head, vs = loss_head(cfg, params, sp)     # one gather for every chunk
    recompute = C < S and torch.is_grad_enabled()
    out = []
    for c0 in range(0, S, C):
        args = (cfg, h[:, c0:c0 + C], labels[:, c0:c0 + C], head, vs)
        out.append(checkpoint(_chunk_nll, *args, use_reentrant=False) if recompute
                   else _chunk_nll(*args))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def loss_fn(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token CE over valid positions. Under the ``default``
    preset every model rank returns the whole batch shard's loss."""
    h, mask = forward_hiddens(cfg, params, batch)
    sp = sequence_layout(cfg, batch)
    nll = _nll(cfg, params, h, batch["labels"], sp)
    mask = mask if sp is None else sp.gather(mask)
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"nll": loss}


def per_example_loss(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """(B,) per-sequence loss — GRAFT's per-sample signal."""
    h, mask = forward_hiddens(cfg, params, batch)
    sp = sequence_layout(cfg, batch)
    nll = _nll(cfg, params, h, batch["labels"], sp)
    mask = mask if sp is None else sp.gather(mask)
    return torch.sum(nll * mask, dim=1) / torch.clamp(torch.sum(mask, dim=1), min=1.0)


def pooled_hiddens(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, D) float32 mean of the final hiddens over the loss mask: the
    matrix the feature sources factor (a vlm batch pools its text positions
    only)."""
    return torch.sum(h.to(torch.float32) * mask[..., None], dim=1) / \
        torch.clamp(torch.sum(mask, dim=1), min=1.0)[:, None]


def whole_hiddens(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward_hiddens`` with the sequence whole on every rank (gathered
    under the ``default`` preset)."""
    h, mask = forward_hiddens(cfg, params, batch)
    sp = sequence_layout(cfg, batch)
    if sp is None:
        return h, mask
    return sp.gather(h), sp.gather(mask)


def pooled_features(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """(B, D) mean-pooled final hiddens — GRAFT's feature source."""
    return pooled_hiddens(*whole_hiddens(cfg, params, batch))
