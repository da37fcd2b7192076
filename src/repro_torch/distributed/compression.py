"""Int8 error-feedback compression of a cross-process reduce — the twin of
the JAX package's ``distributed/compression.py``.

Per-block absmax int8 quantization (blocks of 256 elements) with an
error-feedback accumulator, so that the quantization bias cancels over
calls (Seide et al. / EF-SGD):

  * ``quantize_int8`` / ``dequantize_int8`` / ``quantization_error`` — the
    pure ops;
  * ``ef_compressed_psum`` — quantize(g + e) with a scale every shard
    shares (the max of the shards' block scales), an exact int32 sum of the
    int8 payloads, dequantize to the mean; returns the new error state.

The per-shard arithmetic lives in functions with no collective
(``ef_block_scales``, ``ef_quantize``, ``ef_mean``), so that two shards'
inputs can be fed to them directly; ``ef_compressed_psum`` joins them with
the two reductions it is given (``pmax`` over float32 block scales, ``psum``
over int32 payloads), which the multiprocess backend runs on
``torch.distributed``.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

BLOCK = 256
_F32 = torch.float32


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """``x`` flattened to float32, zero-padded to whole blocks, (N/B, B)."""
    flat = x.reshape(-1).to(_F32)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, torch.zeros(pad, dtype=_F32, device=flat.device)])
    return flat.reshape(-1, BLOCK)


def _scales(blocks: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(blocks), dim=1) / 127.0 + 1e-12


def _round_int8(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax quantization: ``(q int8 (N/B, B), scales (N/B,))``."""
    blocks = _blocks(x)
    scale = _scales(blocks)
    return _round_int8(blocks, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.to(_F32) * scale[:, None]).reshape(-1)
    return flat[:_numel(shape)].reshape(tuple(shape)).to(dtype)


def quantization_error(x: torch.Tensor) -> torch.Tensor:
    q, s = quantize_int8(x)
    return x.to(_F32) - dequantize_int8(q, s, x.shape, _F32)


# ---------------------------------------------------------------------------
# the error-feedback reduce, one shard's part at a time
# ---------------------------------------------------------------------------

def ef_block_scales(grad: torch.Tensor, error: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's compensated blocks ``(g + e)`` and its block scales."""
    blocks = _blocks(grad.to(_F32) + error)
    return blocks, _scales(blocks)


def ef_quantize(blocks: torch.Tensor, scale: torch.Tensor, shape
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's int8 payload under the shared ``scale`` and its new error
    state (what it compensated minus what it sends)."""
    q = _round_int8(blocks, scale)
    n = _numel(shape)
    compensated = blocks.reshape(-1)[:n].reshape(tuple(shape))
    return q, compensated - dequantize_int8(q, scale, shape, _F32)


def ef_mean(summed: torch.Tensor, scale: torch.Tensor, num_shards: int, shape) -> torch.Tensor:
    """The mean from the int32 sum of every shard's payload."""
    flat = (summed.to(_F32) * scale[:, None] / num_shards).reshape(-1)
    return flat[:_numel(shape)].reshape(tuple(shape))


def ef_compressed_psum(grad: torch.Tensor, error: torch.Tensor, num_shards: int,
                       pmax: Callable[[torch.Tensor], torch.Tensor],
                       psum: Callable[[torch.Tensor], torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed mean over ``num_shards`` shards: ``pmax``
    agrees on the block scales, ``psum`` adds the int8 payloads as int32
    (exact under a shared scale). Returns ``(mean f32, new error)``."""
    blocks, scale_local = ef_block_scales(grad, error)
    scale = pmax(scale_local)
    q, new_error = ef_quantize(blocks, scale, grad.shape)
    summed = psum(q.to(torch.int32))
    return ef_mean(summed, scale, num_shards, grad.shape), new_error


def ef_compressed_psum_tree(grads: Sequence[torch.Tensor], errors: Sequence[torch.Tensor],
                            num_shards: int, pmax, psum
                            ) -> Tuple[list, list]:
    """``ef_compressed_psum`` leaf by leaf over matching lists."""
    outs = [ef_compressed_psum(g, e, num_shards, pmax, psum) for g, e in zip(grads, errors)]
    return [o[0] for o in outs], [o[1] for o in outs]
