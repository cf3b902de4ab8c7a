"""Mixed-precision choke point of the port (``repro/models/quant.py``:
``QTensor``, ``quantize``, ``cast``, ``take``,
``quantize_params`` / ``dequantize_params`` / ``storage_bytes``,
``quantize_kv`` and ``dequantize_kv``).

The JAX package keeps f32 params and casts each weight to bf16 where it is
used (`cast`, `take`).  `QTensor` / `quantize` are its symmetric int8
storage, one f32 scale per tile of the last axis, bitwise the reference's.
`quantize_params` swaps the eligible matmul and embedding weights of a
param tree for `QTensor` leaves (``SliceSpec(quant="int8")``); `cast`
dequantises such a leaf at its use and `take` gathers int8 rows and their
scales before it dequantises them, so running the quantised tree gives
bitwise what running `dequantize_params` of it gives.
`quantize_row_space` is the layout the int8 fused lookup reads
(``kernels/fused_lookup.fused_lookup_q``): tiles of 128 lanes from lane 0,
the last one partial, so an unpadded (R, D) row space gets the scales the
reference gives its lanes inside the padded (R, 256) fused table.
`quantize_kv` is the int8 KV cache's layout, one scale a row (the row the
decode kernels stream), bitwise the reference's; the int8 decode kernels
(``kernels/decode_attention``) widen each element on read.

"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch.kernels.ref import dequant, dequant_rows

DEFAULT_TILE = 128
BLOCK_ROWS = 1 << 20    # rows `quantize_row_space` quantises at a time


@dataclasses.dataclass(frozen=True)
class QTensor:
    """int8 weight + per-tile f32 scales over the last axis.

    ``q`` has the logical weight shape; ``scale`` has shape
    ``q.shape[:-1] + (ceil(last / tile),)``.  ``w ~= q * scale`` per tile.
    """
    q: torch.Tensor
    scale: torch.Tensor
    tile: int = DEFAULT_TILE

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self):
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequant(self.q, self.scale, self.tile).to(dtype)


def _tile_scale(r: torch.Tensor) -> torch.Tensor:
    """max(max |r|, 1e-12) / 127 over the last axis, in f32."""
    return r.abs().amax(dim=-1).clamp_min(1e-12) / 127.0


def quantize(w: torch.Tensor, tile: int = DEFAULT_TILE) -> QTensor:
    """Symmetric int8 quantisation, one scale per ``tile`` of the last axis
    (whole-row tiles when the axis does not divide); rounds half to even,
    as ``jnp.round``."""
    last = w.shape[-1]
    if last % tile:
        tile = last
    nt = last // tile
    r = w.float().reshape(*w.shape[:-1], nt, tile)
    scale = _tile_scale(r)
    q = torch.round(r / scale[..., None]).clamp_(-127, 127)
    return QTensor(q.reshape(w.shape).to(torch.int8), scale, tile)


def quantize_row_space(w: torch.Tensor, tile: int = DEFAULT_TILE) -> QTensor:
    """(R, D) f32 row space -> `QTensor` with ``ceil(D / tile)`` scales a
    row: tiles start at lane 0 and the last may be partial.  Bitwise the
    real lanes and first scales of ``quantize(pad(w, Dp), tile)`` for any
    padded width ``Dp`` that is a multiple of ``tile``.

    Works `BLOCK_ROWS` rows at a time, and within a block one tile at a
    time, so at most one f32 temporary of a block's tile is alive besides
    the int8 result: a row space as large as the card's memory can be
    quantised beside itself.  Each row's bits do not depend on the block
    size."""
    R, D = w.shape
    nt = -(-D // tile)
    q = torch.empty((R, D), dtype=torch.int8, device=w.device)
    scale = torch.empty((R, nt), dtype=torch.float32, device=w.device)
    for r0 in range(0, R, BLOCK_ROWS):
        r1 = r0 + BLOCK_ROWS
        blk = w[r0:r1]
        for t in range(nt):
            a, b = t * tile, min(D, (t + 1) * tile)
            part = blk[:, a:b].float()
            s = _tile_scale(part)
            scale[r0:r1, t] = s
            q[r0:r1, a:b] = part.div(s[:, None]).round_().clamp_(
                -127, 127)
    return QTensor(q, scale, tile)


def quantize_kv(kv: torch.Tensor):
    """Per-row KV quantisation: ``kv (..., D) -> (int8 (..., D), f32 (...))``,
    scale ``max(max |row|, 1e-12) / 127``, rounded half to even (as
    ``jnp.round``) and clipped to +-127."""
    x = kv.float()
    scale = _tile_scale(x)
    q = torch.round(x / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` row by row in f32, then cast to ``dtype``."""
    return dequant_rows(q, scale).to(dtype)


def cast(w: Any, dtype=torch.bfloat16) -> torch.Tensor:
    """Weight -> compute dtype: a `QTensor` is dequantised, a tensor cast
    (no copy when it already is)."""
    if isinstance(w, QTensor):
        return w.dequant(dtype)
    return w.to(dtype)


def take(w: Any, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Row gather for embedding tables, then cast.  A `QTensor` gathers its
    int8 rows and their scales and dequantises only those, never the whole
    table."""
    if isinstance(w, QTensor):
        return QTensor(w.q[ids], w.scale[ids], w.tile).dequant(dtype)
    return w[ids].to(dtype)


# ---------------------------------------------------------------------------
# int8 weight storage of a param tree
# ---------------------------------------------------------------------------

# Param-tree keys of the matmul and embedding weights that
# ``layers.attention_qkv / attention_out / mlp_apply`` and
# ``transformer.embed_tokens / unembed`` read through `cast` / `take`.
# Everything else (norm scales, biases) stays full width.
QUANT_KEYS = frozenset({"wq", "wk", "wv", "wo", "wg", "wu", "wi",
                        "embed", "head"})
_EXCLUDE = re.compile(r"(^|/)(moe|router|experts?)(/|$)")


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, lists and tuples, rebuilt in
    the same nesting; ``path`` is the tuple of keys down to the leaf and a
    `QTensor` is a leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _eligible(path: str, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    if leaf.ndim < 2 or _EXCLUDE.search(path):
        return False
    return path.rsplit("/", 1)[-1] in QUANT_KEYS


def quantize_params(cfg, params, tile: int = DEFAULT_TILE):
    """Swap the eligible matmul and embedding weights for int8 `QTensor`
    storage (the tree's paths unchanged): ``POLICY_INT8`` of the
    reference's ``quantize_params``."""

    def one(path, leaf):
        if _eligible(_path_str(path), leaf):
            return quantize(leaf, tile)
        return leaf

    return _map(one, params)


def dequantize_params(params, dtype=torch.bfloat16):
    """Every `QTensor` leaf at full width: running this tree gives what
    running the quantised one gives, bit for bit."""
    return _map(lambda _, x: (x.dequant(dtype) if isinstance(x, QTensor)
                              else x), params)


def storage_bytes(tree) -> int:
    """Weight storage in bytes (``QTensor``: int8 values plus f32 scales)."""
    sizes = []
    _map(lambda _, x: sizes.append(
        x.nbytes if isinstance(x, QTensor)
        else x.numel() * x.element_size()), tree)
    return int(sum(sizes))
