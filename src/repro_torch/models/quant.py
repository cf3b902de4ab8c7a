"""Mixed-precision choke point of the port (``repro/models/quant.py``
``QTensor``, ``quantize``, ``cast``, ``take``, ``quantize_kv`` and
``dequantize_kv``).

The JAX package keeps f32 params and casts each weight to bf16 where it is
used (`cast`, `take`).  `QTensor` / `quantize` are its symmetric int8
storage, one f32 scale per tile of the last axis, bitwise the reference's.
`quantize_row_space` is the layout the int8 fused lookup reads
(``kernels/fused_lookup.fused_lookup_q``): tiles of 128 lanes from lane 0,
the last one partial, so an unpadded (R, D) row space gets the scales the
reference gives its lanes inside the padded (R, 256) fused table.
`quantize_kv` is the int8 KV cache's layout, one scale a row (the row the
decode kernels stream), bitwise the reference's; the int8 decode kernels
(``kernels/decode_attention``) widen each element on read.

Not ported yet: ``quantize_params`` and the serving engine's
``quant="int8"`` path (ROADMAP.md, queue 1, item 4).
"""
from __future__ import annotations

import dataclasses

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


def cast(w: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Weight -> compute dtype (no copy when it already is)."""
    return w.to(dtype)


def take(w: torch.Tensor, ids: torch.Tensor,
         dtype=torch.bfloat16) -> torch.Tensor:
    """Row gather for embedding tables, then cast."""
    return w[ids].to(dtype)
