"""Mamba-2 SSD (state-space duality) block of the port
(``repro/models/ssm.py``).

Three implementations of the same layer:
  * `ssd_forward`   — chunked matmul form (prefill, the teacher-forced
    forward of training): attention-like products inside each chunk, then
    the chunk states passed from chunk to chunk; autograd's backward, which
    no in-place op in it disturbs;
  * `ssd_step`      — O(1) recurrent decode step;
  * `ssd_reference` — the naive sequential recurrence in f32 (test oracle).

Layout: d_inner = expand * d_model, H heads of P = head_dim, state N, one
B/C group (mamba2's n_groups = 1).  Params in the reference's layout:

    in_proj (d, 2*DI + 2*N + H)   conv_w (W, DI + 2*N)   conv_b (DI + 2*N,)
    A_log, D, dt_bias (H,)        norm_w (DI,)           out_proj (DI, d)

(with a leading layer dim when stacked).

Casts are the reference's: the projections run in ``dtype`` on weights cast
at use; the causal conv sums in f32 and rounds to ``dtype``; inside a chunk
``C.B`` takes bf16 operands and ``M`` and ``x*dt`` are rounded to bf16
before their product, both accumulated in f32; the chunk states, the pass
between chunks, ``y_inter`` and the gated RMSNorm are f32; the conv's raw
tail is bf16.  A bf16 product is exact in f32, so the port widens the
rounded operands and multiplies in f32.  The reference passes the states
between chunks with ``jax.lax.associative_scan``; the port walks the chunks
in order, which computes the same sums with other f32 roundings.

One departure from the reference, in the backward only: the reference
computes the intra-chunk decay as ``where(tri, exp(cum_i - cum_j), 0)``.
Above the diagonal that exponent is positive and, at chunk 256 with A up to
16, passes 88: ``exp`` overflows to inf, and the zero cotangent ``where``
sends there gives 0 x inf = NaN in the gradients of ``in_proj``, ``A_log``
and ``dt_bias``.  The port masks the exponent with -inf before the
``exp``: the same forward, bit for bit, and a finite backward.

There is no kernel here: the reference's SSD is plain ``jnp``, and this is
plain torch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import quant


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head_dim, state_dim)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads or (d_inner // s.head_dim)
    return d_inner, nheads, s.head_dim, s.state_dim


def ssd_init(cfg: ModelConfig, gen: torch.Generator,
             stacked: Optional[int] = None, *, device,
             dtype=torch.bfloat16):
    """One SSD block's params (``stacked`` layers along dim 0), drawn from
    ``gen`` with the reference's formulas: truncated-normal projections
    over sqrt(fan_in) and conv over sqrt(W), log-spaced ``dt_bias``
    (softplus^-1 of dt in [1e-3, 1e-1]), ``A_log = log(linspace(1, 16))``,
    ``D`` ones, ``conv_b`` and ``norm_w`` zeros.  The two projections are
    in ``dtype``; the small leaves stay f32, the dtype every use reads them
    in."""
    s = cfg.ssm
    d = cfg.d_model
    DI, H, P, N = ssm_dims(cfg)
    conv_dim = DI + 2 * N
    lead = () if stacked is None else (stacked,)
    f32 = torch.float32

    def vec(values):
        t = torch.from_numpy(np.asarray(values, np.float32)).to(device)
        return t.expand(lead + t.shape).contiguous()

    dt = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H)).astype(np.float32)
    dt_bias = np.log(np.expm1(dt))
    a_init = np.linspace(1.0, 16.0, H).astype(np.float32)
    return {
        "in_proj": L.trunc_normal(gen, lead + (d, 2 * DI + 2 * N + H), d,
                                  device, dtype),
        "conv_w": L.trunc_normal(gen, lead + (s.conv_width, conv_dim),
                                 s.conv_width, device, f32),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=f32, device=device),
        "A_log": vec(np.log(a_init)),
        "D": torch.ones(lead + (H,), dtype=f32, device=device),
        "dt_bias": vec(dt_bias),
        "norm_w": torch.zeros(lead + (DI,), dtype=f32, device=device),
        "out_proj": L.trunc_normal(gen, lead + (DI, d), DI, device, dtype),
    }


def _split_proj(cfg: ModelConfig, proj):
    """(z, x, B, C, dt) along the last dim."""
    DI, H, P, N = ssm_dims(cfg)
    return torch.split(proj, [DI, DI, N, N, H], dim=-1)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv.  xBC: (B, T, C); w: (W, C).  Sums in f32,
    tap by tap, and returns SiLU(out + b) in xBC's dtype."""
    W, T = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(W):
        out = out + pad[:, i: i + T, :].float() * w[i].float()
    return F.silu(out + b.float()).to(xBC.dtype)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gated_rmsnorm(y, z, w, eps: float = 1e-6):
    y = y.float() * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * (1.0 + w.float())


def _mm(a, w, dtype):
    """``a @ w`` with ``w`` cast to ``dtype`` at use, in the dtype the two
    promote to (the reference's einsum of ``a`` and ``w.astype(dtype)``:
    bf16 for a bf16 ``a``, f32 for an f32 one)."""
    w = quant.cast(w, dtype)
    rd = torch.promote_types(a.dtype, w.dtype)
    return torch.matmul(a.to(rd), w.to(rd))


def _bf16(x):
    """``x`` rounded to bf16 and widened back to f32."""
    return x.to(torch.bfloat16).float()


def ssd_forward(cfg: ModelConfig, p, u, *, init_state=None,
                dtype=torch.bfloat16):
    """u: (B, T, D) -> (out (B, T, D) in ``dtype``, final state
    (B, H, P, N) f32, raw conv tail (B, W-1, conv_dim) bf16).

    T is padded up to a multiple of the chunk ``Q = min(chunk, T)``; the pad
    positions get dt = 0, so they add nothing to the state and carry no
    decay.  The tail holds the pre-conv inputs of the last W-1 true
    positions (zeros in front when T < W-1): the decode's conv history."""
    s = cfg.ssm
    DI, H, P, N = ssm_dims(cfg)
    B_, T, _ = u.shape
    Q = min(s.chunk, T)
    padT = (Q - T % Q) % Q
    if padT:
        u = F.pad(u, (0, 0, 0, padT))
    Tp = u.shape[1]
    nc = Tp // Q

    proj = _mm(u, p["in_proj"], dtype)
    z, x, Bv, Cv, dt = _split_proj(cfg, proj)
    xBC = torch.cat([x, Bv, Cv], dim=-1)
    w1 = s.conv_width - 1
    raw_tail = xBC[:, max(0, T - w1): T, :].to(torch.bfloat16)
    if T < w1:
        raw_tail = F.pad(raw_tail, (0, 0, w1 - T, 0))
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    x, Bv, Cv = torch.split(xBC, [DI, N, N], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"].float())            # (B,Tp,H)
    A = -torch.exp(p["A_log"].float())                           # (H,)
    if padT:
        valid = (torch.arange(Tp, device=u.device) < T)[None, :, None]
        dt = torch.where(valid, dt, 0.0)

    a = dt * A                                                   # (B,Tp,H)
    cum = torch.cumsum(a.reshape(B_, nc, Q, H), dim=2)           # (B,nc,Q,H)
    cumT = cum.permute(0, 1, 3, 2)                               # (B,nc,H,Q)
    Bc = Bv.reshape(B_, nc, Q, N)
    Cc = Cv.reshape(B_, nc, Q, N)
    xc = x.reshape(B_, nc, Q, H, P)
    dtc = dt.reshape(B_, nc, Q, H)

    # intra-chunk: M[h, i, j] = (C_i . B_j) exp(cum_i - cum_j) for i >= j
    CB = torch.matmul(_bf16(Cc), _bf16(Bc).transpose(-1, -2))    # (B,nc,Q,Q)
    # masked to -inf before the exp (module docstring); ``seg`` is filled
    # in place as no backward reads it, the exp's output, which its
    # backward reads, never
    tri = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    seg = cumT[..., :, None] - cumT[..., None, :]                # (B,nc,H,Q,Q)
    M = torch.exp(seg.masked_fill_(~tri, float("-inf")))
    del seg
    M = M * CB[:, :, None]
    xdt = xc.float() * dtc[..., None]                            # (B,nc,Q,H,P)
    y = torch.matmul(_bf16(M), _bf16(xdt).permute(0, 1, 3, 2, 4))
    del M                                                        # (B,nc,H,Q,P)

    # chunk-final states, then the pass from chunk to chunk
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,Q,H)
    xw = xc.float() * (decay_end * dtc)[..., None]               # (B,nc,Q,H,P)
    S = torch.matmul(xw.permute(0, 1, 3, 4, 2),
                     Bc.float()[:, :, None])                     # (B,nc,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (B,nc,H)
    acc, dA = S[:, 0], chunk_decay[:, 0]
    befores, decays = [torch.zeros_like(acc)], [torch.ones_like(dA)]
    for c in range(1, nc):
        befores.append(acc)
        decays.append(dA)
        acc = acc * chunk_decay[:, c][..., None, None] + S[:, c]
        dA = dA * chunk_decay[:, c]
    before = torch.stack(befores, dim=1)                         # (B,nc,H,P,N)
    decay_excl = torch.stack(decays, dim=1)                      # (B,nc,H)
    if init_state is not None:
        init = init_state.float()
        before = before + init[:, None] * decay_excl[..., None, None]
        final_state = acc + init * dA[..., None, None]
    else:
        final_state = acc

    # y_inter[h, i] = (C_i . state before the chunk) exp(cum_i)
    y_inter = torch.matmul(Cc.float()[:, :, None],
                           before.transpose(-1, -2))             # (B,nc,H,Q,P)
    y = y + y_inter * torch.exp(cumT)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(B_, Tp, H, P)
    y = y + p["D"].float()[None, None, :, None] * x.reshape(
        B_, Tp, H, P).float()
    y = _gated_rmsnorm(y.reshape(B_, Tp, DI), z, p["norm_w"])
    out = _mm(y.to(dtype), p["out_proj"], dtype)
    if padT:
        out = out[:, :T]
    return out, final_state.float(), raw_tail


def ssd_step(cfg: ModelConfig, p, u_t, state, conv_state, *,
             dtype=torch.bfloat16):
    """One decode step.  u_t: (B, D); state: (B, H, P, N) f32; conv_state:
    (B, W-1, conv_dim), the raw (pre-conv) xBC history.  Returns (out
    (B, D) in ``dtype``, state, conv_state)."""
    DI, H, P, N = ssm_dims(cfg)
    proj = _mm(u_t, p["in_proj"], dtype)
    z, x, Bv, Cv, dt = _split_proj(cfg, proj)
    xBC = torch.cat([x, Bv, Cv], dim=-1)                         # (B, conv)
    hist = torch.cat([conv_state, xBC[:, None, :]], dim=1)       # (B, W, conv)
    conv_out = (hist.float() * p["conv_w"].float()).sum(dim=1)
    conv_out = F.silu(conv_out + p["conv_b"].float()).to(dtype)
    new_conv_state = hist[:, 1:, :]
    x, Bv, Cv = torch.split(conv_out, [DI, N, N], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"].float())            # (B, H)
    A = -torch.exp(p["A_log"].float())
    x = x.reshape(-1, H, P).float()
    da = torch.exp(dt * A)                                       # (B, H)
    state = (state * da[..., None, None]
             + (dt[..., None] * x)[..., None] * Bv.float()[:, None, None, :])
    y = torch.matmul(state, Cv.float()[:, None, :, None])[..., 0]
    y = y + p["D"].float()[None, :, None] * x
    y = _gated_rmsnorm(y.reshape(-1, DI), z, p["norm_w"])
    out = _mm(y.to(dtype), p["out_proj"], dtype)
    return out, state, new_conv_state


def init_ssm_state(cfg: ModelConfig, batch: int, *, device):
    """Zero (state (B, H, P, N) f32, conv history (B, W-1, conv_dim) bf16)."""
    s = cfg.ssm
    DI, H, P, N = ssm_dims(cfg)
    return (torch.zeros((batch, H, P, N), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, s.conv_width - 1, DI + 2 * N),
                        dtype=torch.bfloat16, device=device))


def ssd_reference(cfg: ModelConfig, p, u, *, init_state=None):
    """Naive sequential recurrence in f32 — the oracle of `ssd_forward` /
    `ssd_step`.  Returns (out (B, T, D) f32, final state (B, H, P, N))."""
    DI, H, P, N = ssm_dims(cfg)
    B_, T, _ = u.shape
    proj = torch.matmul(u.float(), p["in_proj"].float())
    z, x, Bv, Cv, dt = _split_proj(cfg, proj)
    xBC = _causal_conv(torch.cat([x, Bv, Cv], dim=-1), p["conv_w"],
                       p["conv_b"]).float()
    x, Bv, Cv = torch.split(xBC, [DI, N, N], dim=-1)
    dt = _softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    x = x.reshape(B_, T, H, P)
    state = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=u.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(T):
        da = torch.exp(dt[:, t] * A)                             # (B, H)
        state = (state * da[..., None, None]
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * Bv[:, t, None, None, :])
        ys.append(torch.matmul(state, Cv[:, t, None, :, None])[..., 0])
    y = torch.stack(ys, dim=1) + p["D"].float()[None, None, :, None] * x
    y = _gated_rmsnorm(y.reshape(B_, T, DI), z, p["norm_w"])
    out = torch.matmul(y, p["out_proj"].float())
    return out, state

