"""Chunked gated linear attention core + Mamba (SSD) block. PyTorch port
of ``repro.models.ssm``.

The recurrence  h_t = a_t · h_{t-1} + B_t · X_tᵀ,   y_t = C_tᵀ h_t
(a_t a per-head scalar decay in (0, 1]) covers both the Mamba-2/SSD
selective SSM and the mLSTM matrix memory (``models/xlstm.py``). Within a
chunk its contribution is an attention-like masked product (C Bᵀ ⊙
decay); across chunks a short loop carries the [n, p] state. The chunk is
the largest divisor of S that is at most ``cfg.chunk`` (``chunk_len``),
as in the reference: it fixes the summation order. A prime S runs at
chunk 1, S steps of the cross-chunk loop.

The reference scans the chunks one at a time (``lax.scan``); here the
intra-chunk products of every chunk run as one batched product, and only
the cross-chunk state update loops. The decay exponent is masked before
the ``exp`` (the entries above the diagonal would be ``exp`` of a large
positive sum, ``inf``). A read or write vector shared by every head (Mamba
broadcasts B and C) is passed as an ``expand`` view and kept at one head
inside, so the [t, s] products are formed once, not per head.

Plain PyTorch: the reference hands all of this to XLA (no Pallas kernel).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import common


def chunk_len(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` that is at most ``chunk``."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _one_head_if_shared(a: torch.Tensor) -> torch.Tensor:
    """[B,S,H,*] -> [B,S,1,*] when the head axis is a broadcast view."""
    if a.shape[2] > 1 and a.stride(2) == 0:
        return a[:, :, :1]
    return a


def chunked_linear_attention(c_read, b_write, x_val, log_a, *, chunk: int,
                             h0=None):
    """Run the gated linear-attention recurrence in chunk-parallel form.

    c_read:  [B,S,H,n]  readout vectors (C / queries)
    b_write: [B,S,H,n]  write vectors  (B / keys)
    x_val:   [B,S,H,p]  values (input gate and dt already folded in)
    log_a:   [B,S,H]    log decay per step, <= 0
    h0:      [B,H,n,p]  incoming state, optional

    Returns (y [B,S,H,p], h_final [B,H,n,p]); fp32 internally.
    """
    bsz, s, nh, _ = c_read.shape
    p = x_val.shape[-1]
    if s % chunk:
        raise ValueError(f"S={s} not divisible by chunk={chunk}")
    nc = s // chunk
    f32 = torch.float32

    def split(a):       # [B,S,h,*] -> [B,nc,h,chunk,*]
        a = _one_head_if_shared(a).to(f32)
        return a.reshape(bsz, nc, chunk, *a.shape[2:]).transpose(2, 3)
    cr, bw, xv = split(c_read), split(b_write), split(x_val)
    L = torch.cumsum(log_a.to(f32).reshape(bsz, nc, chunk, nh)
                     .transpose(2, 3), dim=-1)          # [B,nc,H,c] incl.

    # intra-chunk: G[t,τ] = (C_t·B_τ)·exp(L_t − L_τ) for τ <= t, else 0
    later = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=L.device).triu(1)
    expo = (L[..., :, None] - L[..., None, :]).masked_fill(later,
                                                            float("-inf"))
    g = (cr @ bw.transpose(-1, -2)) * torch.exp(expo)   # [B,nc,H,t,s]
    y = g @ xv                                          # [B,nc,H,t,p]

    # each chunk's own write: Σ_τ exp(L_T − L_τ) B_τ X_τᵀ; the carried
    # state decays by exp(L_T) across the chunk
    w = torch.exp(L[..., -1:] - L)                      # [B,nc,H,c]
    writes = (bw * w[..., None]).transpose(-1, -2) @ xv  # [B,nc,H,n,p]
    decay = torch.exp(L[..., -1])[..., None, None]      # [B,nc,H,1,1]
    h = torch.zeros((bsz, nh, bw.shape[-1], p), dtype=f32,
                    device=L.device) if h0 is None else h0.to(f32)
    before = []
    for c in range(nc):
        before.append(h)
        h = h * decay[:, c] + writes[:, c]
    # inter-chunk: y += exp(L_t) · C_t · h_prev
    y = y + (cr @ torch.stack(before, dim=1)) * torch.exp(L)[..., None]
    return y.transpose(2, 3).reshape(bsz, s, nh, p), h


def linear_attention_step(c_read, b_write, x_val, log_a, h):
    """Single decode step. c/b [B,H,n], x [B,H,p], log_a [B,H],
    h [B,H,n,p] -> (y [B,H,p], h_new)."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None, None]
    h_new = h.to(f32) * a + b_write.to(f32)[..., :, None] \
        * x_val.to(f32)[..., None, :]
    y = (c_read.to(f32)[..., None, :] @ h_new)[..., 0, :]
    return y, h_new


# ---------------------------------------------------------------------------
# Mamba (SSD) block
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_model: int
    expand: int = 2
    head_dim: int = 64
    d_state: int = 16
    d_conv: int = 4
    chunk: int = 256
    dtype: torch.dtype = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init(generator: torch.Generator, cfg: MambaCfg, device=None,
         n_layers=None):
    """The reference's leaves and distribution; ``n_layers`` stacks them
    on a leading axis. Each weight takes its fan-in from its first axis,
    so ``conv_w`` [d_conv, d_inner] is drawn at fan-in d_conv, scale 3."""
    h, di, n, nh = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    lead = () if n_layers is None else (n_layers,)

    def w(shape, scale=1.0):
        return common.truncated_normal_init(
            generator, lead + shape, scale, cfg.dtype, device,
            fan_in=shape[0])

    def const(fill, size, dtype):
        return torch.full(lead + (size,), fill, dtype=dtype, device=device)

    return {
        "wx": w((h, di)), "wz": w((h, di)), "wb": w((h, n)),
        "wc": w((h, n)), "wdt": w((h, nh)),
        "dt_bias": const(0.0, nh, torch.float32),
        "a_log": const(0.0, nh, torch.float32),   # A = exp(a_log) > 0
        "d_skip": const(1.0, nh, torch.float32),
        "conv_w": w((cfg.d_conv, di), 3.0),
        "conv_b": const(0.0, di, cfg.dtype),
        "wo": w((di, h)),
    }


def _depthwise_conv(x, w, b, state=None):
    """Causal depthwise conv over seq. x [B,S,di], w [K,di] -> [B,S,di].
    ``state`` [B,K-1,di] is the left context (zeros when None). Returns
    (y, new_state); the taps add in the reference's order."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                  # [B, S+K-1, di]
    y = xp[:, :s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y + b, new_state


def _gates(params, xin):
    """Shared projections. xin [B,S,H] -> conv-x, z, B, C, dt, log_a."""
    x = xin @ params["wx"]
    z = xin @ params["wz"]
    bmat = (xin @ params["wb"]).float()
    cmat = (xin @ params["wc"]).float()
    dt_raw = (xin @ params["wdt"]).float()
    dt = F.softplus(dt_raw + params["dt_bias"])        # [B,S,nh] > 0
    log_a = -dt * torch.exp(params["a_log"])           # [B,S,nh] <= 0
    return x, z, bmat, cmat, dt, log_a


def _readout(params, cfg: MambaCfg, y, xh, z, dtype):
    """D skip per head, the z gate and the output projection."""
    y = y + xh * params["d_skip"][:, None]
    y = y.reshape(*y.shape[:-2], cfg.d_inner).to(dtype)
    return (y * common.silu(z)) @ params["wo"]


def apply(params, cfg: MambaCfg, xin, *, make_cache: bool = False):
    """Mamba block over a full sequence. xin [B,S,H] -> (y, cache | None);
    the cache is ``conv`` [B, d_conv-1, d_inner] in the activations' dtype
    and ``state`` [B, nh, d_state, head_dim] in fp32."""
    bsz, s, _ = xin.shape
    nh, hd, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    x, z, bmat, cmat, dt, log_a = _gates(params, xin)
    x, conv_state = _depthwise_conv(x, params["conv_w"], params["conv_b"])
    x = common.silu(x)
    xh = x.reshape(bsz, s, nh, hd).float()
    xv = xh * dt[..., None]                            # fold dt into X
    cread = cmat[:, :, None, :].expand(bsz, s, nh, n)
    bwrite = bmat[:, :, None, :].expand(bsz, s, nh, n)
    y, h_final = chunked_linear_attention(cread, bwrite, xv, log_a,
                                          chunk=chunk_len(s, cfg.chunk))
    out = _readout(params, cfg, y, xh, z, xin.dtype)
    cache = {"conv": conv_state, "state": h_final} if make_cache else None
    return out, cache


def apply_decode(params, cfg: MambaCfg, xin, cache):
    """Single-token decode. xin [B,1,H] -> (y [B,1,H], new cache)."""
    bsz = xin.shape[0]
    nh, hd, n = cfg.n_heads, cfg.head_dim, cfg.d_state
    x, z, bmat, cmat, dt, log_a = _gates(params, xin)
    x, conv_state = _depthwise_conv(x, params["conv_w"], params["conv_b"],
                                    state=cache["conv"])
    x = common.silu(x)
    xh = x.reshape(bsz, 1, nh, hd).float()
    xv = xh[:, 0] * dt[:, 0, :, None]
    y, h_new = linear_attention_step(
        cmat[:, 0, None, :].expand(bsz, nh, n),
        bmat[:, 0, None, :].expand(bsz, nh, n), xv, log_a[:, 0],
        cache["state"])
    out = _readout(params, cfg, y[:, None], xh, z, xin.dtype)
    return out, {"conv": conv_state, "state": h_new}
