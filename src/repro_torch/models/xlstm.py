"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar).
PyTorch port of ``repro.models.xlstm``.

mLSTM is a gated linear attention:  C_t = f_t C_{t-1} + i_t v_t k_tᵀ,
n_t = f_t n_{t-1} + i_t k_t,  y_t = C_t q_t / max(|n_tᵀ q_t|, 1). It runs
``ssm.chunked_linear_attention`` with the normaliser carried as an extra
value column (X = [i·v, i·1]). Exponential input gates are soft-clamped
instead of running the paper's m_t stabiliser, as in the reference.

sLSTM keeps per-head scalar state with block-diagonal recurrent weights
and is sequential: a loop over time on one device (the reference runs
its ``lax.scan`` under ``shard_map`` so that its backward pass reduces
once per layer; the port serves only, on one card). The four recurrent
products of a step run as one batched product.

Plain PyTorch: the reference hands all of this to XLA (no Pallas kernel).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.ssm import (chunk_len, chunked_linear_attention,
                                    linear_attention_step)

SLSTM_GATES = ("wz", "wi", "wf", "wo_gate")
SLSTM_RECURRENT = ("rz", "ri", "rf", "ro")


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    d_model: int
    n_heads: int
    chunk: int = 256
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _clamp_exp(x, lo=-10.0, hi=5.0):
    return torch.exp(torch.clamp(x, lo, hi))


def _draw(generator, lead, shape2d, shape, dtype, device):
    """A weight drawn 2-D (its fan-in is ``shape2d[0]``), then reshaped to
    ``shape``, as the reference draws its per-head weights."""
    return common.truncated_normal_init(
        generator, lead + shape2d, 1.0, dtype, device,
        fan_in=shape2d[0]).reshape(lead + shape)


def _project(x, w):
    """x [B,S,H] @ w [H,nh,dh] -> [B,S,nh,dh]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def _out(y, w):
    """y [B,S,nh,dh] @ w [nh,dh,H] -> [B,S,H]."""
    return y.reshape(*y.shape[:-2], -1) @ w.reshape(-1, w.shape[-1])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(generator: torch.Generator, cfg: XLSTMCfg, device=None,
               n_layers=None):
    h, nh, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    lead = () if n_layers is None else (n_layers,)

    def w(shape2d, shape, dtype=cfg.dtype):
        return _draw(generator, lead, shape2d, shape, dtype, device)
    return {
        "wq": w((h, nh * dh), (h, nh, dh)),
        "wk": w((h, nh * dh), (h, nh, dh)),
        "wv": w((h, nh * dh), (h, nh, dh)),
        "wi": w((h, nh), (h, nh), torch.float32),
        "wf": w((h, nh), (h, nh), torch.float32),
        "wog": w((h, h), (h, h)),
        "wo": w((nh * dh, h), (nh, dh, h)),
        "norm_scale": torch.ones(lead + (nh, dh), dtype=torch.float32,
                                 device=device),
    }


def _mlstm_gates(params, cfg: XLSTMCfg, x):
    q = _project(x, params["wq"])
    # the reference divides by sqrt(head_dim) rounded to x's dtype
    scale = float(torch.tensor(math.sqrt(cfg.head_dim)).to(x.dtype))
    k = _project(x, params["wk"]) / scale
    v = _project(x, params["wv"])
    i_raw = x.float() @ params["wi"]
    f_raw = x.float() @ params["wf"]
    i_gate = _clamp_exp(i_raw)                        # exponential input gate
    log_f = F.logsigmoid(f_raw)                       # log decay <= 0
    return q, k, v, i_gate, log_f


def _headnorm(y, scale):
    """Per-head RMS norm of the mLSTM readout (xLSTM's multi-head norm)."""
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-6) * scale


def _mlstm_out(params, x, y_aug, dh: int):
    """Normalised readout -> head norm -> output projection, gated."""
    num, den = y_aug[..., :dh], y_aug[..., dh:]
    y = _headnorm(num / torch.clamp(den.abs(), min=1.0),
                  params["norm_scale"])
    og = torch.sigmoid(x @ params["wog"])
    return _out(y.to(x.dtype), params["wo"]) * og


def mlstm_apply(params, cfg: XLSTMCfg, x, *, make_cache: bool = False):
    """x [B,S,H] -> (y, cache|None). Chunk-parallel over the sequence; the
    cache is ``state`` [B, nh, dh, dh+1] in fp32."""
    bsz, s, _ = x.shape
    nh, dh = cfg.n_heads, cfg.head_dim
    q, k, v, i_gate, log_f = _mlstm_gates(params, cfg, x)
    ones = torch.ones((bsz, s, nh, 1), dtype=torch.float32, device=x.device)
    x_aug = torch.cat([v.float(), ones], dim=-1) * i_gate[..., None]
    y_aug, h_final = chunked_linear_attention(
        q.float(), k.float(), x_aug, log_f, chunk=chunk_len(s, cfg.chunk))
    out = _mlstm_out(params, x, y_aug, dh)
    return out, ({"state": h_final} if make_cache else None)


def mlstm_decode(params, cfg: XLSTMCfg, x, cache):
    """x [B,1,H] -> (y [B,1,H], new cache). O(1) per step."""
    bsz = x.shape[0]
    nh, dh = cfg.n_heads, cfg.head_dim
    q, k, v, i_gate, log_f = _mlstm_gates(params, cfg, x)
    ones = torch.ones((bsz, nh, 1), dtype=torch.float32, device=x.device)
    x_aug = torch.cat([v[:, 0].float(), ones], dim=-1) \
        * i_gate[:, 0, :, None]
    y_aug, h_new = linear_attention_step(
        q[:, 0].float(), k[:, 0].float(), x_aug, log_f[:, 0],
        cache["state"])
    return _mlstm_out(params, x, y_aug[:, None], dh), {"state": h_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(generator: torch.Generator, cfg: XLSTMCfg, device=None,
               n_layers=None):
    h, nh, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    lead = () if n_layers is None else (n_layers,)
    p = {g: _draw(generator, lead, (h, nh * dh), (h, nh, dh), cfg.dtype,
                  device) for g in SLSTM_GATES}
    p.update({r: _draw(generator, lead, (nh * dh, dh), (nh, dh, dh),
                       torch.float32, device) for r in SLSTM_RECURRENT})
    p["wout"] = _draw(generator, lead, (nh * dh, h), (nh, dh, h), cfg.dtype,
                      device)
    return p


def _slstm_scan(params, carry, pre):
    """The time loop. carry = (c, n, h) each [B,nh,dh]; pre [S,B,nh,4,dh]
    the four gates' input projections (z, i, f, o). Returns the final
    carry and every step's h, [S,B,nh,dh]."""
    c, n, h = carry
    r = torch.cat([params[k] for k in SLSTM_RECURRENT], dim=-1)
    nh, dh = r.shape[0], r.shape[1]
    hs = []
    for t in range(pre.shape[0]):
        rec = torch.bmm(h.transpose(0, 1), r).transpose(0, 1)  # [B,nh,4dh]
        g = pre[t] + rec.reshape(-1, nh, 4, dh)
        z = torch.tanh(g[:, :, 0])
        i = _clamp_exp(g[:, :, 1])
        f = torch.sigmoid(g[:, :, 2])
        o = torch.sigmoid(g[:, :, 3])
        c = f * c + i * z
        n = f * n + i
        h = o * (c / torch.clamp(n.abs(), min=1.0))
        hs.append(h)
    return (c, n, h), torch.stack(hs)


def slstm_apply(params, cfg: XLSTMCfg, x, *, make_cache: bool = False,
                carry=None):
    """x [B,S,H] -> (y, cache|None). Sequential over time; the cache is
    ``c``, ``n``, ``h`` [B, nh, dh] in fp32."""
    bsz = x.shape[0]
    nh, dh = cfg.n_heads, cfg.head_dim
    pre = torch.stack([_project(x, params[g]).float() for g in SLSTM_GATES],
                      dim=3)                           # [B,S,nh,4,dh]
    if carry is None:
        zero = torch.zeros((bsz, nh, dh), dtype=torch.float32,
                           device=x.device)
        carry = (zero, zero, zero)
    carry, hs = _slstm_scan(params, carry, pre.transpose(0, 1))
    out = _out(hs.transpose(0, 1).to(x.dtype), params["wout"])
    cache = {"c": carry[0], "n": carry[1], "h": carry[2]} if make_cache \
        else None
    return out, cache


def slstm_decode(params, cfg: XLSTMCfg, x, cache):
    carry = (cache["c"], cache["n"], cache["h"])
    return slstm_apply(params, cfg, x, make_cache=True, carry=carry)
