"""Mixture-of-Experts FFN with capacity-based token dropping. PyTorch port
of ``repro.models.moe`` on one shard (no expert parallelism: the
reference's local path, ep = 1, with neither ``all_to_all`` nor ``psum``).

Dataflow of one chunk of tokens:

  tokens --gate/top-k--> the routing plan (``route``: each choice's
         virtual expert, its slot in that expert's capacity buffer, and
         whether it fits) --scatter--> [V, cap, H] --expert FFN (batched
         matmuls over the V virtual experts)--> gather each choice's row
         back, weight it by its gate probability, sum over choices.

**Virtual experts.** Parameters keep the reference's layout [V, ...]
with V = max(E, ep_hint) and each expert's FFN dim split ``tpw = V / E``
ways: a token goes to all ``tpw`` slices of an expert it picks, and the
slice outputs sum (Grok-1: 8 experts as 16 virtual ones).

**What decides which tokens drop**, kept exactly as the reference has it:
the gate's top-k (ties to the lower expert index), the capacity
``cap = int(t·k·tpw·cf / V + 1)`` rounded up to 8, the slot order (flat
token-major, choice-minor), the overflow slot ``cap`` that is cut away,
and the chunking (``token_chunk``, decremented until it divides the token
count). The chunks route together and run in groups here (the
reference scans them one at a time): each chunk fills its own buffers,
and the expert FFN reads every expert's weights once a group, whose
slots stay within two full chunks' (``group_size``). A token's output
therefore depends on the tokens routed with it whenever a choice drops.

The expert FFN and the dispatch are plain PyTorch: the reference hands
them to XLA (no Pallas kernel), and the port has no package of finished
kernels to take them from.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common

EP_HINT = 16    # the reference's production expert-axis size (moe.init)


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int                   # per-expert hidden dim
    n_experts: int
    top_k: int
    act: str = "silu"
    gated: bool = True
    capacity_factor: float = 1.25
    token_chunk: int = 2048     # tokens per dispatch round
    aux_loss_weight: float = 0.01
    dtype: torch.dtype = torch.bfloat16

    def virtual(self, ep: int) -> tuple[int, int]:
        """(V virtual experts, tpw split factor) for an EP-way expert
        axis."""
        if self.n_experts >= ep:
            if self.n_experts % ep:
                raise ValueError(
                    f"E={self.n_experts} not divisible by EP={ep}")
            return self.n_experts, 1
        if ep % self.n_experts:
            raise ValueError(f"EP={ep} not divisible by E={self.n_experts}")
        return ep, ep // self.n_experts


def init(generator: torch.Generator, cfg: MoECfg, device=None,
         n_layers=None, ep_hint: int = EP_HINT):
    """Gate and expert weights in the virtual layout [V, ...];
    ``n_layers`` stacks them on a leading axis. As in the reference, the
    expert weights take their fan-in from their first axis, V (std
    sqrt(1/V)), and the gate from d_model. A stacked expert leaf is drawn
    one layer at a time, so the fp32 draw never holds the whole stack."""
    v, tpw = cfg.virtual(ep_hint)
    ff = cfg.d_ff // tpw
    lead = () if n_layers is None else (n_layers,)

    def experts(shape):
        out = torch.empty(lead + shape, dtype=cfg.dtype, device=device)
        for layer in (out if lead else (out,)):
            layer.copy_(common.truncated_normal_init(
                generator, shape, 1.0, cfg.dtype, device, fan_in=v))
        return out

    p = {"wg": common.truncated_normal_init(
            generator, lead + (cfg.d_model, cfg.n_experts), 1.0,
            torch.float32, device, fan_in=cfg.d_model),
         "w1": experts((v, cfg.d_model, ff)),
         "w2": experts((v, ff, cfg.d_model))}
    if cfg.gated:
        p["w3"] = experts((v, cfg.d_model, ff))
    return p


def capacity(t: int, cfg: MoECfg, v: int) -> int:
    """Slots per virtual expert for a chunk of ``t`` tokens: the
    reference's ``int(t·k·tpw·cf / V + 1)``, rounded up to 8, at least 8."""
    tpw = v // cfg.n_experts
    cap = int(t * cfg.top_k * tpw * cfg.capacity_factor / v + 1)
    return max(8, -(-cap // 8) * 8)


def chunking(t: int, cfg: MoECfg) -> int:
    """Tokens per chunk: ``min(token_chunk, t)``, decremented until it
    divides t (a prime t runs chunks of one token)."""
    chunk = min(cfg.token_chunk, t)
    while t % chunk:
        chunk -= 1
    return chunk


def _gate(x, wg, cfg: MoECfg):
    """Top-k routing of chunks x [n, t, H] -> (probs [n, t, k], eidx
    [n, t, k], aux [n]). fp32 logits and a softmax over every expert; the
    top k by a stable descending sort, so equal probabilities keep the
    lower expert index first, as ``lax.top_k`` does; renormalised."""
    logits = x.float() @ wg.float()
    probs_full = torch.softmax(logits, dim=-1)
    top_p, eidx = torch.sort(probs_full, dim=-1, descending=True,
                             stable=True)
    top_p, eidx = top_p[..., :cfg.top_k], eidx[..., :cfg.top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e, per chunk
    n, t, k = eidx.shape
    f = torch.nn.functional.one_hot(eidx.reshape(n, t * k),
                                    cfg.n_experts).sum(1).float() / (t * k)
    pbar = probs_full.mean(dim=1)
    aux = cfg.n_experts * (f * pbar).sum(-1)
    return top_p, eidx, aux


def route(x, wg, cfg: MoECfg, v: int, cap: int) -> dict:
    """The routing plan of chunks x [n, t, H] over ``v`` virtual experts
    of ``cap`` slots each. Per flat choice (token-major, choice-minor;
    ``kc = top_k · tpw`` choices a token): ``vidx`` [n, t·kc] its virtual
    expert, ``slot`` the count of earlier choices of its chunk to the same
    expert (``cap`` where that count reaches cap), ``keep`` whether it
    fits, ``weight`` its gate probability (the same for every slice of an
    expert); ``top_p``/``eidx`` [n, t, k] the gate's choices and ``aux``
    [n] its load-balance loss."""
    top_p, eidx, aux = _gate(x, wg, cfg)
    n, t, _ = eidx.shape
    tpw = v // cfg.n_experts
    kc = cfg.top_k * tpw
    vidx = (eidx[..., None] * tpw + torch.arange(tpw, device=x.device)
            ).reshape(n, t * kc)
    # a choice's slot is its rank among its expert's choices: a stable sort
    # by expert keeps them in flat order, and each expert's run starts at
    # the count of choices to lower experts (the reference's cumulative
    # one-hot sum, without the [N, V] one-hot)
    order = torch.sort(vidx, dim=1, stable=True).indices
    counts = torch.zeros((n, v), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, vidx, torch.ones_like(vidx))
    starts = counts.cumsum(1) - counts
    rank = torch.arange(vidx.shape[1], device=x.device) \
        - starts.gather(1, vidx.gather(1, order))
    pos = torch.empty_like(vidx).scatter_(1, order, rank)
    keep = pos < cap
    return {"top_p": top_p, "eidx": eidx, "aux": aux, "vidx": vidx,
            "slot": torch.where(keep, pos, cap), "keep": keep,
            "weight": top_p.repeat_interleave(tpw, dim=-1).reshape(n, -1)}


def expert_ffn(buf, params, cfg: MoECfg):
    """Every virtual expert over its slots: buf [V, R, H] -> [V, R, H],
    in the promoted type of the tokens and the weights (as the
    reference's einsums promote)."""
    dt = torch.promote_types(buf.dtype, params["w1"].dtype)
    buf = buf.to(dt)
    act = common.activation(cfg.act)
    hmid = act(torch.bmm(buf, params["w1"].to(dt)))
    if cfg.gated:
        hmid = hmid * torch.bmm(buf, params["w3"].to(dt))
    return torch.bmm(hmid, params["w2"].to(dt))


def group_size(cap: int, cfg: MoECfg, v: int) -> int:
    """Chunks per expert matmul: as many as keep a group's slots per
    expert (chunks · cap) within two full chunks' (``token_chunk`` tokens
    each). The buffers stay bounded whatever t is (a prime t runs chunks
    of one token, each at cap 8), and a prompt of two full chunks runs as
    one group."""
    return max(1, 2 * capacity(cfg.token_chunk, cfg, v) // cap)


def _dispatch_combine(x, params, cfg: MoECfg):
    """Chunks x [n, t, H] through gate, dispatch, expert FFN and combine
    -> (out [n, t, H], aux [n]). One routing plan for every chunk, then
    the chunks in groups (``group_size``): each expert's buffer holds the
    group's chunks' ``cap`` slots in turn ([V, g·cap, H], one matmul for
    the group); a kept choice owns its row, every overflowing one writes
    the spare row past them (the reference's slot ``cap``), which the FFN
    never reads, and a dropped choice reads zeros (the reference's zero
    row)."""
    n, t, h = x.shape
    v = params["w1"].shape[0]
    cap = capacity(t, cfg, v)
    plan = route(x, params["wg"], cfg, v, cap)
    kc = plan["vidx"].shape[1] // t
    g = group_size(cap, cfg, v)
    out = []
    for c in range(0, n, g):
        vidx, keep = plan["vidx"][c:c + g], plan["keep"][c:c + g]
        m = vidx.shape[0]
        row = torch.arange(m, device=x.device)[:, None] * cap \
            + plan["slot"][c:c + g]
        row = torch.where(keep, row, m * cap)
        buf = x.new_zeros((v, m * cap + 1, h))
        buf[vidx, row] = x[c:c + g].repeat_interleave(kc, dim=1)
        y = expert_ffn(buf[:, :m * cap], params, cfg)      # [V, m·cap, H]
        rows = y[vidx, row.clamp(max=m * cap - 1)]         # [m, N, H]
        rows = rows.masked_fill(~keep[..., None], 0) * (
            plan["weight"][c:c + g].to(rows.dtype)
            * keep.to(rows.dtype))[..., None]
        out.append(rows.reshape(m, t, kc, h).sum(dim=2))
    return torch.cat(out), plan["aux"]


def apply(params, cfg: MoECfg, x):
    """x [B, S, H] -> (y [B, S, H], aux_loss scalar). The B·S tokens, in
    row-major order, split into equal chunks (``chunking``); aux is the
    mean over chunks."""
    b, s, h = x.shape
    tokens = x.reshape(b * s, h)
    chunk = chunking(b * s, cfg)
    out, aux = _dispatch_combine(tokens.reshape(-1, chunk, h), params, cfg)
    return out.reshape(b, s, h), aux.mean()
