"""K1 — paged decode attention: the CUDA kernel ``csrc/paged_decode.cu``
behind a checked wrapper, beside its plain PyTorch version.

Replaces ``repro/kernels/paged.py::paged_decode_attention`` (Pallas, TPU).
The kernel is bound by memory (it must read every gathered K/V row once);
it splits each sequence's block table into ``split_plan`` ranges, one
block each, which first find the sequence's softmax statistics and then
add their share of P·V (see the source's header;
``ref.paged_decode_split_ref`` is the same algorithm in plain form).
With ``quant`` (the int8 cold tier: ``kvcache.quant``'s mirror slabs,
their page scales and the step's ``qmask``) the kernel's int8 form runs:
a marked slot reads ``bf16(float(code) · scale)`` as the plain gather
does. Tensors on the CPU take the plain version; tensors on a GPU launch
the kernel or raise — there is no fallback. ``kernels.LAUNCHES
["paged_decode"]`` counts calls that launched it (either form),
``kernels.FORM_LAUNCHES["paged_decode/fp"]`` and ``["paged_decode/int8"]``
those of each form.

``paged_decode_stats_attention`` is K1's unnormalised (m, l, o) form, for
the spatial engine: the per-shard partial softmax state, over every shard
of a sequence-sharded pool in one launch sequence (the shard axis folds
into the batch axis), in the fp and int8 lanes. Its launches count under
``kernels.LAUNCHES["paged_decode_stats"]`` (and
``FORM_LAUNCHES["paged_decode_stats/fp"]`` / ``["/int8"]``), never under
``"paged_decode"``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import launch

# (head_dim, group size R) pairs the library instantiates; (128, 6),
# (128, 12), (128, 16) and (192, 12) are Grok-1's, StarCoder2-15B's,
# ChatGLM3-6B's and Nemotron-4-340B's GQA groups
SUPPORTED = {(64, 1), (64, 2), (64, 4), (64, 8), (64, 16),
             (128, 1), (128, 2), (128, 4), (128, 6), (128, 8), (128, 12),
             (128, 16), (192, 12), (256, 1), (256, 2), (256, 4)}

SMS = 132                # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 4        # blocks per SM the split plan aims for
STAGE_ROWS = 16          # rows the kernel stages at a time
MAX_RANGE_ROWS = 256     # rows of one range the kernel holds P for


def split_plan(b: int, g: int, w: int, page: int) -> int:
    """How many ranges of block-table slots the kernel splits each
    (sequence, KV head) into, from the shapes alone (kv_len's values would
    cost a device sync per layer): enough for BLOCKS_PER_SM blocks per SM,
    at most one per slot and at most one per STAGE_ROWS rows of a full
    table; but at least enough that no range exceeds MAX_RANGE_ROWS
    rows."""
    target = -(-SMS * BLOCKS_PER_SM // (b * g))
    most = max(1, min(w, w * page // STAGE_ROWS))
    need = -(-w // max(1, MAX_RANGE_ROWS // page))
    return min(w, max(need, min(target, most)))


def split_ranges(w: int, n_split: int) -> list[tuple[int, int]]:
    """The slots [w0, w1) of each split, as the kernel computes them."""
    return [(s * w // n_split, (s + 1) * w // n_split)
            for s in range(n_split)]


def paged_decode_reference(q, k_pages, v_pages, phys, logical, kv_len, *,
                           scale: float, quant=None) -> torch.Tensor:
    """The plain version: ``kvcache.paged_attention.paged_gather_decode``
    (with ``quant``, its int8 read path) on the kernel's [B, G, R, d]
    query layout."""
    from repro_torch.kvcache.paged_attention import paged_gather_decode
    b, g, r, d = q.shape
    o = paged_gather_decode(q.reshape(b, g * r, d), k_pages, v_pages, phys,
                            logical, kv_len, n_kv=g, scale=scale,
                            quant=quant)
    return o.reshape(b, g, r, d)


def _check(q, k_pages, v_pages, phys, logical, kv_len, shards: int = 1
           ) -> None:
    """The normalised form's operands. The stats form checks its folded
    view of the shards with this too: ``shards`` table rows [S·B, W] per
    query and kv_len [B]."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("phys", phys), ("logical", logical),
                    ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"paged_decode: {name} on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"paged_decode: {name} must be bfloat16, "
                            f"got {t.dtype}")
    for name, t in (("phys", phys), ("logical", logical),
                    ("kv_len", kv_len)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"paged_decode: {name} must be contiguous int32")
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("paged_decode: q [B,G,R,d] and pool slabs "
                         "[P,page,G,d] of one shape expected")
    b, g, r, d = q.shape
    if k_pages.shape[2] != g or k_pages.shape[3] != d:
        raise ValueError(f"paged_decode: pool {tuple(k_pages.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if phys.dim() != 2 or phys.shape != logical.shape \
            or phys.shape[0] != shards * b or phys.shape[1] < 1 \
            or kv_len.shape != (b,):
        raise ValueError("paged_decode: phys/logical [B,W] (one row per "
                         "shard and sequence) and kv_len [B] expected")
    if k_pages.shape[1] > MAX_RANGE_ROWS:
        raise ValueError(f"paged_decode: page {k_pages.shape[1]} above "
                         f"{MAX_RANGE_ROWS} rows")
    if (d, r) not in SUPPORTED:
        raise ValueError(f"paged_decode: (head_dim, R) = {(d, r)} not "
                         f"built; supported {sorted(SUPPORTED)}")
    if not q.is_contiguous():
        raise ValueError("paged_decode: q must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        # rows are copied 16 bytes (8 bf16) at a time
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} needs a contiguous "
                             f"head_dim, strides in multiples of 8 and a "
                             f"16-byte aligned start")


def _check_quant(quant: dict, k_pages, phys) -> None:
    """The int8 tier as the kernel reads it: codes in the pool's layout
    (16-byte copies), f32 scales [P], a contiguous bool qmask [B, W]."""
    dev = k_pages.device
    for name in ("kq", "vq", "k_scale", "v_scale", "qmask"):
        if quant[name].device != dev:
            raise ValueError(f"paged_decode: quant {name} on "
                             f"{quant[name].device}, pool on {dev}")
    for name in ("kq", "vq"):
        t = quant[name]
        if t.dtype != torch.int8 or t.shape != k_pages.shape:
            raise TypeError(f"paged_decode: quant {name} must be int8 of "
                            f"the pool's shape {tuple(k_pages.shape)}")
        if t.stride(3) != 1 or any(x % 16 for x in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"paged_decode: quant {name} needs a "
                             f"contiguous head_dim, strides in multiples of "
                             f"16 and a 16-byte aligned start")
    for name in ("k_scale", "v_scale"):
        t = quant[name]
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.shape != k_pages.shape[:1]:
            raise TypeError(f"paged_decode: quant {name} must be "
                            f"contiguous float32 [P]")
    m = quant["qmask"]
    if m.dtype != torch.bool or not m.is_contiguous() \
            or m.shape != phys.shape:
        raise TypeError("paged_decode: qmask must be contiguous bool [B, W]")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, phys: torch.Tensor,
                           logical: torch.Tensor, kv_len: torch.Tensor, *,
                           scale: float, quant=None) -> torch.Tensor:
    """q [B,G,R,d]; k/v pool slabs in their native layout [P,page,G,d];
    phys/logical [B,W] int32 (-1 = padded slot); kv_len [B] int32;
    ``quant`` None or the int8 tier {kq, vq: int8 [P,page,G,d]; k_scale,
    v_scale: f32 [P]; qmask: bool [B,W]}. Returns [B,G,R,d] in q's dtype.

    On the CPU: the plain version. On a GPU: the CUDA kernel (bf16 only;
    its int8 form with ``quant``), launched on the current stream, or an
    exception."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, phys, logical,
                                      kv_len, scale=scale, quant=quant)
    launch.require_cuda("paged_decode", q.device)
    _check(q, k_pages, v_pages, phys, logical, kv_len)
    b, g, r, d = q.shape
    w, page = phys.shape[1], k_pages.shape[1]
    n_split = split_plan(b, g, w, page)
    out = torch.empty_like(q)
    # fp32 scratch: m, l and o[d] per (sequence, KV head, split, head),
    # and the scores of every table row per (sequence, KV head, head)
    ws = torch.empty(b * g * r * (n_split * (d + 2) + w * page),
                     dtype=torch.float32, device=q.device)
    if quant is None:   # the fp form: no tier, null pointers
        tier, strides, form = (None,) * 5, (0,) * 6, "fp"
    else:
        _check_quant(quant, k_pages, phys)
        tier = tuple(quant[name].data_ptr() for name in
                     ("kq", "vq", "k_scale", "v_scale", "qmask"))
        strides = (*quant["kq"].stride()[:3], *quant["vq"].stride()[:3])
        form = "int8"
    fn = launch.bind("paged_decode", "paged_decode",
                     [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                     + [ctypes.c_int64] * 12
                     + [ctypes.c_float, ctypes.c_void_p])
    launch.launch("paged_decode", fn, q.device, q.data_ptr(),
                  k_pages.data_ptr(), v_pages.data_ptr(), phys.data_ptr(),
                  logical.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                  ws.data_ptr(), *tier, b, g, r, d, w, page,
                  k_pages.shape[0], n_split, *k_pages.stride()[:3],
                  *v_pages.stride()[:3], *strides, float(scale), form=form)
    return out


# -- the unnormalised (m, l, o) form over sharded pools ------------------------

def paged_decode_stats_reference(q, k_pages, v_pages, phys, logical, kv_len,
                                 *, scale: float, quant=None):
    """The plain version of the stats form:
    ``kvcache.paged_attention.paged_gather_decode_stats`` over the folded
    shards. q [B,G,R,d] shared by the shards; slabs [S,P,page,G,d];
    phys/logical [S,B,W]; kv_len [B]. Returns m/l [S,B,G,R] and
    o [S,B,G,R,d], fp32."""
    from repro_torch.kvcache.paged_attention import (
        fold_shards, fold_tier, paged_gather_decode_stats)
    b, g, r, d = q.shape
    s, _, w = phys.shape
    kf, pf = fold_shards(k_pages, phys)
    m, l, o = paged_gather_decode_stats(
        q.reshape(1, b, g * r, d).expand(s, b, g * r, d).reshape(
            s * b, g * r, d),
        kf, v_pages.reshape(kf.shape), pf, logical.reshape(s * b, w),
        kv_len.repeat(s), n_kv=g, scale=scale, quant=fold_tier(quant))
    return m.reshape(s, b, g, r), l.reshape(s, b, g, r), \
        o.reshape(s, b, g, r, d)


def paged_decode_stats_attention(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, phys: torch.Tensor,
                                 logical: torch.Tensor, kv_len: torch.Tensor,
                                 *, scale: float, quant=None):
    """Per-shard partial softmax state of one decode step over a
    sequence-sharded pool: q [B,G,R,d] (the query every shard sees); k/v
    slabs [S,P,page,G,d] (S shards of P pages; each shard's slab a slice
    of one tensor, read as [S·P, ...]); phys/logical [S,B,W] int32 with
    shard-LOCAL physical ids (-1 = padded slot); kv_len [B] int32;
    ``quant`` None or the int8 tier {kq, vq: int8 [S,P,page,G,d]; k_scale,
    v_scale: f32 [S,P]; qmask: bool [S,B,W]}.

    Returns fp32 (m, l) [S,B,G,R] and o [S,B,G,R,d]: o = sum of P·v and
    l = sum of P with P = exp(s - m), m the row max, over the shard's
    valid rows; a shard with none for a sequence gives m = NEG_INF, l = 0,
    o = 0, the merge's neutral element. On the CPU: the plain version. On
    a GPU: one launch sequence of K1's stats form for all S shards, or an
    exception."""
    if q.device.type == "cpu":
        return paged_decode_stats_reference(q, k_pages, v_pages, phys,
                                            logical, kv_len, scale=scale,
                                            quant=quant)
    launch.require_cuda("paged_decode_stats", q.device)
    if k_pages.dim() != 5 or phys.dim() != 3 \
            or phys.shape[0] != k_pages.shape[0]:
        raise ValueError("paged_decode_stats: slabs [S,P,page,G,d] and "
                         "phys/logical [S,B,W] of one shard count expected")
    s, p = k_pages.shape[:2]
    b, g, r, d = q.shape
    w = phys.shape[2]
    # the folded view must alias the slabs: a copy would move the pool
    kf = k_pages.view(s * p, *k_pages.shape[2:])
    vf = v_pages.view(s * p, *v_pages.shape[2:])
    pf = phys.view(s * b, w)
    lf = logical.view(s * b, w)
    _check(q, kf, vf, pf, lf, kv_len, shards=s)
    page = kf.shape[1]
    n_split = split_plan(s * b, g, w, page)
    m = torch.empty((s, b, g, r), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    o = torch.empty((s, b, g, r, d), dtype=torch.float32, device=q.device)
    ws = torch.empty(s * b * g * r * (n_split * (d + 2) + w * page),
                     dtype=torch.float32, device=q.device)
    if quant is None:
        tier, strides, form = (None,) * 5, (0,) * 6, "fp"
    else:
        from repro_torch.kvcache.paged_attention import fold_tier
        fq = fold_tier(quant)
        _check_quant(fq, kf, pf)
        tier = tuple(fq[name].data_ptr() for name in
                     ("kq", "vq", "k_scale", "v_scale", "qmask"))
        strides = (*fq["kq"].stride()[:3], *fq["vq"].stride()[:3])
        form = "int8"
    fn = launch.bind("paged_decode", "paged_decode_stats",
                     [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                     + [ctypes.c_int64] * 12
                     + [ctypes.c_float, ctypes.c_void_p])
    launch.launch("paged_decode_stats", fn, q.device, q.data_ptr(),
                  kf.data_ptr(), vf.data_ptr(), pf.data_ptr(),
                  lf.data_ptr(), kv_len.data_ptr(), m.data_ptr(),
                  l.data_ptr(), o.data_ptr(), ws.data_ptr(), *tier, s * b, b,
                  g, r, d, w, page, p, n_split, *kf.stride()[:3],
                  *vf.stride()[:3], *strides, float(scale), form=form)
    return m, l, o
