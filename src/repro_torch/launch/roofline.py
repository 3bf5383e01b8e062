"""The model side of the roofline (``repro.launch.roofline``) for one
H100: the card's peaks, the analytic useful FLOPs of a step (6·N·D to
train, 2·N·D forward) and the three time terms of a step from its FLOPs
and bytes.

MFU's numerator is ``model_flops``: N counts the body parameters, with
the embedding and ``out_head`` excluded and MoE expert weights at
top_k / E (the reference's convention). The reference reads FLOPs and
bytes from XLA's cost analysis of a lowered step and parses collectives
out of its HLO text; eager PyTorch on one card produces neither, so
``analyze`` takes the two numbers from its caller and the collective
term is 0.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.shapes import params_specs
from repro_torch.models import lm
from repro_torch.tree import tree_items

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate
# (at the card's full 700 W power limit).
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card


def count_params(cfg: lm.ModelCfg) -> tuple[int, int]:
    """(total body params N, active body params N_active), embeddings
    excluded (the 6·N·D convention), over ``shapes.params_specs`` (the
    tree on the ``meta`` device: nothing is allocated). Expert weights
    (``w1``/``w2``/``w3`` leaves of three or more dims under ``ffn``, in a
    config with a MoE) count at top_k / E for N_active, truncated per
    leaf as the reference truncates them."""
    params = params_specs(cfg)
    moe_scale = cfg.moe.top_k / cfg.moe.n_experts if cfg.moe else 1.0
    total = active = 0
    for path, leaf in tree_items(params):
        if path[0] in ("embed", "out_head"):
            continue
        n = leaf.numel()
        total += n
        if cfg.moe is not None and "ffn" in path and leaf.dim() >= 3 \
                and any(k in ("w1", "w2", "w3") for k in path):
            active += int(n * moe_scale)
        else:
            active += n
    return total, active


def model_flops(cfg: lm.ModelCfg, shape) -> float:
    """Analytic useful FLOPs for the step (6·N·D train; 2·N·D forward;
    one token per sequence to decode). ``shape``: a ``shapes.ShapeCfg``."""
    _, n_active = count_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.batch * shape.seq
    return 2.0 * n_active * shape.batch


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    model_flops: float
    hlo_total_flops: float
    useful_ratio: float
    bottleneck: str

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(flops: float, bytes_: float, cfg: lm.ModelCfg, shape
            ) -> Roofline:
    """The roofline of one step on one card from the FLOPs it executes
    and the bytes it moves. ``hlo_total_flops`` keeps the reference's
    field name for the executed FLOPs; ``useful_ratio`` is
    ``model_flops`` over them."""
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_ / HBM_BW
    mf = model_flops(cfg, shape)
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=0.0,
        flops_per_device=float(flops), bytes_per_device=float(bytes_),
        collective_bytes=0.0, model_flops=mf, hlo_total_flops=float(flops),
        useful_ratio=mf / flops if flops else 0.0,
        bottleneck=max(terms, key=terms.get))
