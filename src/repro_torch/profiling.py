"""Device time of kernels under ``torch.profiler``, split by profiler
ranges.

The profiler records each ``record_function`` range twice: as a host
event, and as a span on the device timeline that covers the kernels the
range launched. Those device-side spans are not kernels, so summing every
device event counts a range's time a second time. Here the kernels are
the device events that are not range spans, and a range's device time is
the time of the kernels that ran inside its spans.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def ranged(targets: dict):
    """Within the block, each ``(module, attribute)`` of ``targets`` runs
    inside a profiler range named by its value; restored on exit."""
    from torch.profiler import record_function
    real = {key: getattr(*key) for key in targets}

    def wrap(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call
    for (mod, attr), name in targets.items():
        setattr(mod, attr, wrap(name, real[mod, attr]))
    try:
        yield
    finally:
        for (mod, attr), fn in real.items():
            setattr(mod, attr, fn)


def device_events(prof) -> list:
    """(start, end, name) of every event on the device timeline (us): the
    kernels, and the spans the profiler records there for each range."""
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_kernels(prof, ranges) -> tuple[float, float, list]:
    """From a profile: the summed device time of its kernels (ms), the
    time the device was busy (the union of their intervals, ms) and the
    kernels by name, most device time first; the device-side spans of the
    ``ranges`` (names) are not kernels and are left out."""
    spans, by_name = [], {}
    for a, b, name in device_events(prof):
        if name in ranges:
            continue
        spans.append((a, b))
        calls, us = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, us + (b - a))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1][1], reverse=True)
    return total / 1e3, busy / 1e3, [
        {"name": name[:90], "calls": calls, "device_ms": us / 1e3}
        for name, (calls, us) in top]


def range_device_ms(prof, name: str, ranges) -> float:
    """Device time (ms) of the kernels that ran inside the device-side
    spans of the profiler ranges called ``name`` (``ranges``: every range
    name, whose spans are not kernels)."""
    events = device_events(prof)
    spans = [(a, b) for a, b, n in events if n == name]
    return sum(b - a for a, b, n in events if n not in ranges and any(
        lo <= a and b <= hi for lo, hi in spans)) / 1e3


# The prefill split: each block kind's range, the ranges nested in them,
# and the kernels counted by name wherever they ran.
GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet")   # cuBLAS kernel names
_TOP_RANGES = ("attention.apply_prefill", "moe.apply", "mlp.apply",
               "ssm.apply", "xlstm.mlstm_apply", "xlstm.slstm_apply")


def model_ranges(cfg) -> dict:
    """Profiler ranges that split a prefill of ``cfg`` by its blocks:
    ``(module, attribute) -> range name`` for ``ranged``. Attention
    (``attention.apply_prefill``, of which the GQA expansion
    ``attention._repeat_kv``), the MoE (``moe.apply``, of which the expert
    FFN ``moe.expert_ffn``), the dense FFN (``mlp.apply``), Mamba
    (``ssm.apply``, of which the chunk scan
    ``ssm.chunked_linear_attention``), mLSTM and sLSTM (of which the time
    loop ``xlstm._slstm_scan``): those of the blocks ``cfg`` has."""
    from repro_torch.models import attention, mlp, moe, ssm, xlstm
    kinds = {blk.kind for blk in cfg.pattern} | {blk.ffn
                                                 for blk in cfg.pattern}
    wanted = {
        "attn": ((attention, "apply_prefill"), (attention, "_repeat_kv")),
        "moe": ((moe, "apply"), (moe, "expert_ffn")),
        "dense": ((mlp, "apply"),),
        "mamba": ((ssm, "apply"), (ssm, "chunked_linear_attention")),
        "mlstm": ((xlstm, "mlstm_apply"),),
        "slstm": ((xlstm, "slstm_apply"), (xlstm, "_slstm_scan")),
    }
    return {(mod, attr): f"{mod.__name__.rsplit('.', 1)[1]}.{attr}"
            for kind in sorted(kinds) for mod, attr in wanted.get(kind, ())}


def prefill_split(prof, ranges: dict, device_ms: float, top: list) -> dict:
    """A profiled prefill's device time (ms, and share of ``device_ms``)
    split by ``model_ranges``'s ranges: each range's kernels (``<name>_ms``,
    nested ranges counted inside their parents too), the MoE glue (its
    kernels outside the expert FFN), ``other_ms`` (kernels outside every
    block and FFN: norms, residual adds, embedding, output head), and by
    kernel name wherever they ran: K2 and K3 (``dlzs``/``sufa``), K4
    (``flash``) and the GEMMs."""
    names = set(ranges.values())
    parts = {f"{name}_ms": range_device_ms(prof, name, names)
             for name in sorted(names)}

    def by_name(*keys):
        return sum(k["device_ms"] for k in top
                   if any(p in k["name"].lower() for p in keys))
    if "moe.apply" in names:
        parts["moe_glue_ms"] = parts["moe.apply_ms"] \
            - parts["moe.expert_ffn_ms"]
    parts.update(
        other_ms=device_ms - sum(parts.get(f"{n}_ms", 0.0)
                                 for n in _TOP_RANGES),
        k2_k3_ms=by_name("dlzs", "sufa"), k4_ms=by_name("flash"),
        gemm_kernels_ms=by_name(*GEMM_NAMES))
    return {**parts, **{k[:-3] + "_share": v / device_ms
                        for k, v in parts.items()}}
