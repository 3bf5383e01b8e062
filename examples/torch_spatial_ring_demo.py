"""Spatial-architecture demo of the PyTorch port: DRAttention's ring over
8 sequence shards, and the MRCA schedule that realises it on a mesh NoC
without wrap-around links (the twin of ``examples/spatial_ring_demo.py``).

Run:  python examples/torch_spatial_ring_demo.py [--device cpu]

The 8 shards are a leading axis on one device (the JAX script re-execs
itself under 8 fake XLA devices and rotates with ``ppermute``). It runs
on the GPU unless given ``--device cpu``; the inputs come from numpy
(seed 0).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import mrca  # noqa: E402
from repro_torch.core.dr_attention import dr_attention  # noqa: E402
from repro_torch.core.star_attention import dense_attention  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

N, S, D = 8, 1024, 64


def inputs() -> tuple:
    """q, k, v [S, D] in fp32."""
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((S, D), dtype=np.float32)
                 for _ in range(3))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    q, k, v = (torch.from_numpy(x).to(dev) for x in inputs())

    out = dr_attention(q, k, v, n_shards=N, causal=True)
    ref = dense_attention(q, k, v, causal=True)
    err = float((out - ref).abs().max())
    print(f"DRAttention over {N} sequence shards on {dev.type}: max |err| "
          f"vs dense = {err:.2e}")
    print("  (Q sub-blocks rotate with their (m, l, o) partial-softmax "
          "state; KV stays resident — half the ring traffic of "
          "RingAttention-KV)")

    # MRCA: the same ring as a wrap-around-free mesh schedule
    sim = mrca.simulate(N)
    cost_mrca = mrca.schedule_cost(mrca.mrca_schedule(N))
    cost_naive = mrca.schedule_cost(mrca.naive_ring_schedule(N))
    print(f"MRCA on a 1x{N} mesh: every CU computed all {N} chunks in "
          f"{N} steps, max {sim.max_chunks_stored} chunks stored, "
          f"{sim.link_conflicts} link conflicts")
    print(f"  latency vs naive ring-on-mesh: {cost_mrca['latency_ns']:.0f} "
          f"vs {cost_naive['latency_ns']:.0f} ns "
          f"({cost_naive['latency_ns'] / cost_mrca['latency_ns']:.1f}x)")
    return {"device": str(dev), "shards": N, "max_abs_err": err,
            "max_chunks_stored": sim.max_chunks_stored,
            "link_conflicts": sim.link_conflicts,
            "mrca_latency_ns": cost_mrca["latency_ns"],
            "naive_ring_latency_ns": cost_naive["latency_ns"]}


if __name__ == "__main__":
    main()
