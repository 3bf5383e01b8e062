"""Quickstart: STAR sparse attention in three stages, on one head, in the
PyTorch port (the twin of ``examples/quickstart.py``).

Run:  python examples/torch_quickstart.py [--device cpu]

It runs on the GPU unless given ``--device cpu``. The inputs come from
numpy (seed 0), so its numbers differ from the JAX script's, which draws
from ``jax.random``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import (STARConfig, dense_attention,  # noqa: E402
                              dlzs_scores, lz_pack, pow2_quantize,
                              sads_select_blocks, star_attention)
from repro_torch.core.opcount import fa2_ops, star_total_ops  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

T, S, D = 512, 2048, 128
CFG = STARConfig(top_k_ratio=0.2, block_q=128, block_kv=128, radius=5.0)


def inputs() -> tuple:
    """q [T, D], k and v [S, D] in fp32, the first S/16 keys scaled by 3
    (peaked rows), as the JAX script draws them."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for shape in ((T, D), (S, D), (S, D)))
    k[: S // 16] *= 3.0
    return q, k, v


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    q, k, v = (torch.from_numpy(x).to(dev) for x in inputs())
    scale = 1.0 / np.sqrt(D)

    # --- Stage 1: DLZS — multiplier-free score prediction ------------------
    k_pow2 = pow2_quantize(k)          # sign·2^floor(log2|k|): the LZ operand
    s_hat = dlzs_scores(q, k_pow2, scale)
    lz_ratio = lz_pack(k).numel() / (k.numel() * k.element_size())
    print(f"DLZS: predicted scores {tuple(s_hat.shape)}; LZ cache is int8 "
          f"({lz_ratio:.2f}x the fp32 bytes)")

    # --- Stage 2: SADS — segmented top-k with sphere pruning ----------------
    sel = sads_select_blocks(s_hat, CFG.block_q, CFG.block_kv,
                             CFG.keep_blocks(S), radius=CFG.radius)
    kept = sel.block_idx.shape[-1]
    print(f"SADS: each of {T // CFG.block_q} query tiles keeps "
          f"{kept}/{S // CFG.block_kv} KV tiles "
          f"(descending predicted max -> SU-FA order)")

    # --- Stage 3: SU-FA — sorted-updating sparse attention ------------------
    out = star_attention(q, k, v, CFG, causal=False)
    ref = dense_attention(q, k, v, causal=False)
    err = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
    print(f"STAR vs dense attention: rel error {err:.3f} at "
          f"{CFG.top_k_ratio:.0%} kept")

    # --- complexity (paper Fig. 18) -----------------------------------------
    fa = fa2_ops(T, S, D, 128).equivalent_adds
    star = star_total_ops(T, S, D, block_kv=128, k_ratio=0.2,
                          n_segments=S // 128, rho=0.4,
                          strict=False).equivalent_adds
    print(f"equivalent-adds: FA-2 {fa:.2e} vs STAR {star:.2e} "
          f"({1 - star / fa:.0%} reduction)")
    return {"device": str(dev), "lz_bytes_ratio": lz_ratio,
            "tiles_kept": kept, "kv_tiles": S // CFG.block_kv,
            "rel_err": err, "fa2_equivalent_adds": fa,
            "star_equivalent_adds": star, "reduction": 1 - star / fa}


if __name__ == "__main__":
    main()
