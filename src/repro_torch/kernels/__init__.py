"""Kernels written by hand for Hopper, each beside its plain PyTorch twin.

Every wrapper counts its launches in ``LAUNCHES`` (a plain integer per
kernel name, bumped only where the kernel is launched) so a run can show
that its main path went through the kernel and not the plain version.
K2 and K3 have two forms each (``wgmma`` for 128 x 128 tiles, ``mma_sync``
for the others), both of K3's carry the element-level sphere mask
(``sufa/elementwise`` counts those launches too, on top of their form),
and K1 has
an fp and an int8 form (the cold KV tier); ``FORM_LAUNCHES`` counts
launches by form, and ``<kernel>/noncausal`` the prefill kernels' (K2,
K3, K4) launches without the causal mask (an encoder's self-attention,
a decoder's cross-attention). K1's unnormalised (m, l, o) form for the
spatial merge (``kernels.paged.paged_decode_stats_attention``) counts
under its own name, ``paged_decode_stats``, in both lanes. The
backwards of K4 and K3 (``kernels.flash.flash_bwd``,
``kernels.sufa.sufa_bwd``; training) count as ``flash_bwd`` and
``sufa_bwd``, and ``<kernel>/noncausal`` counts theirs without the mask.
K1 and K2 have no backward: the decode is not trained and STAR's tile
selection carries no gradient.
"""

LAUNCHES: dict[str, int] = {"paged_decode": 0, "paged_decode_stats": 0,
                            "dlzs_block": 0, "sufa": 0, "flash": 0,
                            "flash_bwd": 0, "sufa_bwd": 0}
FORM_LAUNCHES: dict[str, int] = {"dlzs_block/wgmma": 0,
                                 "dlzs_block/mma_sync": 0,
                                 "sufa/wgmma": 0, "sufa/mma_sync": 0,
                                 "sufa/elementwise": 0,
                                 "dlzs_block/noncausal": 0,
                                 "sufa/noncausal": 0, "flash/noncausal": 0,
                                 "flash_bwd/noncausal": 0,
                                 "sufa_bwd/noncausal": 0,
                                 "paged_decode/fp": 0,
                                 "paged_decode/int8": 0,
                                 "paged_decode_stats/fp": 0,
                                 "paged_decode_stats/int8": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, FORM_LAUNCHES):
        for name in counts:
            counts[name] = 0
