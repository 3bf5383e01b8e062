"""STAR core math (DLZS, SADS, SU-FA, the composed pipeline) in PyTorch.

The package exports the names ``repro.core`` exports. As there,
``star_attention`` here is the function; the module is
``importlib.import_module("repro_torch.core.star_attention")``.
"""

from repro_torch.core.dlzs import (dlzs_scores, lz_pack, lz_unpack,
                                   pow2_quantize, predict_khat, slzs_scores)
from repro_torch.core.sads import (BlockSelection, SADSSelection,
                                   gather_blocks, gather_selected,
                                   sads_select, sads_select_blocks)
from repro_torch.core.star_attention import (STARConfig, dense_attention,
                                             star_attention,
                                             star_attention_batched,
                                             star_decode)
from repro_torch.core.sufa import (masked_attention_ref, sufa_gathered,
                                   sufa_scan)

__all__ = [
    "BlockSelection", "SADSSelection", "STARConfig", "dense_attention",
    "dlzs_scores", "gather_blocks", "gather_selected", "lz_pack", "lz_unpack",
    "masked_attention_ref", "pow2_quantize", "predict_khat", "sads_select",
    "sads_select_blocks", "slzs_scores", "star_attention",
    "star_attention_batched", "star_decode", "sufa_gathered", "sufa_scan",
]
