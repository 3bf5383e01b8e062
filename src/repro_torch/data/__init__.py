from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.synthetic import SyntheticLM, synthetic_batch

__all__ = ["PrefetchLoader", "SyntheticLM", "synthetic_batch"]
