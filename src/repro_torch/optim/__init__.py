"""Optimizers and schedules of the port (``repro.optim`` in PyTorch):
AdamW, Adafactor and the warmup-cosine schedule. Each update takes the
parameter, gradient and state trees as nested dicts of tensors, does its
math in fp32 and writes the parameters and the state back in place in
their storage dtypes."""

from repro_torch.optim.adafactor import (AdafactorConfig, adafactor_init,
                                         adafactor_update)
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdafactorConfig", "AdamWConfig", "adafactor_init",
           "adafactor_update", "adamw_init", "adamw_update", "global_norm",
           "warmup_cosine"]
