"""Move parameters, caches and configs between the JAX reference and the
port, through numpy. Nothing here imports JAX: callers hand over numpy
arrays (``np.asarray`` of each JAX leaf) and plain dataclass objects.

* bf16 goes through its 16-bit pattern: ``np.asarray`` of a JAX bf16 array
  is an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects,
  so the bits travel as uint16 and are viewed as ``torch.bfloat16``.
* Block parameters keep the reference's leading layer axis (its vmapped
  init), so trees map leaf for leaf under the same keys; optimizer
  states (``opt_state_to_torch``/``opt_state_to_numpy``) likewise.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from repro_torch.core.star_attention import STARConfig
from repro_torch.models import lm, moe, ssm
from repro_torch.tree import tree_map

# reference ModelCfg fields whose non-default values need unported code:
# STAR in training (K2/K3 in train mode and K3's backward; ROADMAP §1
# item 7)
_UNPORTED_FIELDS = {"star_train": False}


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16"


def array_to_torch(arr, device="cpu") -> torch.Tensor:
    arr = np.asarray(arr)
    # ascontiguousarray makes a 0-d array 1-d; the reshape keeps its shape
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if _is_bf16(arr):
        return torch.from_numpy(arr.view(np.uint16).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Torch -> numpy; bf16 comes back as ``ml_dtypes.bfloat16`` (what a
    JAX bf16 array converts to and from). The port does not import
    ``ml_dtypes`` (the card's machine has none): a bf16 leaf needs the
    caller to have loaded it, as JAX does."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        ml_dtypes = sys.modules.get("ml_dtypes")
        if ml_dtypes is None:
            raise RuntimeError("bf16 to numpy needs ml_dtypes loaded (JAX "
                               "loads it)")
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree, device="cpu"):
    """Nested dict of numpy arrays (a reference pytree) -> torch tensors."""
    return tree_map(lambda a: array_to_torch(a, device), tree)


def to_numpy(tree):
    """Nested dict of tensors -> numpy arrays (bf16 as ml_dtypes)."""
    return tree_map(tensor_to_numpy, tree)


def torch_dtype(dtype) -> torch.dtype:
    """numpy-compatible dtype (``jnp.bfloat16``, ``np.float32``, ...) ->
    torch dtype of the same name."""
    return getattr(torch, np.dtype(dtype).name)


def _sub_cfg(port_cls, cfg):
    """The port's twin of a reference layer config: the same fields, its
    dtype as the torch dtype of the same name."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = torch_dtype(fields["dtype"])
    return port_cls(**fields)


def moe_cfg_from_reference(cfg) -> moe.MoECfg:
    """The port's ``MoECfg`` for a reference ``repro.models.moe.MoECfg``."""
    return _sub_cfg(moe.MoECfg, cfg)


def mamba_cfg_from_reference(cfg) -> ssm.MambaCfg:
    """The port's ``MambaCfg`` for a reference ``repro.models.ssm.MambaCfg``."""
    return _sub_cfg(ssm.MambaCfg, cfg)


def model_cfg_from_reference(cfg) -> lm.ModelCfg:
    """The port's ``ModelCfg`` for a reference ``repro.models.lm.ModelCfg``
    (any dataclass with its field names; the training fields carry over,
    ``accum_dtype`` as the torch dtype of its name). Raises
    NotImplementedError for configurations that need unported code
    (``star_train``)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name, default in _UNPORTED_FIELDS.items():
        if fields.get(name, default) != default:
            raise NotImplementedError(
                f"{cfg.name}: {name}={fields[name]!r} is not ported yet: "
                "STAR in training needs K3's backward (ROADMAP §1 item 7)")
    kept = {f.name for f in dataclasses.fields(lm.ModelCfg)}
    out = {k: v for k, v in fields.items() if k in kept}
    out["pattern"] = tuple(lm.BlockCfg(b.kind, b.ffn, b.cross_attn)
                           for b in fields["pattern"])
    if fields["star"] is not None:
        out["star"] = STARConfig(**dataclasses.asdict(fields["star"]))
    if fields.get("moe") is not None:
        out["moe"] = moe_cfg_from_reference(fields["moe"])
    if fields.get("mamba") is not None:
        out["mamba"] = mamba_cfg_from_reference(fields["mamba"])
    out["dtype"] = torch_dtype(fields["dtype"])
    out["accum_dtype"] = torch_dtype(fields["accum_dtype"])
    port = lm.ModelCfg(**out)
    lm.check_supported(port)
    return port


def opt_state_to_torch(state, device="cpu"):
    """A reference optimizer state (numpy leaves: AdamW's ``{m, v,
    step}`` or Adafactor's ``{slots, step}``) -> the port's, on
    ``device``; ``step`` stays a 0-d int32 tensor."""
    _check_opt_state(state)
    return to_torch(state, device)


def opt_state_to_numpy(state):
    """The port's optimizer state -> numpy leaves in the reference's
    layout (bf16 moments as ``ml_dtypes.bfloat16``)."""
    _check_opt_state(state)
    return to_numpy(state)


def _check_opt_state(state) -> None:
    if set(state) not in ({"m", "v", "step"}, {"slots", "step"}):
        raise ValueError(f"not an AdamW or Adafactor state: keys "
                         f"{sorted(state)}")
