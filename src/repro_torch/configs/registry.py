"""Architecture registry of the port: every architecture of
``repro.configs`` resolves; an unknown name raises ``KeyError``."""

from __future__ import annotations

import importlib

ARCHS = ("olmo_1b", "chatglm3_6b", "starcoder2_15b", "star_paper",
         "nemotron_4_340b", "olmoe_1b_7b", "grok_1_314b",
         "jamba_1_5_large_398b", "xlstm_125m", "seamless_m4t_large_v2",
         "internvl2_26b")
NOT_YET_PORTED = ()


def _module(name: str):
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()
