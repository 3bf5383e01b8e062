"""Architecture registry of the port. Only the families whose blocks are
ported resolve; every other architecture of ``repro.configs`` raises
``KeyError("... not yet ported ...")`` (ROADMAP §1 item 4)."""

from __future__ import annotations

import importlib

ARCHS = ("olmo_1b", "chatglm3_6b", "starcoder2_15b", "star_paper",
         "nemotron_4_340b", "olmoe_1b_7b", "grok_1_314b",
         "jamba_1_5_large_398b", "xlstm_125m")
NOT_YET_PORTED = ("seamless_m4t_large_v2", "internvl2_26b")


def _module(name: str):
    name = name.replace("-", "_").replace(".", "_")
    if name in NOT_YET_PORTED:
        raise KeyError(f"arch {name!r} is not yet ported to repro_torch "
                       f"(ROADMAP §1 item 4); ported: {ARCHS}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()
