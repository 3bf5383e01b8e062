"""PyTorch + CUDA port of the STAR serving system (``repro``'s twin).

The package mirrors ``repro``'s layout — ``core/``, ``models/``,
``kvcache/``, ``kernels/``, ``serving/``, ``obs/``, ``configs/`` — so each
module's counterpart is easy to find. It imports neither ``jax`` nor
``repro``: host-only helpers it needs are copied, and only the tests
import both packages to hold the port against the reference.

Entry points (``serving.api.LLM.from_config``, ``models.lm.init``) run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU they
raise rather than fall back (``device.resolve_device``). The Pallas TPU
kernels become kernels written by hand for Hopper under
``kernels/`` + ``csrc/``; everything else is plain PyTorch.
"""
