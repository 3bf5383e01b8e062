"""Prefill/decode disaggregation: the ``KVTransfer`` fabric and the
dual-instance ``DisaggRouter`` (PyTorch port of
``repro.serving.disagg``).

``KVTransfer`` moves a request's committed KV pages between two
``EngineCore`` instances in the flat-payload swap format
(``kvcache.wire``); ``DisaggRouter`` is the ``LLM``-compatible front door
that admits to a prefill-tuned instance and hands each request to a
decode-tuned one at the phase boundary."""

from repro_torch.serving.disagg.router import DisaggRouter
from repro_torch.serving.disagg.transfer import KVTransfer

__all__ = ["DisaggRouter", "KVTransfer"]
