"""Attention-only decoder (the OLMo family) in PyTorch: plain functions
over nested-dict parameters with ``repro.models``' keys and layouts."""
