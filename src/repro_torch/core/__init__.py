"""STAR core math (DLZS, SADS, SU-FA, the composed pipeline) in PyTorch."""
