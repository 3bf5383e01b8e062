def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skips where torch.cuda is "
        "unavailable (run on the card: python -m pytest -m cuda "
        "tests/test_torch_*.py)")
