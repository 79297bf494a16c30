def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; the test skips where torch.cuda.is_available() is False",
    )
