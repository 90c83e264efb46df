"""Plain float32 PyTorch references of the configurations the benchmark runs."""
