"""The benchmark of roma_torch, the PyTorch and CUDA port (see BENCHMARK.json)."""
