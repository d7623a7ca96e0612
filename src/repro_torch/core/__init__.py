"""Algorithm 1, its regularizers, plane layout and metrics, in PyTorch."""
