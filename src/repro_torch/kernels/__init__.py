"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), their
plain PyTorch versions (ref.py) and the adapters that route the model to
them (ops.py)."""
