"""The benchmark of boundless_tpu_torch, the PyTorch and CUDA port (see run.py)."""
