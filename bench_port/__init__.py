"""The benchmark of the PyTorch and CUDA package ``dgs_tpu_torch``."""
