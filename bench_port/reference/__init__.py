"""The plain reference of the benchmark: plain PyTorch, independent of the
system under test (it imports nothing of ``dgs_tpu_torch``)."""
