"""Runnable examples of the port (``python -m dgs_tpu_torch.examples.<name>``)."""
