"""Measurement tools of the port (``python -m dgs_tpu_torch.tools.<name>``)."""
