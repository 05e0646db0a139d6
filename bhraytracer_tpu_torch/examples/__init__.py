"""Runnable examples of the port (python -m bhraytracer_tpu_torch.examples.<name>)."""
