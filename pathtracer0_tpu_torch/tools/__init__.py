"""Diagnostic tools of the port, run as `python -m pathtracer0_tpu_torch.tools.<name>`."""
