"""The port's bench entry points (``python -m bndm_tpu_torch.scripts.<name>``)."""
