"""The CLI of the port: ``python -m mia_tpu_torch.cli``."""
