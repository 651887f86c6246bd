"""Runnable entry points of the port (`python -m sbsim_tpu_torch.examples.<name>`)."""
