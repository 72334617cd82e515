"""Runnable examples of the port (``python -m mcmc_spec_tpu_torch.examples.<name>``)."""
