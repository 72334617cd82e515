"""The cost-attribution experiments of the fused posterior, on the card.

Counterparts of the JAX package's experiment scripts (``scripts/`` at the
repository root), each run as ``python -m mcmc_spec_tpu_torch.scripts.<name>``:

* ``vpu_microbench``: the FP32 issue ceiling (S10 ``fma_chains``), the row
  median alone (S11 ``median_only``) and the median's share of the fused
  posterior K1;
* ``try_fast_recip``: the receipt for the ``recip_newton`` dial (S4
  ``spectrum_recip``);
* ``ablate_fused_sections``: K1 with its sections switched off one by one (S12
  ``posterior_sections``).

Each ``main(device="cuda")`` runs on the card; ``device="cpu"`` runs the
kernels' plain versions at the sizes given, with host-clock times.
"""
