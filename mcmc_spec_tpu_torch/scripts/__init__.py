"""The experiments on the fused posterior K1, on the card.

Counterparts of the JAX package's experiment scripts (``scripts/`` at the
repository root), each run as ``python -m mcmc_spec_tpu_torch.scripts.<name>``:

* ``vpu_microbench``: the FP32 issue ceiling (S10 ``fma_chains``), the row
  median alone (S11 ``median_only``) and the median's share of the fused
  posterior K1;
* ``try_fast_recip``: the receipt for the ``recip_newton`` dial (S4
  ``spectrum_recip``);
* ``ablate_fused_sections``: K1 with its sections switched off one by one (S12
  ``posterior_sections``);

and the candidate redesigns of K1, each against what it would replace:

* ``try_transposed_epilogue``: K1 over 32-walker tiles with a walker-per-lane
  epilogue (S8 ``posterior_transposed``) against K1;
* ``try_whileloop_median``: the exact median with an early exit (S9
  ``median_adaptive``) against 31 fixed passes (S11);
* ``try_packed_median``: the exact median with 16-bit coarse passes (S7
  ``median_packed``) against 31 passes (S11);
* ``try_mxu_overlap``: the spectrum block in four program orders (S5
  ``spectrum_overlap``).

Each ``main(device="cuda")`` runs on the card; ``device="cpu"`` runs the
kernels' plain versions at the sizes given, with host-clock times.
"""
