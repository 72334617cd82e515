"""The experiments on the fused posterior K1, on the card.

Counterparts of the JAX package's experiment scripts (``scripts/`` at the
repository root), each run as ``python -m mcmc_spec_tpu_torch.scripts.<name>``:

* ``vpu_microbench``: the FP32 issue ceiling (S10 ``fma_chains``), the row
  median alone (S11 ``median_only``) and the median's share of the fused
  posterior K1;
* ``try_fast_recip``: the receipt for the ``recip_newton`` dial (S4
  ``spectrum_recip``);
* ``ablate_fused_sections``: K1 with its sections switched off one by one (the
  JAX script's seven variants, masks of S13 ``posterior_ablate``);

and the candidate redesigns of K1, each against what it would replace:

* ``try_transposed_epilogue``: K1 over 32-walker tiles with a walker-per-lane
  epilogue (S8 ``posterior_transposed``) against K1;
* ``try_whileloop_median``: the exact median with an early exit (S9
  ``median_adaptive``) against 31 fixed passes (S11);
* ``try_packed_median``: the exact median with 16-bit coarse passes (S7
  ``median_packed``) against 31 passes (S11);
* ``try_mxu_overlap``: the spectrum block in four program orders (S5
  ``spectrum_overlap``);

the fleet spectrum kernel under two grid orders:

* ``try_fleet_grid_order``: K4's body with a target's walkers as neighbouring
  blocks or alternating targets (S6 ``spectrum_chi2_fleet_2d``) against K4;

and the launch-cost probes of K1, trivial kernels with K1's operands and no
compute (``csrc/launch_probe.cu``), each timed eager and as a CUDA graph:

* ``dma_probe``: against the table count, width and walkers per block (S1
  ``trivial_probe``);
* ``dma_probe_bisect``: K1's signature ingredients one at a time (S2
  ``bisect_probe``);
* ``dma_probe_bisect2``: every table read by every block, up to K1's operand
  multiset (S3 ``bisect2_probe``).

and one check of the fleet mesh:

* ``batch_rows``: the ops of the composed fleet route (K4's) whose rows a
  share of the one device's batch rounds otherwise, with a count for each.

Each ``main(device="cuda")`` runs on the card; ``device="cpu"`` runs the
kernels' plain versions at the sizes given, with host-clock times.

The accuracy and truth-recovery tools, counterparts of the JAX scripts of the
same names: ``median_tempering_bound`` (and ``_cpu``), ``segmented_median_bound``,
``fast_median_impact``, ``matmul_passes_impact``, ``mist_sensitivity``,
``anneal_budget_divergence``, ``card_validation`` (for ``tpu_validation``) and
the recovery fixtures (``recovery_fixtures``, ``synth_recovery_matrix``,
``synth_recovery_extra``).

The attribution tools, counterparts of the JAX tracing and ablation scripts of
the same names, on the production kernels: ``op_table`` (the device op table of
a ``torch.profiler`` run, shared by the others), ``ablate_matrix`` and
``ablate_matrix_traced`` (the 2^4 section matrix of K1 v2, S13
``posterior_ablate``), ``trace_fused_call``, ``trace_stretch``,
``profile_breakdown`` (``utils.profiling.device_loop_time``),
``trace_fleet_step`` (K4 v2's sections, S14 ``fleet_sections``),
``try_fleet_block``, ``try_block_size``, ``try_two_blocks`` (two walkers a warp,
S15 ``posterior_pair``), ``attr_segmented`` and ``bench_large_nd``.
"""
