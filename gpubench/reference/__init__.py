"""The plain reference of the benchmark: the log-posterior and the stretch move of a
binary-star fit written in numpy and plain PyTorch, from the configuration's
equations and the benchmark's own inputs.

It imports nothing of the program under test (``mcmc_spec_tpu_torch``), nothing of
the JAX package beside it, and no JAX.  ``pack`` works out again everything the
program derives at pack time (the grid on the data wavelengths, the filter
weights, the extinction curve, the continuum-fit matrices, the lookup nodes);
``posterior`` evaluates walkers on it; ``sampler`` reproduces the stretch move's
draws and judges an update.
"""
