"""Inference: the packed target, the posterior (per walker and batched), the samplers.

The JAX package's public names, imported when first used (PEP 562): the
kernels' modules that ``inference.batched`` imports import ``parallel``, whose
sharded chain imports ``inference.stretch``, so an eager import here would be
circular.
"""
import importlib

_NAMES = {
    "target": ("PackedTarget", "pack_target"),
    "posterior": ("log_posterior", "log_likelihood", "log_prior", "optimizer_chi2",
                  "forward_summary"),
    "batched": ("log_posterior_batch", "log_likelihood_batch", "log_prior_batch",
                "optimizer_chi2_batch", "forward_batch"),
    "stretch": ("EnsembleState", "run_ensemble", "stretch_step"),
    "anneal": ("run_anneal", "init_walkers"),
    "fleet": ("stack_targets", "log_posterior_fleet", "init_fleet_ensemble",
              "run_fleet_ensemble"),
    "sampler_api": ("EnsembleSampler",),
}
_MODULE_OF = {name: mod for mod, names in _NAMES.items() for name in names}
__all__ = sorted(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
