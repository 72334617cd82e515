"""Downstream population analysis (port of ``mcmc_spec_tpu.analysis``), without pandas and sklearn."""
from mcmc_spec_tpu_torch.analysis.planets import (  # noqa: F401
    max_greenhouse_limit,
    recent_venus,
    runaway_greenhouse,
    SystemPosteriors,
    revise_planet,
    population_analysis,
)
