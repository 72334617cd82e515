"""Report helpers: corner statistics and plot, the full-resolution composite and band-magnitude
posteriors (matplotlib is imported only to draw).

``corner_plot`` is not exported here, unlike in JAX: the function's name would
hide the module ``report.corner_plot`` that ``from mcmc_spec_tpu_torch.report
import corner_plot`` gives its callers.
"""
from mcmc_spec_tpu_torch.report.corner_stats import (  # noqa: F401
    bimodal_decompose,
    gauss,
    bimodal,
    quantile_title,
)
from mcmc_spec_tpu_torch.report.composite import composite_full, band_mag_posteriors  # noqa: F401
