"""Host I/O: FITS tables, filter curves, spectra, Vega, results and checkpoints."""
from mcmc_spec_tpu_torch.io.fits import read_bintable, list_hdus  # noqa: F401
from mcmc_spec_tpu_torch.io.filters import load_transmission, FilterBank  # noqa: F401
from mcmc_spec_tpu_torch.io.spectra import load_data_spectrum, TELLURIC_BANDS  # noqa: F401
from mcmc_spec_tpu_torch.io.vega import load_vega_flam  # noqa: F401
from mcmc_spec_tpu_torch.io.results import (  # noqa: F401
    write_samples,
    read_samples,
    write_optimize_results,
    read_optimize_results,
    Checkpoint,
)
