"""Model grids, the MIST isochrone table and the Av(distance) prior."""
from mcmc_spec_tpu_torch.models.grid import SpectralGrid  # noqa: F401
from mcmc_spec_tpu_torch.models.synthetic import synthetic_grid, synthetic_spectrum  # noqa: F401
from mcmc_spec_tpu_torch.models.mist import MistTable  # noqa: F401
from mcmc_spec_tpu_torch.models.dust import AvProfile  # noqa: F401
