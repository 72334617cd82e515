"""Host and tensor ops: extinction, broadening, continuum, interpolation; the CUDA kernels' wrappers
live in ``ops.cuda_kernels`` and ``ops.spec_segmented``."""
from mcmc_spec_tpu_torch.ops.extinction import ccm89, apply_extinction, extinct  # noqa: F401
from mcmc_spec_tpu_torch.ops.broaden import (  # noqa: F401
    gaussian_instrumental_kernel,
    instrumental_broaden,
    instrumental_broaden_fft,
    rotational_broaden,
    redres,
    make_reg,
)
from mcmc_spec_tpu_torch.ops.continuum import polyfit_renorm_matrix, continuum_renorm, chisq  # noqa: F401
from mcmc_spec_tpu_torch.ops.misc import bccorr, find_nearest  # noqa: F401
from mcmc_spec_tpu_torch.ops.interp import (  # noqa: F401
    linear_interp_matrix,
    interp1d_weights,
    apply_interp,
    bilinear_bracket,
    bilinear_gather_blend,
)
