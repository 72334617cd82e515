from mcmc_spec_tpu_torch.parallel.mesh import make_fleet_mesh, make_mesh  # noqa: F401
from mcmc_spec_tpu_torch.parallel.sharding import (  # noqa: F401
    run_fleet_ensemble_sharded,
    run_ensemble_sharded,
    shard_ensemble_state,
    sharded_log_prob,
    sharded_stretch_step,
)
