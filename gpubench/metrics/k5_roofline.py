"""K5 (csrc/log_posterior_fleet_fused.cu) over its roofline, from the trace."""
from gpubench.harness.readers import roofline

NAMES = ("log_posterior_fleet_fused_kernel",)


def read(run):
    return roofline(run, NAMES)
