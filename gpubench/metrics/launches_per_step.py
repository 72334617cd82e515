"""Device ops (kernels, copies, fills) a stretch step in the traced segment, by the
profiler's count, so the torch ops around the program's own kernels count too."""
from gpubench.harness.readers import launches_per_step as read  # noqa: F401
