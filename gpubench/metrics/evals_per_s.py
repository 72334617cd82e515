"""Stage-2 evaluations per second: steps x walkers of the window over its host-clock
time, the card synchronised at its end."""
from gpubench.harness.readers import rate as read  # noqa: F401
