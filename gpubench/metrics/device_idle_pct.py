"""The device's idle share of the window: 1 - the busy device time a step in the traced
segment (the union of the device ops' intervals) over the window's time a step."""
from gpubench.harness.readers import idle as read  # noqa: F401
