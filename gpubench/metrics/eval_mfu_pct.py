"""The whole evaluation's share of the float32 peak over the window: the operations the
window's evaluations need (harness/counts.py) over its time x 67 TFLOP/s."""
from gpubench.harness.readers import eval_mfu as read  # noqa: F401
