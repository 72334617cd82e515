"""The harness: inputs, the window, the trace, the counts and the check."""
