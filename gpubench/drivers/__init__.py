"""The program's entries that a cell's window drives, one module each, found by the
``driver`` name in the cell's file: ``build(cell, cfg, inputs, device)`` returns an
object with ``chunk()`` (one call of the window), ``evals_per_chunk``, ``steps_per_chunk``,
``half_batch`` (the walkers one evaluation launch takes), ``chunk_state`` and
``chunk_start`` (the sampler generator's state and the walkers before the latest
chunk), ``layout`` (``single`` or ``fleet``: how the chunk draws its numbers),
``final()`` (coords [ntgt, nw, ndim], log_prob [ntgt, nw]) and ``last_eval()`` (the
last chunk's last evaluation: proposals and log-posteriors, or None), by which the check
judges the window's last update."""
