"""The D rows a block of K1 or K5 staged, over the traced segment's blocks: the union U of
the grid rows its walkers blend, which the block copies to shared memory
(``csrc/spectrum_stage.cuh``).  The program's staging counter (``profiling.rows_counter``)
holds the sum of the unions and the blocks that added to it, read as ``rows_staged`` and
``blocks_staged`` in the first session's columns (``harness/spans.py``).  None where the
session counts no blocks: a program whose counter has no third slot, or no staged launch."""
from gpubench.harness import spans


def per_block(cols):
    blocks = cols.get("blocks_staged")
    return cols["rows_staged"] / blocks if blocks else None


def read(run):
    return spans.read(per_block)
