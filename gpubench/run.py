"""The benchmark's command: ``python3 gpubench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout (``gpubench/README.md``)."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from gpubench.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
