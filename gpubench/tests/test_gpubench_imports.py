"""Nothing the benchmark runs loads JAX or the JAX package (top-level names compared
whole: ``mcmc_spec_tpu_torch`` begins with ``mcmc_spec_tpu``), and the reference loads
nothing of the program."""
import ast
import subprocess
import sys

import pytest

from gpubench.harness import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "mcmc_spec_tpu"}
PY = sorted(p for p in bench.BENCH.rglob("*.py") if ".cache" not in p.parts)


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=bench.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_readers_and_reference_load_no_jax():
    readers = "".join(f"bench.load_module(bench.BENCH / 'metrics' / '{p.name}', 'm{i}')\n"
                      for i, p in enumerate(sorted((bench.BENCH / "metrics").glob("*.py"))))
    loaded = _loaded("from gpubench.harness import bench, check, control, counts, inputs, "
                     "op_table, readers, trace\nfrom gpubench.drivers import fleet, packing, "
                     "stage2\nfrom gpubench.reference import pack, posterior, sampler\n"
                     "import mcmc_spec_tpu_torch.inference.fleet\n" + readers)
    assert not loaded & FORBIDDEN
    assert "mcmc_spec_tpu_torch" in loaded  # the check itself sees the program


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("from gpubench.reference import pack, posterior, sampler\n"
                     "from gpubench.harness import check, inputs")
    assert "mcmc_spec_tpu_torch" not in loaded and not loaded & FORBIDDEN


@pytest.mark.parametrize("path", PY, ids=lambda p: str(p.relative_to(bench.BENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN
    if "reference" in path.parts:
        assert "mcmc_spec_tpu_torch" not in names
