"""PyTorch port: ``MCMC_SPEC_COMPILE_CACHE`` and the kernels' build directory (CPU).

A fake ``nvcc`` on ``PATH`` writes the files it is asked for and counts its
calls, so ``runtime.cuda_build.build()`` runs its whole path here: where the
library lands for each value of the variable, that a second build in the same
directory runs no nvcc, that ``off`` builds into a temporary directory gone
when the process exits, and that the directory cannot move once the library
is loaded.  ``utils.flags.enable_persistent_compile_cache`` returns what the
JAX package's returns where both are defined without touching JAX's global
configuration (``0``, ``off`` and empty: None).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from mcmc_spec_tpu.utils import flags as jax_flags  # noqa: E402
from mcmc_spec_tpu_torch.runtime import cuda_build  # noqa: E402
from mcmc_spec_tpu_torch.utils import flags  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# writes the file named after -o and appends its arguments to a file, one line a call
FAKE_NVCC = """#!/bin/sh
echo "$@" >> '{calls}'
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then echo "fake" > "$a"; fi
  prev="$a"
done
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A fake nvcc first on PATH; returns a function giving its number of calls.  The
    build directory's module state starts unset and is restored after the test."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "nvcc_calls.txt"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(calls=calls))
    nvcc.chmod(0o755)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    for name in ("_chosen", "_temporary", "_loaded"):
        monkeypatch.setattr(cuda_build, name, None)
    cuda_build.load.cache_clear()
    yield lambda: len(calls.read_text().splitlines()) if calls.exists() else 0
    cuda_build.load.cache_clear()


def test_named_directory_builds_there_once(fake_nvcc, tmp_path, monkeypatch):
    cache = tmp_path / "kernels" / "deeper"
    monkeypatch.setenv("MCMC_SPEC_COMPILE_CACHE", str(cache))
    lib = cuda_build.build()
    assert lib.parent == cache and lib.exists() and lib.name.startswith("libmcmc_spec_kernels_")
    assert lib.with_suffix(".log").exists()
    n = fake_nvcc()
    assert n == len(cuda_build.SOURCES) + 1  # one nvcc a source, then the link
    assert not list(cache.glob("*.o")) and not list(cache.glob("*.tmp"))
    assert cuda_build.build() == lib and fake_nvcc() == n  # the hit: no nvcc
    # the flag names the same directory and returns it
    assert flags.enable_persistent_compile_cache() == str(cache)
    assert flags.enable_persistent_compile_cache() == str(cache)  # idempotent
    assert cuda_build.build() == lib and fake_nvcc() == n


def test_tools_library_builds_apart_at_its_first_use(fake_nvcc, tmp_path, monkeypatch):
    """S13's source is the attribution tools' library alone: building the kernels' library
    runs no nvcc on it, and the tools' library, beside it, one nvcc and the link."""
    monkeypatch.setenv("MCMC_SPEC_COMPILE_CACHE", str(tmp_path / "k"))
    tools = cuda_build.LIBRARIES["tools"]
    assert tools == ("posterior_ablate.cu",) and not set(tools) & set(cuda_build.SOURCES)
    lib = cuda_build.build()
    n = fake_nvcc()
    assert n == len(cuda_build.SOURCES) + 1
    assert "posterior_ablate.cu" not in (tmp_path / "nvcc_calls.txt").read_text()
    other = cuda_build.build("tools")
    assert other.parent == lib.parent and other.name.startswith("libmcmc_spec_tools_")
    assert other != lib and fake_nvcc() == n + len(tools) + 1
    assert cuda_build.build("tools") == other and fake_nvcc() == n + len(tools) + 1


def test_path_argument_stands_in_for_the_variable(fake_nvcc, tmp_path, monkeypatch):
    monkeypatch.delenv("MCMC_SPEC_COMPILE_CACHE", raising=False)
    assert flags.enable_persistent_compile_cache(str(tmp_path / "mine")) == str(tmp_path / "mine")
    assert cuda_build.build().parent == tmp_path / "mine"
    monkeypatch.setenv("MCMC_SPEC_COMPILE_CACHE", "off")  # off wins over a path, as in JAX
    assert flags.enable_persistent_compile_cache(str(tmp_path / "other")) is None


@pytest.mark.parametrize("value", [None, "1", "auto", "AUTO"])
def test_auto_and_unset_are_the_package_build_dir(fake_nvcc, monkeypatch, value):
    if value is None:
        monkeypatch.delenv("MCMC_SPEC_COMPILE_CACHE", raising=False)
    else:
        monkeypatch.setenv("MCMC_SPEC_COMPILE_CACHE", value)
    assert cuda_build.cache_setting() == cuda_build.BUILD_DIR
    assert cuda_build.build_dir() == cuda_build.BUILD_DIR
    assert cuda_build.library_path().parent == cuda_build.BUILD_DIR
    assert flags.enable_persistent_compile_cache() == str(cuda_build.BUILD_DIR)
    assert fake_nvcc() == 0


@pytest.mark.parametrize("value", ["0", "off", "OFF", ""])
def test_off_returns_none_as_jax_does(fake_nvcc, monkeypatch, value):
    monkeypatch.setenv("MCMC_SPEC_COMPILE_CACHE", value)
    assert jax_flags.enable_persistent_compile_cache() is None
    assert flags.enable_persistent_compile_cache() is None
    d = cuda_build.build_dir()
    assert d != cuda_build.BUILD_DIR and d.is_dir() and not list(d.iterdir())
    assert flags.enable_persistent_compile_cache() is None and cuda_build.build_dir() == d


def test_off_builds_into_a_directory_gone_at_exit(fake_nvcc, tmp_path):
    """Two processes with the cache off: each runs nvcc into its own temporary directory,
    which is gone after the process exits."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        from mcmc_spec_tpu_torch.runtime import cuda_build
        lib = cuda_build.build()
        assert lib.exists() and lib.parent != cuda_build.BUILD_DIR
        assert cuda_build.build() == lib
        print(lib)
    """)
    env = dict(os.environ, MCMC_SPEC_COMPILE_CACHE="off")
    libs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", code, str(REPO)], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        libs.append(Path(proc.stdout.strip().splitlines()[-1]))
    assert libs[0].parent != libs[1].parent
    assert not libs[0].parent.exists() and not libs[1].parent.exists()
    assert fake_nvcc() == 2 * (len(cuda_build.SOURCES) + 1)


def test_directory_cannot_move_after_load(fake_nvcc, tmp_path, monkeypatch):
    monkeypatch.setenv("MCMC_SPEC_COMPILE_CACHE", str(tmp_path / "a"))
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: ("loaded", path))
    assert cuda_build.load() == ("loaded", str(cuda_build.library_path()))
    assert flags.enable_persistent_compile_cache() == str(tmp_path / "a")  # the same: fine
    with pytest.raises(RuntimeError, match="already loaded"):
        flags.enable_persistent_compile_cache(str(tmp_path / "b"))
    monkeypatch.setenv("MCMC_SPEC_COMPILE_CACHE", "off")
    with pytest.raises(RuntimeError, match="already loaded"):
        flags.enable_persistent_compile_cache()
    # the library keeps its directory whatever the variable says now
    monkeypatch.setenv("MCMC_SPEC_COMPILE_CACHE", str(tmp_path / "c"))
    assert cuda_build.library_path().parent == tmp_path / "a"


def test_concurrent_cold_builds_share_a_directory(fake_nvcc, tmp_path, monkeypatch):
    """Ranks that start cold in one directory each build with their own object names and
    rename the library into place: the directory ends with one library and no objects."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        from mcmc_spec_tpu_torch.runtime import cuda_build
        print(cuda_build.build())
    """)
    env = dict(os.environ, MCMC_SPEC_COMPILE_CACHE=str(tmp_path / "shared"))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(REPO)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    libs = {o[0].strip() for o in outs}
    assert len(libs) == 1
    shared = tmp_path / "shared"
    assert [p.name for p in shared.glob("*.so")] == [Path(libs.pop()).name]
    assert not list(shared.glob("*.o")) and not list(shared.glob("*.tmp"))


def test_cli_sets_the_cache_before_the_first_dispatch(monkeypatch):
    """``cli.main`` calls the flag after parsing its arguments, before any config is read."""
    from mcmc_spec_tpu_torch import cli

    seen = []

    def fake_enable():
        seen.append("cache")
        return None

    def stop(path):
        seen.append("config")
        raise SystemExit(0)

    monkeypatch.setattr(cli, "enable_persistent_compile_cache", fake_enable)
    monkeypatch.setattr(cli.FitConfig, "from_file", staticmethod(stop))
    with pytest.raises(SystemExit):
        cli.main(["cli", "-f", "param.txt", "-o", "True", "-e", "True", "--noplots",
                  "--device", "cpu"])
    assert seen == ["cache", "config"]
