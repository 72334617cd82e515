"""Fixtures of the benchmark's tests.  Tests that need the card carry the ``card``
marker and take the ``card`` fixture, which decides inside the test whether a CUDA
card is present."""
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 (gpubench/README.md)")
    return torch.device("cuda", 0)


@pytest.fixture
def clean_env():
    """The harness sets the program's variables and cache paths: restore them."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.fixture
def plain_dials(monkeypatch):
    """On CPU tensors the program's kernel wrappers run their plain versions; this makes
    the dispatch take them where a CUDA float32 batch would, with the dials'
    arithmetic (the fused K1 and K5)."""
    import torch

    from mcmc_spec_tpu_torch.inference import batched

    monkeypatch.setattr(batched, "_on_cuda_f32", lambda p: p.dtype == torch.float32)
