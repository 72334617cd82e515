"""Result files + chain checkpointing.

Artifact compatibility with the reference so its downstream tooling keeps
working: ``{dirname}/samples.txt`` (flat chain, ``mft6.py:1529-1531``),
``optimize_res.txt``/``optimize_cs.txt`` (stage-1 best fits, ``mft6.py:
1760-1763``), per-walker ``params{n}.txt``/``chisq{n}.txt`` traces
(``mft6.py:1105-1115``), ``{fname}_autocorr.txt`` (``mft6.py:1515-1516``),
and burn-in/results coordinate dumps every ``nthin`` steps.

Checkpointing (absent in the reference beyond those text files) stores the
full sampler state — coordinates, log-probs, RNG state, step index — as npz so
an interrupted chain resumes exactly.

A copy of ``mcmc_spec_tpu.io.results`` with the npz backend only.  The
checkpoint's ``key`` field holds the sampler's ``torch.Generator`` state
(``Generator.get_state()`` as uint8), so a resumed chain continues the same
draws.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


def _pandas_or_none():
    try:
        import pandas as pd
        return pd
    except ImportError:
        return None


def write_sample_block(f, arr: np.ndarray, pd=None):
    """One block of ``samples.txt`` rows to an open handle.

    THE format-critical writer: every samples.txt producer goes through
    this single helper so the bytes cannot diverge between producers.  pandas' C csv writer is ~5x ``np.savetxt``'s Python row loop
    at GB-scale; values are shortest-roundtrip (bit-identical doubles on
    ``np.genfromtxt`` read-back, tests/test_io.py).  ``na_rep``: to_csv
    writes NaN as an EMPTY field by default, which np.genfromtxt reads as
    a short row ("got N columns instead of M"); np.savetxt wrote 'nan',
    so match it for diverged-walker rows.
    """
    arr = np.asarray(arr)
    if pd is not None:
        pd.DataFrame(arr).to_csv(f, sep=" ", header=False, index=False,
                                 na_rep="nan")
    else:
        np.savetxt(f, arr)


def write_samples(dirname: str, samples: np.ndarray):
    """Flat-chain ``samples.txt`` in the reference's np.savetxt format.

    At production ensemble sizes the file is GB-scale text (a 9x4096-walker
    config-5 fleet writes ~11 GB across targets); see
    :func:`write_sample_block` for the format contract.
    """
    path = os.path.join(dirname, "samples.txt")
    with open(path, "w") as f:
        write_sample_block(f, samples, _pandas_or_none())


def write_samples_streamed(dirname: str, blocks) -> int:
    """``samples.txt`` from an iterable of [rows, ndim] blocks, O(block) RAM.

    The streaming write for production-scale chains (a config-5 fleet chain is
    ~13 GB; concatenating it for one :func:`write_samples` call holds twice
    that).  Writes the bytes of :func:`write_samples` on the concatenated
    blocks (both go through :func:`write_sample_block`).  Returns the number
    of rows written.
    """
    path = os.path.join(dirname, "samples.txt")
    n = 0
    pd = _pandas_or_none()
    with open(path, "w") as f:
        for b in blocks:
            arr = np.asarray(b)
            write_sample_block(f, arr, pd)
            n += len(arr)
    return n


def read_samples(dirname: str) -> np.ndarray:
    """Read ``samples.txt`` back (reference format).

    pandas' C parser is ~20x ``np.genfromtxt`` on the GB-scale production
    files; both parse the same whitespace-delimited float rows ('nan' for
    diverged walkers).
    """
    path = os.path.join(dirname, "samples.txt")
    try:
        import pandas as pd

        # float_precision: pandas' default parser (xstrtod) is NOT
        # round-trip accurate; "round_trip" matches np.genfromtxt (the
        # reference tooling's reader) bit for bit
        return pd.read_csv(path, sep=r"\s+", header=None, dtype=np.float64,
                           float_precision="round_trip").to_numpy()
    except ImportError:
        return np.genfromtxt(path)


def write_optimize_results(dirname: str, params: np.ndarray, chis: np.ndarray):
    """Append stage-1 results like the reference's optimizer fan-out."""
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "optimize_res.txt"), "a") as f:
        for row in np.asarray(params):
            f.write(" ".join(str(v) for v in row) + "\n")
    with open(os.path.join(dirname, "optimize_cs.txt"), "a") as f:
        for c in np.asarray(chis):
            f.write(str(c) + "\n")


def read_optimize_results(dirname: str):
    chis = np.genfromtxt(os.path.join(dirname, "optimize_cs.txt"))
    pars = np.genfromtxt(os.path.join(dirname, "optimize_res.txt"))
    return np.atleast_1d(chis), np.atleast_2d(pars)


def write_walker_traces(dirname: str, trace_params: np.ndarray, trace_chi: np.ndarray):
    """Per-walker ``params{n}.txt``/``chisq{n}.txt`` trace files.

    ``trace_params [n_snap, nw, ndim]``, ``trace_chi [n_snap, nw]``.
    """
    os.makedirs(dirname, exist_ok=True)
    n_snap, nw, ndim = np.asarray(trace_params).shape
    for w in range(nw):
        with open(os.path.join(dirname, f"params{w}.txt"), "a") as f:
            for s in range(n_snap):
                f.write(" ".join(str(v) for v in np.asarray(trace_params)[s, w]) + "\n")
        with open(os.path.join(dirname, f"chisq{w}.txt"), "a") as f:
            for s in range(n_snap):
                f.write(f"{np.asarray(trace_chi)[s, w]} {np.asarray(trace_chi)[s, w]}\n")


def append_autocorr(dirname: str, fname: str, macl: float):
    with open(os.path.join(dirname, f"{fname}_autocorr.txt"), "a") as f:
        f.write(str(macl) + "\n")


def dump_coords(dirname: str, fname: str, step: int, coords: np.ndarray, stage: str = "results"):
    """Thinned coordinate dumps (``{fname}_{n}_burnin.txt`` / ``_results.txt``)."""
    path = os.path.join(dirname, f"{fname}_{step}_{stage}.txt")
    with open(path, "ab") as f:
        f.write(b"\n")
        np.savetxt(f, np.asarray(coords))


class ChainStore:
    """Append-only chunked chain persistence.

    Each chunk lands once as its own ``chunk_{n:05d}.npy`` (O(n) total I/O
    over a run) and resume reconstructs the chain by concatenation.  The
    sampler state (coords/key/step) is in :class:`Checkpoint`.
    """

    def __init__(self, dirname: str, name: str = "chain_chunks"):
        self.path = os.path.join(dirname, name)

    def _chunk_path(self, n: int) -> str:
        return os.path.join(self.path, f"chunk_{n:05d}.npy")

    def append(self, n: int, chunk: np.ndarray):
        """Write chunk ``n`` (idempotent: a re-run of the same chunk overwrites)."""
        os.makedirs(self.path, exist_ok=True)
        # np.save appends .npy to names lacking it, so the tmp must end in .npy
        tmp = os.path.join(self.path, f"tmp_{n:05d}.npy")
        np.save(tmp, np.asarray(chunk))
        os.replace(tmp, self._chunk_path(n))

    def chunk_ids(self):
        if not os.path.isdir(self.path):
            return []
        ids = []
        for f in sorted(os.listdir(self.path)):
            if f.startswith("chunk_") and f.endswith(".npy"):
                ids.append(int(f[len("chunk_"):-len(".npy")]))
        return ids

    def has_chunks(self, n_chunks: int) -> bool:
        """True iff chunks 0..n_chunks-1 all exist (contiguity without
        loading anything — the resume guards use this before committing to
        the streamed read path)."""
        ids = [i for i in self.chunk_ids() if i < n_chunks]
        return ids == list(range(n_chunks))

    def iter_chunks(self, n_chunks: Optional[int] = None):
        """Yield chunks 0..n_chunks-1 one at a time (all when None).

        O(chunk) memory — the streamed counterpart of :meth:`load_upto` for
        production-scale chains.  Raises on a gapped store (same contract:
        silently yielding a subset would drop part of the chain).
        """
        ids = self.chunk_ids()
        if n_chunks is not None:
            ids = [i for i in ids if i < n_chunks]
        want = n_chunks if n_chunks is not None else len(ids)
        if ids != list(range(want)):
            raise ValueError(
                f"chain store {self.path} is missing chunks: have {ids}, "
                f"want 0..{want - 1}"
            )
        for i in ids:
            yield np.load(self._chunk_path(i))

    def load_upto(self, n_chunks: Optional[int] = None) -> Optional[np.ndarray]:
        """Concatenate chunks 0..n_chunks-1 (all when None); None if empty
        OR if any chunk in the range is missing — a gap means the store and
        the checkpoint disagree, and concatenating the subset would silently
        drop part of the pre-crash chain (the resume guards treat None as
        "history unavailable" and restart loudly)."""
        ids = self.chunk_ids()
        if n_chunks is not None:
            ids = [i for i in ids if i < n_chunks]
        if not ids:
            return None
        want = n_chunks if n_chunks is not None else len(ids)
        if ids != list(range(want)):
            return None
        return np.concatenate([np.load(self._chunk_path(i)) for i in ids], axis=0)

    def clear(self):
        import shutil

        if os.path.isdir(self.path):
            shutil.rmtree(self.path)


@dataclasses.dataclass
class Checkpoint:
    """Exact-resume sampler checkpoint (the chain itself is in :class:`ChainStore`)."""

    coords: np.ndarray
    log_prob: np.ndarray
    key: np.ndarray  # torch.Generator.get_state() bytes
    step: int
    n_accept: int = 0
    config_tag: str = ""  # guards against resuming a different run's state

    def save(self, path: str):
        arrays = dict(
            coords=np.asarray(self.coords),
            log_prob=np.asarray(self.log_prob),
            key=np.asarray(self.key),
            step=self.step,
            n_accept=self.n_accept,
            config_tag=np.asarray(self.config_tag),
        )
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)  # atomic: a crash mid-write never corrupts

    @classmethod
    def load(cls, path: str) -> "Checkpoint":
        z = np.load(path)
        return cls(
            coords=z["coords"],
            log_prob=z["log_prob"],
            key=z["key"],
            step=int(z["step"]),
            n_accept=int(z["n_accept"]),
            config_tag=str(z["config_tag"]) if "config_tag" in z.files else "",
        )

    @classmethod
    def maybe_load(cls, path: str) -> Optional["Checkpoint"]:
        return cls.load(path) if os.path.exists(path) else None


# --- checkpoint backend ------------------------------------------------------
#
# The atomic npz above is the only backend.  The JAX package's
# ``MCMC_SPEC_CKPT_BACKEND=orbax`` (async, sharded-array checkpoints) is not
# ported; asking for it raises rather than silently writing npz.


def _ckpt_backend() -> str:
    mode = os.environ.get("MCMC_SPEC_CKPT_BACKEND", "npz").lower()
    if mode == "orbax":
        raise ValueError(
            "MCMC_SPEC_CKPT_BACKEND=orbax: the orbax checkpoint backend is not "
            "ported to mcmc_spec_tpu_torch; use npz (the default)")
    if mode != "npz":
        raise ValueError(f"bad MCMC_SPEC_CKPT_BACKEND={mode!r}")
    return mode


def save_checkpoint(ck: "Checkpoint", path: str) -> None:
    _ckpt_backend()
    ck.save(path)


def maybe_load_checkpoint(path: str) -> Optional["Checkpoint"]:
    _ckpt_backend()
    return Checkpoint.maybe_load(path)


def remove_checkpoint(path: str) -> None:
    """Completion cleanup: a finished run's checkpoint must not resume the next."""
    if os.path.exists(path):
        os.remove(path)
