"""The mesh of ranks for walker and spectral sharding (counterpart of ``mcmc_spec_tpu/parallel/mesh.py``).

JAX lays its ``(walkers, spec)`` mesh over the devices of one process.  Here a
mesh is a layout of the ``W x S`` ranks of the default ``torch.distributed``
process group, walker-major (``rank = w S + s``, as JAX reshapes its device
list), each rank computing on its own device.  Two kinds of subgroups carry
the collectives:

* a rank's **walker group**, the W ranks that share its spec index: the
  stretch move's complement gather, the accept count and the chain gathers;
* its **spec group**, the S ranks that share its walker index: the spectrum
  term's count and partial-sum all-reduces.

``walker_sharding`` and ``replicated`` of the JAX module are placements of
arrays on a mesh; here a rank holds its share of the walkers and of the data
axis itself (``parallel.sharding``, ``parallel.spec_shard``), so the mesh
carries their meaning.  The backend belongs to whoever initialised the
process group (the CLI, a test, ``chip_smoke.py``): NCCL with one card per
rank, or gloo.

Every collective of the sharded paths goes through ``all_reduce`` and
``all_gather`` here, which count each call by op in ``COLLECTIVES``: the
census counterpart of the kernels' launch counts (``ops.cuda_kernels``).
A mesh of one rank runs the same collectives on its group of one, so the
census does not depend on the mesh size.

A fleet (many targets, ``fleet_pipeline``) lays the ranks out as a
``targets x walkers`` mesh instead (``make_fleet_mesh``), target-major
(``rank = t W + w``), as JAX reshapes its device list to ``(t_ax, w_ax)``:

* a rank's **walker group**, the W ranks that share its block of targets: the
  stretch move's complement gather and, first of the chain's two gathers for
  the host, the chain's;
* its **target group**, the T ranks that share its walker index: only the
  second gather of the chain.

The accept count is summed over the whole mesh (the default group).
"""
from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any

import torch
import torch.distributed as dist

# collectives issued, by op, since the last reset_collectives()
COLLECTIVES = {"all_reduce_sum": 0, "all_reduce_min": 0, "all_gather": 0, "barrier": 0}
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


def parse_wxs(mesh) -> tuple[int, int] | None:
    """Parse a ``"WxS"`` 2-D mesh string into ``(walkers, spec)`` counts.

    Returns ``None`` when ``mesh`` is not WxS-shaped at all (not a string, or
    not digits-and-'x'), so callers can fall through to the other mesh
    spellings (``"auto"``, a :class:`Mesh`, falsy).  Raises ``ValueError`` for
    WxS-shaped but malformed strings (``"0x2"``, ``"4x"``, ``"2x2x2"``).  The
    single parser behind ``cli.py --mesh`` and ``pipeline.resolve_mesh``.
    """
    if not (isinstance(mesh, str) and "x" in mesh and mesh.replace("x", "").isdigit()):
        return None
    parts = mesh.split("x")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        raise ValueError(
            f"mesh must be WxS with two positive integers (e.g. 4x2), got {mesh!r}"
        )
    w, s = int(parts[0]), int(parts[1])
    if w < 1 or s < 1:
        raise ValueError(
            f"mesh {mesh!r}: both walker and spec counts must be >= 1"
        )
    return w, s


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``walkers x spec`` layout of the process group's ranks.

    ``axis_names`` is ``("walkers", "spec")`` for a WxS mesh (the spectral-sharded
    path, whatever S) and ``("walkers",)`` for a walker mesh (S = 1).
    """

    walkers: int
    spec: int
    rank: int
    device: torch.device
    axis_names: tuple
    walker_group: Any
    spec_group: Any

    @property
    def w_index(self) -> int:
        return self.rank // self.spec

    @property
    def s_index(self) -> int:
        return self.rank % self.spec

    @property
    def shape(self) -> dict:
        return {"walkers": self.walkers, "spec": self.spec}


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """This rank's place in a ``targets x walkers`` layout of the process group's ranks.

    A class of its own rather than a :class:`Mesh`: the fleet's other axis is the
    targets', not the data axis's, and ``Mesh.s_index``/``spec_group`` would name it
    wrongly.  ``walkers``, ``w_index`` and ``walker_group`` mean what they mean on a
    :class:`Mesh`, so ``parallel.sharding.walker_share`` takes either.
    """

    targets: int
    walkers: int
    rank: int
    device: torch.device
    walker_group: Any
    target_group: Any
    axis_names = ("targets", "walkers")

    @property
    def t_index(self) -> int:
        return self.rank // self.walkers

    @property
    def w_index(self) -> int:
        return self.rank % self.walkers

    @property
    def shape(self) -> dict:
        return {"targets": self.targets, "walkers": self.walkers}


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device=None) -> torch.device:
    """The device a rank computes on: ``cuda:LOCAL_RANK`` for ``"cuda"`` (the default),
    the CPU for ``"cpu"``, an indexed device as given."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return d


def make_mesh(walkers: int, spec: int = 1, device=None,
              axis_names=("walkers", "spec")) -> Mesh:
    """The ``walkers x spec`` mesh over the ranks of the initialised default group.

    Every rank must call it, with the same arguments and in the same order as
    its other ``dist.new_group`` calls: each rank creates every subgroup.
    Raises ``ValueError`` where ``walkers * spec`` is not the world size.
    ``device``: where this rank computes (``rank_device``).
    """
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialised torch.distributed process group "
                         "(torchrun, or dist.init_process_group)")
    rank, size = world()
    if walkers * spec != size:
        raise ValueError(f"a {walkers}x{spec} mesh needs {walkers * spec} ranks, the process "
                         f"group has {size}")
    walker_groups = [dist.new_group([w * spec + s for w in range(walkers)]) for s in range(spec)]
    spec_groups = [dist.new_group([w * spec + s for s in range(spec)]) for w in range(walkers)]
    return Mesh(walkers, spec, rank, rank_device(device), tuple(axis_names),
                walker_groups[rank % spec], spec_groups[rank // spec])


def make_fleet_mesh(targets: int, walkers: int, device=None) -> FleetMesh:
    """The ``targets x walkers`` mesh over the ranks of the initialised default group,
    target-major (``rank = t * walkers + w``).  Every rank must call it, as ``make_mesh``; raises ``ValueError``
    where ``targets * walkers`` is not the world size."""
    if not dist.is_initialized():
        raise ValueError("make_fleet_mesh needs an initialised torch.distributed process "
                         "group (torchrun, or dist.init_process_group)")
    rank, size = world()
    if targets * walkers != size:
        raise ValueError(f"a {targets}x{walkers} fleet mesh needs {targets * walkers} ranks, "
                         f"the process group has {size}")
    walker_groups = [dist.new_group([t * walkers + w for w in range(walkers)])
                     for t in range(targets)]
    target_groups = [dist.new_group([t * walkers + w for t in range(targets)])
                     for w in range(walkers)]
    return FleetMesh(targets, walkers, rank, rank_device(device),
                     walker_groups[rank // walkers], target_groups[rank % walkers])


def free_port() -> int:
    """A free TCP port on this host, for a process group's ``tcp://127.0.0.1`` address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the collectives and their census


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def collective_counts() -> dict:
    return dict(COLLECTIVES)


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` summed (``op="sum"``) or minimised (``"min"``) over ``group``; returns the
    reduced tensor (``t`` itself where it is contiguous)."""
    t = t.contiguous()
    dist.all_reduce(t, op=_OPS[op], group=group)
    COLLECTIVES[f"all_reduce_{op}"] += 1
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` of ``group``, concatenated along ``dim`` in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def barrier() -> None:
    """Every rank of the default group waits for the others (a no-op without a group of
    several ranks): an all-reduce of one element where the backend takes it, on this
    process's current card under NCCL and on the CPU under gloo."""
    if world()[1] <= 1:
        return
    nccl = dist.get_backend() == "nccl"
    dist.all_reduce(torch.zeros(1, device=f"cuda:{torch.cuda.current_device()}" if nccl
                                else "cpu"))
    COLLECTIVES["barrier"] += 1
