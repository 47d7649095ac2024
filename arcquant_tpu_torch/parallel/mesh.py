"""Process groups for tensor parallelism (counterpart of
``arcquant_tpu/parallel/mesh.py``).

JAX runs one program over a mesh of devices; PyTorch runs one process a
rank, each holding only its own shard, and the ranks meet in
``torch.distributed`` collectives. ``launch`` starts the ranks:

  - spawned with ``torch.multiprocessing`` (start method ``spawn``), the
    ranks meeting at a ``file://`` rendezvous in a temporary directory
    (no network); the parent builds the CUDA library first, so no two
    ranks run nvcc into ``build/`` at once;
  - or, under ``torchrun`` (RANK and WORLD_SIZE set), in this process as
    the rank torchrun made it, meeting at ``env://``.

The backend is the caller's choice and never switches by itself:

  - ``nccl``: rank r runs on ``cuda:r`` (one card a rank; fewer cards
    than ranks raises);
  - ``gloo``: on the CPU (``cpu=True``), or with every rank on
    ``cuda:0``, the kernels on the card and the collectives' payloads
    carried through the host. Gloo's collectives cannot be captured in
    a CUDA graph, so an engine over gloo decodes eagerly.

Only dp = 1 is ported: a data-parallel axis raises (ROADMAP queue 1
item 8).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# A collective that waits longer than this fails instead of hanging.
TIMEOUT = datetime.timedelta(seconds=600)


class CommStats:
    """The all_reduces a rank made, by op ("sum", "max"), and with
    ``timed`` their host seconds (the device synchronized before and
    after each call, so the time includes waiting for the other ranks)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls = {"sum": 0, "max": 0}
        self.seconds = 0.0

    def snapshot(self) -> tuple:
        return dict(self.calls), self.seconds


@dataclass(frozen=True)
class TPContext:
    """This process's place in the TP group: tp ranks, its rank, the
    process group (None: the default one), the backend, the device its
    shard lives on, and the counts of its collectives."""
    tp: int
    rank: int
    group: Optional[object]
    backend: str
    device: torch.device
    comm: CommStats = field(default_factory=CommStats, compare=False)


def rank_device(backend: str, rank: int, cpu: bool = False) -> torch.device:
    """The device of `rank`: the CPU when asked, cuda:rank under nccl,
    cuda:0 under gloo."""
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else 0)


def check_backend(backend: str, tp: int, cpu: bool = False) -> None:
    """Raise unless `backend` can run `tp` ranks on this machine."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and cpu:
        raise ValueError("the nccl backend runs on CUDA devices only; use "
                         "the gloo backend on the CPU")
    if cpu:
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and cards < tp:
        raise RuntimeError(
            f"nccl needs one CUDA device a rank: {tp} ranks, {cards} "
            "device(s); use the gloo backend to run every rank on cuda:0")
    if cards == 0:
        raise RuntimeError("torch sees no CUDA device; pass cpu=True (--cpu) "
                           "to run the ranks on the CPU")


def init_tp(tp: int, rank: int, backend: str, init_method: str,
            cpu: bool = False) -> TPContext:
    """Join the process group as `rank` of `tp` and return its context;
    on the card, the rank's device becomes the current one."""
    device = rank_device(backend, rank, cpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=tp, rank=rank, timeout=TIMEOUT)
    return TPContext(tp, rank, None, backend, device)


def make_mesh(dp: int = 1, tp: Optional[int] = None,
              cpu: bool = False) -> TPContext:
    """The TP context of this process in the initialized default group
    (``launch`` or ``init_tp`` joined it): tp defaults to every rank."""
    if dp != 1:
        raise NotImplementedError(
            f"dp={dp}: a data-parallel axis is not ported (ROADMAP queue 1 "
            "item 8)")
    world = dist.get_world_size()
    tp = world if tp is None else tp
    if tp != world:
        raise ValueError(f"tp={tp} must be the group's {world} ranks")
    backend = dist.get_backend()
    rank = dist.get_rank()
    return TPContext(tp, rank, None, backend,
                     rank_device(backend, rank, cpu))


def _rank_entry(rank: int, fn: Callable, tp: int, backend: str, cpu: bool,
                init_method: str, outdir: str, args: Sequence) -> None:
    ctx = init_tp(tp, rank, backend, init_method, cpu)
    try:
        result = fn(ctx, *args)
        torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, tp: int, backend: str = "nccl", cpu: bool = False,
           args: Sequence = ()) -> List:
    """Run fn(ctx, *args) on `tp` ranks and return their results in rank
    order (each picklable by torch.save). A rank that raises stops the
    others and raises here. Under torchrun this process runs its own
    rank only and the list holds its result alone."""
    check_backend(backend, tp, cpu)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != tp:
            raise ValueError(f"tp={tp} under torchrun's WORLD_SIZE="
                             f"{os.environ['WORLD_SIZE']}")
        ctx = init_tp(tp, int(os.environ["RANK"]), backend, "env://", cpu)
        try:
            return [fn(ctx, *args)]
        finally:
            dist.destroy_process_group()
    if not cpu:
        from ..kernels import _build
        _build.library()
    work = tempfile.mkdtemp(prefix="arcquant_tp_")
    try:
        init = "file://" + os.path.join(work, "rendezvous")
        torch.multiprocessing.spawn(
            _rank_entry, args=(fn, tp, backend, cpu, init, work, tuple(args)),
            nprocs=tp, join=True, start_method="spawn")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(tp)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
