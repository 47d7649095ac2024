"""Process groups for the parallel modes (counterpart of
``arcquant_tpu/parallel/mesh.py``).

JAX runs one program over a mesh of devices; PyTorch runs one process a
rank, each holding only its own shard, and the ranks meet in
``torch.distributed`` collectives on explicit groups. ``launch`` starts
the ranks:

  - spawned with ``torch.multiprocessing`` (start method ``spawn``), the
    ranks meeting at a ``file://`` rendezvous in a temporary directory
    (no network); the parent builds the CUDA library first, so no two
    ranks run nvcc into ``build/`` at once;
  - or, under ``torchrun`` (RANK and WORLD_SIZE set), in this process as
    the rank torchrun made it, meeting at ``env://``;
  - or across hosts: each process calls ``multihost_init`` with the
    coordinator's address, then the mode's context maker.

The contexts a rank builds over the default group (every rank calls the
maker, with the same arguments, in the same order, since
``dist.new_group`` must be entered by every rank):

  - ``make_mesh(dp, tp)``: the (dp, tp) mesh, rank r = g * tp + j in dp
    group g at tp index j (JAX's row-major device mesh); a TPContext
    holding the tp group (the ranks of g) and the dp group (the ranks at
    index j);
  - ``make_pp(pp)``: the pipeline's stages, rank s is stage s;
  - ``make_sp(sp)``: the sequence shards, rank i owns shard i.

The backend is the caller's choice and never switches by itself:

  - ``nccl``: rank r runs on ``cuda:r`` (one card a rank; fewer cards
    than ranks raises);
  - ``gloo``: on the CPU (``cpu=True``), or with every rank on
    ``cuda:0``, the kernels on the card and the collectives' payloads
    carried through the host. Gloo's point-to-point send and recv take
    CPU tensors only, so under gloo every payload of a send, recv,
    broadcast or all_gather is staged through a CPU buffer explicitly
    (``Comm``); all_reduce takes the CUDA tensor as it is. Gloo's
    collectives cannot be captured in a CUDA graph, so an engine over
    gloo decodes eagerly.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# A collective that waits longer than this fails instead of hanging.
TIMEOUT = datetime.timedelta(seconds=600)


class CommStats:
    """The collectives a rank made: ``calls`` by op ("sum" and "max" for
    all_reduce; "send", "recv", "broadcast" and "all_gather" from their
    first call on), the payload bytes of the point-to-point and gather
    ops (``nbytes``), and with ``timed`` their host seconds (the device
    synchronized before and after each call, so the time includes
    waiting for the other ranks)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls = {"sum": 0, "max": 0}
        self.nbytes = 0
        self.seconds = 0.0

    def snapshot(self) -> tuple:
        return dict(self.calls), self.seconds, self.nbytes

    def since(self, snap: tuple) -> dict:
        """The calls, ms and bytes since `snap` (a snapshot)."""
        calls0, sec0, bytes0 = snap
        return dict(comm={op: n - calls0.get(op, 0)
                          for op, n in self.calls.items()},
                    comm_ms=(self.seconds - sec0) * 1e3,
                    comm_bytes=self.nbytes - bytes0)


class StepRecords:
    """Step records of a sharded engine (self.mesh's CommStats, self.device,
    the step methods wrapping their work in ``_recorded``):
    ``record_steps()`` makes every later step append to ``steps`` its
    kind, host ms, collectives (calls by op, ms, payload bytes) and a
    digest of its logits, the device synchronized around each step and
    collective."""

    steps: Optional[List[dict]] = None

    def record_steps(self) -> None:
        """Record every later step (``steps``) and time the collectives."""
        self.steps = []
        self.mesh.comm.timed = True

    def _recorded(self, kind: str, fn, *args):
        if self.steps is None:
            return fn(*args)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else lambda *a: None)
        sync(self.device)
        snap = self.mesh.comm.snapshot()
        t0 = time.perf_counter()
        logits, state = fn(*args)
        sync(self.device)
        ms = (time.perf_counter() - t0) * 1e3
        self.steps.append(dict(
            kind=kind, ms=ms, **self.mesh.comm.since(snap),
            digest=hashlib.sha256(logits.float().cpu().numpy().tobytes())
            .hexdigest()))
        return logits, state


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class _Timed:
    """Count one call of `op` (or of each op, as often as a dict of them
    says) in `comm` and its payload bytes, timing it when the stats are
    timed."""

    def __init__(self, comm: CommStats, op, t: torch.Tensor,
                 nbytes: int = 0):
        self.comm, self.t, self.n = comm, t, nbytes
        self.ops = {op: 1} if isinstance(op, str) else op

    def __enter__(self):
        c = self.comm
        for op, n in self.ops.items():
            c.calls[op] = c.calls.get(op, 0) + n
        c.nbytes += self.n
        if c.timed:
            _sync(self.t)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.comm.timed and exc[0] is None:
            _sync(self.t)
            self.comm.seconds += time.perf_counter() - self.t0


class Comm:
    """The collectives of one group, counted in its CommStats: the group
    (None: the default one), its ranks in order (global rank numbers) and
    the backend. Under gloo the payloads of send, recv, broadcast and
    all_gather go through a CPU copy (gloo's send and recv take no CUDA
    tensor), and so do exchange's blocks; all_reduce takes the tensor as
    it is."""

    def __init__(self, group, ranks: Sequence[int], backend: str,
                 stats: CommStats):
        self.group, self.ranks, self.backend = group, tuple(ranks), backend
        self.stats = stats

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """all_reduce(op) of t over the group, in place (none alone)."""
        if len(self.ranks) == 1:
            return t
        with _Timed(self.stats, op, t):
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                            else dist.ReduceOp.MAX, group=self.group)
        return t

    def send(self, t: torch.Tensor, dst: int) -> None:
        """Send t to the group's member at index dst."""
        t = t.contiguous()
        with _Timed(self.stats, "send", t, t.numel() * t.element_size()):
            dist.send(t.cpu() if self._staged(t) else t, self.ranks[dst],
                      group=self.group)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        """A tensor shaped like `like`, received from index src."""
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        buf = torch.empty(out.shape, dtype=out.dtype) if self._staged(
            out) else out
        with _Timed(self.stats, "recv", out, out.numel() * out.element_size()):
            dist.recv(buf, self.ranks[src], group=self.group)
        if buf is not out:
            out.copy_(buf)
        return out

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """t from index src on every member (in place on the others)."""
        if len(self.ranks) == 1:
            return t
        buf = t.cpu() if self._staged(t) else t
        with _Timed(self.stats, "broadcast", t, t.numel() * t.element_size()):
            dist.broadcast(buf, self.ranks[src], group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def exchange(self, blocks: Sequence[torch.Tensor], nxt: int,
                 prev: int) -> List[torch.Tensor]:
        """Send each block to the member at index `nxt` and receive as many
        blocks, shaped alike, from index `prev`, in one batch_isend_irecv
        (a send and a recv a block in the counts)."""
        sends = [b.contiguous() for b in blocks]
        bufs = [b.cpu() if self._staged(b) else b for b in sends]
        recvs = [torch.empty_like(b) for b in bufs]
        ops = ([dist.P2POp(dist.isend, b, self.ranks[nxt], self.group)
                for b in bufs]
               + [dist.P2POp(dist.irecv, b, self.ranks[prev], self.group)
                  for b in recvs])
        with _Timed(self.stats, {"send": len(sends), "recv": len(recvs)},
                    sends[0], sum(b.numel() * b.element_size()
                                  for b in sends)):
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return [r.to(b.device) for r, b in zip(recvs, sends)]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The members' t concatenated on dim 0, in group order."""
        if len(self.ranks) == 1:
            return t
        t = t.contiguous()
        src = t.cpu() if self._staged(t) else t
        parts = [torch.empty_like(src) for _ in self.ranks]
        with _Timed(self.stats, "all_gather", t,
                    t.numel() * t.element_size() * len(self.ranks)):
            dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(t.device)


@dataclass(frozen=True)
class TPContext:
    """This process's place in the (dp, tp) mesh: tp ranks, its rank in
    the tp group, the tp process group (None: the default one), the
    backend, the device its shard lives on, the counts of its
    collectives, and its data-parallel axis: dp groups, this rank's
    group, and the dp process group (the ranks at this tp index)."""
    tp: int
    rank: int
    group: Optional[object]
    backend: str
    device: torch.device
    comm: CommStats = field(default_factory=CommStats, compare=False)
    dp: int = 1
    dp_rank: int = 0
    dp_group: Optional[object] = None
    tp_ranks: Optional[tuple] = None
    dp_ranks: Optional[tuple] = None

    def tp_comm(self) -> Comm:
        ranks = self.tp_ranks or tuple(range(self.tp))
        return Comm(self.group, ranks, self.backend, self.comm)

    def dp_comm(self) -> Comm:
        ranks = self.dp_ranks or (self.rank,)
        return Comm(self.dp_group, ranks, self.backend, self.comm)


@dataclass(frozen=True)
class AxisContext:
    """A rank's place on a one-dimensional axis of ranks (a pipeline's
    stages, a sequence's shards): the axis size, this rank's index, the
    process group and its ranks in order, the backend, the device and the
    counts of its collectives. ``prev`` and ``next`` are the neighbours'
    indices around the ring (the pipeline uses them without the wrap)."""
    size: int
    index: int
    group: Optional[object]
    ranks: tuple
    backend: str
    device: torch.device
    comm: CommStats = field(default_factory=CommStats, compare=False)

    @property
    def prev(self) -> int:
        return (self.index - 1) % self.size

    @property
    def next(self) -> int:
        return (self.index + 1) % self.size

    def comms(self) -> Comm:
        return Comm(self.group, self.ranks, self.backend, self.comm)


class PPContext(AxisContext):
    """A pipeline stage: ``pp`` stages, this rank's ``stage``."""

    @property
    def pp(self) -> int:
        return self.size

    @property
    def stage(self) -> int:
        return self.index


class SPContext(AxisContext):
    """A sequence shard: ``sp`` shards, this rank's ``shard``."""

    @property
    def sp(self) -> int:
        return self.size

    @property
    def shard(self) -> int:
        return self.index


def rank_device(backend: str, rank: int, cpu: bool = False) -> torch.device:
    """The device of `rank`: the CPU when asked, cuda:rank under nccl,
    cuda:0 under gloo."""
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else 0)


def check_backend(backend: str, n: int, cpu: bool = False) -> None:
    """Raise unless `backend` can run `n` ranks on this machine."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and cpu:
        raise ValueError("the nccl backend runs on CUDA devices only; use "
                         "the gloo backend on the CPU")
    if cpu:
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and cards < n:
        raise RuntimeError(
            f"nccl needs one CUDA device a rank: {n} ranks, {cards} "
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


def multihost_init(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: str = "gloo") -> bool:
    """Join the default process group of `num_processes` processes across
    hosts over ``tcp://<coordinator>`` (host:port) as `process_id`, on
    the named backend (gloo unless the caller names nccl; it never
    switches). A no-op, returning False, when a group already exists or
    there is one process, as JAX's ``jax.distributed.initialize`` wrapper
    is; True when it joined. Then ``make_mesh``, ``make_pp`` or
    ``make_sp`` build the mode's groups."""
    if dist.is_initialized() or not num_processes or num_processes <= 1:
        return False
    if coordinator is None or process_id is None:
        raise ValueError("multihost_init needs the coordinator's host:port "
                         "and this process's id")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return True


def _device(cpu: bool) -> torch.device:
    return rank_device(dist.get_backend(), dist.get_rank(), cpu)


def make_mesh(dp: int = 1, tp: Optional[int] = None,
              cpu: bool = False) -> TPContext:
    """This process's TPContext in the (dp, tp) mesh over the initialized
    default group (``launch``, ``init_tp`` or ``multihost_init`` joined
    it): tp defaults to every rank over dp. Every rank builds the tp
    groups, then the dp groups, in group order."""
    world = dist.get_world_size()
    tp = world // dp if tp is None else tp
    if dp < 1 or dp * tp != world:
        raise ValueError(f"dp={dp} x tp={tp} must be the group's {world} "
                         "ranks")
    backend = dist.get_backend()
    rank = dist.get_rank()
    g, j = divmod(rank, tp)
    device = _device(cpu)
    if dp == 1:
        return TPContext(tp, rank, None, backend, device)
    tp_groups = [tuple(range(i * tp, (i + 1) * tp)) for i in range(dp)]
    dp_groups = [tuple(range(i, world, tp)) for i in range(tp)]
    tp_pg = [dist.new_group(list(r)) for r in tp_groups]
    dp_pg = [dist.new_group(list(r)) for r in dp_groups]
    return TPContext(tp, j, tp_pg[g], backend, device, dp=dp, dp_rank=g,
                     dp_group=dp_pg[j], tp_ranks=tp_groups[g],
                     dp_ranks=dp_groups[j])


def _axis(cls, n: Optional[int], cpu: bool):
    world = dist.get_world_size()
    n = world if n is None else n
    if n != world:
        raise ValueError(f"{cls.__name__}: {n} ranks must be the group's "
                         f"{world}")
    return cls(n, dist.get_rank(), None, tuple(range(n)), dist.get_backend(),
               _device(cpu))


def make_pp(pp: Optional[int] = None, cpu: bool = False) -> PPContext:
    """This process's pipeline stage over the default group: rank s is
    stage s of pp (every rank)."""
    return _axis(PPContext, pp, cpu)


def make_sp(sp: Optional[int] = None, cpu: bool = False) -> SPContext:
    """This process's sequence shard over the default group: rank i owns
    shard i of sp (every rank)."""
    return _axis(SPContext, sp, cpu)


def _rank_entry(rank: int, fn: Callable, n: int, backend: str, cpu: bool,
                init_method: str, outdir: str, args: Sequence) -> None:
    ctx = init_tp(n, rank, backend, init_method, cpu)
    try:
        result = fn(ctx, *args)
        torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, backend: str = "nccl", cpu: bool = False,
           args: Sequence = ()) -> List:
    """Run fn(ctx, *args) on `n` ranks and return their results in rank
    order (each picklable by torch.save); ctx is the rank's TPContext over
    all n ranks (tp n), from which fn may build another mode's context
    (make_mesh, make_pp, make_sp). A rank that raises stops the others
    and raises here. Under torchrun this process runs its own rank only
    and the list holds its result alone."""
    check_backend(backend, n, cpu)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise ValueError(f"{n} ranks under torchrun's WORLD_SIZE="
                             f"{os.environ['WORLD_SIZE']}")
        ctx = init_tp(n, int(os.environ["RANK"]), backend, "env://", cpu)
        try:
            return [fn(ctx, *args)]
        finally:
            dist.destroy_process_group()
    if not cpu:
        from ..kernels import _build
        _build.library()
    work = tempfile.mkdtemp(prefix="arcquant_ranks_")
    try:
        init = "file://" + os.path.join(work, "rendezvous")
        torch.multiprocessing.spawn(
            _rank_entry, args=(fn, n, backend, cpu, init, work, tuple(args)),
            nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
