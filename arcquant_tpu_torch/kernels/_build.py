"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

All sources compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``: one ``nvcc -c`` per
source, all started together, then one link. The build runs at first
use, writes into ``build/arcquant_tpu_torch/`` at the repository root
(listed in ``.gitignore``) and is redone whenever the sources' hash
changes. A missing ``nvcc`` or a failed build raises: no kernel wrapper
ever falls back to its plain PyTorch version on a CUDA tensor.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; ``Kernel.__call__`` raises
if that is not 0 and otherwise counts the launch (``GraphLaunches``
keeps the counts right under CUDA graph capture and replay).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arcquant_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# Every Kernel, in the order the modules made them.
KERNELS: list = []

# Toolkit roots searched after PATH and CUDA_HOME.
CUDA_ROOTS = ("/usr/local/cuda",)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or CUDA_ROOTS."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of arcquant_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library. Raises
    RuntimeError when nvcc is missing or the build fails."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libarcquant_kernels_{source_hash()}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        objs, procs = [], []
        for cu in sorted(CSRC_DIR.glob("*.cu")):
            obj = tmp.with_name(f"{tmp.name}.{cu.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o",
                   str(obj), str(cu)]
            objs.append(str(obj))
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        runs = [(c, p.communicate()[0], p.returncode) for c, p in procs]
        if all(rc == 0 for _, _, rc in runs):
            r = subprocess.run(cmd, capture_output=True, text=True)
            runs.append((cmd, r.stdout + r.stderr, r.returncode))
        log = BUILD_DIR / "build.log"
        log.write_text("".join(" ".join(c) + "\n" + out + f"rc={rc}\n"
                               for c, out, rc in runs)
                       + f"seconds={time.perf_counter() - t0:.1f}\n")
        for o in objs:
            Path(o).unlink(missing_ok=True)
        bad = [out for _, out, rc in runs if rc != 0]
        if bad:
            raise RuntimeError(f"nvcc failed, see {log}:\n"
                               + bad[0][-4000:])
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


class Kernel:
    """One C entry point of the library, with its launch count.

    ``launches`` is incremented once per successful call, that is once
    per launch of the kernel by its wrapper. A wrapper that passes ``m``
    (its row count) also counts the launch under that M in ``by_m``.
    Two other things touch them: ``reset``, and ``GraphLaunches``. A call
    made while a CUDA graph is captured enqueues the kernel into the
    graph and launches nothing, so GraphLaunches takes that count back
    out when the capture ends and adds it again at every replay of the
    graph: the counts stay launches on the card."""

    def __init__(self, name: str, symbol: str, argtypes):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.by_m = collections.Counter()
        KERNELS.append(self)

    def reset(self) -> None:
        """Set the counts to 0."""
        self.launches = 0
        self.by_m.clear()

    def __call__(self, *args, m=None) -> None:
        fn = getattr(library(), self.symbol)
        fn.argtypes = self.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"CUDA kernel {self.symbol} failed to launch: "
                f"cudaError {rc}")
        self.launches += 1
        if m is not None:
            self.by_m[m] += 1


class GraphLaunches:
    """The kernel launches that one captured CUDA graph holds.

    Enter it around the capture: the counts the wrappers add there
    (calls that only enqueue into the graph) are taken back out when it
    exits and kept as the graph's launches; ``replayed(n)`` adds them n
    times, once for each replay of the graph."""

    def __init__(self):
        self.delta = []              # (kernel, launches, by_m) per kernel

    def __enter__(self) -> "GraphLaunches":
        self._before = [(k, k.launches, collections.Counter(k.by_m))
                        for k in KERNELS]
        return self

    def __exit__(self, *exc) -> bool:
        self.delta = []
        for k, n, by_m in self._before:
            d, dm = k.launches - n, k.by_m - by_m
            if d:
                self.delta.append((k, d, dm))
            k.launches = n
            k.by_m.clear()
            k.by_m.update(by_m)
        return False

    @property
    def total(self) -> int:
        """Launches of one replay."""
        return sum(d for _, d, _ in self.delta)

    def replayed(self, times: int = 1) -> None:
        """Count `times` replays of the graph."""
        for k, d, dm in self.delta:
            k.launches += d * times
            for m, c in dm.items():
                k.by_m[m] += c * times


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float


def ptr(t) -> int:
    """Device pointer of a tensor (None -> NULL)."""
    return 0 if t is None else t.data_ptr()


def require_cuda(name: str, *tensors) -> None:
    for t in tensors:
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got "
                             f"{t.device}")
