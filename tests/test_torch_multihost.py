"""Multi-host init of arcquant_tpu_torch (parallel/mesh.py multihost_init),
the counterpart of the JAX package's test_multihost.py: two separate
Python processes join one process group over tcp on a loopback port
(gloo, the CPU), then make a cross-process SUM and the row-parallel
matmul; multihost_init is a no-op once a group exists and with one
process. The processes run arcquant_tpu_torch.testing.multihost_worker,
which imports no JAX.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from arcquant_tpu_torch.parallel import multihost_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_group_collectives():
    """Both processes print "proc <pid> ok": the SUM over both of 28, the
    row-parallel matmul equal to the whole product, and a second
    multihost_init returning False."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = ("from arcquant_tpu_torch.testing import multihost_worker; "
            f"multihost_worker({coord!r}, {{}})")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(i)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"proc {i} ok" in out


def test_multihost_init_noop_single_process():
    """One process (or none named) joins nothing: False, no group."""
    assert not dist.is_initialized()
    assert multihost_init(coordinator="127.0.0.1:1", num_processes=1,
                          process_id=0) is False
    assert multihost_init() is False
    assert not dist.is_initialized()


def test_multihost_init_refuses_missing_address():
    with pytest.raises(ValueError, match="coordinator"):
        multihost_init(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="backend"):
        multihost_init("127.0.0.1:1", 2, 0, backend="mpi")
