"""The collectives of a group of one rank (parallel/mesh.py ``Comm``) and
the TP engine's captured step over it, in this process: no rank is
spawned and no process group exists.

Under gloo a one-rank group returns at once; under nccl it makes the
call, so that a one-rank engine on one card captures the collectives a
rank of a wider group makes. Here ``torch.distributed`` is replaced by a
stub that counts the calls and computes what one rank gets back (the
operand). On the CPU there is nothing to capture, so the TP engine's
graph path (``cuda_graphs=True``) runs the bodies the card captures
eagerly: they are held bitwise to the eager loop, counted, run under a
dispatch mode that fails on host reads (the MoE block too), and reached
through ``generate``'s rank function under nccl. The card's side is in
tests/test_torch_kernels_gpu.py.
"""

import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from arcquant_tpu_torch import generate
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import EngineConfig, SamplingParams
from arcquant_tpu_torch.models import quantized
from arcquant_tpu_torch.parallel import TPContext, TPInferenceEngine
from arcquant_tpu_torch.parallel import mesh as mesh_mod
from arcquant_tpu_torch.parallel.mesh import CommCapture, CommStats, Comm
from arcquant_tpu_torch.parallel.tp_engine import captures
from arcquant_tpu_torch.testing import TP_EKW, TP_QKW

CPU = torch.device("cpu")
PROMPTS = [[5, 17, 301, 42, 8], [100, 200, 7]]


class StubDist:
    """The torch.distributed calls Comm makes, over a group of one rank:
    each is recorded, and its result is what one rank gets back."""
    ReduceOp = dist.ReduceOp

    def __init__(self):
        self.calls = []

    def all_reduce(self, t, op=dist.ReduceOp.SUM, group=None):
        self.calls.append(("all_reduce", "sum" if op == dist.ReduceOp.SUM
                           else "max"))

    def broadcast(self, t, src, group=None):
        self.calls.append(("broadcast", src))

    def all_gather(self, parts, t, group=None):
        self.calls.append(("all_gather", len(parts)))
        parts[0].copy_(t)


@pytest.fixture
def stub(monkeypatch):
    s = StubDist()
    monkeypatch.setattr(mesh_mod, "dist", s)
    return s


def _comm(backend):
    return Comm(None, (0,), backend, CommStats())


OPS = {
    "sum": lambda c, t: c.all_reduce(t, "sum"),
    "max": lambda c, t: c.all_reduce(t, "max"),
    "broadcast": lambda c, t: c.broadcast(t, 0),
    "all_gather": lambda c, t: c.all_gather(t),
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_one_rank_rule(stub, backend, op):
    """A one-rank group under nccl makes the call (counted in its
    CommStats), under gloo none; the result is the operand either way."""
    c = _comm(backend)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    want = t.clone()
    got = OPS[op](c, t)
    assert torch.equal(got, want)
    if backend == "gloo":
        assert stub.calls == [] and got is t
        assert c.stats.calls == {"sum": 0, "max": 0}
        return
    assert len(stub.calls) == 1
    assert c.stats.calls.get(op) == 1


def test_comm_capture_counts_a_replay(stub):
    """CommCapture takes the calls and bytes counted inside it back out
    of the stats, keeps them (record()), and adds them once a replay."""
    c = _comm("nccl")
    t = torch.ones(4)
    c.all_reduce(t, "sum")
    with CommCapture(c.stats) as cap:
        c.all_reduce(t, "sum")
        c.all_reduce(t, "max")
        c.all_gather(t)
    assert c.stats.calls == {"sum": 1, "max": 0} and c.stats.nbytes == 0
    assert cap.record() == dict(comm={"sum": 1, "max": 1, "all_gather": 1},
                                comm_bytes=16)
    cap.replayed(3)
    assert c.stats.calls == {"sum": 4, "max": 3, "all_gather": 3}
    assert c.stats.nbytes == 48


def test_timed_collective_not_timed_while_capturing(stub, monkeypatch):
    """Timed stats synchronize around a collective, except while a stream
    captures (a synchronize is illegal there); the call counts alike."""
    syncs = []
    monkeypatch.setattr(mesh_mod, "_sync", lambda t: syncs.append(1))
    c = _comm("nccl")
    c.stats.timed = True
    c.all_reduce(torch.ones(2), "sum")
    assert len(syncs) == 2
    monkeypatch.setattr(mesh_mod, "_capturing", lambda t: True)
    seconds = c.stats.seconds
    c.all_reduce(torch.ones(2), "max")
    assert len(syncs) == 2 and c.stats.seconds == seconds
    assert c.stats.calls == {"sum": 1, "max": 1}


@pytest.mark.parametrize("backend,device,asked,want", [
    ("nccl", "cpu", None, True), ("nccl", "cpu", False, False),
    ("gloo", "cpu", None, False), ("gloo", "cpu", True, True),
    ("gloo", "cuda", None, False), ("gloo", "cuda", False, False),
    ("gloo", "cuda", True, ValueError)])
def test_tp_engine_captures(backend, device, asked, want):
    """The TP engine captures by default under nccl; gloo stays eager, and
    a graph under gloo on the card raises (the context needs no card)."""
    ctx = TPContext(1, 0, None, backend, torch.device(device))
    if want is ValueError:
        with pytest.raises(ValueError, match="CUDA graph"):
            captures(ctx, asked)
    else:
        assert captures(ctx, asked) is want


def _engine(backend, name="test-tiny"):
    """A one-rank TP engine (ARC 0.125, seed 3), its backend's default
    cuda_graphs."""
    cfg = get_model_config(name)
    return TPInferenceEngine.dummy(cfg, quantized.identity_calib(cfg, 0.125),
                                   QuantConfig(**TP_QKW),
                                   EngineConfig(**TP_EKW),
                                   TPContext(1, 0, None, backend, CPU),
                                   seed=3)


def _run(eng, sampling=None):
    """Every step's logits and the tokens of a decode_scan after a
    prefill, a decode_step and a verify at W 4, and each step's record."""
    eng.record_steps()
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    first = logits.argmax(-1).to(torch.int32)
    act = torch.ones(2, dtype=torch.bool)
    out = {"prefill": logits}
    out["decode"], state = eng.decode_step(state, first, act)
    vt = torch.stack([out["decode"].argmax(-1).to(torch.int32)]
                     + [torch.tensor([7, 5], dtype=torch.int32)] * 3, 1)
    out["verify"], state = eng.verify_step(state, vt,
                                           torch.tensor([4, 2]))
    out["scan"], state = eng.decode_scan(state, first, act, 4,
                                         sampling=sampling, seed=5)
    out["seq_lens"] = state[2].clone()
    out["steps"] = eng.steps
    eng.steps = None
    return out


@pytest.mark.parametrize("sampling", [None, SamplingParams(0.9, top_k=8)],
                         ids=["greedy", "sampled"])
def test_one_rank_nccl_graph_path_is_the_eager_loop(stub, sampling):
    """One rank under nccl, the graph path (cuda_graphs on by default; on
    the CPU its bodies run eagerly) against one rank under gloo (eager,
    no call): every step's logits and the scan's tokens bitwise; each
    decode step, the scan's replays included, records 2 SUM + 2 MAX a
    layer, and the stub saw as many."""
    graph = _engine("nccl")
    assert graph.cuda_graphs
    eager = _engine("gloo")
    assert not eager.cuda_graphs
    got = _run(graph, sampling)
    want = _run(eager, sampling)
    for k in ("prefill", "decode", "verify", "scan", "seq_lens"):
        assert torch.equal(got[k], want[k]), k
    assert [s["digest"] for s in got["steps"]] == [
        s["digest"] for s in want["steps"]]
    layers = graph.cfg.num_layers
    dec = [s for s in got["steps"] if s["kind"] == "decode"]
    assert len(dec) == 5
    assert all(s["comm"] == {"sum": 2 * layers, "max": 2 * layers}
               for s in dec)
    assert all(s["comm"] == {"sum": 0, "max": 0} for s in want["steps"])
    steps = len(got["steps"])          # prefill, decode, verify, 4 scans
    assert len(stub.calls) == steps * 4 * layers


class NoHostRead(TorchDispatchMode):
    """Raises on the ops that read a device value back to the host."""
    BANNED = (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
              torch.ops.aten.is_nonzero)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.BANNED:
            raise AssertionError(f"host read in the step: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-moe"])
def test_tp_step_reads_nothing_back(stub, name):
    """The TP step's bodies (decode_step, greedy and sampled decode_scan
    and verify_step on the graph path) make no host read, the MoE
    block's (ep_moe_block: routing, the rank's experts, its all_reduces)
    included; MoE's greedy scan equals its eager loop."""
    eng = _engine("nccl", name)
    toks, lens, _ = eng._pad_prompts(PROMPTS)
    logits, state = eng.prefill(eng.new_state(), toks, lens)
    first = logits.argmax(-1).to(torch.int32)
    act = torch.ones(2, dtype=torch.bool)
    with NoHostRead():
        eng.decode_step(state, first, act)
        eng.verify_step(state, torch.stack([first] * 4, 1),
                        torch.tensor([4, 4], dtype=torch.int32))
        scan, _ = eng.decode_scan(state, first, act, 3)
        eng.decode_scan(state, first, act, 2,
                        sampling=SamplingParams(0.8, top_k=8, top_p=0.9),
                        seed=1)
    loop = _engine("gloo", name)
    lg, st = loop.prefill(loop.new_state(), toks, lens)
    loop.decode_step(st, first, act)
    loop.verify_step(st, torch.stack([first] * 4, 1),
                     torch.tensor([4, 4], dtype=torch.int32))
    want, _ = loop.decode_scan(st, first, act, 3)
    assert torch.equal(scan, want)
    assert any(op == "max" for _, op in stub.calls)


def _args(backend):
    argv = ["--model", "test-tiny", "--tp", "1", "--dist_backend", backend,
            "--cpu", "--max_new", "5", "--max_batch", "2",
            "--max_seq_len", "64", "--quant_head"]
    for p in PROMPTS:
        argv += ["--tokens", ",".join(map(str, p))]
    return generate.build_parser().parse_args(argv)


def test_generate_tp_rank_captures_under_nccl(stub, monkeypatch):
    """generate's rank function builds a capturing engine under nccl (its
    batcher decoding through the graph path) and an eager one under
    gloo, on the same dummy weights: the same tokens."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = {b: generate._tp_rank(TPContext(1, 0, None, b, CPU), _args(b))
           for b in ("nccl", "gloo")}
    assert out["nccl"]["cuda_graphs"] and not out["gloo"]["cuda_graphs"]
    assert out["nccl"]["outputs"] == out["gloo"]["outputs"]
    assert [len(o) for o in out["nccl"]["outputs"]] == [5, 5]
    assert stub.calls and all(c[0] == "all_reduce" for c in stub.calls)
