"""The HTTP front of arcquant_tpu_torch, after the JAX package's
tests/test_server.py: the serving loop and HTTP layer give the same
outputs as driving the ContinuousBatcher directly, under concurrent
clients; sampled requests, /health, bad requests, SSE streaming,
cancellation, a loop that survives a bad request and fails its waiters
on a fatal one, n parallel samples, and the serve entry point. A tiny
dummy engine on the CPU (test-tiny, W4A4 + ARC, dynamic pages, chunked
prefill, prefix sharing).
"""

import http.client
import json
import threading
import time

import pytest
import torch

from arcquant_tpu_torch import serve
from arcquant_tpu_torch.config import QuantConfig, get_model_config
from arcquant_tpu_torch.engine import (ContinuousBatcher, EngineConfig,
                                       InferenceEngine, Request)
from arcquant_tpu_torch.engine.server import ServingLoop, make_server
from arcquant_tpu_torch.models import quantized

PROMPTS = [[5, 17, 301, 42, 8], [100, 200, 7], [1, 2, 3, 4] * 4]


@pytest.fixture(scope="module")
def eng():
    cfg = get_model_config("test-tiny")
    qcfg = QuantConfig(quant_type="NVFP4", use_kernels=True,
                       weight_fmt="w8", act_scale="row", w_scale="channel",
                       prefill_act_bits=16, quantize_lm_head=True)
    return InferenceEngine.dummy(
        cfg, quantized.identity_calib(cfg, 0.125), qcfg,
        EngineConfig(max_batch=2, max_seq_len=64, page_size=16,
                     dynamic_pages=True, prefill_chunk=16,
                     prefix_sharing=True), seed=0, device="cpu")


def _start(loop, **kw):
    srv = make_server(loop, port=0, **kw)       # ephemeral port
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _post(port, obj, timeout=300):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request("POST", "/v1/completions", json.dumps(obj),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    return r.status, out


@pytest.fixture(scope="module")
def server(eng):
    loop = ServingLoop(ContinuousBatcher(eng, top_k=8))
    srv = _start(loop)
    yield srv.server_address[1], loop
    srv.shutdown()
    srv.server_close()
    loop.shutdown()


def test_http_completions_match_direct_batcher(eng, server):
    port, _ = server
    ref = ContinuousBatcher(eng)
    for p in PROMPTS:
        ref.submit(Request(prompt=list(p), max_new_tokens=6))
    expect = {tuple(r.prompt): r.output for r in ref.run()}
    results = {}

    def client(p):
        results[tuple(p)] = _post(port, {"prompt": p, "max_tokens": 6})
    # concurrent clients: more requests than engine slots
    ts = [threading.Thread(target=client, args=(p,)) for p in PROMPTS]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    for p in PROMPTS:
        status, out = results[tuple(p)]
        assert status == 200 and out["tokens"] == expect[tuple(p)], p
        assert out["ttft_s"] >= 0


def _health(port):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", "/health")
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    return r.status, out


def test_http_sampled_and_health(eng, server):
    port, _ = server
    status, out = _post(port, {"prompt": PROMPTS[0], "max_tokens": 5,
                               "temperature": 1.2, "top_p": 0.9,
                               "seed": 3})
    assert status == 200 and len(out["tokens"]) == 5
    assert all(0 <= t < eng.cfg.vocab_size for t in out["tokens"])
    again = _post(port, {"prompt": PROMPTS[0], "max_tokens": 5,
                         "temperature": 1.2, "top_p": 0.9, "seed": 3})[1]
    assert again["tokens"] == out["tokens"]       # seeded: reproducible
    status, h = _health(port)
    assert status == 200 and h["ok"]
    st = h["stats"]
    assert st["finished"] >= 2 and st["running"] == 0 and st["queued"] == 0
    assert st["kv_pages"]["capacity"] == eng.ecfg.total_pages() - 1


def test_http_bad_requests(server):
    port, loop = server
    assert _post(port, {"max_tokens": 5})[0] == 400          # no prompt
    assert _post(port, {"prompt": "hello"})[0] == 400        # no tokenizer
    assert _post(port, {"prompt": [1], "n": 2, "stream": True})[0] == 400
    assert _post(port, {"prompt": [1], "max_tokens": "x"})[0] == 400
    status, out = _post(port, {"prompt": [1, 10 ** 6], "max_tokens": 2})
    assert status == 200 and "token ids" in out["error"]
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", "/nope")
    assert c.getresponse().status == 404
    c.close()
    assert loop.error is None


def test_http_streaming_sse(server):
    """stream=true: per-token SSE frames, then an authoritative final
    frame equal to the non-streamed result."""
    port, _ = server
    expect = _post(port, {"prompt": PROMPTS[0], "max_tokens": 6})[1][
        "tokens"]
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    c.request("POST", "/v1/completions", json.dumps(
        {"prompt": PROMPTS[0], "max_tokens": 6, "stream": True}),
        {"Content-Type": "application/json"})
    r = c.getresponse()
    assert r.getheader("Content-Type") == "text/event-stream"
    frames = [json.loads(line[6:]) for line in r.read().decode().splitlines()
              if line.startswith("data: ")]
    c.close()
    assert frames[-1]["done"] and frames[-1]["tokens"] == expect
    assert [f["token"] for f in frames[:-1]] == expect
    assert [f["index"] for f in frames[:-1]] == list(range(6))


def test_http_n_parallel_samples(server):
    port, _ = server
    status, out = _post(port, {"prompt": PROMPTS[2], "max_tokens": 5,
                               "n": 3, "temperature": 1.2})
    assert status == 200 and len(out["choices"]) == 3
    assert all(len(ch["tokens"]) == 5 for ch in out["choices"])
    assert len({tuple(ch["tokens"]) for ch in out["choices"]}) > 1


def test_cancel_frees_slot(eng):
    """A cancelled in-flight request retires at the next step with error
    'cancelled', its slot and pages freed; new work then runs."""
    loop = ServingLoop(ContinuousBatcher(eng))
    try:
        slow = Request(prompt=[5, 17, 301], max_new_tokens=60)
        ev = loop.submit(slow)
        deadline = time.time() + 60
        while not slow.output and time.time() < deadline:
            time.sleep(0.01)
        assert slow.output, "request never started"
        assert loop.cancel(slow.request_id)
        assert ev.wait(60), "cancelled request never completed"
        assert slow.error == "cancelled" and len(slow.output) < 60
        nxt = Request(prompt=[1, 2, 3], max_new_tokens=4)
        loop.complete(nxt, timeout=300)
        assert nxt.error is None and len(nxt.output) == 4
        assert not loop.cancel(999999)            # unknown id
        a = loop.batcher.alloc
        assert not a.owned and a.available() == a.capacity
    finally:
        loop.shutdown()


def test_serving_loop_survives_bad_request(eng):
    """A request the batcher rejects (a token id outside the vocabulary)
    fails alone; the loop keeps serving."""
    loop = ServingLoop(ContinuousBatcher(eng))
    try:
        bad = Request(prompt=[1, eng.cfg.vocab_size], max_new_tokens=4)
        loop.complete(bad, timeout=60)
        assert bad.error and "token ids" in bad.error
        ok = Request(prompt=[5, 17, 301], max_new_tokens=4)
        loop.complete(ok, timeout=300)
        assert ok.error is None and len(ok.output) == 4
        assert loop.error is None
    finally:
        loop.shutdown()


def test_serving_loop_fatal_error_fails_waiters(eng):
    """An exception escaping batcher.step wakes every waiter with the
    error, and later submits are refused."""
    bt = ContinuousBatcher(eng)

    def boom():
        raise RuntimeError("synthetic engine failure")
    bt.step = boom
    loop = ServingLoop(bt)
    req = Request(prompt=[1, 2, 3], max_new_tokens=4)
    assert loop.submit(req).wait(60), "waiter hung after engine failure"
    assert req.error and "synthetic engine failure" in req.error
    with pytest.raises(RuntimeError):
        loop.submit(Request(prompt=[4], max_new_tokens=1))


def test_loop_thread_steps_in_inference_mode(eng):
    """The loop thread steps the engine under torch.inference_mode()."""
    seen = []
    bt = ContinuousBatcher(eng)
    step = bt.step

    def spy():
        seen.append(torch.is_inference_mode_enabled())
        return step()
    bt.step = spy
    loop = ServingLoop(bt)
    try:
        loop.complete(Request(prompt=[1, 2], max_new_tokens=2), timeout=300)
        assert seen and all(seen)
    finally:
        loop.shutdown()


def test_serve_entry_point():
    """serve.py's flags and defaults; a registry name serves dummy
    weights (here on the CPU); a checkpoint directory is not ported;
    without --cpu the engine goes to the card and never falls back."""
    ap = serve.build_parser()
    d = ap.parse_args(["--model", "test-tiny"])
    assert (d.prefill_chunk, d.prefill_act_bits, d.select_frac,
            d.weight_fmt, d.max_batch, d.max_seq_len, d.cpu) == (
                512, 16, 0.125, "w8", 8, 2048, False)
    args = ap.parse_args(["--model", "test-tiny", "--cpu", "--max_batch",
                          "2", "--max_seq_len", "64", "--prefill_chunk",
                          "16", "--dynamic_pages", "--prefix_sharing"])
    loop = serve.build_loop(args)
    srv = _start(loop)
    try:
        status, out = _post(srv.server_address[1],
                            {"prompt": PROMPTS[2], "max_tokens": 3})
        assert status == 200 and len(out["tokens"]) == 3
        assert loop.batcher.engine.qcfg_prefill.act_bits == 16
    finally:
        srv.shutdown()
        srv.server_close()
        loop.shutdown()
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        serve.build_loop(ap.parse_args(["--model", ".", "--cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.build_loop(ap.parse_args(["--model", "test-tiny"]))
