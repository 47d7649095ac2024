"""HTTP serving front over the continuous batcher (counterpart of
``arcquant_tpu/engine/server.py``).

A single engine-stepping thread drains a thread-safe submission queue
into the ContinuousBatcher (admission, paged KV, preemption and
per-request sampling come from scheduler.py), and a stdlib
ThreadingHTTPServer exposes it.

Endpoints:
  POST /v1/completions   {"prompt": [token ids] | "text",
                          "max_tokens": N, "temperature": t,
                          "top_p": p, "eos_id": id,
                          "stop": [[ids]...], "logit_bias": {id: b},
                          "min_tokens": N, "stream": bool}
                         -> {"tokens": [...], "text": ...?,
                             "request_id": ..., "ttft_s": ...}
                         stream=true: SSE frames `data: {"index": i,
                         "token": t}` per token, then a final
                         `data: {"done": true, "tokens": [...]}`
                         (authoritative — stop-sequence trimming can
                         retract the last streamed tokens)
  GET  /health           -> {"ok": true, "stats": {...}}

Design: exactly one thread touches the engine and the batcher (the
batcher's host state is not thread-safe); HTTP workers only enqueue and
wait on per-request events. Grad mode and the current CUDA device and
stream are per thread in PyTorch, so the loop thread runs every step
under ``torch.inference_mode()`` with the engine's device current; the
kernels launch on that thread's current stream. String prompts need a
tokenizer (token ids otherwise).
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from .scheduler import ContinuousBatcher, Request


class ServingLoop:
    """Engine-stepping thread around a ContinuousBatcher."""

    def __init__(self, batcher: ContinuousBatcher):
        self.batcher = batcher
        self._inbox: "queue.Queue[Request]" = queue.Queue()
        self._events: dict = {}          # request_id -> Event
        self._reqs: dict = {}            # request_id -> Request
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._steps = 0
        self._done_total = 0
        self._ttft_sum = 0.0              # latency aggregates over
        self._ttft_n = 0                  # completed requests
        self._dec_tokens = 0
        self._dec_time = 0.0
        self.error: Optional[str] = None  # fatal engine-thread error
        self._thread.start()

    def submit(self, req: Request) -> threading.Event:
        if self.error is not None:
            raise RuntimeError(f"serving loop is down: {self.error}")
        ev = threading.Event()
        with self._lock:
            self._events[req.request_id] = ev
            self._reqs[req.request_id] = req
        self._inbox.put(req)
        return ev

    def cancel(self, request_id: int) -> bool:
        """Cooperatively cancel an in-flight request (client
        disconnect): the engine thread retires it at its next step,
        freeing the slot/pages. Returns False for unknown ids."""
        with self._lock:
            req = self._reqs.get(request_id)
        if req is None:
            return False
        req.cancelled = True
        return True

    def complete(self, req: Request,
                 timeout: Optional[float] = None) -> Request:
        """Submit and block until the request finishes."""
        ev = self.submit(req)
        if not ev.wait(timeout):
            raise TimeoutError(f"request {req.request_id} timed out")
        return req

    def _signal(self, req: Request):
        with self._lock:
            ev = self._events.pop(req.request_id, None)
            self._reqs.pop(req.request_id, None)
        if ev is not None:
            ev.set()

    def _run(self):
        dev = self.batcher.engine.device
        with torch.inference_mode(), (torch.cuda.device(dev)
                                      if dev.type == "cuda"
                                      else contextlib.nullcontext()):
            self._loop()

    def _loop(self):
        idle_sleep = 0.002
        while not self._stop.is_set():
            moved = False
            while True:
                try:
                    req = self._inbox.get_nowait()
                except queue.Empty:
                    break
                moved = True
                try:
                    self.batcher.submit(req)
                except ValueError as e:
                    # per-request validation error (e.g. a token id
                    # outside the vocabulary): fail this request, keep
                    # serving
                    req.error = str(e)
                    req.done = True
                    self._signal(req)
            busy = (self.batcher.queue
                    or any(s is not None for s in self.batcher.slots))
            if busy:
                try:
                    done = self.batcher.step()
                except Exception as e:            # noqa: BLE001
                    # engine failure is fatal for in-flight state —
                    # fail every waiting request loudly instead of
                    # hanging their clients forever
                    self.error = repr(e)
                    for s in self.batcher.slots:
                        if s is not None:
                            s.error = s.error or self.error
                    pend = (list(self.batcher.queue)
                            + [s for s in self.batcher.slots
                               if s is not None])
                    while True:               # never-admitted waiters
                        try:
                            pend.append(self._inbox.get_nowait())
                        except queue.Empty:
                            break
                    for r in pend:
                        r.error = r.error or self.error
                        self._signal(r)
                    with self._lock:          # belt and braces
                        for ev in self._events.values():
                            ev.set()
                        self._events.clear()
                    return
                self._steps += 1
                self._done_total += len(done)
                for r in done:
                    if (r.t_submit is not None
                            and r.t_first is not None):
                        self._ttft_sum += r.t_first - r.t_submit
                        self._ttft_n += 1
                        # preempted requests' t_done - t_first spans
                        # requeue + re-prefill — skip them so the
                        # decode rate reflects actual decoding
                        if (r.t_done is not None and len(r.output) > 1
                                and not r.preempts):
                            self._dec_tokens += len(r.output) - 1
                            self._dec_time += r.t_done - r.t_first
                    self._signal(r)
                # the batcher archives every finished Request; a
                # long-running server must not accumulate them
                self.batcher.finished.clear()
            elif not moved:
                time.sleep(idle_sleep)

    def stats(self) -> dict:
        b = self.batcher
        out = {"steps": self._steps,
               "queued": len(b.queue),
               "running": sum(s is not None for s in b.slots),
               "finished": self._done_total}
        if self._ttft_n:
            out["avg_ttft_s"] = round(self._ttft_sum / self._ttft_n,
                                      4)
        if self._dec_time > 0:
            out["decode_tokens_per_s"] = round(
                self._dec_tokens / self._dec_time, 1)
        if b.alloc is not None:
            out["kv_pages"] = {"capacity": b.alloc.capacity,
                               "free": len(b.alloc.free),
                               "cached": len(b.alloc.cached)}
        if b.spec_window:
            out["spec"] = dict(b.spec_stats)
        return out

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)


def make_server(loop: ServingLoop, host: str = "127.0.0.1",
                port: int = 8000, tokenizer=None,
                default_max_tokens: int = 128) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; call .serve_forever()."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):        # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                ok = loop.error is None
                out = {"ok": ok, "stats": loop.stats()}
                dev = loop.batcher.engine.device
                if dev.type == "cuda":
                    out["stats"]["device_mem_gb"] = round(
                        torch.cuda.memory_allocated(dev) / 1e9, 2)
                if not ok:
                    out["error"] = loop.error
                self._json(200 if ok else 503, out)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/completions":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt = body["prompt"]
                if isinstance(prompt, str):
                    if tokenizer is None:
                        self._json(400, {"error":
                                         "string prompts need a "
                                         "tokenizer; pass token ids"})
                        return
                    prompt = tokenizer.encode(prompt)
                stop = body.get("stop")
                if stop is not None:
                    stop = [[int(t) for t in s] for s in stop]
                bias = body.get("logit_bias")
                if bias is not None:
                    bias = {int(t): float(v) for t, v in bias.items()}

                def make_req():
                    return Request(
                        prompt=[int(t) for t in prompt],
                        max_new_tokens=int(body.get(
                            "max_tokens", default_max_tokens)),
                        eos_id=body.get("eos_id"),
                        temperature=float(body.get("temperature",
                                                   0.0)),
                        top_p=float(body.get("top_p", 1.0)),
                        stop=stop, logit_bias=bias,
                        min_new_tokens=int(body.get("min_tokens", 0)),
                        presence_penalty=float(
                            body.get("presence_penalty", 0.0)),
                        frequency_penalty=float(
                            body.get("frequency_penalty", 0.0)),
                        seed=(int(body["seed"])
                              if body.get("seed") is not None
                              else None))
                def fmt(r):
                    o = {"request_id": r.request_id,
                         "tokens": r.output}
                    if r.error:
                        o["error"] = r.error
                    if r.t_first is not None:
                        o["ttft_s"] = round(r.t_first - r.t_submit, 4)
                    if tokenizer is not None:
                        o["text"] = tokenizer.decode(r.output)
                    return o

                req = make_req()
                n = int(body.get("n", 1))
                if n > 1:
                    if body.get("stream"):
                        self._json(400, {"error": "n > 1 does not "
                                         "support stream"})
                        return
                    # n parallel samples of one prompt (enable
                    # prefix_sharing so the prompt KV is stored once)
                    reqs = [req] + [make_req() for _ in range(n - 1)]
                    evs = [loop.submit(r) for r in reqs]
                    for r, ev in zip(reqs, evs):
                        if not ev.wait(body.get("timeout")):
                            # a timed-out fan-out must not leak the
                            # still-running siblings
                            for rr in reqs:
                                loop.cancel(rr.request_id)
                            raise TimeoutError(
                                f"request {r.request_id} timed out")
                    self._json(200, {"choices": [fmt(r)
                                                 for r in reqs]})
                    return
                if body.get("stream"):
                    self._stream(req, body.get("timeout"))
                    return
                try:
                    loop.complete(req, timeout=body.get("timeout"))
                except TimeoutError:
                    loop.cancel(req.request_id)
                    raise
                self._json(200, fmt(req))
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
            except RuntimeError as e:         # serving loop is down
                self._json(503, {"error": str(e)})

        def _stream(self, req, timeout):
            """SSE token streaming: poll the request's growing output
            (appends come from the single engine thread; we snapshot
            per poll) and flush one frame per new token."""
            ev = loop.submit(req)
            try:
                self._stream_frames(req, ev, timeout)
            except (BrokenPipeError, ConnectionResetError):
                # client went away mid-stream: free the slot
                loop.cancel(req.request_id)

        def _stream_frames(self, req, ev, timeout):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            deadline = (time.monotonic() + timeout) if timeout \
                else None
            sent = 0
            while True:
                # observe completion BEFORE snapshotting: tokens
                # appended between a snapshot and the event firing
                # still get per-token frames on this final pass
                done_now = ev.is_set() or req.done
                snap = list(req.output)
                for i in range(sent, len(snap)):
                    frame = {"index": i, "token": snap[i]}
                    if tokenizer is not None:
                        frame["text"] = tokenizer.decode([snap[i]])
                    self.wfile.write(
                        f"data: {json.dumps(frame)}\n\n".encode())
                if len(snap) > sent:
                    self.wfile.flush()
                    sent = len(snap)
                if done_now:
                    break
                if deadline and time.monotonic() > deadline:
                    req.error = req.error or "stream timeout"
                    loop.cancel(req.request_id)
                    break
                time.sleep(0.005)
            final = {"done": True, "request_id": req.request_id,
                     "tokens": list(req.output)}
            if req.error:
                final["error"] = req.error
            if tokenizer is not None:
                final["text"] = tokenizer.decode(final["tokens"])
            self.wfile.write(
                f"data: {json.dumps(final)}\n\n".encode())

    return ThreadingHTTPServer((host, port), Handler)
