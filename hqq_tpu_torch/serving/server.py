# SPDX-License-Identifier: Apache-2.0
"""HTTP inference server over the batching engines.

Mirrors `hqq_tpu.serving.server` (this package's own copy: it imports
nothing of `hqq_tpu`). A threaded stdlib HTTP endpoint in front of
`ContinuousBatchingEngine` or `PagedBatchingEngine` (anything with
add_request / step / cancel / queue / active / finished). One loop thread
drives ``engine.step()``, and so is the only thread that launches the
engine's kernels; request threads run the embedder where a request has
images, enqueue, wait on a condition until their uid finishes, and read the
engine's containers.

    POST /generate   {"prompt_ids": [...], "max_new_tokens": 64}
                  -> {"uid": 3, "tokens": [...]}
                  Per-request sampling: "temperature" (0 = greedy), "top_p",
                  "top_k", "do_sample", "stop_token_ids" [ids], "stop"
                  [strings, each one token of the tokenizer], "adapter_id"
                  (multi-LoRA; an id outside the tree's stacks is
                  answered 400).
    POST /generate   {"prompt_ids": [...], "stream": true}
                  -> text/event-stream; `data: {"uid": 3, "tokens": [...]}`
                     as the engine steps, then a last event with
                     `"done": true` and the whole token list
    POST /generate   {"prompt_ids": [...], "pixel_values": [...]
                      (, "grid_thw": [[t, h, w], ...])}
                  -> the same, blocking or streamed, for a prompt with
                     images: the server's ``embedder`` turns the ids and
                     pixels into the prompt's embeddings (the vision
                     tower, then the image rows over the placeholders),
                     which the engine prefills on
    POST /cancel     {"uid": 3} -> {"cancelled": true}
    GET  /healthz    -> {"ok": true, "active": 2, "queued": 0}

With a `tokenizer` (any object with `__call__(text) -> {"input_ids": ...}`
and `decode(ids)`, such as an HF tokenizer) "prompt" strings are taken and
"text" is returned beside the ids. With an ``embedder`` (``(prompt_ids,
{"pixel_values", "grid_thw"}) -> inputs_embeds [T, D]``, `serve.py`'s for a
LLaVA checkpoint) requests with "pixel_values" are served; without one
they are answered 400, and so is one the embedder refuses with a
ValueError (a placeholder count that does not match the image's rows,
pixels of the wrong shape). The embedder runs on the request's own thread
while the loop thread steps the engine: both launch onto the card's
default stream, which orders them, and neither engine captures a CUDA
graph (their steps are eager), so no capture is under way when the
embedder launches.

If ``engine.step()`` raises, the loop stops, every waiting request is
answered 500 (a stream gets a last event with "error"), and so is every
later one: the server does not go on as if the engine had served.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import torch

__all__ = ["InferenceServer"]

# how long a waiting request thread sleeps before it looks again (a first
# request may build the kernels for minutes; the waits simply repeat)
_WAIT_S = 60.0


class EngineFailed(RuntimeError):
    """The loop thread's ``engine.step()`` raised; the message holds its
    traceback."""


class InferenceServer:
    def __init__(self, engine: Any, host: str = "127.0.0.1", port: int = 8000,
                 tokenizer: Optional[Any] = None, embedder: Optional[Any] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.embedder = embedder
        # Two locks, so that a long step (a first one builds the kernels)
        # never blocks /healthz or a submission:
        #   _step_lock  serializes what must not overlap a step (the step
        #               itself, cancel)
        #   _lock/_done guard submission and the wait for a finished uid
        # add_request only appends to the engine's queue, which the step
        # pops, so a submission is instant while a step runs.
        self._step_lock = threading.Lock()
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._srv_thread: Optional[threading.Thread] = None
        self.error: Optional[str] = None  # the traceback of a failed step
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _sse(self, events):
                """Server-sent events: one `data:` line per decode progress,
                the connection's close ends the stream."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    for event in events:
                        if srv.tokenizer is not None and event.get("done"):
                            event["text"] = srv.tokenizer.decode(event["tokens"])
                        self._event(event)
                except EngineFailed as e:
                    self._event({"error": str(e)})

            def _event(self, event: dict):
                self.wfile.write(f"data: {json.dumps(event)}\n\n".encode())
                self.wfile.flush()

            def do_GET(self):
                if self.path == "/healthz":
                    # no lock: len() of the engine's containers is atomic
                    # under the interpreter lock, and health answers mid-step
                    self._json(500 if srv.error else 200, {
                        "ok": srv.error is None,
                        "active": len(srv.engine.active),
                        "queued": len(srv.engine.queue),
                    })
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    return self._json(400, {"error": "bad json"})
                if not isinstance(req, dict):
                    return self._json(400, {"error": "the body must be a JSON object"})
                if self.path == "/generate":
                    return self._generate(req)
                if self.path == "/cancel":
                    with srv._step_lock:  # must not overlap a running step
                        ok = srv.engine.cancel(int(req.get("uid", -1)))
                    with srv._lock:
                        srv._done.notify_all()
                    return self._json(200, {"cancelled": bool(ok)})
                return self._json(404, {"error": "not found"})

            def _generate(self, req: dict):
                ids = req.get("prompt_ids")
                if ids is None and srv.tokenizer is not None:
                    ids = srv.tokenizer(req.get("prompt", ""))["input_ids"]
                if not ids:
                    return self._json(400, {"error": "prompt_ids required"})
                try:
                    samp = srv._sampling_kwargs(req)
                    mnt = int(req.get("max_new_tokens", 64))
                except (TypeError, ValueError) as e:
                    return self._json(400, {"error": str(e)})
                vl = {k: req[k] for k in ("pixel_values", "grid_thw") if k in req}
                if vl:
                    if srv.embedder is None:
                        return self._json(400, {
                            "error": "multimodal request, but the server has no embedder "
                                     "(serve a vision-language checkpoint)"})
                    try:
                        samp["inputs_embeds"] = srv.embedder(ids, vl)
                    except (TypeError, ValueError, KeyError, IndexError) as e:
                        return self._json(400, {"error": f"embedder refused the request: {e}"})
                try:
                    if req.get("stream"):
                        return self._sse(srv.stream(ids, mnt, **samp))
                    out = srv.generate(ids, mnt, **samp)
                except EngineFailed as e:
                    return self._json(500, {"error": str(e)})
                except (NotImplementedError, ValueError) as e:  # refused by the engine
                    return self._json(400, {"error": str(e)})
                if srv.tokenizer is not None:
                    out["text"] = srv.tokenizer.decode(out["tokens"])
                return self._json(200, out)

        self._http = ThreadingHTTPServer((host, port), Handler)
        self.port = self._http.server_address[1]

    def _sampling_kwargs(self, req: dict) -> dict:
        """The request's sampling parameters as add_request arguments.
        ``temperature: 0`` means greedy; a positive temperature without
        ``do_sample`` means sampling."""
        kw = {}
        if "do_sample" in req:
            kw["do_sample"] = bool(req["do_sample"])
        if "temperature" in req:
            t = float(req["temperature"])
            if "do_sample" not in req:
                kw["do_sample"] = t > 0.0
            if t > 0.0:
                kw["temperature"] = t
        if "top_p" in req:
            kw["top_p"] = float(req["top_p"])
        if "top_k" in req:
            kw["top_k"] = int(req["top_k"])
        if "adapter_id" in req:
            kw["adapter_id"] = int(req["adapter_id"])
        stop_ids = [int(x) for x in req.get("stop_token_ids", [])]
        for s in req.get("stop", []):
            if self.tokenizer is None:
                raise ValueError("'stop' strings require the server to have a tokenizer; use "
                                 "stop_token_ids")
            enc = self.tokenizer(s, add_special_tokens=False)["input_ids"]
            if len(enc) != 1:
                raise ValueError(f"stop string {s!r} encodes to {len(enc)} tokens; only "
                                 "single-token stop strings are supported (use stop_token_ids)")
            stop_ids.append(int(enc[0]))
        if stop_ids:
            kw["stop_token_ids"] = stop_ids
        return kw

    # -- driving the engine ------------------------------------------------------
    def _loop(self):
        device = getattr(self.engine, "device", None)
        if device is not None and device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)  # the kernels launch on the engine's card
        while not self._stop.is_set():
            busy = bool(self.engine.queue or self.engine.active
                        or getattr(self.engine, "_prefilling", None))
            if not busy:
                time.sleep(0.005)
                continue
            try:
                with self._step_lock:
                    self.engine.step()
            except Exception:  # the boundary: record, wake every waiter, stop
                self.error = traceback.format_exc()
                self._stop.set()
            with self._lock:
                self._done.notify_all()

    def _check(self) -> None:
        if self.error is not None:
            raise EngineFailed(f"the engine's step failed:\n{self.error}")

    def generate(self, prompt_ids, max_new_tokens: int, **samp) -> dict:
        """Blocking submit: enqueue, wait for completion. ``samp`` goes to
        `engine.add_request` (per-request sampling, stop ids)."""
        with self._lock:
            self._check()
            uid = self.engine.add_request(prompt_ids, max_new_tokens=max_new_tokens, **samp)
            while uid not in self.engine.finished:
                self._check()
                self._done.wait(timeout=_WAIT_S)
            return {"uid": uid, "tokens": list(self.engine.finished[uid].output)}

    def _progress(self, uid):
        """(tokens so far, done) of a request; the caller holds `_lock`.
        The loop thread changes `engine.active` under `_step_lock`, so a
        snapshot may meet a dict that resizes: it is retried (CPython raises
        RuntimeError then, and corrupts nothing)."""
        req = self.engine.finished.get(uid)
        if req is None:
            candidates = []
            for _ in range(8):
                try:
                    candidates = list(self.engine.active.values())
                    break
                except RuntimeError:
                    continue
            req = next((r for r in candidates if r.uid == uid), None)
        out = list(req.output) if req is not None and req.output else []
        return out, uid in self.engine.finished

    def stream(self, prompt_ids, max_new_tokens: int, **samp):
        """Incremental submit: enqueue now (so the engine's refusal raises
        here), and return a generator of {"uid", "tokens": the new ones} as
        the engine decodes, then {"uid", "done": True, "tokens": all}. The
        chunks concatenate to the blocking result. The lock is not held
        while a chunk is consumed."""
        with self._lock:
            self._check()
            uid = self.engine.add_request(prompt_ids, max_new_tokens=max_new_tokens, **samp)
        return self._events(uid)

    def _events(self, uid: int):
        sent = 0
        while True:
            with self._lock:
                out, done = self._progress(uid)
                while len(out) == sent and not done:
                    self._check()
                    self._done.wait(timeout=_WAIT_S)
                    out, done = self._progress(uid)
            if len(out) > sent:
                yield {"uid": uid, "tokens": out[sent:]}
                sent = len(out)
            if done:
                yield {"uid": uid, "done": True, "tokens": out}
                return

    # -- lifecycle ---------------------------------------------------------------
    def start(self) -> "InferenceServer":
        self._loop_thread = threading.Thread(target=self._loop, daemon=True)
        self._loop_thread.start()
        self._srv_thread = threading.Thread(target=self._http.serve_forever, daemon=True)
        self._srv_thread.start()
        return self

    def stop(self) -> None:
        """Stop the loop and the HTTP server and close its socket."""
        self._stop.set()
        self._http.shutdown()
        self._http.server_close()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)

    def serve_forever(self) -> None:  # pragma: no cover - interactive entry
        self.start()
        try:
            self._srv_thread.join()
        except KeyboardInterrupt:
            self.stop()
