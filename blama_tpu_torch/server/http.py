"""HTTP server: the reference's four endpoints with its exact JSON wire format.

Counterpart of blama_tpu/server/http.py, the mirror of the reference C++
server's http/HttpServerMain.cpp:
  POST /complete              {prompt, max_tokens?, seed?, suffix?, temp?, top_p?}
                              → {text, tokenData: [{str, id, logits: [{id, logit}×10]}]}
  POST /chat/completions      {messages, max_tokens?, seed?, temp?, top_p?} → same
  POST /verify_completion     {request: <complete-params>, response: {tokenData}}
                              → {result: <score>}
  POST /chat/verify_completion  analogous
Non-POST → 400; unknown path → 404; CORS *; content-type text/json
(HttpServerMain.cpp:306-354, 266-272).

Env config (HttpServerMain.cpp:379-435): BLAMA_HOST (default 0.0.0.0),
BLAMA_PORT (default 7331, strict numeric), BLAMA_MODEL (.gguf path).

Implementation: stdlib ThreadingHTTPServer front-end (the reference runs 4
HTTP threads, HttpServerMain.cpp:445); inference is serialized on the Server
facade's single worker thread either way.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .server import (
    ChatCompleteRequestParams,
    ChatMessage,
    CompleteRequestParams,
    CompleteResponse,
    Facade,
    LogitData,
    Server,
    TokenData,
)

DEFAULT_PORT = 7331


def response_to_json(resp: CompleteResponse) -> list:
    """toJson (HttpServerMain.cpp:37-51)."""
    return [
        {
            "str": t.token_str,
            "id": t.token_id,
            "logits": [{"id": l.token_id, "logit": l.logit} for l in t.logits],
        }
        for t in resp
    ]


def json_to_response(obj: dict) -> CompleteResponse:
    """toCompleteResponse (HttpServerMain.cpp:53-70)."""
    out: CompleteResponse = []
    for jt in obj.get("tokenData", []):
        out.append(
            TokenData(
                token_str=jt.get("str", ""),
                token_id=int(jt["id"]),
                logits=[LogitData(int(jl["id"]), float(jl["logit"])) for jl in jt.get("logits", [])],
            )
        )
    return out


def json_to_complete_params(obj: dict) -> CompleteRequestParams:
    """toCompleteParams (HttpServerMain.cpp:85-94)."""
    p = CompleteRequestParams(prompt=obj["prompt"])
    p.max_tokens = int(obj.get("max_tokens", p.max_tokens))
    p.seed = int(obj.get("seed", p.seed))
    p.suffix = obj.get("suffix", p.suffix)
    p.temperature = float(obj.get("temp", p.temperature))
    p.top_p = float(obj.get("top_p", p.top_p))
    return p


def json_to_chat_params(obj: dict) -> ChatCompleteRequestParams:
    """toChatCompleteParams (HttpServerMain.cpp:96-117)."""
    p = ChatCompleteRequestParams()
    for m in obj.get("messages", []):
        p.messages.append(ChatMessage(m.get("role", ""), m.get("content", "")))
    p.max_tokens = int(obj.get("max_tokens", p.max_tokens))
    p.seed = int(obj.get("seed", p.seed))
    p.temperature = float(obj.get("temp", p.temperature))
    p.top_p = float(obj.get("top_p", p.top_p))
    return p


class _Handler(BaseHTTPRequestHandler):
    server_version = "blama-tpu-torch"
    protocol_version = "HTTP/1.1"

    # the Server facade is attached to the HTTP server object
    @property
    def api(self) -> Facade:
        return self.server.api  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):
        import logging

        logging.getLogger("blama_tpu_torch.http").debug(fmt, *args)

    def _send(self, status: int, body: bytes | None = None) -> None:
        self.send_response(status)
        self.send_header("Access-Control-Allow-Origin", "*")
        if body is not None:
            self.send_header("Content-Type", "text/json")
            self.send_header("Content-Length", str(len(body)))
        else:
            self.send_header("Content-Length", "0")
        self.end_headers()
        if body is not None:
            self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        # /metrics is an extension (the reference C++ server has no
        # observability endpoint); all other GETs are 400
        # like the reference (HttpServerMain.cpp:306-310).
        if self.path == "/metrics":
            snap = self.api.metrics_snapshot()
            self._send(200, json.dumps(snap).encode())
            return
        self._send(400)

    class _Timeout(Exception):
        pass

    def _await(self, submit) -> object:
        """Bridge the callback API to a blocking wait (the reference's
        async_compose bridge, HttpServerMain.cpp:173-252). Raises _Timeout
        after the server's request_timeout (0 = wait forever)."""
        done = threading.Event()
        box = {}

        def cb(result):
            box["result"] = result
            done.set()

        submit(cb)
        timeout = getattr(self.server, "request_timeout", 0) or None
        if not done.wait(timeout):
            raise self._Timeout
        return box["result"]

    def do_POST(self):  # noqa: N802
        # robustness beyond the reference C++ server (which has none):
        # bounded concurrency, payload size cap, request timeout
        slots = getattr(self.server, "slots", None)
        if slots is not None and not slots.acquire(blocking=False):
            self._send(503, b'{"error": "too many concurrent requests"}')
            return
        try:
            self._do_post_inner()
        finally:
            if slots is not None:
                slots.release()

    def _do_post_inner(self) -> None:
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > getattr(self.server, "max_body_bytes", 32 << 20):
                self._send(413, b'{"error": "request body too large"}')
                return
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._send(400)
            return

        path = self.path
        try:
            if path == "/complete":
                params = json_to_complete_params(body)
                gen = self._await(lambda cb: self.api.complete_text(params, cb))
                self._send_complete(gen)
            elif path == "/chat/completions":
                params = json_to_chat_params(body)
                gen = self._await(lambda cb: self.api.chat_complete(params, cb))
                self._send_complete(gen)
            elif path == "/verify_completion":
                req = json_to_complete_params(body["request"])
                resp = json_to_response(body["response"])
                score = self._await(lambda cb: self.api.verify(req, resp, cb))
                self._send(200, json.dumps({"result": score}).encode())
            elif path == "/chat/verify_completion":
                req = json_to_chat_params(body["request"])
                resp = json_to_response(body["response"])
                score = self._await(lambda cb: self.api.chat_verify(req, resp, cb))
                self._send(200, json.dumps({"result": score}).encode())
            else:
                self._send(404)
        except KeyError:
            self._send(400)
        except self._Timeout:
            self._send(503, b'{"error": "request timed out"}')

    def _send_complete(self, gen: CompleteResponse) -> None:
        """getCompleteResponse (HttpServerMain.cpp:255-275). `finish_reason`
        is an extension field (absent on the solo-Session path and
        in the reference wire format): it distinguishes EOG ("stop") from
        truncation ("length" / "evicted") which the reference signals only
        by throwing (Session.cpp:331-333)."""
        text = "".join(t.token_str for t in gen)
        out = {"text": text, "tokenData": response_to_json(gen)}
        reason = getattr(gen, "finish_reason", None)
        if reason is not None:
            out["finish_reason"] = reason
        self._send(200, json.dumps(out).encode())


class HttpServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr: tuple[str, int], api: Facade,
                 max_concurrent: int = 64, request_timeout: float = 0.0,
                 max_body_bytes: int = 32 << 20):
        super().__init__(addr, _Handler)
        self.api = api
        self.slots = threading.Semaphore(max_concurrent) if max_concurrent else None
        self.request_timeout = request_timeout
        self.max_body_bytes = max_body_bytes


def env_config() -> tuple[str, int, str]:
    """BLAMA_HOST/BLAMA_PORT/BLAMA_MODEL validation
    (HttpServerMain.cpp:383-435)."""
    host = os.environ.get("BLAMA_HOST", "0.0.0.0")
    port_s = os.environ.get("BLAMA_PORT", str(DEFAULT_PORT))
    if not port_s.isdigit():
        raise ValueError(f"BLAMA_PORT must be numeric, got {port_s!r}")
    port = int(port_s)
    if not (0 < port < 65536):
        raise ValueError(f"BLAMA_PORT out of range: {port}")
    model = os.environ.get("BLAMA_MODEL", "")
    if model:
        if not model.endswith(".gguf"):
            raise ValueError(f"BLAMA_MODEL must be a .gguf file: {model!r}")
        if not os.path.isfile(model):
            raise ValueError(f"BLAMA_MODEL not found: {model!r}")
    return host, port, model


def main() -> None:
    """Serve BLAMA_MODEL on the CUDA card (BLAMA_DEVICE=cpu runs the plain
    versions on the CPU). BLAMA_SCHEDULER=N enables continuous batching
    with N rows; BLAMA_PAGED_KV=1 switches it to the shared page pool
    (admission by free pages, not rows), BLAMA_KV_PAGES sizes the pool in
    128-slot pages (0 = the dense row layout's memory), BLAMA_HORIZON (default
    8, 0 disables) is the number of decode steps per scheduler iteration
    with the logits kept on the device; it engages only when every active
    row is greedy or a verification row and gives way to per-token steps
    otherwise. Unset, BLAMA_DTYPE leaves the model at ModelParams' defaults,
    the `float32` engine and attn="xla" (the two-pass chain), as the
    reference's single-process server builds Model(path); set, it names the
    weight engine (an extension of the port: the reference reads it only
    under BLAMA_MULTIHOST; one the port does not serve fails here with
    Model's NotImplementedError; a MoE file takes `q4k_a8` or `q4k_fused`).
    """
    import logging

    logging.basicConfig(level=logging.INFO)
    from ..runtime.instance import InstanceInitParams
    from ..runtime.model import Model, ModelParams

    host, port, model_path = env_config()
    if not model_path:
        raise SystemExit("BLAMA_MODEL must point to a .gguf model file")
    if os.environ.get("BLAMA_MULTIHOST", "0") == "1":
        raise NotImplementedError(
            "BLAMA_MULTIHOST: multi-process serving is not ported "
            "(ROADMAP.md §1 item 13, multi-GPU)")

    def progress(p: float) -> None:
        print(f"\rloading model: {p * 100:5.1f}%", end="", flush=True)

    # as the reference server builds it, Model(path): dtype "float32" and
    # attn "xla" unless BLAMA_DTYPE names another engine
    params = ModelParams(device=os.environ.get("BLAMA_DEVICE", "cuda"))
    if "BLAMA_DTYPE" in os.environ:
        params.dtype = os.environ["BLAMA_DTYPE"]
    model = Model(model_path, params, progress_cb=progress)
    print()
    # the solo path keeps the reference's default f32 KV rows; the
    # scheduler picks its own store type
    inst_params = InstanceInitParams()
    sched_batch = int(os.environ.get("BLAMA_SCHEDULER", "0"))
    if sched_batch > 0:
        from .scheduler_server import SchedulerServer

        paged = os.environ.get("BLAMA_PAGED_KV", "0") == "1"
        api = SchedulerServer(model, inst_params, max_batch=sched_batch,
                              paged=paged,
                              horizon=int(os.environ.get("BLAMA_HORIZON", "8")),
                              n_pages=int(os.environ.get("BLAMA_KV_PAGES", "0")))
        print(f"continuous batching enabled (max_batch={sched_batch}"
              f"{', paged KV' if paged else ''})")
    else:
        api = Server(model, inst_params)
    srv = HttpServer(
        (host, port), api,
        max_concurrent=int(os.environ.get("BLAMA_MAX_CONCURRENT", "64")),
        request_timeout=float(os.environ.get("BLAMA_REQUEST_TIMEOUT", "0")),
    )
    # graceful shutdown on SIGTERM: stop accepting, drain, release the model
    import signal

    def on_term(signum, frame):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_term)
    print(f"blama-tpu-torch http server listening on {host}:{port} "
          f"({model.device}, engine {model.params.dtype}, attn {model.params.attn})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        api.close()
        model.close()


if __name__ == "__main__":
    main()
