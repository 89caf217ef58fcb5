"""OpenAI- and Ollama-compatible HTTP server over the port's ServeEngine
(counterpart of ktransformers_tpu/serving/server.py), on the standard
library's ThreadingHTTPServer.

Routes: /health, /v1/models, /metrics (Prometheus text),
/v1/completions (prompt as text or token ids), /v1/chat/completions (with
tools), /api/tags, /api/generate, /api/chat, the assistants API
(serving/assistants.py) and the chat page at / and /web. Responses carry
the JAX package's JSON keys and values. Each request has a handler thread,
which submits its query to the engine and blocks on the query's
``out_queue``, which the engine's scheduler fills from its own thread;
streaming responses are server-sent events, one ``data:`` line a token,
flushed as it comes, and every response closes its connection (HTTP/1.0).

A query the engine cannot run gets HTTP 400 (ServeEngine.admission_error):
token ids outside the model's vocabulary (the JAX server passes them on
and its embedding gather clamps them), or more tokens than a query's page
table, the page pool or the model's positions hold (the JAX engine's
thread fails on the first, and every later request waits; a query past
the pool waits for ever; the JAX rope gather clamps the positions).
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

from ktransformers_tpu_torch.engine.sampler import SamplingConfig
from ktransformers_tpu_torch.serving.tools import (
    parse_tool_calls,
    render_tool_messages,
    render_tools_preamble,
)


class SimpleTokenizer:
    """Codepoint fallback tokenizer for tests and raw-id mode (the JAX
    package's, the same ids and text)."""

    eos_token_id = None

    def encode(self, text: str):
        return [ord(c) % 50000 for c in text]

    def decode(self, ids):
        return "".join(chr((i % 94) + 33) for i in ids)

    def apply_chat_template(self, messages, **kw):
        return "\n".join(f"{m['role']}: {m['content']}" for m in messages)


class IdTokenizer:
    """Token ids as text, for clients that speak ids (load_tokenizer's
    "ids"): encode reads whitespace-separated integers, decode writes each
    id after a space (so streamed pieces concatenate), and the chat
    template joins the messages' contents."""

    eos_token_id = None

    def encode(self, text: str):
        try:
            return [int(t) for t in text.split()]
        except ValueError as e:
            raise BadRequest(f"the ids tokenizer takes integers: {e}") from e

    def decode(self, ids):
        return "".join(f" {int(i)}" for i in ids)

    def apply_chat_template(self, messages, **kw):
        return " ".join(str(m.get("content", "")) for m in messages)


def _sse(data) -> bytes:
    return f"data: {json.dumps(data)}\n\n".encode()


class BadRequest(Exception):
    """Answered with HTTP 400 and an OpenAI-style error body."""


class Request:
    """One request as a route handler sees it."""

    def __init__(self, handler: BaseHTTPRequestHandler, match: dict,
                 body: bytes):
        self.handler = handler
        self.match = match
        self.body = body

    def json(self):
        try:
            return json.loads(self.body or b"{}")
        except ValueError as e:
            raise BadRequest(f"request body is not JSON: {e}") from e

    def start_stream(self) -> None:
        h = self.handler
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.end_headers()

    def write(self, data: bytes) -> None:
        self.handler.wfile.write(data)
        self.handler.wfile.flush()


class Raw:
    """A response body that is not JSON."""

    def __init__(self, body: bytes, content_type: str, status: int = 200):
        self.body, self.content_type, self.status = body, content_type, status


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"

    def do_GET(self):
        self.server.app.dispatch(self, "GET")

    def do_POST(self):
        self.server.app.dispatch(self, "POST")

    def do_DELETE(self):
        self.server.app.dispatch(self, "DELETE")

    def log_message(self, fmt, *args):  # no access log on stderr
        pass


class OpenAIServer:
    def __init__(self, engine, tokenizer=None,
                 model_name: str = "ktransformers-tpu",
                 api_key: str | None = None, mount_web: bool = True):
        self.engine = engine
        self.tok = tokenizer or SimpleTokenizer()
        self.model_name = model_name
        self.api_key = api_key
        self._routes = []
        self._httpd = None
        self._thread = None
        from ktransformers_tpu_torch.serving.assistants import (
            AssistantStore,
            register_routes,
        )

        self.assistants = AssistantStore(engine, self.tok, model_name)
        register_routes(self, self.assistants)
        if mount_web:
            self.add_route("GET", "/", self.webui)
            self.add_route("GET", "/web", self.webui)
        for method, path, fn in (
            ("GET", "/health", self.health),
            ("GET", "/v1/models", self.models),
            ("GET", "/metrics", self.metrics),
            ("POST", "/v1/completions", self.completions),
            ("POST", "/v1/chat/completions", self.chat_completions),
            ("GET", "/api/tags", self.ollama_tags),
            ("POST", "/api/generate", self.ollama_generate),
            ("POST", "/api/chat", self.ollama_chat),
        ):
            self.add_route(method, path, fn)

    # -- routing -------------------------------------------------------------

    def add_route(self, method: str, pattern: str, fn) -> None:
        """``pattern`` is a path with {name} segments; ``fn(request)``
        returns (status, JSON object), a Raw, or None once it has written
        a streamed response itself."""
        rx = re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)",
                                     pattern) + "$")
        self._routes.append((method, rx, fn))

    def _send(self, h, status: int, body: bytes, ctype: str) -> None:
        h.send_response(status)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    def _send_json(self, h, status: int, obj) -> None:
        self._send(h, status, json.dumps(obj).encode(),
                   "application/json; charset=utf-8")

    def dispatch(self, h: BaseHTTPRequestHandler, method: str) -> None:
        path = urlsplit(h.path).path
        n = int(h.headers.get("Content-Length") or 0)
        body = h.rfile.read(n) if n else b""
        if self.api_key and path.startswith(("/v1", "/api")):
            # bearer auth on the API; health, metrics and the page stay open
            if h.headers.get("Authorization", "") != f"Bearer {self.api_key}":
                self._send_json(h, 401, {"error": {
                    "message": "invalid api key",
                    "type": "authentication_error"}})
                return
        allowed = False
        for m, rx, fn in self._routes:
            hit = rx.match(path)
            if hit is None:
                continue
            allowed = True
            if m != method:
                continue
            req = Request(h, hit.groupdict(), body)
            try:
                out = fn(req)
            except BadRequest as e:
                self._send_json(h, 400, {"error": {
                    "message": str(e), "type": "invalid_request_error"}})
                return
            except (BrokenPipeError, ConnectionResetError):
                return
            except Exception as e:  # answered, and the server keeps serving
                self._send_json(h, 500, {"error": {
                    "message": f"{type(e).__name__}: {e}",
                    "type": "server_error"}})
                return
            if isinstance(out, Raw):
                self._send(h, out.status, out.body, out.content_type)
            elif out is not None:
                self._send_json(h, *out)
            return
        if allowed:
            self._send_json(h, 405, {"error": "method not allowed"})
        else:
            self._send_json(h, 404, {"error": "not found"})

    # -- lifetime ------------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Listen on (host, port) from a background thread (port 0 picks a
        free one); returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.app = self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None

    # -- helpers -------------------------------------------------------------

    def _chat_ids(self, messages) -> list[int]:
        text = self.tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        return list(self.tok.encode(text))

    def _prompt_ids(self, body: dict) -> list[int]:
        if "messages" in body:
            messages = body["messages"]
            if body.get("tools"):
                # tool schemas as a system preamble; tool-role and
                # tool_calls turns flattened for the template
                pre = render_tools_preamble(body["tools"],
                                            body.get("tool_choice", "auto"))
                messages = ([{"role": "system", "content": pre}]
                            + render_tool_messages(messages))
            return self._chat_ids(messages)
        prompt = body.get("prompt", "")
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return prompt
        return list(self.tok.encode(prompt))

    def _sampling(self, body: dict) -> SamplingConfig:
        return SamplingConfig(
            temperature=float(body.get("temperature", 0.0) or 0.0),
            top_p=float(body.get("top_p", 1.0) or 1.0),
            top_k=int(body.get("top_k", 0) or 0),
            repetition_penalty=float(
                body.get("repetition_penalty", 1.0) or 1.0),
            presence_penalty=float(body.get("presence_penalty", 0.0) or 0.0),
            frequency_penalty=float(
                body.get("frequency_penalty", 0.0) or 0.0),
        )

    def _submit(self, ids, max_new: int, sampling: SamplingConfig):
        err = self.engine.admission_error(ids, max_new)
        if err:
            raise BadRequest(err)
        return self.engine.submit(
            ids, max_new_tokens=max_new, sampling=sampling,
            eos_token_id=getattr(self.tok, "eos_token_id", None))

    @staticmethod
    def _collect(q) -> list[int]:
        out = []
        while (tok := q.out_queue.get()) is not None:
            out.append(tok)
        return out

    # -- endpoints -----------------------------------------------------------

    def health(self, req):
        return 200, {"status": "ok"}

    def webui(self, req):
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "webui", "index.html")
        with open(path, "rb") as f:
            return Raw(f.read(), "text/html; charset=utf-8")

    def models(self, req):
        return 200, {"object": "list", "data": [{
            "id": self.model_name, "object": "model",
            "owned_by": "ktransformers_tpu"}]}

    def metrics(self, req):
        lines = []
        for k, v in self.engine.metrics().items():
            lines.append(f"# TYPE ktransformers_tpu_{k} gauge")
            lines.append(f"ktransformers_tpu_{k} {float(v)}")
        return Raw(("\n".join(lines) + "\n").encode(),
                   "text/plain; charset=utf-8")

    def ollama_tags(self, req):
        return 200, {"models": [{"name": self.model_name,
                                 "model": self.model_name}]}

    def _ollama_query(self, body: dict, ids):
        opts = body.get("options", {})
        return self._submit(ids, int(opts.get("num_predict", 128)),
                            self._sampling(opts))

    def ollama_generate(self, req):
        body = req.json()
        q = self._ollama_query(body, list(
            self.tok.encode(body.get("prompt", ""))))
        out = self._collect(q)
        return 200, {"model": self.model_name,
                     "response": self.tok.decode(out), "done": True,
                     "done_reason": q.finish_reason or "stop",
                     "eval_count": len(out)}

    def ollama_chat(self, req):
        body = req.json()
        q = self._ollama_query(body, self._chat_ids(body.get("messages", [])))
        out = self._collect(q)
        return 200, {"model": self.model_name,
                     "message": {"role": "assistant",
                                 "content": self.tok.decode(out)},
                     "done": True, "done_reason": q.finish_reason or "stop"}

    def completions(self, req):
        return self._serve(req, chat=False)

    def chat_completions(self, req):
        return self._serve(req, chat=True)

    def _serve(self, req, chat: bool):
        body = req.json()
        ids = self._prompt_ids(body)
        max_new = int(body.get("max_tokens",
                               body.get("max_completion_tokens", 128)) or 128)
        q = self._submit(ids, max_new, self._sampling(body))
        rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:12]}"
        head = {"id": rid,
                "object": "chat.completion.chunk" if chat
                else "text_completion",
                "created": int(time.time()), "model": self.model_name}
        tools = (chat and body.get("tools")
                 and body.get("tool_choice") != "none")

        if body.get("stream") and tools:
            # collect, parse, then one delta chunk and the final chunk
            text = self.tok.decode(self._collect(q))
            content, calls = parse_tool_calls(text)
            delta = {"role": "assistant"}
            finish = q.finish_reason or "stop"
            if calls:
                for i, c in enumerate(calls):
                    c["index"] = i
                delta["tool_calls"] = calls
                if content:
                    delta["content"] = content
                finish = "tool_calls"
            else:
                delta["content"] = text
            req.start_stream()
            req.write(_sse({**head, "choices": [
                {"index": 0, "delta": delta, "finish_reason": None}]}))
            req.write(_sse({**head, "choices": [
                {"index": 0, "delta": {}, "finish_reason": finish}]}))
            req.write(b"data: [DONE]\n\n")
            return None

        if body.get("stream"):
            req.start_stream()
            try:
                while (tok := q.out_queue.get()) is not None:
                    piece = self.tok.decode([tok])
                    choice = ({"index": 0, "delta": {"content": piece},
                               "finish_reason": None} if chat else
                              {"index": 0, "text": piece,
                               "finish_reason": None})
                    req.write(_sse({**head, "choices": [choice]}))
                final = {"index": 0, "finish_reason": q.finish_reason
                         or "stop"}
                final["delta" if chat else "text"] = {} if chat else ""
                req.write(_sse({**head, "choices": [final]}))
                req.write(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError):
                # the client went away: free the query's slot and pages
                self.engine.cancel(q)
            return None

        out = self._collect(q)
        text = self.tok.decode(out)
        usage = {"prompt_tokens": len(ids), "completion_tokens": len(out),
                 "total_tokens": len(ids) + len(out)}
        finish = q.finish_reason or "stop"
        if not chat:
            return 200, {**head, "choices": [
                {"index": 0, "text": text, "finish_reason": finish}],
                "usage": usage}
        message = {"role": "assistant", "content": text}
        if tools:
            content, calls = parse_tool_calls(text)
            if calls:
                message = {"role": "assistant", "content": content or None,
                           "tool_calls": calls}
                finish = "tool_calls"
        return 200, {**head, "object": "chat.completion", "choices": [
            {"index": 0, "message": message, "finish_reason": finish}],
            "usage": usage}


def serve(engine, tokenizer=None, host: str = "0.0.0.0", port: int = 8192,
          model_name: str = "ktransformers-tpu", api_key: str | None = None,
          mount_web: bool = True, block: bool = True):
    """Start the engine thread and the HTTP server. With ``block`` serve
    until interrupted, then stop both; else return the running
    OpenAIServer (its ``port`` is the bound one; ``stop()`` it and the
    engine when done)."""
    engine.start()
    srv = OpenAIServer(engine, tokenizer, model_name=model_name,
                       api_key=api_key, mount_web=mount_web)
    bound = srv.start(host, port)
    print(f"serving on http://{host}:{bound}", file=sys.stderr, flush=True)
    if not block:
        return srv
    try:
        while srv._thread.is_alive():
            srv._thread.join(timeout=1.0)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
        engine.stop()
    return srv
