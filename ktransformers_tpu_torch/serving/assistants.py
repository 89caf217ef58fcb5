"""OpenAI Assistants API (a v2 subset) over the port's ServeEngine
(counterpart of ktransformers_tpu/serving/assistants.py).

An in-process store (dicts keyed by OpenAI-style ids) whose runs go
straight to the engine's continuous-batching scheduler. Covered:
create / get / list / delete assistants; create / get threads; create /
list messages; create / get / cancel runs (queued -> in_progress ->
completed / cancelled), a completed run appending the assistant's message
to its thread. A run the engine cannot take
(ServeEngine.admission_error) is refused with HTTP 400.
"""

from __future__ import annotations

import threading
import time
import uuid


def _oid(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:24]}"


class AssistantStore:
    def __init__(self, engine, tokenizer, model_name: str):
        self.engine = engine
        self.tok = tokenizer
        self.model_name = model_name
        self.assistants: dict[str, dict] = {}
        self.threads: dict[str, dict] = {}
        self.messages: dict[str, list[dict]] = {}  # thread id -> msgs
        self.runs: dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- assistants ----------------------------------------------------------

    def create_assistant(self, body: dict) -> dict:
        a = {
            "id": _oid("asst"),
            "object": "assistant",
            "created_at": int(time.time()),
            "model": body.get("model", self.model_name),
            "name": body.get("name"),
            "instructions": body.get("instructions"),
            "metadata": body.get("metadata") or {},
            "tools": [],
        }
        with self._lock:
            self.assistants[a["id"]] = a
        return a

    def list_assistants(self) -> list[dict]:
        with self._lock:
            return list(self.assistants.values())

    def get_assistant(self, aid: str) -> dict | None:
        return self.assistants.get(aid)

    def delete_assistant(self, aid: str) -> bool:
        with self._lock:
            return self.assistants.pop(aid, None) is not None

    # -- threads / messages --------------------------------------------------

    def create_thread(self, body: dict) -> dict:
        t = {
            "id": _oid("thread"),
            "object": "thread",
            "created_at": int(time.time()),
            "metadata": (body or {}).get("metadata") or {},
        }
        with self._lock:
            self.threads[t["id"]] = t
            self.messages[t["id"]] = []
        for m in (body or {}).get("messages", []):
            self.create_message(t["id"], m)
        return t

    def get_thread(self, tid: str) -> dict | None:
        return self.threads.get(tid)

    def create_message(self, tid: str, body: dict) -> dict | None:
        if tid not in self.threads:
            return None
        content = body.get("content", "")
        if isinstance(content, str):
            content = [{"type": "text", "text": {"value": content,
                                                 "annotations": []}}]
        m = {
            "id": _oid("msg"),
            "object": "thread.message",
            "created_at": int(time.time()),
            "thread_id": tid,
            "role": body.get("role", "user"),
            "content": content,
            "metadata": body.get("metadata") or {},
        }
        with self._lock:
            self.messages[tid].append(m)
        return m

    def list_messages(self, tid: str) -> list[dict] | None:
        if tid not in self.threads:
            return None
        with self._lock:
            return list(self.messages[tid])

    # -- runs ----------------------------------------------------------------

    def _thread_as_chat(self, tid: str, assistant: dict) -> list[dict]:
        msgs = []
        if assistant.get("instructions"):
            msgs.append({"role": "system",
                         "content": assistant["instructions"]})
        for m in self.messages[tid]:
            text = "".join(
                c["text"]["value"] for c in m["content"]
                if c.get("type") == "text"
            )
            msgs.append({"role": m["role"], "content": text})
        return msgs

    def create_run(self, tid: str, body: dict) -> dict | None:
        aid = body.get("assistant_id")
        a = self.assistants.get(aid)
        if a is None or tid not in self.threads:
            return None
        text = self.tok.apply_chat_template(
            self._thread_as_chat(tid, a), tokenize=False,
            add_generation_prompt=True,
        )
        ids = list(self.tok.encode(text))
        max_new = int(body.get("max_completion_tokens", 256))
        err = self.engine.admission_error(ids, max_new)
        if err:
            raise ValueError(err)
        run = {
            "id": _oid("run"),
            "object": "thread.run",
            "created_at": int(time.time()),
            "thread_id": tid,
            "assistant_id": aid,
            "status": "queued",
            "model": a["model"],
            "instructions": body.get("instructions") or a["instructions"],
            "metadata": body.get("metadata") or {},
        }
        with self._lock:
            self.runs[run["id"]] = run
        q = self.engine.submit(
            ids,
            max_new_tokens=max_new,
            eos_token_id=getattr(self.tok, "eos_token_id", None),
        )
        run["_query"] = q
        run["status"] = "in_progress"

        def finish():
            while q.state != "done":
                time.sleep(0.005)
            with self._lock:
                if run["status"] == "cancelled":
                    return
                run["status"] = "completed"
                run["completed_at"] = int(time.time())
            self.create_message(tid, {
                "role": "assistant",
                "content": self.tok.decode(list(q.output_ids)),
                "metadata": {"run_id": run["id"]},
            })

        threading.Thread(target=finish, daemon=True).start()
        return run

    def get_run(self, tid: str, rid: str) -> dict | None:
        r = self.runs.get(rid)
        if r is None or r["thread_id"] != tid:
            return None
        return {k: v for k, v in r.items() if not k.startswith("_")}

    def cancel_run(self, tid: str, rid: str) -> dict | None:
        r = self.runs.get(rid)
        if r is None or r["thread_id"] != tid:
            return None
        with self._lock:
            if r["status"] in ("queued", "in_progress"):
                r["status"] = "cancelled"
                q = r.get("_query")
                if q is not None and hasattr(self.engine, "cancel"):
                    self.engine.cancel(q)
        return self.get_run(tid, rid)


def register_routes(server, store: AssistantStore) -> None:
    """Attach the assistants endpoints to an OpenAIServer's router."""

    def listing(data):
        return {"object": "list", "data": data,
                "first_id": data[0]["id"] if data else None,
                "last_id": data[-1]["id"] if data else None,
                "has_more": False}

    def found(obj, what="not found"):
        return (200, obj) if obj else (404, {"error": what})

    def create_run(req):
        try:
            r = store.create_run(req.match["tid"], req.json())
        except ValueError as e:
            return 400, {"error": {"message": str(e),
                                   "type": "invalid_request_error"}}
        if r is None:
            return 404, {"error": "no such thread/assistant"}
        return 200, {k: v for k, v in r.items() if not k.startswith("_")}

    def list_messages(req):
        ms = store.list_messages(req.match["tid"])
        return (200, listing(ms)) if ms is not None else (
            404, {"error": "no such thread"})

    def delete_assistant(req):
        aid = req.match["aid"]
        return 200, {"id": aid, "deleted": store.delete_assistant(aid),
                     "object": "assistant.deleted"}

    routes = [
        ("POST", "/v1/assistants",
         lambda req: (200, store.create_assistant(req.json()))),
        ("GET", "/v1/assistants",
         lambda req: (200, listing(store.list_assistants()))),
        ("GET", "/v1/assistants/{aid}",
         lambda req: found(store.get_assistant(req.match["aid"]))),
        ("DELETE", "/v1/assistants/{aid}", delete_assistant),
        ("POST", "/v1/threads",
         lambda req: (200, store.create_thread(req.json()
                                               if req.body else {}))),
        ("GET", "/v1/threads/{tid}",
         lambda req: found(store.get_thread(req.match["tid"]))),
        ("POST", "/v1/threads/{tid}/messages",
         lambda req: found(store.create_message(req.match["tid"],
                                                req.json()),
                           "no such thread")),
        ("GET", "/v1/threads/{tid}/messages", list_messages),
        ("POST", "/v1/threads/{tid}/runs", create_run),
        ("GET", "/v1/threads/{tid}/runs/{rid}",
         lambda req: found(store.get_run(req.match["tid"],
                                         req.match["rid"]))),
        ("POST", "/v1/threads/{tid}/runs/{rid}/cancel",
         lambda req: found(store.cancel_run(req.match["tid"],
                                            req.match["rid"]))),
    ]
    for method, pattern, fn in routes:
        server.add_route(method, pattern, fn)
