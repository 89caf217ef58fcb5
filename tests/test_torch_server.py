"""The port's HTTP front door (serving/server.py, assistants.py, config.py,
tools.py, engine/local_chat.chat_loop, utils/eval.mmlu_eval_http) against
the JAX package's.

Both servers run over ServeEngines of one tiny float32 DeepSeek-V2 (the
TINY_DS shape with a vocabulary of 128, so ASCII text encodes in range):
the JAX engine on the JAX params, the port's on the same params carried
across with convert.params_from_jax. The JAX OpenAIServer runs on an
aiohttp AppRunner on a loopback port in a thread of its own, the port's on
127.0.0.1:0; the same urllib client sends both the same requests, one at a
time, each with a 30 s timeout. Their tokenizer decodes ids as "<id>", so
every response carries its token ids. Greedy decoding on float32 weights
gives equal tokens in both packages (tests/test_torch_serving.py holds the
engines to each other); the comparisons here are exact: JSON keys,
finish_reason, usage and token ids.
"""

import asyncio
import json
import os
import re
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from ktransformers_tpu.models.init import init_params as j_init_params
from ktransformers_tpu.models.spec import spec_from_hf_config as j_spec
from ktransformers_tpu.serving import tools as j_tools
from ktransformers_tpu.serving.config import ServerConfig as JServerConfig
from ktransformers_tpu.serving.engine import ServeEngine as JServeEngine
from ktransformers_tpu.serving.scheduler import (
    SchedulerConfig as JSchedulerConfig,
)
from ktransformers_tpu.serving.server import OpenAIServer as JOpenAIServer

from ktransformers_tpu_torch.convert import params_from_jax
from ktransformers_tpu_torch.models.spec import spec_from_hf_config
from ktransformers_tpu_torch.serving import tools
from ktransformers_tpu_torch.serving.config import ServerConfig
from ktransformers_tpu_torch.serving.engine import ServeEngine
from ktransformers_tpu_torch.serving.scheduler import SchedulerConfig
from ktransformers_tpu_torch.serving.server import (
    OpenAIServer,
    SimpleTokenizer,
)

from tests.test_generate import TINY_DS
from tests.test_torch_model import one_torch_thread  # noqa: F401
from tests.test_tool_calling import TOOLS

TINY = dict(TINY_DS, vocab_size=128, max_position_embeddings=1024)
SCHED = dict(max_batch_size=2, prefill_chunk=32, page_size=8,
             max_pages_per_query=96)
TIMEOUT = 30


class IdTok:
    """Codepoints in, "<id>" out: the response text names its ids."""

    eos_token_id = None

    def encode(self, text):
        return [ord(c) for c in text]

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)

    def apply_chat_template(self, messages, **kw):
        return "\n".join(f"{m['role']}: {m.get('content', '')}"
                         for m in messages)


def ids_of(text: str) -> list[int]:
    return [int(t) for t in re.findall(r"<(\d+)>", text)]


def call(base, path, body=None, method=None, headers=None, raw=False):
    """(status, JSON body or text) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + path, data=data, method=method or ("POST" if data else "GET"),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            status, payload = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, payload = e.code, e.read()
    text = payload.decode()
    if raw:
        return status, text
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


def sse_events(text: str) -> list:
    lines = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(ln) for ln in lines[:-1]]


def keys(obj):
    """The nested key structure of a JSON value (lists by their items)."""
    if isinstance(obj, dict):
        return {k: keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [keys(v) for v in obj]
    return type(obj).__name__


class JaxServer:
    """The JAX OpenAIServer's aiohttp app on a loopback port, its event
    loop on a thread of its own."""

    def __init__(self, app):
        from aiohttp import web

        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app)
        self.loop.run_until_complete(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self.loop.run_until_complete(site.start())
        port = site._server.sockets[0].getsockname()[1]
        self.base = f"http://127.0.0.1:{port}"
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        self.loop.run_until_complete(self.runner.cleanup())
        self.loop.close()


class PortServer:
    def __init__(self, srv: OpenAIServer):
        self.srv = srv
        self.base = f"http://127.0.0.1:{srv.start('127.0.0.1', 0)}"

    def stop(self):
        self.srv.stop()


@pytest.fixture(scope="module")
def engines():
    jspec = j_spec(dict(TINY))
    jparams = j_init_params(jspec, seed=0, quant="bf16")
    spec = spec_from_hf_config(dict(TINY))
    tparams = params_from_jax(jax.device_get(jparams), spec, "cpu")
    jeng = JServeEngine(jparams, jspec, JSchedulerConfig(**SCHED),
                        num_pages=256, cache_dtype=jnp.float32,
                        compute_dtype=jnp.float32)
    teng = ServeEngine(tparams, spec, SchedulerConfig(**SCHED), num_pages=256,
                       cache_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu")
    jeng.start()
    teng.start()
    yield jeng, teng
    jeng.stop()
    teng.stop()


@pytest.fixture(scope="module")
def servers(engines):
    """(JAX base URL, port base URL) over the two engines."""
    jeng, teng = engines
    js = JaxServer(JOpenAIServer(jeng, IdTok()).app)
    ps = PortServer(OpenAIServer(teng, IdTok()))
    yield js.base, ps.base
    js.stop()
    ps.stop()


def both(servers, *args, **kw):
    return [call(base, *args, **kw) for base in servers]


def test_health_models_tags_metrics(servers):
    for path in ("/health", "/v1/models", "/api/tags"):
        (js, jb), (ts, tb) = both(servers, path)
        assert js == ts == 200 and jb == tb, path
    both(servers, "/v1/completions", {"prompt": [1, 2, 3], "max_tokens": 2})
    (js, jm), (ts, tm) = both(servers, "/metrics", raw=True)
    assert js == ts == 200
    names = lambda t: {ln.split()[0] for ln in t.splitlines()
                       if ln and not ln.startswith("#")}
    # the port's engine also counts its fused mixed steps
    assert names(tm) - names(jm) == {"ktransformers_tpu_mixed_steps_fused"}
    assert names(jm) <= names(tm)
    assert "ktransformers_tpu_queries_finished" in names(tm)


@pytest.mark.parametrize("prompt", [list(range(3, 9)), "The cat, 42"])
def test_completion(servers, prompt):
    body = {"prompt": prompt, "max_tokens": 5}
    (js, jb), (ts, tb) = both(servers, "/v1/completions", body)
    assert js == ts == 200
    assert keys(jb) == keys(tb)
    assert jb["usage"] == tb["usage"]
    assert jb["choices"][0]["finish_reason"] == \
        tb["choices"][0]["finish_reason"] == "length"
    assert ids_of(jb["choices"][0]["text"]) == \
        ids_of(tb["choices"][0]["text"])
    assert len(ids_of(tb["choices"][0]["text"])) == 5
    assert tb["object"] == "text_completion"


@pytest.mark.parametrize("tooled", [False, True])
def test_chat_completion(servers, tooled):
    body = {"messages": [{"role": "user", "content": "Hi there"}],
            "max_tokens": 4}
    if tooled:
        body["tools"] = TOOLS
    (js, jb), (ts, tb) = both(servers, "/v1/chat/completions", body)
    assert js == ts == 200
    assert keys(jb) == keys(tb) and jb["usage"] == tb["usage"]
    jc, tc = jb["choices"][0], tb["choices"][0]
    assert jc["finish_reason"] == tc["finish_reason"] == "length"
    assert ids_of(jc["message"]["content"]) == \
        ids_of(tc["message"]["content"])
    assert tb["object"] == "chat.completion"


@pytest.mark.parametrize("route,body", [
    ("/v1/completions", {"prompt": [5, 6, 7, 8], "max_tokens": 4}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": "stream"}], "max_tokens": 4}),
    ("/v1/chat/completions",
     {"messages": [{"role": "user", "content": "tools"}], "max_tokens": 3,
      "tools": TOOLS}),
])
def test_streaming(servers, route, body):
    (js, jt), (ts, tt) = both(servers, route, dict(body, stream=True),
                              raw=True)
    assert js == ts == 200
    je, te = sse_events(jt), sse_events(tt)
    assert [keys(e) for e in je] == [keys(e) for e in te]
    piece = "text" if route == "/v1/completions" else "delta"

    def toks(events):
        out = []
        for e in events:
            c = e["choices"][0][piece]
            out += ids_of(c if isinstance(c, str) else c.get("content", ""))
        return out

    assert toks(je) == toks(te) and len(toks(te)) == body["max_tokens"]
    assert je[-1]["choices"][0]["finish_reason"] == \
        te[-1]["choices"][0]["finish_reason"] == "length"


def test_ollama(servers):
    body = {"prompt": "Why?", "options": {"num_predict": 3}}
    (js, jb), (ts, tb) = both(servers, "/api/generate", body)
    assert js == ts == 200 and keys(jb) == keys(tb)
    assert ids_of(jb["response"]) == ids_of(tb["response"])
    assert jb["done_reason"] == tb["done_reason"] == "length"
    assert jb["eval_count"] == tb["eval_count"] == 3
    body = {"messages": [{"role": "user", "content": "Hey"}],
            "options": {"num_predict": 3}}
    (js, jb), (ts, tb) = both(servers, "/api/chat", body)
    assert js == ts == 200 and keys(jb) == keys(tb)
    assert ids_of(jb["message"]["content"]) == \
        ids_of(tb["message"]["content"])
    assert jb["done_reason"] == tb["done_reason"]


def _run_life_cycle(base):
    s, a = call(base, "/v1/assistants",
                {"name": "helper", "instructions": "Be brief."})
    assert s == 200
    s, t = call(base, "/v1/threads",
                {"messages": [{"role": "user", "content": "Hello"}]})
    s, m = call(base, f"/v1/threads/{t['id']}/messages",
                {"role": "user", "content": "More"})
    s, run = call(base, f"/v1/threads/{t['id']}/runs",
                  {"assistant_id": a["id"], "max_completion_tokens": 3})
    assert s == 200 and run["status"] == "in_progress"
    deadline = time.monotonic() + TIMEOUT
    while True:
        s, r = call(base, f"/v1/threads/{t['id']}/runs/{run['id']}")
        if r["status"] == "completed":
            break
        assert time.monotonic() < deadline, r
        time.sleep(0.05)
    s, msgs = call(base, f"/v1/threads/{t['id']}/messages")
    s, listed = call(base, "/v1/assistants")
    s, got = call(base, f"/v1/assistants/{a['id']}")
    s, missing = call(base, "/v1/threads/thread_none/runs/run_none")
    s2, deleted = call(base, f"/v1/assistants/{a['id']}", method="DELETE")
    return dict(assistant=a, thread=t, message=m, run=run, done=r,
                msgs=msgs, listed=listed, got=got, missing=(s, missing),
                deleted=deleted)


def test_assistants_life_cycle(servers):
    jr, tr = (_run_life_cycle(b) for b in servers)
    for k in jr:
        assert keys(jr[k]) == keys(tr[k]), k
    assert tr["done"]["status"] == "completed"
    assert tr["missing"][0] == 404 and tr["deleted"]["deleted"]
    jtext = jr["msgs"]["data"][-1]["content"][0]["text"]["value"]
    ttext = tr["msgs"]["data"][-1]["content"][0]["text"]["value"]
    assert ids_of(jtext) == ids_of(ttext) and len(ids_of(ttext)) == 3
    assert [m["role"] for m in tr["msgs"]["data"]] == \
        ["user", "user", "assistant"]


def test_assistants_cancel(servers):
    for base in servers:
        s, a = call(base, "/v1/assistants", {"name": "x"})
        s, t = call(base, "/v1/threads", {})
        call(base, f"/v1/threads/{t['id']}/messages",
             {"role": "user", "content": "Long"})
        s, run = call(base, f"/v1/threads/{t['id']}/runs",
                      {"assistant_id": a["id"], "max_completion_tokens": 40})
        s, c = call(base, f"/v1/threads/{t['id']}/runs/{run['id']}/cancel",
                    {})
        assert s == 200 and c["status"] in ("cancelled", "completed")


def test_api_key_and_web_page(engines):
    jeng, teng = engines
    js = JaxServer(JOpenAIServer(jeng, IdTok(), api_key="k1",
                                 mount_web=False).app)
    ps = PortServer(OpenAIServer(teng, IdTok(), api_key="k1",
                                 mount_web=False))
    try:
        for base in (js.base, ps.base):
            s, b = call(base, "/v1/models")
            assert s == 401 and b["error"]["type"] == "authentication_error"
            s, b = call(base, "/v1/models",
                        headers={"Authorization": "Bearer k1"})
            assert s == 200
            assert call(base, "/health")[0] == 200
            assert call(base, "/", raw=True)[0] == 404
    finally:
        js.stop()
        ps.stop()
    ps = PortServer(OpenAIServer(teng, IdTok()))
    try:
        for path in ("/", "/web"):
            s, page = call(ps.base, path, raw=True)
            assert s == 200 and "<html" in page.lower()
    finally:
        ps.stop()


def test_out_of_vocab_prompt_is_refused():
    """A "hello" chat on a vocabulary of 96 (SimpleTokenizer: every
    codepoint past 95) and a token id past the vocabulary get HTTP 400
    naming the vocabulary; the JAX server would clamp them."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    spec = spec_from_hf_config(dict(TINY_DS))
    eng = ServeEngine(init_params_synthetic(spec, seed=0, quant="bf16",
                                            device="cpu"),
                      spec, SchedulerConfig(**SCHED), num_pages=16,
                      device="cpu")
    ps = PortServer(OpenAIServer(eng))  # engine not started: no request
    try:                                # may reach it
        for route, body in (
            ("/v1/chat/completions",
             {"messages": [{"role": "user", "content": "hello"}]}),
            ("/v1/completions", {"prompt": [1, 96]}),
            ("/api/generate", {"prompt": "hello"}),
        ):
            s, b = call(ps.base, route, body)
            assert s == 400, route
            assert "vocabulary of 96" in b["error"]["message"]
        assert call(ps.base, "/v1/completions", {"prompt": ""})[0] == 400
        for n in (700, 100):  # past the page table; past the 16 pages
            s, b = call(ps.base, "/v1/completions",
                        {"prompt": [1] * n, "max_tokens": 100})
            assert s == 400 and "a query may hold" in b["error"]["message"]
        assert not eng.scheduler.waiting
    finally:
        ps.stop()


def test_tool_functions_match_jax():
    texts = [
        'Let me check.\n<tool_call>\n{"name": "get_weather", "arguments": '
        '{"city": "Paris"}}\n</tool_call>',
        '{"name": "get_weather", "arguments": {"city": "Oslo"}}',
        "just words, no calls { } here",
        '<tool_call>{"name": "a", "parameters": {"x": 1}}</tool_call> and '
        '<tool_call>{bad json}</tool_call>',
    ]
    mask = lambda calls: [dict(c, id=c["id"][:5]) for c in calls]
    for text in texts:
        jc, jcalls = j_tools.parse_tool_calls(text)
        tc, tcalls = tools.parse_tool_calls(text)
        assert jc == tc and mask(jcalls) == mask(tcalls)
    for choice in ("auto", "required", "none",
                   {"type": "function", "function": {"name": "get_weather"}}):
        assert tools.render_tools_preamble(TOOLS, choice) == \
            j_tools.render_tools_preamble(TOOLS, choice)
    msgs = [
        {"role": "user", "content": "weather in Paris?"},
        {"role": "assistant", "tool_calls": [{
            "id": "call_1", "type": "function",
            "function": {"name": "get_weather",
                         "arguments": '{"city": "Paris"}'}}]},
        {"role": "assistant", "content": "x", "tool_calls": [{
            "function": {"name": "f", "arguments": "{not json"}}]},
        {"role": "tool", "tool_call_id": "call_1", "content": "22C sunny"},
    ]
    assert tools.render_tool_messages(msgs) == \
        j_tools.render_tool_messages(msgs)


def test_canned_tool_call_over_http():
    """A tokenizer whose decode is a tool call: tool_calls and
    finish_reason "tool_calls", streamed and not."""
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    class ToolTok(IdTok):
        def decode(self, ids):
            return ('<tool_call>\n{"name": "get_weather", '
                    '"arguments": {"city": "Paris"}}\n</tool_call>')

    spec = spec_from_hf_config(dict(TINY))
    eng = ServeEngine(init_params_synthetic(spec, seed=0, quant="bf16",
                                            device="cpu"),
                      spec, SchedulerConfig(**SCHED), num_pages=128,
                      compute_dtype=torch.float32, device="cpu")
    eng.start()
    ps = PortServer(OpenAIServer(eng, ToolTok()))
    body = {"messages": [{"role": "user", "content": "weather?"}],
            "tools": TOOLS, "max_tokens": 2}
    try:
        s, b = call(ps.base, "/v1/chat/completions", body)
        c = b["choices"][0]
        assert s == 200 and c["finish_reason"] == "tool_calls"
        args = c["message"]["tool_calls"][0]["function"]["arguments"]
        assert json.loads(args) == {"city": "Paris"}
        s, t = call(ps.base, "/v1/chat/completions", dict(body, stream=True),
                    raw=True)
        ev = sse_events(t)
        assert ev[0]["choices"][0]["delta"]["tool_calls"][0]["index"] == 0
        assert ev[-1]["choices"][0]["finish_reason"] == "tool_calls"
    finally:
        ps.stop()
        eng.stop()


def test_server_config_matches_jax(tmp_path):
    cfg = {"port": 9001, "max_batch_size": 4, "quant": "int8",
           "offload": True, "api_key": "k", "num_pages": 128}
    jf = tmp_path / "server.json"
    jf.write_text(json.dumps(cfg))
    yf = tmp_path / "server.yaml"
    yf.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in cfg.items()))
    for f in (jf, yf):
        t = ServerConfig.from_file(str(f), port=9002, host=None)
        j = JServerConfig.from_file(str(f), port=9002, host=None)
        assert vars(t) == vars(j) and t.port == 9002
        assert t.scheduler_config().max_batch_size == 4
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"max_batch": 3}))
    with pytest.raises(ValueError, match="unknown config keys"):
        ServerConfig.from_file(str(bad))
    f = tmp_path / "sparse.json"
    f.write_text(json.dumps({"sparse_budget": 8,
                             "sparse_anchor": "block_max"}))
    t = ServerConfig.from_file(str(f))
    assert vars(t) == vars(JServerConfig.from_file(str(f)))
    f.write_text(json.dumps({"collect_routing": True,
                             "rebalance_interval_steps": 4}))
    t = ServerConfig.from_file(str(f))
    assert vars(t) == vars(JServerConfig.from_file(str(f)))
    for extra, err, what in (
            ({"sparse_anchor": "nearest"}, ValueError, "sparse_anchor"),
            ({"sparse_retrieval": "token"}, ValueError, "sparse_retrieval")):
        f = tmp_path / "unported.json"
        f.write_text(json.dumps(extra))
        with pytest.raises(err, match=what):
            ServerConfig.from_file(str(f))


def test_chat_loop_submits_the_rendered_template(monkeypatch, capsys):
    """chat_loop encodes the rendered template (text), never the template's
    characters as ids; an id past the vocabulary raises."""
    from ktransformers_tpu_torch.engine import local_chat
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    spec = spec_from_hf_config(dict(TINY))
    params = init_params_synthetic(spec, seed=0, quant="bf16", device="cpu")
    seen = []

    def fake_generate(self, prompt_ids, cfg, on_token=None):
        seen.append(prompt_ids)
        on_token(torch.tensor([7]))
        return [[7]]

    monkeypatch.setattr(local_chat.Generator, "generate", fake_generate)
    lines = iter(["hi", "again"])

    def fake_input(prompt=""):
        try:
            return next(lines)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr("builtins.input", fake_input)
    tok = SimpleTokenizer()
    local_chat.chat_loop(spec, params, tok, max_len=64, device="cpu")
    hist = [{"role": "user", "content": "hi"}]
    first = tok.encode(tok.apply_chat_template(hist))
    assert seen[0] == [first]
    assert all(isinstance(t, int) for t in seen[0][0])
    hist += [{"role": "assistant", "content": tok.decode([7])},
             {"role": "user", "content": "again"}]
    assert seen[1] == [tok.encode(tok.apply_chat_template(hist))]
    lines = iter(["été"])  # codepoints 233: past 128
    with pytest.raises(ValueError, match="vocabulary of 128"):
        local_chat.chat_loop(spec, params, tok, max_len=64, device="cpu")
    # with a draft, greedy turns go to draft_generate with the same ids
    from ktransformers_tpu_torch.engine import draft_spec

    drafted = []

    def fake_draft(target, draft, ids, cfg):
        drafted.append((draft, ids))
        return [7], None

    monkeypatch.setattr(draft_spec, "draft_generate", fake_draft)
    lines = iter(["hi"])
    sentinel = object()
    local_chat.chat_loop(spec, params, tok, max_len=64, temperature=0.0,
                         draft=sentinel, device="cpu")
    assert drafted == [(sentinel, first)]


def test_mmlu_eval_http(servers, tmp_path):
    from ktransformers_tpu.utils.eval import mmlu_eval_http as j_mmlu

    from ktransformers_tpu_torch.utils.eval import mmlu_eval_http

    data = [{"question": "2+2?", "choices": ["3", "4"], "answer": 1},
            {"question": "Sky?", "choices": ["Blue", "Red", "Tea"],
             "answer": 0}]
    path = tmp_path / "mc.json"
    path.write_text(json.dumps(data))
    jbase, tbase = servers
    got = mmlu_eval_http(tbase, str(path), timeout=TIMEOUT)
    assert got["n"] == 2 and 0.0 <= got["accuracy"] <= 1.0
    assert got == j_mmlu(jbase, str(path))
    assert mmlu_eval_http(jbase, str(path), limit=1)["n"] == 1


BLOCKED = ("aiohttp", "click", "yaml", "safetensors", "transformers")


def test_front_door_without_optional_packages(tmp_path):
    """The card's installation has none of aiohttp, click, PyYAML,
    safetensors or transformers: with each blocked, the port's server
    answers a request, the CLI prints its help, a packed directory loads,
    the safetensors reader reads and the placement library resolves."""
    from ktransformers_tpu_torch.models.checkpoint import save_params
    from ktransformers_tpu_torch.models.init import init_params_synthetic

    spec = spec_from_hf_config(dict(TINY))
    packed = tmp_path / "packed"
    save_params(init_params_synthetic(spec, seed=0, quant="int8",
                                      moe_quant="int4_g", device="cpu"),
                str(packed))
    (packed / "config.json").write_text(json.dumps(TINY))
    script = textwrap.dedent(f"""
        import sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        import json, urllib.request
        import torch
        torch.set_num_threads(1)
        from ktransformers_tpu_torch.cli.main import main
        from ktransformers_tpu_torch.engine.local_chat import load_model
        from ktransformers_tpu_torch.loader.safetensors_io import (
            SafetensorsFile)
        from ktransformers_tpu_torch.placement.library import load_placement
        from ktransformers_tpu_torch.serving.engine import ServeEngine
        from ktransformers_tpu_torch.serving.scheduler import SchedulerConfig
        from ktransformers_tpu_torch.serving.server import serve
        try:
            main(["--help"])
        except SystemExit as e:
            assert e.code == 0
        f = SafetensorsFile({str(packed / 'params.safetensors')!r})
        assert len(f.keys()) > 10
        quant = load_placement("deepseek-v2-lite").quant_for(
            "layers.1.moe.experts")
        assert quant == ("int4_g", 128), quant
        spec, params = load_model({str(packed)!r}, device="cpu")
        eng = ServeEngine(params, spec, SchedulerConfig(**{SCHED!r}),
                          num_pages=16, device="cpu")
        srv = serve(eng, host="127.0.0.1", port=0, block=False)
        req = urllib.request.Request(
            f"http://127.0.0.1:{{srv.port}}/v1/completions",
            data=json.dumps({{"prompt": [1, 2, 3], "max_tokens": 2}}).encode(),
            headers={{"Content-Type": "application/json"}})
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.load(r)
        srv.stop()
        eng.stop()
        assert body["usage"]["completion_tokens"] == 2, body
        for name in {BLOCKED!r}:
            assert sys.modules[name] is None, name
        print("FRONT-DOOR-OK")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert "FRONT-DOOR-OK" in out.stdout, out.stderr[-3000:]


def test_id_tokenizer_and_tokenizer_fallback(capsys):
    """load_tokenizer's "ids" gives the IdTokenizer, which chip_smoke.py's
    front door and token-id clients use: ids in as text, ids out; text
    that is not ids gets HTTP 400. A directory without a tokenizer falls
    back to SimpleTokenizer and says so on stderr."""
    from ktransformers_tpu_torch.engine.local_chat import load_tokenizer
    from ktransformers_tpu_torch.models.init import init_params_synthetic
    from ktransformers_tpu_torch.serving.server import IdTokenizer

    tok = load_tokenizer("unused", "ids")
    assert isinstance(tok, IdTokenizer)
    assert tok.encode(" 5 6\n7") == [5, 6, 7] and tok.decode([5, 6]) == " 5 6"
    assert isinstance(load_tokenizer("/no/such/dir"), SimpleTokenizer)
    assert "using SimpleTokenizer" in capsys.readouterr().err
    spec = spec_from_hf_config(dict(TINY))
    eng = ServeEngine(init_params_synthetic(spec, seed=0, quant="bf16",
                                            device="cpu"),
                      spec, SchedulerConfig(**SCHED), num_pages=32,
                      compute_dtype=torch.float32, device="cpu")
    eng.start()
    ps = PortServer(OpenAIServer(eng, tok))
    try:
        s, b = call(ps.base, "/v1/completions",
                    {"prompt": " 3 4 5", "max_tokens": 3})
        toks = tok.encode(b["choices"][0]["text"])
        assert s == 200 and len(toks) == 3
        s, c = call(ps.base, "/v1/completions",
                    {"prompt": [3, 4, 5], "max_tokens": 3})
        assert tok.encode(c["choices"][0]["text"]) == toks
        s, b = call(ps.base, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "3 4 5"}],
            "max_tokens": 3})
        assert tok.encode(b["choices"][0]["message"]["content"]) == toks
        s, b = call(ps.base, "/api/generate", {"prompt": "three"})
        assert s == 400 and "integers" in b["error"]["message"]
    finally:
        ps.stop()
        eng.stop()
