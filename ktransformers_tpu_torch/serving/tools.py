"""OpenAI tool / function calling for the chat API (counterpart of
ktransformers_tpu/serving/tools.py, the same strings).

The request carries ``tools`` and ``tool_choice``; the response carries
``tool_calls`` and finish_reason "tool_calls". The model-side convention is
the one DeepSeek / Qwen chat templates use: tool schemas go in a system
preamble and the model emits

    <tool_call>
    {"name": "...", "arguments": {...}}
    </tool_call>

blocks; a bare top-level JSON object with name / arguments is taken too.
"""

from __future__ import annotations

import json
import re
import uuid

_TOOL_CALL_RE = re.compile(
    r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL
)


def render_tools_preamble(tools: list, tool_choice) -> str:
    """System-prompt preamble describing the available tools and the
    expected call format (what a served model's own chat template would
    otherwise say)."""
    lines = [
        "You may call functions to help answer. Available tools:",
    ]
    for t in tools or []:
        fn = t.get("function", t)
        lines.append(json.dumps({
            "name": fn.get("name"),
            "description": fn.get("description", ""),
            "parameters": fn.get("parameters", {}),
        }))
    if isinstance(tool_choice, dict):
        want = tool_choice.get("function", {}).get("name")
        lines.append(f"You MUST call the function `{want}`.")
    elif tool_choice == "required":
        lines.append("You MUST call one of the functions.")
    lines.append(
        "To call a function, emit exactly:\n"
        '<tool_call>\n{"name": "<function-name>", "arguments": {...}}\n'
        "</tool_call>"
    )
    return "\n".join(lines)


def render_tool_messages(messages: list) -> list:
    """Flatten assistant tool_calls / tool-role messages into plain text
    turns for templates (incl. the fallback) that don't know the roles."""
    out = []
    for m in messages:
        role = m.get("role")
        if role == "assistant" and m.get("tool_calls"):
            def _args(c):
                a = c["function"].get("arguments", {})
                if isinstance(a, str):
                    # client-supplied history: malformed JSON must not 500
                    # the request path — pass the raw string through
                    try:
                        return json.loads(a)
                    except (json.JSONDecodeError, ValueError):
                        return a
                return a

            calls = "\n".join(
                "<tool_call>\n"
                + json.dumps({
                    "name": c["function"]["name"],
                    "arguments": _args(c),
                })
                + "\n</tool_call>"
                for c in m["tool_calls"]
            )
            content = (m.get("content") or "") + calls
            out.append({"role": "assistant", "content": content})
        elif role == "tool":
            out.append({
                "role": "user",
                "content": (
                    f"<tool_response>\n{m.get('content', '')}\n"
                    "</tool_response>"
                ),
            })
        else:
            out.append(m)
    return out


def parse_tool_calls(text: str):
    """Extract tool calls from generated text.

    Returns (content_without_calls, calls) where calls is the OpenAI
    `tool_calls` list ([] when none parsed)."""
    calls = []

    def mk(obj):
        args = obj.get("arguments", obj.get("parameters", {}))
        if not isinstance(args, str):
            args = json.dumps(args)
        return {
            "id": "call_" + uuid.uuid4().hex[:16],
            "type": "function",
            "function": {"name": obj.get("name"), "arguments": args},
        }

    content = text
    for m in _TOOL_CALL_RE.finditer(text):
        try:
            obj = json.loads(m.group(1))
        except json.JSONDecodeError:
            continue
        if obj.get("name"):
            calls.append(mk(obj))
    if calls:
        content = _TOOL_CALL_RE.sub("", text).strip()
        return content, calls

    # bare JSON object fallback: the whole (stripped) output is one call
    stripped = text.strip()
    if stripped.startswith("{") and stripped.endswith("}"):
        try:
            obj = json.loads(stripped)
            if obj.get("name") and (
                "arguments" in obj or "parameters" in obj
            ):
                return "", [mk(obj)]
        except json.JSONDecodeError:
            pass
    return content, []
