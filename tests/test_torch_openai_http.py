"""The OpenAI HTTP server (``nano_tpu_torch.serve.openai_http``) against the
JAX package's ``OpenAIServer`` on the CPU, both through aiohttp's test
client as tests/test_openai_http.py serves the JAX one: the same f32 .bin
(tests/test_torch_serve.py's), greedy, the same requests; one-shot and SSE
responses equal apart from ``id`` / ``created``, the same validation
statuses and messages, stop sequences (also one that completes in the
flushed tail), routing by "model" to a served LoRA adapter.  Also the
transport-free methods alone: the SSE pieces concatenated equal the
one-shot text, and the usage counts."""

import asyncio
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from nano_tpu.infer.engine import LLMContext as JContext
from nano_tpu.io import binfmt as jbin
from nano_tpu.models import gpt as jgpt
from nano_tpu.serve import openai_http as jhttp
from nano_tpu.serve import wss as jwss
from nano_tpu_torch.infer.engine import LLMContext as TContext
from nano_tpu_torch.serve import openai_http as thttp
from nano_tpu_torch.serve import wss as twss
from tests.test_torch_serve import jax_ctx, port_ctx, write_tiny_bin

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

GREEDY = {"temperature": 0.0, "repetition_penalty": 1.0}
PACKAGES = ((jwss, jhttp), (twss, thttp))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The .bin, a rank-4 LoRA .bin for it, and a context of each package
    (made once)."""
    d = tmp_path_factory.mktemp("openai")
    path = write_tiny_bin(str(d / "m.bin"))
    j = jax_ctx(path)
    rng = np.random.RandomState(0)
    lora = jgpt.init_lora_params(jax.random.PRNGKey(9), j.cfg, rank=4)
    lora = jax.tree.map(lambda x: jnp.asarray(
        rng.randn(*x.shape).astype(np.float32) * 0.3), lora)
    lora_path = str(d / "l.bin")
    jbin.write_lora(lora_path, lora, j.cfg, rank=4, alpha=32)
    return dict(path=path, lora=lora_path, ctxs=(j, port_ctx(path)))


def _strip(obj):
    """A response without its per-request id and timestamps."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k != "created" and not (k == "id" and str(v).startswith(
                    ("cmpl-", "chatcmpl-")))}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_strip(v) for v in obj)
    return obj


async def _read(resp):
    """(status, JSON body) or (status, [SSE events..., None for DONE])."""
    if not resp.headers["Content-Type"].startswith("text/event-stream"):
        return resp.status, await resp.json()
    events = []
    async for line in resp.content:
        line = line.decode().strip()
        if not line.startswith("data: "):
            continue
        body = line[len("data: "):]
        if body == "[DONE]":
            events.append(None)
            break
        events.append(json.loads(body))
    return resp.status, events


def _exchange(files, calls, **pool_kw):
    """Each package's server answers `calls` [(method, path, json or raw
    bytes)] in order -> (JAX answers, port answers), ids stripped."""
    out = []
    for (wss, http), ctx in zip(PACKAGES, files["ctxs"]):
        async def run():
            pool = wss.WSServer(ctx, **{"n_slots": 4, "template": True,
                                        "model_name": "toy.bin", **pool_kw})
            client = TestClient(TestServer(http.OpenAIServer(pool).app()))
            await client.start_server()
            got = []
            try:
                for method, url, body in calls:
                    kw = ({"data": body} if isinstance(body, bytes)
                          else {"json": body} if body is not None else {})
                    r = await getattr(client, method)(url, **kw)
                    got.append(await _read(r))
            finally:
                await client.close()
                for s in pool._steppers:
                    if s is not None:
                        s.cancel()
            return got
        out.append(_strip(asyncio.run(run())))
    return out


def test_models_and_completions_match_jax(files):
    chat = {"messages": [{"role": "system", "content": "be brief"},
                         {"role": "user", "content": "abc"}],
            "max_tokens": 8, **GREEDY}
    comp = {"prompt": "abcd", "max_tokens": 10, **GREEDY}
    calls = [("get", "/v1/models", None),
             ("post", "/v1/chat/completions", chat),
             ("post", "/v1/chat/completions", {**chat, "stream": True}),
             ("post", "/v1/completions", comp),
             ("post", "/v1/completions", {**comp, "stream": True}),
             ("post", "/v1/completions", {**comp, "max_tokens": 1})]
    j, t = _exchange(files, calls)
    assert t == j
    (_, one), (_, events) = t[3], t[4]
    assert events[-1] is None
    assert "".join(e["choices"][0]["text"] for e in events[:-2]) \
        == one["choices"][0]["text"]
    assert t[2][1][0]["choices"][0]["delta"] == {"role": "assistant"}
    assert t[5][1]["usage"]["completion_tokens"] == 1


def test_stop_sequences_match_jax(files):
    comp = {"prompt": "abcd", "max_tokens": 12, **GREEDY}
    full = _exchange(files, [("post", "/v1/completions", comp)])[1][0][1]
    text = full["choices"][0]["text"]
    stop = text[2:4]
    calls = [("post", "/v1/completions", {**comp, "stop": stop}),
             ("post", "/v1/completions", {**comp, "stop": [stop, "zz"],
                                          "stream": True}),
             ("post", "/v1/chat/completions", {
                 "messages": [{"role": "user", "content": "ab"}],
                 "max_tokens": 12, "stop": stop, **GREEDY})]
    j, t = _exchange(files, calls)
    assert t == j
    out = t[0][1]
    assert out["choices"][0]["text"] == text[:text.find(stop)]
    assert out["choices"][0]["finish_reason"] == "stop"
    assert out["usage"]["completion_tokens"] < comp["max_tokens"]
    events = t[1][1]
    assert "".join(e["choices"][0]["text"] for e in events[:-2]) \
        == text[:text.find(stop)]
    assert events[-2]["choices"][0]["finish_reason"] == "stop"


def test_stop_completed_in_the_flushed_tail_matches_jax(files, monkeypatch):
    """A stop that shows only when the stream decoder flushes its held
    tail still ends with finish_reason "stop"."""
    class HoldAll:
        def __init__(self, tok):
            self.tok, self.toks = tok, []

        def feed(self, t):
            self.toks.append(t)
            return ""

        def flush(self):
            out, self.toks = self.tok.decode(self.toks), []
            return out

    comp = {"prompt": "abcd", "max_tokens": 6, **GREEDY}
    full = _exchange(files, [("post", "/v1/completions", comp)])[1][0][1]
    text = full["choices"][0]["text"]
    stop = text[2:4]
    for cls in (JContext, TContext):
        monkeypatch.setattr(cls, "stream_decoder",
                            lambda self: HoldAll(self.tokenizer))
    calls = [("post", "/v1/completions", {**comp, "stop": stop,
                                          "stream": s}) for s in (False, True)]
    j, t = _exchange(files, calls)
    assert t == j
    assert t[0][1]["choices"][0] == {"index": 0, "finish_reason": "stop",
                                     "text": text[:text.find(stop)]}
    assert t[1][1][-2]["choices"][0]["finish_reason"] == "stop"


def test_validation_matches_jax(files):
    calls = [("post", "/v1/chat/completions",
              {"messages": [{"role": "user", "content": "x"}], "n": 2}),
             ("post", "/v1/chat/completions", {"messages": []}),
             ("post", "/v1/chat/completions", {"messages": "hi"}),
             ("post", "/v1/completions", {"prompt": ["a", "b"]}),
             ("post", "/v1/completions", {"prompt": 5}),
             ("post", "/v1/completions", {"prompt": ["ab"], "max_tokens": 3,
                                          **GREEDY}),
             ("post", "/v1/completions", b"not json"),
             ("get", "/stats", None)]
    j, t = _exchange(files, calls)
    for k in ("uptime_s", "tok_s_60s"):
        j[-1][1].pop(k), t[-1][1].pop(k)
    assert t == j
    assert [s for s, _ in t] == [400] * 5 + [200, 400, 200]
    assert t[0][1] == {"error": {"message": "only n=1 is supported",
                                 "type": "invalid_request_error"}}
    assert t[-1][1]["requests_total"] == 1


def test_adapter_routing_matches_jax(files):
    def comp(**extra):
        return ("post", "/v1/completions", {"prompt": "abcd", "max_tokens": 8,
                                            **GREEDY, **extra})
    calls = [("get", "/v1/models", None), comp(), comp(model="tuned"),
             comp(model="gpt-4o")]
    j, t = _exchange(files, calls, template=False, model_name="base",
                     adapters={"tuned": files["lora"]})
    assert t == j
    assert [m["id"] for m in t[0][1]["data"]] == ["base", "tuned"]
    text = [r[1]["choices"][0]["text"] for r in t[1:]]
    assert text[0] != text[1] and text[2] == text[0]


def test_transport_free_methods(files):
    """The methods the aiohttp handlers wrap, driven directly (no HTTP
    library in the way)."""
    ctx = files["ctxs"][1]

    async def run():
        pool = twss.WSServer(ctx, n_slots=2, template=True,
                             model_name="toy.bin")
        srv = thttp.OpenAIServer(pool)
        req = {"prompt": "abcd", "max_tokens": 10, **GREEDY}
        one = await srv.completions(req)
        sse = await srv.completions({**req, "stream": True})
        events = [e async for e in sse.events]
        bad = await srv.chat({"messages": []})
        models = srv.models()
        for s in pool._steppers:
            s.cancel()
        return one, events, bad, models

    one, events, bad, models = asyncio.run(run())
    assert one.status == 200 and one.events is None
    body = one.body
    assert "".join(e["choices"][0]["text"] for e in events[:-1]) \
        == body["choices"][0]["text"]
    assert events[-1]["choices"][0]["finish_reason"] \
        == body["choices"][0]["finish_reason"]
    from nano_tpu_torch.infer.engine import Session
    s = Session(ctx, "abcd", max_new_tokens=10)
    while s.step() is not None:
        pass
    n, m = len(s.prompt_ids), len(s.output_ids)
    assert body["usage"] == {"prompt_tokens": n, "completion_tokens": m,
                             "total_tokens": n + m}
    assert body["choices"][0]["text"] == ctx.decode(s.output_ids)
    assert bad.status == 400 and bad.events is None
    assert [m["id"] for m in models.body["data"]] == ["toy.bin"]
