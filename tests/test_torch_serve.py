"""The WebSocket server (``nano_tpu_torch.serve.wss``) against the JAX
package's ``WSServer`` on the CPU: the same f32 .bin (3 layers, width 32,
vocab 64, the shape of tests/test_observe.py), greedy, the same messages
through in-process connections (``Conn``: recv / send coroutines over
queues) to both servers, the frames compared one by one — tokens, texts,
terminators, ``done`` / ``reason``; the verbs; STOP; pipelined requests;
two replicas on the CPU.  Also the real ``websockets`` transport, the
stepper surviving a failed burst, ``warmup`` covering every burst, and
``serve.cli``."""

import argparse
import asyncio
import json
import time
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.config import ModelConfig as JConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.io import binfmt as jbin
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import sampling as jsamp
from nano_tpu.serve import wss as jwss
from nano_tpu.tokenizer.trie import TrieTokenizer as JTrie
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.serve import cli as tcli
from nano_tpu_torch.serve import wss as twss

TINY = dict(block_size=32, vocab_size=64, n_layer=3, n_embd=32, n_head=4,
            n_kv_head=2, n_hidden=64)
GREEDY = {"temperature": 0.0, "repetition_penalty": 1.0}
CLOSE = object()            # a Conn's recv raises: the client went away


def write_tiny_bin(path: str, seed: int = 1) -> str:
    cfg = JConfig(**TINY)
    params = jgpt.init_params(jax.random.PRNGKey(seed), cfg)
    tok = JTrie()
    tok.build([chr(ord("a") + i) for i in range(26)])
    jbin.write_model(path, jax.tree.map(np.asarray, params), cfg,
                     tok.config, quant="f32")
    return path


def jax_ctx(path, **kw):
    kw.setdefault("sampler", jsamp.SamplerConfig(temperature=0.0,
                                                 repetition_penalty=1.0))
    return jeng.LLMContext.from_bin(path, max_seq_len=32, dtype=jnp.float32,
                                    **kw)


def port_ctx(path, **kw):
    kw.setdefault("sampler", tsamp.SamplerConfig(temperature=0.0,
                                                 repetition_penalty=1.0))
    return teng.LLMContext.from_bin(path, max_seq_len=32,
                                    dtype=torch.float32, device="cpu", **kw)


class Conn:
    """An in-process WebSocket connection: the server's recv() takes the
    client's messages from a queue, its send() appends to `frames`."""

    def __init__(self):
        self.inbox: asyncio.Queue = asyncio.Queue()
        self.frames: list = []
        self.changed = asyncio.Event()

    async def recv(self):
        m = await self.inbox.get()
        if m is CLOSE:
            raise ConnectionError("closed")
        return m

    async def send(self, m):
        self.frames.append(m)
        self.changed.set()

    async def wait_for(self, pred, timeout=60.0):
        """Until pred(frames) holds."""
        deadline = time.monotonic() + timeout
        while not pred(self.frames):
            self.changed.clear()
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"frames so far: {self.frames}")
            try:
                await asyncio.wait_for(self.changed.wait(), left)
            except asyncio.TimeoutError:
                pass


def is_end(frame) -> bool:
    """A frame that ends one reply: the reference protocol's empty frame,
    or a JSON object that is no token frame (done, error, a verb's
    reply)."""
    if frame == "":
        return True
    try:
        obj = json.loads(frame)
    except (TypeError, ValueError):
        return False
    return isinstance(obj, dict) and ("done" in obj or "error" in obj or (
        "token" not in obj and "text" not in obj))


def n_ends(frames) -> int:
    return sum(is_end(f) for f in frames)


async def client(server, msgs, n_replies, after=None):
    """One connection: `msgs` sent at once (pipelined), then (`after`) a
    coroutine of the connection, then the close once `n_replies` replies
    ended.  -> the frames."""
    conn = Conn()
    task = asyncio.create_task(server.handle(conn))
    for m in msgs:
        conn.inbox.put_nowait(m)
    if after is not None:
        await after(conn)
    await conn.wait_for(lambda f: n_ends(f) >= n_replies)
    conn.inbox.put_nowait(CLOSE)
    await asyncio.wait_for(task, 60)
    return conn.frames


def req(prompt, n=8, **kw):
    return json.dumps({"prompt": prompt, "max_new_tokens": n,
                       "template": False, **GREEDY, **kw})


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The .bin and a context of each package over it."""
    path = write_tiny_bin(str(tmp_path_factory.mktemp("serve") / "m.bin"))
    return types.SimpleNamespace(path=path, j=jax_ctx(path),
                                 t=port_ctx(path))


def run_both(both, scenario, **server_kw):
    """scenario(server) on a fresh server of each package -> (JAX, port)."""
    out = []
    for mod, ctx in ((jwss, both.j), (twss, both.t)):
        server = mod.WSServer(ctx, **{"n_slots": 2, "template": False,
                                      **server_kw})

        async def go():
            try:
                return await scenario(server)
            finally:
                for s in server._steppers:
                    if s is not None:
                        s.cancel()
        out.append(asyncio.run(go()))
    return out


@pytest.mark.parametrize("proto", ["json", "reference"])
def test_two_concurrent_clients_match_jax(both, proto):
    prompts = ["abcdef", "hello"]
    if proto == "json":
        msgs = [req(prompts[0]), req(prompts[1], n=6, template=True)]
    else:
        msgs = [f"{len(p):05d}|{p}" for p in prompts]

    async def scenario(server):
        return await asyncio.gather(*[client(server, [m], 1) for m in msgs])

    jf, tf = run_both(both, scenario)
    assert tf == jf
    for frames in tf:
        assert len(frames) >= 3 and is_end(frames[-1])
        if proto == "json":
            assert json.loads(frames[-1])["reason"] in ("stop", "length")
        else:
            assert frames[-1] == ""


def test_verbs_match_jax(both):
    msgs = [req("abc", n=4), json.dumps({"stats": True}),
            json.dumps({"list_models": True}),
            json.dumps({"get_current_model": True}),
            json.dumps({"switch_model": "default"}),
            json.dumps({"switch_model": "nope"}),
            req("abc", n=3, model="nope")]

    async def scenario(server):
        frames = await client(server, msgs, len(msgs))
        return [json.loads(f) for f in frames]

    jf, tf = run_both(both, scenario)
    assert len(tf) == len(jf)
    for j, t in zip(jf, tf):
        if "uptime_s" in j:                 # stats: the clocks differ
            assert sorted(t) == sorted(j)
            for k in ("uptime_s", "tok_s_60s"):
                j.pop(k), t.pop(k)
        assert t == j
    stats = [f for f in tf if "requests_total" in f][0]
    assert stats["requests_total"] == 1 and stats["tokens_total"] == 4
    assert {"error": "unknown model: 'nope'"} in tf
    assert {"ok": False, "current": "default", "switched": False,
            "error": "unknown model: 'nope'"} in tf


def _slow(server, seconds=0.01):
    """Each burst of `server`'s engines takes at least `seconds` (so that a
    STOP lands mid-stream)."""
    for e in server.engines:
        inner = e.step_burst

        def slow(n=1, inner=inner):
            time.sleep(seconds)
            return inner(n)
        e.step_burst = slow


def test_stop_midstream_ends_interrupted(both):
    async def scenario(server):
        _slow(server)

        async def stop_after_first(conn):
            await conn.wait_for(lambda f: len(f) >= 2)
            conn.inbox.put_nowait("STOP")
        frames = await client(server, [req("abc", n=24)], 1,
                              after=stop_after_first)
        full = await client(server, [req("abc", n=24)], 1)
        return frames, full

    for frames, full in run_both(both, scenario):
        assert json.loads(frames[-1]) == {"done": True,
                                          "reason": "interrupted"}
        assert len(frames) < len(full)
        assert frames[:-1] == full[:len(frames) - 1]


def test_pipelined_requests_all_answered_match_jax(both):
    msgs = [req("ab", n=5), req("cd", n=3), f"{2:05d}|ef", req("gh", n=4)]

    async def scenario(server):
        return await client(server, msgs, len(msgs))

    jf, tf = run_both(both, scenario)
    assert tf == jf and n_ends(tf) == 4


def test_two_replicas_on_the_cpu_match_jax(both):
    msgs = [req("abcdef"), req("hello"), req("xyz", n=5)]

    async def scenario(server):
        got = await asyncio.gather(*[client(server, [m], 1) for m in msgs])
        return got, [e.n_slots for e in server.engines], server.stats()

    (jf, jslots, jst), (tf, tslots, tst) = run_both(both, scenario,
                                                    n_slots=1, replicas=2)
    assert tf == jf and tslots == jslots == [1, 1]
    assert tst["replicas"] == 2 and tst["requests_total"] == 3
    assert tst["tokens_total"] == jst["tokens_total"]


def test_replicas_refuse_more_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    ctx = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="replicas=2 but only 1"):
        twss._replica_devices(ctx, 2)
    assert twss._replica_devices(types.SimpleNamespace(
        device=torch.device("cpu")), 3) == [torch.device("cpu")] * 3


def test_websockets_transport(both):
    websockets = pytest.importorskip("websockets")
    expect = []
    s = teng.Session(both.t, "abcdef", max_new_tokens=8)
    while (t := s.step()) is not None:
        expect.append(t)

    async def run():
        server = twss.WSServer(both.t, n_slots=2, template=False)
        async with websockets.serve(server.handle, "127.0.0.1", 0) as srv:
            port = list(srv.sockets)[0].getsockname()[1]
            async with websockets.connect(f"ws://127.0.0.1:{port}") as c:
                await c.send(req("abcdef"))
                toks = []
                while True:
                    m = json.loads(await asyncio.wait_for(c.recv(), 60))
                    if m.get("done"):
                        break
                    toks.append(m["token"])
                await c.send(f"{6:05d}|abcdef")
                text = []
                while (m := await asyncio.wait_for(c.recv(), 60)) != "":
                    text.append(m)
        for st in server._steppers:
            st.cancel()
        return toks, "".join(text)

    toks, text = asyncio.run(run())
    assert toks == expect
    assert text.startswith(both.t.decode(expect))


def test_stepper_survives_a_failed_burst(both):
    """A burst that raises ends the active streams with reason "error";
    the next request is served."""
    async def scenario():
        server = twss.WSServer(both.t, n_slots=2, template=False)
        e = server.engines[0]
        inner, calls = e.step_burst, []

        def flaky(n=1):
            calls.append(n)
            if len(calls) == 1:
                raise RuntimeError("transient")
            return inner(n)
        e.step_burst = flaky
        bad = await client(server, [req("abc", n=6)], 1)
        good = await client(server, [req("abc", n=6)], 1)
        for st in server._steppers:
            st.cancel()
        return bad, good

    bad, good = asyncio.run(scenario())
    assert json.loads(bad[-1]) == {"done": True, "reason": "error"}
    assert json.loads(good[-1])["reason"] == "length"
    assert len(good) == 7 and all(is_end(f) for f in good[-1:])


@pytest.mark.parametrize("burst", [1, 4])
def test_warmup_covers_every_burst(both, burst):
    """BatchedEngine.warmup() (what --warmup runs) captures the one-step
    graphs of every capacity, which a burst of any length replays: serving
    afterwards at `burst` makes no new graph."""
    server = twss.WSServer(both.t, n_slots=2, template=False, burst=burst)
    twss.warm(server)
    e = server.engines[0]
    before = set(e._graphs)

    async def go():
        got = await asyncio.gather(client(server, [req("abcdef", n=20)], 1),
                                   client(server, [req("xy", n=12)], 1))
        for st in server._steppers:
            st.cancel()
        return got

    asyncio.run(go())
    assert set(e._graphs) == before and len(before) > 1


def test_cli_engine_args():
    """--device, --kv_cache int8 -> torch.int8, name=path --lora entries
    -> the adapters registry (the JAX package's build_ctx)."""
    from nano_tpu.serve import cli as jcli
    path = "tests/js/fixtures/tiny_q80.bin"
    argv = ["--model", path, "--lora", "a=x.bin", "--lora", "b=y.bin",
            "-t", "0", "-r", "1.0", "--spec", "2"]
    ap = argparse.ArgumentParser()
    tcli.add_engine_args(ap, port=8080)
    args = ap.parse_args(argv + ["--device", "cpu"])
    ctx, adapters = tcli.build_ctx(args)
    jap = argparse.ArgumentParser()
    jcli.add_engine_args(jap, port=8080)
    jctx, jadapters = jcli.build_ctx(jap.parse_args(argv))
    assert adapters == jadapters == {"a": "x.bin", "b": "y.bin"}
    assert ctx.kv_cache_dtype == torch.int8 and ctx.device.type == "cpu"
    assert ctx.spec_k == jctx.spec_k == 2
    assert ctx.sampler == tsamp.SamplerConfig(
        temperature=0.0, top_p=0.8, repetition_penalty=1.0)
    ap2 = argparse.ArgumentParser()
    tcli.add_engine_args(ap2, port=8080)
    args2 = ap2.parse_args(["--model", path, "--kv_cache", "model",
                            "--device", "cpu"])
    assert tcli.build_ctx(args2)[0].kv_cache_dtype is None
    assert args2.port == 8080 and args2.slots == 8 and args2.burst == 1
