"""The model gateway (``nano_tpu_torch.serve.gateway``) against the JAX
package's on the CPU, through in-process connections
(tests/test_torch_serve.py's ``Conn``): ``NativeGGUFGateway`` on a GGUF
file the port writes (the frames of three requests with different
samplers equal to the JAX gateway's, one decoder across them, the pieces
equal to the port's ``Session`` stream); the registry and hot-swap
replies; the llama.cpp backend gated as in JAX; the transformers backend
on a toy model; a mid-stream stop and the legacy framing."""

import asyncio
import json
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JConfig
from nano_tpu.serve import gateway as jgw
from nano_tpu.tokenizer import bpe as jbpe
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.io import gguf as tgguf
from nano_tpu_torch.serve import gateway as tgw
from nano_tpu_torch.tokenizer import bpe as tbpe
from tests.test_torch_serve import CLOSE, Conn, n_ends

QWEN3 = dict(block_size=64, vocab_size=256, n_layer=2, n_embd=64, n_head=2,
             n_kv_head=1, n_hidden=96, head_dim=32, use_qk_norm=True,
             rope_style="half", rope_theta=1e6, norm_eps=1e-6,
             tie_embeddings=True)


async def talk(gw, msgs, n_replies, after=None):
    """`msgs` to gw.handle on one connection; the frames once `n_replies`
    replies ended (JSON frames parsed)."""
    conn = Conn()
    task = asyncio.create_task(gw.handle(conn))
    for m in msgs:
        conn.inbox.put_nowait(m)
    if after is not None:
        await after(conn)
    await conn.wait_for(lambda f: n_ends(f) >= n_replies, timeout=120)
    conn.inbox.put_nowait(CLOSE)
    await asyncio.wait_for(task, 60)
    return [json.loads(f) for f in conn.frames]


def gen_req(prompt, **kw):
    return json.dumps({"prompt": prompt, "max_new_tokens": 8,
                       "temperature": 0.0, **kw})


def _write_gguf(path, quant):
    """A Qwen3-shaped GGUF file the port writes."""
    cfg = JConfig(**QWEN3)
    rng = np.random.RandomState(0)
    E, F, V, L = cfg.n_embd, cfg.n_hidden, cfg.vocab_size, cfg.n_layer
    HD, KVD = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim

    def w(*s):
        return torch.from_numpy((rng.randn(*s) * 0.05).astype(np.float32))

    params = {"tok_embeddings": w(V, E), "norm": w(E) + 1, "blocks": {
        "attn_norm": w(L, E) + 1, "ffn_norm": w(L, E) + 1,
        "wq": w(L, E, HD), "wk": w(L, E, KVD), "wv": w(L, E, KVD),
        "wo": w(L, HD, E), "w1": w(L, E, F), "w2": w(L, F, E),
        "w3": w(L, E, F), "q_norm": w(L, cfg.head_dim) + 1,
        "k_norm": w(L, cfg.head_dim) + 1}}
    tok = tbpe.BpeTokenizer([bytes([i]) for i in range(256)], [0.0] * 256)
    tgguf.write_gguf(path, params, teng.ModelConfig(**QWEN3), tok,
                     arch="qwen3", quant=quant)
    return path


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    """-> quant -> the file (f32 and Q8_0, written once)."""
    d = tmp_path_factory.mktemp("gguf")
    return {q: _write_gguf(str(d / f"m_{q}.gguf"), q) for q in ("f32", "q8_0")}


SAMPLERS = ({}, {"repetition_penalty": 1.3}, {"top_p": 0.5,
                                                "repetition_penalty": 1.1})


def test_native_gguf_gateway_matches_jax(gguf_path):
    """On an f32 file, whose dense weights both packages multiply alike
    (a Q8_0 file's the port keeps in its rows form).  Greedy: the packages
    draw from different generators."""
    gguf_path = gguf_path["f32"]
    msgs = [gen_req("hello", template=False, **SAMPLERS[0]),
            gen_req("hello", template=True, **SAMPLERS[1]),
            gen_req("abcde", max_new_tokens=12),
            gen_req("ab", template=False, **SAMPLERS[2])]
    jg = jgw.make_gateway(gguf_path, n_ctx=64)
    tg = tgw.make_gateway(gguf_path, n_ctx=64, device="cpu")
    assert isinstance(jg, jgw.NativeGGUFGateway)
    assert isinstance(tg, tgw.NativeGGUFGateway)
    # the JAX gateway's context computes in f32 here as the port's does
    # (its bf16 default rounds differently on XLA's CPU and PyTorch's)
    import jax.numpy as jnp
    from nano_tpu.infer import engine as jeng
    jg.ctx = jeng.LLMContext.from_gguf(gguf_path, max_seq_len=64,
                                       dtype=jnp.float32)
    tg.ctx = teng.LLMContext.from_gguf(gguf_path, max_seq_len=64,
                                       dtype=torch.float32, device="cpu")
    jf = asyncio.run(talk(jg, msgs, 4))
    tf = asyncio.run(talk(tg, msgs, 4))
    assert tf == jf
    assert [f for f in tf if "done" in f] == [{"done": True,
                                               "reason": "stop"}] * 4
    assert sum("text" in f for f in tf) > 8


def test_native_gguf_gateway_one_decoder_and_session_pieces(gguf_path):
    """The default (bf16) gateway keeps one context and one decoder
    across requests with different samplers — a graph each, reused — and
    its pieces are the port's Session stream (a Q8_0 file: the rows
    form)."""
    gguf_path = gguf_path["q8_0"]
    gw = tgw.NativeGGUFGateway(gguf_path, n_ctx=64, device="cpu")
    ctx = gw.ctx
    texts, decoders = [], []
    for kw in SAMPLERS + SAMPLERS[:1]:
        frames = asyncio.run(talk(gw, [gen_req("hello", template=False,
                                               **kw)], 1))
        texts.append("".join(f.get("text", "") for f in frames))
        decoders.append(ctx._decoder)
        assert gw.ctx is ctx
    assert all(d is decoders[0] for d in decoders)
    assert len(ctx._decoder.graphs) == len(SAMPLERS)
    from nano_tpu_torch.ops import sampling
    ctx.sampler = sampling.SamplerConfig(temperature=0.0, top_p=0.8,
                                         repetition_penalty=1.3)
    s = teng.generate_sync(ctx, "hello", max_new_tokens=8)
    sdec = ctx.stream_decoder()
    want = "".join(sdec.feed(t) for t in s.output_ids) + sdec.flush()
    assert texts[1] == want and texts[0] == texts[3]


def test_registry_and_hot_swap_match_jax(monkeypatch):
    class FakeLlama:
        def __init__(self, model_path, **kw):
            self.tag = model_path.rsplit("/", 1)[-1].removesuffix(".gguf")

        def create_completion(self, prompt, **kw):
            yield {"choices": [{"text": f"{self.tag}:{prompt}"}]}

    fake = types.ModuleType("llama_cpp")
    fake.Llama = FakeLlama
    monkeypatch.setitem(sys.modules, "llama_cpp", fake)
    entries = ["alpha=/m/alpha.gguf", "/m/beta.gguf"]
    assert tgw.parse_model_registry(entries) == jgw.parse_model_registry(
        entries)
    for bad in (["a=/x", "a=/y"], ["=/x"], ["a="]):
        with pytest.raises(ValueError) as te:
            tgw.parse_model_registry(bad)
        with pytest.raises(ValueError) as je:
            jgw.parse_model_registry(bad)
        assert str(te.value) == str(je.value)

    def script(mod):
        gw = mod.SwitchableGateway(mod.parse_model_registry(entries),
                                   backend="gguf-llama")
        msgs = [json.dumps({"list_models": True}),
                gen_req("hi", template=False),
                json.dumps({"switch_model": "alpha"}),
                json.dumps({"switch_model": "nope"}),
                json.dumps({"switch_model": "beta.gguf"}),
                json.dumps({"get_current_model": True}),
                gen_req("hi", template=False)]

        async def go():
            got = await talk(gw, msgs, len(msgs))
            async with gw.lock:                 # a generation in flight
                got += await talk(gw, [json.dumps(
                    {"switch_model": "alpha"})], 1)
            return got, gw.current
        return asyncio.run(go())

    (jf, jcur), (tf, tcur) = script(jgw), script(tgw)
    assert tf == jf and tcur == jcur == "beta.gguf"
    assert {"text": "beta:hi"} in tf and {"text": "alpha:hi"} in tf
    assert "busy" in tf[-1]["error"]


def test_llama_cpp_backend_is_gated_as_in_jax(tmp_path, monkeypatch):
    monkeypatch.delitem(sys.modules, "llama_cpp", raising=False)
    missing = str(tmp_path / "missing.gguf")
    with pytest.raises(RuntimeError, match="llama-cpp-python"):
        jgw.make_gateway(missing)
    with pytest.raises(RuntimeError, match="llama-cpp-python"):
        tgw.make_gateway(missing, device="cpu")
    # the port's engine never falls back quietly onto the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgw.make_gateway(missing)
    with pytest.raises(ValueError, match="unknown gateway backend"):
        tgw.make_gateway("x", backend="onnx")


def test_hf_gateway_matches_jax(tmp_path):
    pytest.importorskip("transformers")
    from transformers import Qwen3Config, Qwen3ForCausalLM
    from tests.test_qwen import _write_toy_hf_tokenizer_json

    d = tmp_path / "hf"
    d.mkdir()
    qcfg = Qwen3Config(
        vocab_size=512, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=16, max_position_embeddings=64, tie_word_embeddings=False)
    torch.manual_seed(0)
    Qwen3ForCausalLM(qcfg).save_pretrained(str(d), safe_serialization=True)
    _write_toy_hf_tokenizer_json(str(d / "tokenizer.json"), 512)
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast"}))
    msgs = [gen_req("he", template=False, max_new_tokens=6)]
    jf = asyncio.run(talk(jgw.HFGateway(str(d)), msgs, 1))
    tf = asyncio.run(talk(tgw.make_gateway(str(d), backend="hf",
                                           device="cpu"), msgs, 1))
    assert tf == jf and tf[-1] == {"done": True, "reason": "stop"}
    assert "".join(f.get("text", "") for f in tf)


def test_midstream_stop_and_legacy_separator():
    assert tgw._legacy_prompt("00003|abc") == "abc"
    assert tgw._legacy_prompt("00003abc") == "abc"
    for m in ("STOP", b"STOP", '{"stop": true}', '{"prompt": "x"}', "x"):
        assert tgw._is_stop(m) == jgw._is_stop(m)

    class SlowGateway(tgw._Gateway):
        def __init__(self):
            self.lock = asyncio.Lock()
            self.calls = []

        def _generate_stream(self, prompt, template, max_new_tokens,
                             temperature, top_p, repetition_penalty):
            self.calls.append(prompt)
            ev = threading.Event()

            def gen():
                for i in range(max_new_tokens):
                    if ev.is_set():
                        return
                    time.sleep(0.01)
                    yield f"t{i} "
            return gen(), [], ev.set

    gw = SlowGateway()

    async def stop_after_first(conn):
        await conn.wait_for(lambda f: len(f) >= 1)
        conn.inbox.put_nowait(json.dumps({"stop": True}))

    async def go():
        first = await talk(gw, [json.dumps({"stop": True}),
                                gen_req("long", max_new_tokens=5000)], 1,
                           after=stop_after_first)
        second = await talk(gw, [f"{5:05d}|hello"], 1)
        return first, second

    first, second = asyncio.run(go())
    assert first[-1] == {"done": True, "reason": "interrupted"}
    assert len(first) < 1000
    assert second[-1] == {"done": True, "reason": "stop"}
    assert len(second) == 257              # the default max_new_tokens
    assert gw.calls == ["long", "hello"]
