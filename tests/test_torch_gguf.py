"""nano_tpu_torch.io.gguf against nano_tpu.io.gguf: the block
dequantizers, the container reader, write_gguf and convert_gguf bytes, the
four lossless maps onto the port's quantized tensors, the mixed-type
requantization, the quantized device load, from_gguf's greedy streams and
the refusals.  Every comparison is exact: bytes, arrays or tokens."""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.infer import engine as jeng
from nano_tpu.io import binfmt as jbin
from nano_tpu.io import gguf as jg
from nano_tpu.ops import sampling as jsamp
from nano_tpu.tokenizer import bpe as jbpe
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.io import binfmt as tbin
from nano_tpu_torch.io import gguf as tg
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.ops import sampling as tsamp
from nano_tpu_torch.ops.q4k import Q4KTensor
from nano_tpu_torch.ops.qmatmul import Q80Tensor
from nano_tpu_torch.tokenizer import bpe as tbpe

GREEDY = dict(temperature=0.0, repetition_penalty=1.0)
# raw block sizes and the offsets of their f16 scale fields
BLOCK = {tg.GGML_Q8_0: (32, 34, (0,)), tg.GGML_Q4_0: (32, 18, (0,)),
         tg.GGML_Q4_K: (256, 144, (0, 2)), tg.GGML_Q6_K: (256, 210, (208,))}


def tiny_cfg(arch="qwen3", **over):
    cfg = dict(block_size=64, vocab_size=256, n_layer=2, n_embd=64, n_head=2,
               n_kv_head=1, n_hidden=96, head_dim=32,
               use_qk_norm=(arch == "qwen3"), qkv_bias=(arch == "qwen2"),
               rope_style="half" if arch == "qwen3" else "interleaved",
               rope_theta=1e6, norm_eps=1e-6, tie_embeddings=(arch == "qwen3"))
    cfg.update(over)
    return cfg


def tiny_params(cfg, seed=0):
    c = JModelConfig(**cfg)
    rng = np.random.RandomState(seed)
    E, F, V, L = c.n_embd, c.n_hidden, c.vocab_size, c.n_layer
    HD, KVD = c.n_head * c.head_dim, c.n_kv_head * c.head_dim

    def w(*s):
        return (rng.randn(*s) * 0.05).astype(np.float32)

    blocks = {"attn_norm": w(L, E) + 1, "ffn_norm": w(L, E) + 1,
              "wq": w(L, E, HD), "wk": w(L, E, KVD), "wv": w(L, E, KVD),
              "wo": w(L, HD, E), "w1": w(L, E, F), "w2": w(L, F, E),
              "w3": w(L, E, F)}
    if c.use_qk_norm:
        blocks["q_norm"] = w(L, c.head_dim) + 1
        blocks["k_norm"] = w(L, c.head_dim) + 1
    if c.qkv_bias:
        blocks.update(bq=w(L, HD), bk=w(L, KVD), bv=w(L, KVD))
    p = {"tok_embeddings": w(V, E), "norm": w(E) + 1, "blocks": blocks}
    if not c.tie_embeddings:
        p["output"] = w(E, V)
    return p


def toy_bpe(mod):
    vocab = [bytes([i]) for i in range(252)] + [b"ab", b"abc", b"he", b"hel"]
    scores = [0.0] * 252 + [-1.0, -2.0, -3.0, -4.0]
    return mod.BpeTokenizer(vocab, scores)


def _write(tmp_path, arch, quant, name="m.gguf", seed=0, **over):
    cfg = tiny_cfg(arch, **over)
    params = tiny_params(cfg, seed)
    path = str(tmp_path / name)
    jg.write_gguf(path, params, JModelConfig(**cfg), toy_bpe(jbpe), arch=arch,
                  quant=quant)
    return path, cfg, params


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def raw_blocks(gtype, n, seed):
    """Random raw ggml blocks for n values, their f16 scales finite."""
    blen, bbytes, f16_offs = BLOCK[gtype]
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, n // blen * bbytes).astype(np.uint8)
    for b in range(n // blen):
        for off in f16_offs:
            d = np.float16(rng.rand() * 0.1 + 1e-3)
            raw[b * bbytes + off:b * bbytes + off + 2] = np.frombuffer(
                d.tobytes(), np.uint8)
    return raw


# ---------------------------------------------------------------------
# dequantizers and the reader
# ---------------------------------------------------------------------

@pytest.mark.parametrize("gtype,fn", [
    (tg.GGML_Q8_0, "dequant_q8_0"), (tg.GGML_Q4_0, "dequant_q4_0"),
    (tg.GGML_Q4_K, "dequant_q4_k"), (tg.GGML_Q6_K, "dequant_q6_k")])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dequantizers_equal_jax(gtype, fn, seed):
    n = 256 * 3
    raw = raw_blocks(gtype, n, seed)
    got = getattr(tg, fn)(raw, n)
    want = getattr(jg, fn)(raw, n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gtype", [tg.GGML_F16, tg.GGML_BF16, tg.GGML_F32])
def test_float_tensors_equal_jax(gtype):
    raw = np.random.RandomState(3).randint(0, 256, 2 * 6 * 4).astype(np.uint8)
    if gtype != tg.GGML_F32:
        raw = raw[:2 * 6 * 2]
        raw[1::2] &= 0x3F                    # finite f16 / bf16 values
    else:
        raw = np.random.RandomState(3).randn(12).astype(np.float32).view(
            np.uint8)
    got = tg.GGUFTensor("t", (2, 6), gtype, raw).to_f32()
    want = jg.GGUFTensor("t", (2, 6), gtype, raw).to_f32()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["qwen3", "qwen2"])
@pytest.mark.parametrize("quant", ["f32", "f16", "q8_0"])
def test_write_gguf_bytes_equal_jax(tmp_path, arch, quant):
    cfg = tiny_cfg(arch)
    params = tiny_params(cfg, seed=5)
    jp, tp = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jg.write_gguf(jp, params, JModelConfig(**cfg), toy_bpe(jbpe), arch=arch,
                  quant=quant)
    tensors = jax.tree.map(torch.from_numpy, params)
    tg.write_gguf(tp, tensors, ModelConfig(**cfg), toy_bpe(tbpe), arch=arch,
                  quant=quant)
    assert _read(tp) == _read(jp)
    # the reader: metadata, tensors and the checkpoint-layout load
    g, h = tg.GGUFFile(tp), jg.GGUFFile(jp)
    assert sorted(g.meta) == sorted(h.meta)
    for k, v in h.meta.items():
        np.testing.assert_array_equal(np.asarray(g.meta[k]), np.asarray(v))
    assert sorted(g.tensors) == sorted(h.tensors)
    for k, t in h.tensors.items():
        assert g.tensors[k].shape == t.shape and g.tensors[k].ggml_type == \
            t.ggml_type
        np.testing.assert_array_equal(g.tensors[k].to_f32(), t.to_f32())
    cfg_t, pt, mt_t, tok_t = tg.load_gguf_qwen(tp, max_seq_len=48)
    cfg_j, pj, mt_j, tok_j = jg.load_gguf_qwen(jp, max_seq_len=48)
    assert cfg_t.to_dict() == cfg_j.to_dict() and mt_t == mt_j
    assert tok_t.vocab == tok_j.vocab and tok_t.scores == tok_j.scores
    assert tok_t.encode("abc hello") == tok_j.encode("abc hello")
    jax.tree.map(np.testing.assert_array_equal, pt, pj)


# Q4K .bin files hold no Qwen2 (both writers refuse it)
@pytest.mark.parametrize("arch,quant", [("qwen3", "f32"), ("qwen3", "q80"),
                                        ("qwen3", "q4k"), ("qwen2", "f32"),
                                        ("qwen2", "q80")])
@pytest.mark.parametrize("src", ["f32", "q8_0"])
def test_convert_gguf_bytes_equal_jax(tmp_path, arch, src, quant):
    path, _, _ = _write(tmp_path, arch, src, seed=7)
    jp, tp = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jg.convert_gguf(path, jp, quant=quant, group_size=32)
    tg.convert_gguf(path, tp, quant=quant, group_size=32)
    assert _read(tp) == _read(jp)


# ---------------------------------------------------------------------
# the lossless maps and the quantized load
# ---------------------------------------------------------------------

MAPS = [(tg.GGML_Q8_0, "q80_from_q8_0"), (tg.GGML_Q6_K, "q80_from_q6_k"),
        (tg.GGML_Q4_K, "q4k_from_q4_k"), (tg.GGML_Q4_0, "q4k_from_q4_0")]


def _fields(x):
    if isinstance(x, Q80Tensor) or hasattr(x, "group_size"):
        return {"q": x.q, "scales": x.scales}
    return {"packed": x.packed, "scales": x.scales, "biases": x.biases}


@pytest.mark.parametrize("gtype,fn", MAPS)
def test_lossless_maps_equal_jax(gtype, fn):
    out, inn = 3, 512
    raw = raw_blocks(gtype, out * inn, seed=gtype)
    got = getattr(tg, fn)(tg.GGUFTensor("w", (out, inn), gtype, raw))
    want = getattr(jg, fn)(jg.GGUFTensor("w", (out, inn), gtype, raw))
    fg, fw = _fields(got), _fields(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        np.testing.assert_array_equal(fg[k].numpy(), np.asarray(fw[k]),
                                      err_msg=k)
    if isinstance(got, Q80Tensor):
        assert got.group_size == want.group_size == (
            32 if gtype == tg.GGML_Q8_0 else 16)
    else:
        assert got.in_dim == want.in_dim == inn
    # lossless: the device tensor holds the file's values
    np.testing.assert_array_equal(
        got.dequantize(torch.float32).numpy(),
        tg.GGUFTensor("w", (out, inn), gtype, raw).to_f32())


def _swapped(path, swaps):
    """Both packages' GGUFFile of `path` with tensors replaced by raw
    blocks: {name: (ggml type, raw)}."""
    files = []
    for mod in (tg, jg):
        g = mod.GGUFFile(path)
        for name, (gtype, raw) in swaps.items():
            g.tensors[name] = mod.GGUFTensor(name, g.tensors[name].shape,
                                             gtype, raw)
        files.append(g)
    return files


def _assert_params_equal(got, want_jax):
    want = params_from_jax(jax.tree.map(np.asarray, want_jax), device="cpu")
    assert sorted(got) == sorted(want)
    assert sorted(got["blocks"]) == sorted(want["blocks"])

    def eq(a, b, name):
        assert type(a) is type(b), name
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
            return
        for k, v in _fields(b).items():
            assert torch.equal(_fields(a)[k], v), (name, k)
            assert _fields(a)[k].is_contiguous(), (name, k)
        if isinstance(a, Q80Tensor):
            assert (a.group_size, a.w8a8) == (b.group_size, b.w8a8), name
        else:
            assert a.in_dim == b.in_dim, name

    for k in want:
        if k != "blocks":
            eq(got[k], want[k], k)
    for k in want["blocks"]:
        eq(got["blocks"][k], want["blocks"][k], k)


@pytest.mark.parametrize("arch", ["qwen3", "qwen2"])
def test_quantized_load_q8_0_equals_jax(tmp_path, arch):
    path, cfg, _ = _write(tmp_path, arch, "q8_0", seed=2)
    c = ModelConfig(**cfg)
    got = tg.quantized_device_params(tg.GGUFFile(path), c, arch, device="cpu")
    want = jg.quantized_device_params(jg.GGUFFile(path), JModelConfig(**cfg),
                                      arch)
    _assert_params_equal(got, want)
    # gs 32: every product takes the rows form; stacked and contiguous
    wq = got["blocks"]["wq"]
    assert isinstance(wq, Q80Tensor) and wq.group_size == 32
    assert not wq.w8a8 and wq.q.shape[0] == cfg["n_layer"]
    if arch == "qwen3":
        assert got["output_q"] is got["tok_embeddings"]


WIDE = dict(n_embd=256, n_head=2, n_kv_head=1, head_dim=128, n_hidden=256)


@pytest.mark.parametrize("arch", ["qwen3", "qwen2"])
def test_quantized_load_k_quants_equal_jax(tmp_path, arch):
    """Q4_K, Q6_K and Q4_0 blocks in one file: each name of one type maps
    losslessly; wv mixes Q4_K and Q6_K across layers and both packages
    requantize it to Q4K; a tied Q4_K head is requantized to Q80."""
    path, cfg, _ = _write(tmp_path, arch, "q8_0", seed=4, **WIDE)
    c = ModelConfig(**cfg)
    g0 = tg.GGUFFile(path)
    types = {"attn_q": tg.GGML_Q4_K, "attn_k": tg.GGML_Q4_0,
             "attn_output": tg.GGML_Q6_K, "ffn_gate": tg.GGML_Q4_K,
             "ffn_down": tg.GGML_Q6_K}
    swaps = {}
    for i in range(cfg["n_layer"]):
        for theirs, gtype in types.items():
            name = f"blk.{i}.{theirs}.weight"
            swaps[name] = (gtype, raw_blocks(
                gtype, int(np.prod(g0.tensors[name].shape)), seed=i * 7 + gtype))
        name = f"blk.{i}.attn_v.weight"
        gtype = (tg.GGML_Q4_K, tg.GGML_Q6_K)[i % 2]
        swaps[name] = (gtype, raw_blocks(
            gtype, int(np.prod(g0.tensors[name].shape)), seed=100 + i))
    # the tied (qwen3) or untied (qwen2) head as Q4_K
    head = "token_embd.weight" if arch == "qwen3" else "output.weight"
    n = int(np.prod(g0.tensors[head].shape))
    swaps[head] = (tg.GGML_Q4_K, raw_blocks(tg.GGML_Q4_K, n, seed=9))
    tfile, jfile = _swapped(path, swaps)
    got = tg.quantized_device_params(tfile, c, arch, device="cpu")
    want = jg.quantized_device_params(jfile, JModelConfig(**cfg), arch)
    _assert_params_equal(got, want)
    b = got["blocks"]
    assert isinstance(b["wq"], Q4KTensor) and isinstance(b["wk"], Q4KTensor)
    assert isinstance(b["wv"], Q4KTensor)               # requantized
    assert isinstance(b["wo"], Q80Tensor) and b["wo"].group_size == 16
    assert isinstance(b["w3"], Q80Tensor) and b["w3"].group_size == 32
    if arch == "qwen3":
        head = got["output_q"]
        assert isinstance(head, Q80Tensor) and head.group_size == 256
        assert head.w8a8
    else:
        assert isinstance(got["output"], Q4KTensor)
    # the mixed model decodes end to end (unfused Q4K and Q80 gs 16 / 32
    # products, the Q4K head of either kind)
    ctx = teng.LLMContext(cfg=c, params=got, tokenizer=toy_bpe(tbpe),
                          max_seq_len=64, device="cpu", dtype=torch.float32,
                          sampler=tsamp.SamplerConfig(**GREEDY), arch=arch)
    out = teng.generate_on_device(ctx, [5, 6, 7, 8], 6).tolist()
    assert len(out) == 6 and all(0 <= t < c.vocab_size for t in out)


@pytest.mark.parametrize("arch", ["qwen3", "qwen2"])
@pytest.mark.parametrize("quant", ["f32", "q8_0"])
def test_from_gguf_streams_equal_jax(tmp_path, arch, quant):
    path, _, _ = _write(tmp_path, arch, quant, seed=11)
    jctx = jeng.LLMContext.from_gguf(path, dtype=jnp.float32, quantized=False,
                                     sampler=jsamp.SamplerConfig(**GREEDY))
    ids = jctx.encode("abc hello ab")
    want = jeng.generate_on_device(jctx, ids, 16).tolist()
    for quantized in (None, False):
        tctx = teng.LLMContext.from_gguf(
            path, dtype=torch.float32, quantized=quantized, device="cpu",
            sampler=tsamp.SamplerConfig(**GREEDY))
        assert tctx.arch == jctx.arch == arch
        assert tctx.stop_tokens == jctx.stop_tokens
        assert tctx.encode("abc hello ab") == ids
        # a Q8_0 file keeps its Q80 weights, fused as a .bin file's
        b = tctx.params["blocks"]
        fused = quant == "q8_0" and quantized is None
        assert ("wqkv" in b and "w13" in b) == fused
        assert isinstance(b["w13"] if fused else b["w1"], Q80Tensor) == fused
        assert teng.generate_on_device(tctx, ids, 16).tolist() == want


@pytest.mark.parametrize("arch", ["qwen3", "qwen2"])
def test_from_gguf_fuses_q80_products(tmp_path, arch):
    """from_gguf serves a Q8_0 file with wq / wk / wv as one wqkv and w1 /
    w3 as one w13 (the loader's own output stays unfused, as JAX's: see
    test_quantized_load_q8_0_equals_jax), rows concatenated along the
    output dimension; the fused model's logits equal the unfused model's
    within 1e-6 of max|logit| (the same rows and math; the CPU's matmul may
    sum a wider product in another order)."""
    path, cfg, _ = _write(tmp_path, arch, "q8_0", seed=5)
    c = ModelConfig(**cfg)
    ctx = teng.LLMContext.from_gguf(path, dtype=torch.float32, device="cpu",
                                    sampler=tsamp.SamplerConfig(**GREEDY))
    loose = tg.quantized_device_params(tg.GGUFFile(path), c, arch,
                                       device="cpu")
    b, lb = ctx.params["blocks"], loose["blocks"]
    assert not {"wq", "wk", "wv", "w1", "w3"} & set(b)
    for fused, names in (("wqkv", ("wq", "wk", "wv")), ("w13", ("w1", "w3"))):
        w = b[fused]
        assert isinstance(w, Q80Tensor) and w.group_size == 32 and not w.w8a8
        assert w.q.is_contiguous() and w.scales.is_contiguous()
        assert torch.equal(w.q, torch.cat([lb[n].q for n in names], dim=1))
        assert torch.equal(w.scales,
                           torch.cat([lb[n].scales for n in names], dim=1))
    unfused = teng.LLMContext(cfg=c, params=loose, tokenizer=ctx.tokenizer,
                              max_seq_len=64, device="cpu",
                              dtype=torch.float32, arch=arch,
                              sampler=tsamp.SamplerConfig(**GREEDY))
    ids = ctx.encode("abc hello ab")
    got, _ = teng._prefill(ctx, ids, ctx.new_cache(1))
    want, _ = teng._prefill(unfused, ids, unfused.new_cache(1))
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-6 * scale


def test_from_gguf_leaves_a_mixed_k_quant_file_unfused(tmp_path, monkeypatch):
    """A file whose attention and FFN sets mix kinds (Q4_K, Q4_0, Q6_K and
    Q8_0, as a Q4_K_M file mixes Q4_K with Q6_K) is served as the loader
    gives it: every product unfused."""
    path, cfg, _ = _write(tmp_path, "qwen3", "q8_0", seed=4, **WIDE)
    g0 = tg.GGUFFile(path)
    swaps = {}
    for i in range(cfg["n_layer"]):
        for theirs, gtype in (("attn_q", tg.GGML_Q4_K), ("attn_k", tg.GGML_Q4_K),
                              ("attn_v", tg.GGML_Q6_K), ("ffn_gate", tg.GGML_Q4_K),
                              ("ffn_down", tg.GGML_Q6_K)):
            name = f"blk.{i}.{theirs}.weight"
            swaps[name] = (gtype, raw_blocks(
                gtype, int(np.prod(g0.tensors[name].shape)), seed=i * 5 + gtype))
    tfile, _ = _swapped(path, swaps)
    monkeypatch.setattr(tg, "GGUFFile", lambda p: tfile)
    ctx = teng.LLMContext.from_gguf(path, dtype=torch.float32, device="cpu",
                                    sampler=tsamp.SamplerConfig(**GREEDY))
    b = ctx.params["blocks"]
    assert {"wq", "wk", "wv", "w1", "w3"} <= set(b)
    assert not {"wqkv", "w13"} & set(b)
    assert isinstance(b["wq"], Q4KTensor) and isinstance(b["wv"], Q80Tensor)
    assert b["wv"].group_size == 16 and isinstance(b["w1"], Q4KTensor)
    assert isinstance(b["w3"], Q80Tensor) and b["w3"].group_size == 32
    out = teng.generate_on_device(ctx, [5, 6, 7, 8], 4).tolist()
    assert len(out) == 4 and all(0 <= t < cfg["vocab_size"] for t in out)


def test_from_gguf_goes_through_the_decoder_graph_path(tmp_path):
    """The quantized context decodes through the same SingleDecoder as a
    .bin context (on the CPU its steps run eagerly)."""
    path, _, _ = _write(tmp_path, "qwen3", "q8_0", seed=12)
    ctx = teng.LLMContext.from_gguf(path, dtype=torch.float32, device="cpu",
                                    sampler=tsamp.SamplerConfig(**GREEDY))
    s = teng.generate_sync(ctx, "abc", max_new_tokens=6)
    assert len(s.output_ids) == 6
    assert isinstance(ctx.decoder(), teng.SingleDecoder)


def test_unsupported_arch_and_truncated_file_raise(tmp_path):
    path, _, _ = _write(tmp_path, "qwen3", "f32")
    raw = _read(path)
    lpath = str(tmp_path / "l.gguf")
    with open(lpath, "wb") as f:
        f.write(raw.replace(struct.pack("<Q", 5) + b"qwen3",
                            struct.pack("<Q", 5) + b"llama", 1))
    for fn in (lambda: tg.load_gguf_qwen(lpath),
               lambda: teng.LLMContext.from_gguf(lpath, device="cpu")):
        with pytest.raises(ValueError, match="unsupported GGUF architecture"):
            fn()
    tpath = str(tmp_path / "t.gguf")
    with open(tpath, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(ValueError, match="exceeds file size"):
        tg.GGUFFile(tpath)
    with pytest.raises(ValueError, match="not a GGUF file"):
        tg.GGUFFile(os.path.join(os.path.dirname(__file__), "js", "fixtures",
                                 "tiny_f32.bin"))
    bad = tg.GGUFTensor("x", (2, 32), 99, np.zeros(0, np.uint8))
    with pytest.raises(ValueError, match="unsupported ggml tensor type"):
        bad.to_f32()


def test_to_gguf_and_from_gguf_entry_points_equal_root(tmp_path, monkeypatch):
    import sys
    import export as root_export
    from nano_tpu_torch import export as texport
    cfg = tiny_cfg("qwen3")
    bpath = str(tmp_path / "m.bin")
    jbin.write_model(bpath, tiny_params(cfg, 3), JModelConfig(**cfg),
                     toy_bpe(jbpe), quant="f32",
                     model_type=jbin.MODEL_TYPE_QWEN3)
    outs = {}
    for who in ("port", "root"):
        g, b = str(tmp_path / f"{who}.gguf"), str(tmp_path / f"{who}.bin")
        for argv in ([g, "--to-gguf", bpath, "--to", "q8_0"],
                     [b, "--from-gguf", g, "--to", "q80"]):
            if who == "port":
                texport.main(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["export.py"] + argv)
                root_export.main()
        outs[who] = (_read(g), _read(b))
    assert outs["port"] == outs["root"]
    with pytest.raises(SystemExit, match="Qwen-arch"):
        texport.main([str(tmp_path / "x.gguf"), "--to-gguf",
                      os.path.join(os.path.dirname(__file__), "js",
                                   "fixtures", "tiny_f32.bin")])
