"""nano_tpu_torch.io.qwen against nano_tpu.io.qwen on a synthetic HF
checkpoint directory written here: safetensors files written by hand (F32,
F16 and BF16 tensors, two shards), config.json and a tiny tokenizer.json.
load_hf_qwen's arrays must be equal and convert_hf_qwen's .bin bytes
identical, for Qwen3 and Qwen2."""

import json
import os
import struct

import jax
import numpy as np
import pytest

from nano_tpu.io import qwen as jqwen
from nano_tpu.tokenizer import bpe as jbpe
from nano_tpu_torch.io import binfmt as tbin
from nano_tpu_torch.io import qwen as tqwen

_CODES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


def write_safetensors(path, tensors):
    """{name: (dtype code, array)} -> a .safetensors file (BF16 arrays are
    f32 values, stored as their top 16 bits)."""
    header, chunks, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, (code, arr) in tensors.items():
        arr = np.asarray(arr, np.float32)
        if code == "BF16":
            raw = (arr.view(np.uint32) >> 16).astype("<u2").tobytes()
        else:
            raw = arr.astype(_CODES[code]).tobytes()
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head + b"".join(chunks))


def write_tokenizer_json(path, vocab_size):
    b2u = jbpe.gpt2_bytes_to_unicode()
    vocab = {b2u[i]: i for i in range(256)}
    vocab[b2u[ord("h")] + b2u[ord("e")]] = 256
    for i in range(257, vocab_size):
        vocab[f"<extra_{i}>"] = i
    with open(path, "w") as f:
        json.dump({"model": {"vocab": vocab,
                             "merges": [[b2u[ord("h")], b2u[ord("e")]]]},
                   "added_tokens": []}, f)


def make_hf_dir(d, arch, seed=0, tied=False):
    """A random tiny Qwen checkpoint in HF layout; matrices alternate
    between BF16, F16 and F32, split over two shards."""
    rng = np.random.RandomState(seed)
    V, E, L, H, KV, D, F = 300, 64, 2, 4, 2, 16, 96
    hc = {"model_type": arch, "vocab_size": V, "hidden_size": E,
          "num_hidden_layers": L, "num_attention_heads": H,
          "num_key_value_heads": KV, "head_dim": D, "intermediate_size": F,
          "max_position_embeddings": 128, "rope_theta": 1e6,
          "rms_norm_eps": 1e-6, "tie_word_embeddings": tied}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hc, f)
    write_tokenizer_json(os.path.join(d, "tokenizer.json"), V)

    codes = ["BF16", "F16", "F32"]
    t = {}

    def w(name, *shape, norm=False):
        a = (rng.randn(*shape) * 0.05 + (1.0 if norm else 0.0))
        t[name] = (codes[len(t) % 3], a.astype(np.float32))

    w("model.embed_tokens.weight", V, E)
    w("model.norm.weight", E, norm=True)
    if not tied:
        w("lm_head.weight", V, E)
    for i in range(L):
        p = f"model.layers.{i}."
        w(p + "input_layernorm.weight", E, norm=True)
        w(p + "post_attention_layernorm.weight", E, norm=True)
        w(p + "self_attn.q_proj.weight", H * D, E)
        w(p + "self_attn.k_proj.weight", KV * D, E)
        w(p + "self_attn.v_proj.weight", KV * D, E)
        w(p + "self_attn.o_proj.weight", E, H * D)
        w(p + "mlp.gate_proj.weight", F, E)
        w(p + "mlp.down_proj.weight", E, F)
        w(p + "mlp.up_proj.weight", F, E)
        if arch == "qwen3":
            w(p + "self_attn.q_norm.weight", D, norm=True)
            w(p + "self_attn.k_norm.weight", D, norm=True)
        else:
            w(p + "self_attn.q_proj.bias", H * D)
            w(p + "self_attn.k_proj.bias", KV * D)
            w(p + "self_attn.v_proj.bias", KV * D)
    names = sorted(t)
    half = len(names) // 2
    write_safetensors(os.path.join(d, "model-00002-of-00002.safetensors"),
                      {n: t[n] for n in names[half:]})
    write_safetensors(os.path.join(d, "model-00001-of-00002.safetensors"),
                      {n: t[n] for n in names[:half]})
    return d


@pytest.fixture(scope="module", params=[("qwen3", False), ("qwen2", False),
                                        ("qwen3", True)],
                ids=["qwen3", "qwen2", "qwen3_tied"])
def hf_dir(request, tmp_path_factory):
    arch, tied = request.param
    d = str(tmp_path_factory.mktemp(f"hf_{arch}_{tied}"))
    return make_hf_dir(d, arch, seed=len(arch) + tied, tied=tied), arch


def test_safetensors_reader_equals_the_package(hf_dir):
    safetensors = pytest.importorskip("safetensors")
    d, _ = hf_dir
    for path in sorted(os.listdir(d)):
        if not path.endswith(".safetensors"):
            continue
        got = tqwen._read_safetensors(os.path.join(d, path))
        with safetensors.safe_open(os.path.join(d, path),
                                   framework="numpy") as f:
            assert sorted(f.keys()) == sorted(got)
            for k in f.keys():
                np.testing.assert_array_equal(tqwen._to_f32(got[k]),
                                              jqwen._to_f32(f.get_tensor(k)))
    kinds = {a.dtype for a in tqwen._load_safetensors(d).values()}
    assert kinds == {np.dtype("<f4"), np.dtype("<f2"), np.dtype("<u2")}


def test_load_hf_qwen_arrays_equal_jax(hf_dir):
    d, arch = hf_dir
    cfg_t, pt, mt_t = tqwen.load_hf_qwen(d, max_seq_len=96)
    cfg_j, pj, mt_j = jqwen.load_hf_qwen(d, max_seq_len=96)
    assert cfg_t.to_dict() == cfg_j.to_dict()
    assert mt_t == mt_j == (tbin.MODEL_TYPE_QWEN3 if arch == "qwen3"
                            else tbin.MODEL_TYPE_QWEN2)
    assert jax.tree.structure(pt) == jax.tree.structure(pj)
    jax.tree.map(np.testing.assert_array_equal, pt, pj)
    jax.tree.map(lambda a: None if a.dtype == np.float32 else
                 pytest.fail(f"{a.dtype}"), pt)


@pytest.mark.parametrize("quant", ["f32", "q80"])
def test_convert_hf_qwen_bytes_equal_jax(hf_dir, tmp_path, quant):
    d, _ = hf_dir
    tp, jp = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tqwen.convert_hf_qwen(d, tp, quant=quant, group_size=32, max_seq_len=96)
    jqwen.convert_hf_qwen(d, jp, quant=quant, group_size=32, max_seq_len=96)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()


def test_rope_permute_reverse_equals_jax():
    w = np.random.RandomState(0).randn(4 * 16, 8).astype(np.float32)
    np.testing.assert_array_equal(tqwen.rope_permute_reverse(w, 4, 16),
                                  jqwen.rope_permute_reverse(w, 4, 16))


def test_refusals(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "qwen3", "vocab_size": 8, "hidden_size": 8,
                   "num_hidden_layers": 1, "num_attention_heads": 1,
                   "num_key_value_heads": 1, "intermediate_size": 8,
                   "max_position_embeddings": 8}, f)
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        tqwen.load_hf_qwen(str(tmp_path))
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "llama"}, f)
    with pytest.raises(ValueError, match="unsupported HF model_type"):
        tqwen.load_hf_qwen(str(tmp_path))
    bad = str(tmp_path / "x.safetensors")
    write_safetensors(bad, {"a": ("F32", np.zeros(4, np.float32))})
    raw = open(bad, "rb").read().replace(b'"F32"', b'"I64"')
    with open(bad, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="unsupported dtype I64"):
        tqwen._read_safetensors(bad)
