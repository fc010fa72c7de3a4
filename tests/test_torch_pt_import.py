"""nano_tpu_torch.io.pt_import against nano_tpu.io.pt_import on a
reference-schema ``.pt`` written here by torch.save: the configs pickled
as dataclasses named ModelConfig / TrainConfig of a throwaway module (gone
again when the file is read), a torch.compile prefix and non-parameter
buffers in the state dict.  import_checkpoint's arrays must be equal,
pt_to_bin's bytes identical, pt_to_npz's output must load in the JAX
Checkpoint, and a pickle that names os.system is refused by both."""

import dataclasses
import os
import pickle
import sys
import types

import jax
import numpy as np
import pytest
import torch

from nano_tpu.config import ModelConfig as JModelConfig
from nano_tpu.io import checkpoint as jckpt
from nano_tpu.io import pt_import as jpt
from nano_tpu.models import gpt as jgpt
from nano_tpu.tokenizer.trie import TrieTokenizer
from nano_tpu_torch import export as texport
from nano_tpu_torch.io import binfmt as tbin
from nano_tpu_torch.io import pt_import as tpt

REF = dict(block_size=32, vocab_size=40, n_layer=2, n_embd=32, n_head=4,
           n_kv_head=2, n_hidden=80, dropout=0.0, use_rope=True,
           norm_eps=1e-5, is_causal=True)


def _reference_module():
    """A throwaway module holding dataclasses named as the reference's."""
    mod = types.ModuleType("ref_model_for_pt_test")

    @dataclasses.dataclass
    class ModelConfig:
        block_size: int = 512
        vocab_size: int = 16384
        n_layer: int = 8
        n_embd: int = 512
        n_head: int = 16
        n_kv_head: int = 16
        n_hidden: int = 1536
        dropout: float = 0.0
        use_rope: bool = True
        norm_eps: float = 1e-5
        is_causal: bool = True

    @dataclasses.dataclass
    class TrainConfig:
        learning_rate: float = 6e-4
        batch_size: int = 128
        lora_rank: int = 16
        lora_alpha: int = 32
        device: str = "cuda"

    for cls in (ModelConfig, TrainConfig):
        cls.__module__ = mod.__name__
        cls.__qualname__ = cls.__name__
        setattr(mod, cls.__name__, cls)
    return mod


def _state_dict(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    E, F, V = cfg["n_embd"], cfg["n_hidden"], cfg["vocab_size"]
    HD = E
    KVD = cfg["n_kv_head"] * E // cfg["n_head"]

    def w(*s):
        return torch.randn(*s, generator=g) * 0.05

    sd = {"tok_embeddings.weight": w(V, E), "norm.weight": 1 + w(E),
          "output.weight": w(V, E), "freqs_cis": w(16, 2)}
    for i in range(cfg["n_layer"]):
        p = f"layers.{i}."
        sd.update({p + "attention_norm.weight": 1 + w(E),
                   p + "ffn_norm.weight": 1 + w(E),
                   p + "attention.wq.weight": w(HD, E),
                   p + "attention.wk.weight": w(KVD, E),
                   p + "attention.wv.weight": w(KVD, E),
                   p + "attention.wo.weight": w(E, HD),
                   p + "feed_forward.w1.weight": w(F, E),
                   p + "feed_forward.w2.weight": w(E, F),
                   p + "feed_forward.w3.weight": w(F, E),
                   p + "attention.mask": torch.ones(4, 4)})
    # as a torch.compile'd module saves it
    return {"_orig_mod." + k: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def ref_pt(tmp_path_factory):
    d = tmp_path_factory.mktemp("pt")
    mod = _reference_module()
    tok = TrieTokenizer()
    tok.build([chr(ord("a") + i) for i in range(26)])
    ck = {"version": "2024.10", "is_lora": False,
          "model": _state_dict(REF, seed=5), "optimizer": {},
          "step_count": 123,
          "train_config": mod.TrainConfig(learning_rate=3e-4, batch_size=8),
          "model_config": mod.ModelConfig(**REF),
          "tokenizer_config": tok.config}
    path = str(d / "ref.pt")
    sys.modules[mod.__name__] = mod
    try:
        torch.save(ck, path)
    finally:
        del sys.modules[mod.__name__]
    return path


def test_import_checkpoint_equals_jax(ref_pt):
    cfg_t, pt, tok_t, step_t, tc_t = tpt.import_checkpoint(ref_pt)
    cfg_j, pj, tok_j, step_j, tc_j = jpt.import_checkpoint(ref_pt)
    assert cfg_t.to_dict() == cfg_j.to_dict()
    assert (tok_t, step_t, tc_t) == (tok_j, step_j, tc_j)
    assert step_t == 123 and tc_t["learning_rate"] == 3e-4
    assert jax.tree.structure(pt) == jax.tree.structure(pj)
    jax.tree.map(np.testing.assert_array_equal, pt, pj)
    assert "output" not in pt                    # tied: the head is ignored


@pytest.mark.parametrize("quant", ["f32", "q80", "q4k"])
def test_pt_to_bin_bytes_equal_jax(ref_pt, tmp_path, quant):
    tp, jp = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    tpt.pt_to_bin(ref_pt, tp, quant=quant)
    jpt.pt_to_bin(ref_pt, jp, quant=quant)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()


def test_export_entry_point_takes_pt(ref_pt, tmp_path, monkeypatch):
    import export as root_export
    ours, theirs = str(tmp_path / "o.bin"), str(tmp_path / "r.bin")
    texport.main([ours, "--quant", ref_pt])
    monkeypatch.setattr(sys, "argv", ["export.py", theirs, "--quant", ref_pt])
    root_export.main()
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert tbin.parse_header(open(ours, "rb").read()).quant_type == \
        tbin.QUANT_Q80


def test_pt_to_npz_loads_in_the_jax_checkpoint(ref_pt, tmp_path):
    npz = str(tmp_path / "conv.npz")
    cfg = tpt.pt_to_npz(ref_pt, npz)
    ck = jckpt.Checkpoint(npz)
    assert ck.step == 123 and not ck.is_lora
    jcfg = JModelConfig.from_dict(ck.model_config)
    assert jcfg.to_dict() == cfg.to_dict()
    like = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    got = jax.tree.map(np.asarray, ck.load_params(like))
    _, want, *_ = jpt.import_checkpoint(ref_pt)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    assert ck.tokenizer_config == jpt.import_checkpoint(ref_pt)[2]
    assert ck.train_config["batch_size"] == 8


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo should-not-run",))


def test_a_pickle_naming_os_system_is_refused(tmp_path):
    path = str(tmp_path / "evil.pt")
    torch.save({"model": {}, "model_config": {}, "x": _Evil()}, path)
    for mod in (tpt, jpt):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            mod.load_pt(path)
    legacy = str(tmp_path / "legacy.pt")
    torch.save({"x": _Evil()}, legacy, _use_new_zipfile_serialization=False)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tpt.load_pt(legacy)


def test_lora_checkpoint_is_refused(tmp_path):
    path = str(tmp_path / "lora.pt")
    torch.save({"is_lora": True, "lora": {}, "model_config": dict(REF)}, path)
    with pytest.raises(ValueError, match="LoRA"):
        tpt.import_checkpoint(path)
