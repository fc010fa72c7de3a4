"""nano_tpu_torch.io.binfmt against nano_tpu.io.binfmt on the committed
tiny fixtures: every tensor and the tokenizer, array for array."""

import os

import numpy as np
import pytest
import jax
import torch

from nano_tpu.io import binfmt as jbin
from nano_tpu_torch.io import binfmt as tbin
from nano_tpu_torch.io.from_jax import params_from_jax
from nano_tpu_torch.ops.qmatmul import Q80Tensor

FIX = os.path.join(os.path.dirname(__file__), "js", "fixtures")


def _quant_equal(x, y):
    np.testing.assert_array_equal(x.q, y.q)
    np.testing.assert_array_equal(x.scale, y.scale)
    assert x.group_size == y.group_size


def _walk(a, b, path=""):
    """Equal nested dicts of arrays, QuantTensors and lists of them."""
    assert sorted(a) == sorted(b), path
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            _walk(x, y, f"{path}/{k}")
        elif isinstance(x, list):
            assert len(x) == len(y)
            for xi, yi in zip(x, y):
                _quant_equal(xi, yi)
        elif hasattr(x, "group_size"):
            _quant_equal(x, y)
        else:
            np.testing.assert_array_equal(x, np.asarray(y),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("name", ["tiny_f32.bin", "tiny_q80.bin"])
@pytest.mark.parametrize("dense", [True, False])
def test_read_model_matches_jax(name, dense):
    path = os.path.join(FIX, name)
    j = jbin.read_model(path, dense=dense)
    t = tbin.read_model(path, dense=dense)
    assert vars(t.header) == vars(j.header)
    assert t.config.to_dict() == j.config.to_dict()
    assert t.tokenizer_config == j.tokenizer_config
    np.testing.assert_array_equal(t.rope_cos, j.rope_cos)
    np.testing.assert_array_equal(t.rope_sin, j.rope_sin)
    _walk(t.params, j.params)
    if j.qparams is None:
        assert t.qparams is None
    else:
        _walk(t.qparams, j.qparams)


def test_quantized_device_params_match_jax_loader():
    path = os.path.join(FIX, "tiny_q80.bin")
    jp = jax.tree.map(np.asarray,
                      jbin.quantized_device_params(jbin.read_model(path)))
    want = params_from_jax(jp, device="cpu")
    got = tbin.quantized_device_params(tbin.read_model(path, dense=False),
                                       device="cpu")
    assert sorted(got) == sorted(want) and sorted(got["blocks"]) == sorted(
        want["blocks"])
    for k in ("tok_embeddings", "output_q"):
        assert isinstance(got[k], Q80Tensor)
        assert torch.equal(got[k].q, want[k].q)
        assert torch.equal(got[k].scales, want[k].scales)
        assert got[k].w8a8 is False                    # gs 32 < 256: rows
    assert got["output_q"] is got["tok_embeddings"]    # tied head, 1 copy
    for k, v in want["blocks"].items():
        if isinstance(v, Q80Tensor):
            assert torch.equal(got["blocks"][k].q, v.q), k
            assert torch.equal(got["blocks"][k].scales, v.scales), k
        else:
            assert torch.equal(got["blocks"][k], v), k
