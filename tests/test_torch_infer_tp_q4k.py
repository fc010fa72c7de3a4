"""The port's tensor-parallel serving of Q4K models against the JAX
package on the CPU (tests/test_torch_infer_tp.py: f32 and Q80, and how
both files build and serve their models).

A tiny Q4K file (heads of 8 values: wo's input cannot be cut on the
activation fake-quant's blocks of 256, so the heads are gathered, and its
64 hidden units are one block, so every rank runs the whole FFN: no sum
changes, and its TP streams are its single-device ones) and a wide one
(heads of 128 values and 1024 hidden units: wo and w2 cut on blocks at
TP = 2, w2 at TP = 4), served by four gloo ranks at TP = 2 and 4.  The
JAX package runs op by op (``jax.disable_jit()``: jitted, XLA's CPU
backend folds the fake-quant's rounding away, tests/test_torch_q4k_slice.py)
with f32 dequant dots.  Op by op it compiles each operation on its first
shape and sharding (~37 ms each, ~25 s a model and mesh here), so it
serves the wide file alone at TP = 2, 8 tokens, which the port's 12-token
streams must begin with; the port's single-device Q4K path is held to
the JAX package's by tests/test_torch_q4k_slice.py.
"""

import numpy as np
import pytest

import jax

from nano_tpu.parallel import mesh as jmesh
from nano_tpu_torch.ops.q4k import Q4KTensor
from tests import torch_parallel_ranks as ranks
from tests.test_torch_infer_tp import (TINY, WIDE, WIDTHS, jax_f32_dequant,
                                       jax_greedy, serve_files, write_model)

N_JAX = 8


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp4k")
    files = {"tiny_q4k": write_model(d, "tiny_q4k", TINY, "q4k", 256),
             "wide_q4k": write_model(d, "wide_q4k", WIDE, "q4k", 256)}
    got = serve_files(files)
    wide = files["wide_q4k"]
    with jax_f32_dequant(op_by_op=True):
        jax_tp2 = jax_greedy(wide, jmesh.make_mesh(
            n_data=1, n_model=2, devices=jax.devices()[:2]), n=N_JAX)
    whole = {name: ranks._ctx(p) for name, p in files.items()}
    return dict(files=files, ranks=got, jax_tp2=jax_tp2,
                streams={k: ranks.greedy(c, "abcdef") for k, c in
                         whole.items()},
                logits={k: ranks.prefill_logits(c) for k, c in
                        whole.items()})


@pytest.mark.parametrize("tp", WIDTHS)
def test_tp_q4k_tiny_streams_are_the_single_device_ones(served, tp):
    """Gathered heads and a whole FFN change no sum: every rank's stream
    and first logits are the single-device ones."""
    want = served["streams"]["tiny_q4k"]
    assert len(set(want)) > 1
    for r in served["ranks"]:
        assert r[f"tiny_q4k/tp{tp}/session"] == want
        assert np.array_equal(r[f"tiny_q4k/tp{tp}/logits"],
                              served["logits"]["tiny_q4k"])


def test_tp_q4k_wide_streams_match_jax(served):
    """The wide file's TP = 2 streams (on every rank) begin with the JAX
    package's TP = 2 stream.  Both packages' TP streams leave their
    single-device ones at the third token (the port's here; the JAX
    package's when this test was written): the row-parallel sums round in
    another order, and the Q4K activation quantization of a later product
    turns that into another 4-bit code for some value."""
    assert len(set(served["jax_tp2"])) > 1
    for r in served["ranks"]:
        assert r["wide_q4k/tp2/session"][:N_JAX] == served["jax_tp2"]
    one = served["streams"]["wide_q4k"]
    assert one[:2] == served["jax_tp2"][:2] and one != served["jax_tp2"]


# the first logits of a cut Q4K model beside one device's: the sums of the
# row-parallel products in another order (~1e-6 of max|logit| here) and
# what a 4-bit code that flips with them moves
Q4K_TP_LOGITS_TOL = 1e-4


@pytest.mark.parametrize("tp", WIDTHS)
def test_tp_q4k_wide_first_logits_are_one_devices_up_to_rounding(served,
                                                                  tp):
    want = served["logits"]["wide_q4k"]
    for r in served["ranks"]:
        got = r[f"wide_q4k/tp{tp}/logits"]
        err = np.abs(got - want).max()
        assert 0 < err <= Q4K_TP_LOGITS_TOL * np.abs(want).max(), (tp, err)


@pytest.mark.parametrize("name,tp,attn,ffn_mode", [
    ("tiny_q4k", 2, "gather", "replicated"),
    ("tiny_q4k", 4, "gather", "replicated"),
    ("wide_q4k", 2, "row", "row"), ("wide_q4k", 4, "gather", "row")])
def test_q4k_cuts_keep_whole_blocks(served, name, tp, attn, ffn_mode):
    """A rank's wo and w2 are cut on blocks of 256 inputs or kept whole,
    and its wqkv / w13 hold its own heads' and hidden units' rows, part by
    part (the packed nibbles, scales and biases alike)."""
    blocks = ranks._ctx(served["files"][name]).params["blocks"]
    H, KV = 4, 2
    D, F = (8, 64) if name == "tiny_q4k" else (128, 1024)
    rows = lambda w, parts: {
        k: np.concatenate([getattr(w, k)[0][lo:hi].numpy()
                           for lo, hi in parts])
        for k in ("packed", "scales", "biases")}
    for rank, r in enumerate(served["ranks"]):
        plan = r[f"{name}/tp{tp}/plan"]
        cuts = r[f"{name}/tp{tp}/cuts"]
        assert (plan["attn"], plan["ffn_mode"]) == (attn, ffn_mode)
        (h0, h1), (k0, k1), (f0, f1) = (plan["heads"], plan["kv_heads"],
                                        plan["ffn"])
        HD, KD = H * D, KV * D
        want = rows(blocks["wqkv"], [(h0 * D, h1 * D),
                                     (HD + k0 * D, HD + k1 * D),
                                     (HD + KD + k0 * D, HD + KD + k1 * D)])
        want13 = rows(blocks["w13"], [(f0, f1), (F + f0, F + f1)])
        for k in want:
            assert np.array_equal(cuts["wqkv"][k], want[k]), (rank, k)
            assert np.array_equal(cuts["w13"][k], want13[k]), (rank, k)
        wo = blocks["wo"]
        assert isinstance(wo, Q4KTensor)
        n_wo = cuts["wo"]["packed"].shape[-1] * 2
        assert n_wo == (wo.n_pad // tp if attn == "row" else wo.n_pad)
        n_w2 = cuts["w2"]["packed"].shape[-1] * 2
        assert n_w2 % 256 == 0 and n_w2 == (
            -(-(f1 - f0) // 256) * 256 if ffn_mode == "row"
            else blocks["w2"].n_pad)


def test_every_rank_takes_the_same_q4k_tokens(served):
    first = served["ranks"][0]
    for r in served["ranks"][1:]:
        for k, v in first.items():
            if k.endswith("session"):
                assert r[k] == v, k
