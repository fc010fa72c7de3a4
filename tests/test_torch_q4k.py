"""nano_tpu_torch.ops.q4k against nano_tpu.ops.q4k on the CPU: the block
and frame helpers, the activation quantization (integer decisions and
fake-quantized values, bit for bit), the fused-dequant matmul against the
TPU kernel run in interpret mode, and the committed expected.json unit
vectors.  Inputs are made with numpy from a seed and handed to both."""

import base64
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.ops import q4k as jq
from nano_tpu_torch.ops import q4k as tq

FIX = os.path.join(os.path.dirname(__file__), "js", "fixtures")


@pytest.fixture(scope="module")
def units():
    with open(os.path.join(FIX, "expected.json")) as f:
        return json.load(f)["units"]


def _rows(n, B=3, seed=0):
    """Random activation rows with an all-zero group, a constant positive
    group and a constant negative group where n has room for them."""
    x = (np.random.RandomState(seed + n).randn(B, n) * 0.7).astype(np.float32)
    x[0, :min(n, 32)] = 0.0
    if n >= 64:
        x[1 % B, 32:64] = 2.5
    if n >= 128:
        x[2 % B, 64:96] = -1.25
    return x


def _weights(out, inn, seed=0, scale=0.05):
    w = (np.random.RandomState(seed).randn(out, inn) * scale).astype(np.float32)
    return jq.quantize_lines_np(w)


# ---------------------------------------------------------------------
# host helpers (exact)
# ---------------------------------------------------------------------

def test_nearest_int_matches_jax_and_expected(units):
    u = units["nearest_int"]
    x = np.asarray(u["x"], np.float32)
    np.testing.assert_array_equal(tq.nearest_int_np(x), u["y"])
    r = (np.random.RandomState(1).randn(4096) * 40).astype(np.float32)
    np.testing.assert_array_equal(tq.nearest_int_np(r), jq.nearest_int_np(r))
    np.testing.assert_array_equal(tq.nearest_int(torch.from_numpy(r)).numpy(),
                                  jq.nearest_int_np(r))


def test_frame_helpers_match_expected_units(units):
    u = units["q4k_frame"]
    frame = base64.b64decode(u["frame_b64"])
    blocks, shape, end = tq.parse_tensor_frame(frame, 0)
    assert list(shape) == u["shape"] and end == len(frame)
    v, s, b, _ = tq.unpack_blocks_np(blocks)
    np.testing.assert_array_equal(v.reshape(-1), u["v"])
    np.testing.assert_array_equal(s.reshape(-1), np.asarray(u["s"], np.float32))
    np.testing.assert_array_equal(b.reshape(-1), np.asarray(u["b"], np.float32))


@pytest.mark.parametrize("rows,n", [(4, 256), (3, 768), (5, 40), (2, 320)])
def test_block_helpers_match_jax(rows, n):
    blocks = _weights(rows, n, seed=rows * n)
    frame = jq.pack_tensor_frame(
        jq.dequantize_lines_np(blocks, rows, n))
    for got, want in zip(tq.parse_tensor_frame(frame, 0)[:2],
                         jq.parse_tensor_frame(frame, 0)[:2]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for got, want in zip(tq.unpack_blocks_np(blocks), jq.unpack_blocks_np(blocks)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tq.dequantize_lines_np(blocks, rows, n),
                                  jq.dequantize_lines_np(blocks, rows, n))
    jt = jq.Q4KTensor.from_blocks(blocks, rows, n)
    tt = tq.Q4KTensor.from_blocks(blocks, rows, n)
    np.testing.assert_array_equal(tt.packed.numpy(), np.asarray(jt.packed))
    np.testing.assert_array_equal(tt.scales.numpy(), np.asarray(jt.scales))
    np.testing.assert_array_equal(tt.biases.numpy(), np.asarray(jt.biases))
    assert (tt.in_dim, tt.n_pad, tt.out_dim) == (jt.in_dim, jt.n_pad, jt.out_dim)
    np.testing.assert_array_equal(tt.dequantize().numpy(),
                                  np.asarray(jt.dequantize()))
    ids = np.array([rows - 1, 0, rows // 2])
    np.testing.assert_array_equal(
        tt.dequantize_rows(torch.from_numpy(ids)).numpy(),
        np.asarray(jt.dequantize_rows(jnp.asarray(ids))))


# ---------------------------------------------------------------------
# activation quantization (exact)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 256])
def test_act_quant_matches_expected_units(units, n):
    u = units[f"quant_q4k_act_{n}"]
    x = torch.tensor([u["x"]], dtype=torch.float32)
    v, s, b = tq.act_quant_q4k_plain(x)
    assert v.shape == (1, u["npad"] // 32, 32)
    np.testing.assert_array_equal(v.reshape(-1).numpy(), u["v"])
    np.testing.assert_array_equal(s.reshape(-1).numpy(),
                                  np.asarray(u["s"], np.float32))
    np.testing.assert_array_equal(b.reshape(-1).numpy(),
                                  np.asarray(u["b"], np.float32))


@pytest.mark.parametrize("n", [40, 64, 128, 1024, 3072])
def test_act_quant_matches_jax(n):
    x = _rows(n)
    want = [np.asarray(a) for a in jq.act_quant_q4k(jnp.asarray(x))]
    got = [a.numpy() for a in tq.act_quant_q4k_plain(torch.from_numpy(x))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the all-zero group: values 0, parameters 0
    assert not got[0][0, 0].any() and got[1][0, 0] == 0 and got[2][0, 0] == 0


@pytest.mark.parametrize("n", [40, 64, 128, 256, 1024, 2048, 3072])
def test_fake_quant_matches_jax(n):
    """Values equal bit for bit (no tolerance: XLA's CPU backend does not
    contract v * s_eff - b_eff into an FMA, and neither does PyTorch), and
    the padded tail is zero."""
    x = _rows(n)
    want = np.asarray(jq.fake_quant_act(jnp.asarray(x)))
    got = tq.fake_quant_act_plain(torch.from_numpy(x)).numpy()
    assert got.shape == (x.shape[0], tq.n_blocks_per_line(n) * 256)
    np.testing.assert_array_equal(got[:, :n], want)
    assert not got[:, n:].any()
    # and the host quantizer's round trip (the C engine's semantics)
    np.testing.assert_array_equal(
        got[:, :n], jq.dequantize_lines_np(jq.quantize_lines_np(x), 3, n))


def test_fake_quant_of_bf16_input_matches_jax():
    x = torch.from_numpy(_rows(1024)).to(torch.bfloat16)
    want = np.asarray(jq.fake_quant_act(jnp.asarray(x.float().numpy())))
    np.testing.assert_array_equal(tq.fake_quant_act_plain(x).numpy(), want)


# ---------------------------------------------------------------------
# fused-dequant matmul (f32 sums in another order)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("out,inn,B", [(256, 512, 8), (128, 320, 8),
                                       (128, 64, 8)])
def test_q4k_matmul_plain_matches_interpret_kernel(out, inn, B):
    """K3 itself (the Pallas kernel in interpret mode on _permute_act input,
    as tests/test_q4k.py runs it) against the port's plain version on the
    same fake-quantized activation: f32 both sides, sums in another
    order -> 1e-5 of max|y|."""
    wt = jq.Q4KTensor.from_blocks(_weights(out, inn, seed=inn), out, inn)
    x = _rows(inn, B=B)
    xq = jq.fake_quant_act(jnp.asarray(x))
    xp = jq._permute_act(xq, wt.n_pad)
    want = np.asarray(jq._q4k_matmul_2d(xp, wt.packed, wt.scales, wt.biases,
                                        interpret=True))
    tw = tq.Q4KTensor.from_blocks(_weights(out, inn, seed=inn), out, inn)
    txq = tq.fake_quant_act_plain(torch.from_numpy(x))
    got = tq.q4k_matmul_plain(txq, tw, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # more than one row: the wrappers take the integer-form plain versions
    # for CPU tensors (tests/test_torch_q4k_w4a4.py holds them to K3)
    n0 = (tq.act_quant_q4k_packed.launches, tq.q4k_matmul_w4a4.launches)
    np.testing.assert_array_equal(
        tq.q4k_matmul(torch.from_numpy(x), tw, torch.float32).numpy(),
        tq.q4k_matmul_w4a4_plain(
            *tq.act_quant_q4k_packed_plain(torch.from_numpy(x)), tw,
            torch.float32).numpy())
    assert (tq.act_quant_q4k_packed.launches,
            tq.q4k_matmul_w4a4.launches) == n0


def test_q4k_matmul_plain_matches_matvec_units(units):
    """expected.json's matvec_q4k: a (3, 40) weight whose pad nibbles were
    set to 0xE (a right kernel never reads them), against an f64 product,
    within the fixture's own y_rtol."""
    u = units["matvec_q4k"]
    blocks = np.frombuffer(base64.b64decode(u["w_blocks_b64"]), np.uint8)
    w = tq.Q4KTensor.from_blocks(blocks.reshape(-1, 160), u["n_out"], u["n"])
    xv = np.asarray(u["xv"], np.float32).reshape(8, 32)
    xdq = (xv * np.asarray(u["xs"], np.float32)[:, None]
           - np.asarray(u["xb"], np.float32)[:, None]).reshape(1, 256)
    xq = torch.from_numpy(np.ascontiguousarray(xdq))
    for x in (xq, xq[:, :u["n"]]):
        y = tq.q4k_matmul_plain(x, w, torch.float32).numpy()[0]
        np.testing.assert_allclose(y, u["y"], rtol=u["y_rtol"],
                                   atol=u["y_rtol"] * np.abs(u["y"]).max())


@pytest.mark.parametrize("n", [40, 64, 128, 1024, 3072])
def test_fused_matvec_plain_matches_jax_op_by_op(n, monkeypatch):
    """``q4k_matvec_fq`` (one row, the fake-quant folded into the decode
    matmul) takes its plain version on the CPU.  The activation it
    quantizes equals the JAX ``fake_quant_act`` bit for bit, and its output
    the JAX ``q4k_matmul`` within 1e-5 of max|y| (f32 sums in another
    order), the JAX side run op by op with an f32 dequant dot
    (NANO_TPU_DEQUANT=f32, ``jax.disable_jit()``: jitted on the CPU, XLA
    folds the fake-quant's rounding away; tests/test_torch_q4k_slice.py).
    ``q4k_matmul`` takes it for one row and counts no launch."""
    x = _rows(n, B=1)
    blocks = _weights(96, n, seed=n)
    jw = jq.Q4KTensor.from_blocks(blocks, 96, n)
    tw = tq.Q4KTensor.from_blocks(blocks, 96, n)
    monkeypatch.setenv("NANO_TPU_DEQUANT", "f32")
    jax.clear_caches()
    try:
        with jax.disable_jit():
            want_x = np.asarray(jq.fake_quant_act(jnp.asarray(x)))
            want = np.asarray(jq.q4k_matmul(jnp.asarray(x), jw, jnp.float32))
    finally:
        monkeypatch.delenv("NANO_TPU_DEQUANT")
        jax.clear_caches()
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(tq.fake_quant_act_plain(tx).numpy()[:, :n],
                                  want_x)
    n0 = (tq.fake_quant_act.launches, tq.q4k_matmul_f32.launches,
          tq.q4k_matvec_fq.launches)
    got = tq.q4k_matvec_fq(tx, tw, torch.float32).numpy()
    assert got.shape == (1, 96)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(
        tq.q4k_matmul(tx[0], tw, torch.float32).numpy(), got[0])
    assert (tq.fake_quant_act.launches, tq.q4k_matmul_f32.launches,
            tq.q4k_matvec_fq.launches) == n0

