"""The port's Q4K product at more than one row, in integer form, against the
JAX package on the CPU: ``act_quant_q4k_packed_plain`` (the activation's
Q4K quantization kept as integers, packed in the weights' layout) and
``q4k_matmul_w4a4_plain`` (the C engine's integer expansion of the
product), the plain versions of the ``q4k_act_quant`` and
``q4k_matmul_w4a4`` kernels.  Inputs are made with numpy from a seed and
handed to both; the JAX side runs op by op with NANO_TPU_DEQUANT=f32, as
in tests/test_torch_q4k_slice.py."""

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


@pytest.fixture(autouse=True)
def jax_f32_op_by_op(monkeypatch):
    monkeypatch.setenv("NANO_TPU_DEQUANT", "f32")
    jax.clear_caches()
    with jax.disable_jit():
        yield
    monkeypatch.delenv("NANO_TPU_DEQUANT")
    jax.clear_caches()


@pytest.fixture(scope="module")
def units():
    with open(os.path.join(FIX, "expected.json")) as f:
        return json.load(f)["units"]


def _rows(n, B, seed=0):
    """Random activation rows with an all-zero group, a constant positive
    group and a constant negative group where n has room for them."""
    x = (np.random.RandomState(seed + n + B).randn(B, n) * 0.7
         ).astype(np.float32)
    x[0, :min(n, 32)] = 0.0
    if n >= 64:
        x[1 % B, 32:64] = 2.5
    if n >= 128:
        x[2 % B, 64:96] = -1.25
    return x


def _weights(out, inn, seed=0, scale=0.05):
    w = (np.random.RandomState(seed).randn(out, inn) * scale
         ).astype(np.float32)
    return jq.quantize_lines_np(w)


def _unpack(vp, G):
    """vp (B, G * 16) -> values (B, G, 32)."""
    p = vp.reshape(vp.shape[0], G, 16)
    return np.concatenate([p & 0x0F, p >> 4], axis=-1)


def _c_np(v, sa, ba, n):
    """c = sa * A - n_g * ba, each operation rounded to f32."""
    G = v.shape[1]
    A = v.astype(np.int32).sum(-1).astype(np.float32)
    n_g = np.clip(n - 32 * np.arange(G), 0, 32).astype(np.float32)
    return (sa * A).astype(np.float32) - (n_g * ba).astype(np.float32)


def _within(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------
# the activation's integer form (exact)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("B", [2, 8, 65])
@pytest.mark.parametrize("n", [40, 64, 128, 1024, 3072])
def test_packed_act_quant_matches_jax(n, B):
    """Unpacked, the values equal the JAX ``act_quant_q4k``'s bit for bit,
    0 at positions >= n; sa and ba are its s_eff and b_eff; c is
    sa * A - n_g * ba."""
    x = _rows(n, B)
    v, s, b = (np.asarray(a) for a in jq.act_quant_q4k(jnp.asarray(x)))
    vp, sa, ba, c = (a.numpy() for a in
                     tq.act_quant_q4k_packed_plain(torch.from_numpy(x)))
    G = v.shape[1]
    assert vp.shape == (B, G * 16) and vp.dtype == np.uint8
    np.testing.assert_array_equal(_unpack(vp, G), v)
    np.testing.assert_array_equal(sa, s)
    np.testing.assert_array_equal(ba, b)
    np.testing.assert_array_equal(c, _c_np(v, s, b, n))
    assert not _unpack(vp, G).reshape(B, -1)[:, n:].any()


@pytest.mark.parametrize("n", [64, 256])
def test_packed_act_quant_matches_expected_units(units, n):
    u = units[f"quant_q4k_act_{n}"]
    x = torch.tensor([u["x"]], dtype=torch.float32)
    vp, sa, ba, _ = tq.act_quant_q4k_packed_plain(x)
    G = u["npad"] // 32
    np.testing.assert_array_equal(_unpack(vp.numpy(), G).reshape(-1), u["v"])
    np.testing.assert_array_equal(sa.reshape(-1).numpy(),
                                  np.asarray(u["s"], np.float32))
    np.testing.assert_array_equal(ba.reshape(-1).numpy(),
                                  np.asarray(u["b"], np.float32))


def test_packed_act_quant_of_bf16_input_matches_jax():
    x = torch.from_numpy(_rows(1024, 8)).to(torch.bfloat16)
    v, s, b = (np.asarray(a) for a in
               jq.act_quant_q4k(jnp.asarray(x.float().numpy())))
    vp, sa, ba, _ = tq.act_quant_q4k_packed_plain(x)
    np.testing.assert_array_equal(_unpack(vp.numpy(), v.shape[1]), v)
    np.testing.assert_array_equal(sa.numpy(), s)
    np.testing.assert_array_equal(ba.numpy(), b)


# ---------------------------------------------------------------------
# the integer expansion of the product (f32 sums in another order)
# ---------------------------------------------------------------------

@pytest.mark.parametrize("out,inn,B", [(256, 512, 8), (128, 320, 8),
                                       (128, 64, 2), (128, 40, 3),
                                       (128, 1024, 65), (128, 3072, 2)])
def test_w4a4_plain_matches_jax_and_the_f32_forms(out, inn, B):
    """Within 1e-5 of max|y| (the same integers, f32 sums in another order)
    of the exact product of the JAX quantization's integers (f64), of the
    JAX ``q4k_matmul_int8`` on ``to_grouped()`` weights (where
    in % 32 == 0; beyond its own error), of K3 itself (the Pallas ``_q4k_matmul_2d`` in interpret
    mode on the fake-quantized activation) and of the port's f32 dequant
    dot ``q4k_matmul_plain``."""
    blocks = _weights(out, inn, seed=inn + out)
    jw = jq.Q4KTensor.from_blocks(blocks, out, inn)
    tw = tq.Q4KTensor.from_blocks(blocks, out, inn)
    x = _rows(inn, B)
    got = tq.q4k_matmul_w4a4_plain(
        *tq.act_quant_q4k_packed_plain(torch.from_numpy(x)), tw,
        torch.float32).numpy()
    assert got.shape == (B, out)
    # the exact value of the quantized product: the JAX integer form in f64
    v, s, b = (np.asarray(a, np.float64) for a in
               jq.act_quant_q4k(jnp.asarray(x)))
    xdq = (v * s[..., None] - b[..., None]).reshape(B, -1)[:, :inn]
    exact = xdq @ np.asarray(jw.dequantize(), np.float64).T
    _within(got, exact)
    if inn % 32 == 0:
        # q4k_matmul_int8 takes the correction as one sum subtracted from
        # another, so its own f32 error grows with in (to ~5e-5 of max|y|
        # at in = 3072): it is held to 1e-5 of max|y| beyond that error
        want = np.asarray(jq.q4k_matmul_int8(jnp.asarray(x), jw.to_grouped(),
                                             jnp.float32))
        own = np.abs(want - exact).max()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=own + 1e-5 * np.abs(want).max())
    xq = jq.fake_quant_act(jnp.asarray(x))
    _within(got, np.asarray(jq._q4k_matmul_2d(
        jq._permute_act(xq, jw.n_pad), jw.packed, jw.scales, jw.biases,
        interpret=True)))
    _within(got, tq.q4k_matmul_plain(
        tq.fake_quant_act_plain(torch.from_numpy(x)), tw,
        torch.float32).numpy())


def test_w4a4_plain_matches_matvec_units(units):
    """expected.json's matvec_q4k (in = 40, the weight's pad nibbles set to
    0xE, which the product must mask) with its activation row repeated to
    B = 3, within the fixture's own y_rtol of its f64 product."""
    u = units["matvec_q4k"]
    blocks = np.frombuffer(base64.b64decode(u["w_blocks_b64"]), np.uint8)
    w = tq.Q4KTensor.from_blocks(blocks.reshape(-1, 160), u["n_out"], u["n"])
    v_file = tq.unpack_blocks_np(blocks.reshape(-1, 160))[0]
    assert (v_file[:, 40:42] == 0xE).all()
    v = np.asarray(u["xv"], np.uint8).reshape(1, 8, 32).repeat(3, 0)
    sa = np.asarray(u["xs"], np.float32)[None].repeat(3, 0)
    ba = np.asarray(u["xb"], np.float32)[None].repeat(3, 0)
    act = tq.pack_act_q4k(torch.from_numpy(v), torch.from_numpy(sa),
                          torch.from_numpy(ba), u["n"])
    np.testing.assert_array_equal(act[3].numpy(), _c_np(v, sa, ba, u["n"]))
    y = tq.q4k_matmul_w4a4_plain(*act, w, torch.float32).numpy()
    for row in y:
        np.testing.assert_allclose(row, u["y"], rtol=u["y_rtol"],
                                   atol=u["y_rtol"] * np.abs(u["y"]).max())


@pytest.mark.parametrize("inn,B", [(64, 2), (40, 5), (1024, 8)])
def test_q4k_matmul_takes_the_integer_form_for_rows_on_the_cpu(inn, B):
    """More than one row: ``q4k_matmul`` equals the integer-form plain
    versions exactly (the wrappers take them for CPU tensors), in bf16 and
    f32, over a leading batch shape, and counts no launch."""
    tw = tq.Q4KTensor.from_blocks(_weights(72, inn, seed=inn), 72, inn)
    x = torch.from_numpy(_rows(inn, B))
    counters = (tq.act_quant_q4k_packed, tq.q4k_matmul_w4a4,
                tq.fake_quant_act, tq.q4k_matmul_f32, tq.q4k_matvec_fq)
    n0 = [f.launches for f in counters]
    for dt in (torch.float32, torch.bfloat16):
        want = tq.q4k_matmul_w4a4_plain(*tq.act_quant_q4k_packed_plain(x),
                                        tw, dt)
        assert torch.equal(tq.q4k_matmul(x, tw, dt), want)
        assert torch.equal(tq.q4k_matmul(x[None], tw, dt), want[None])
    assert [f.launches for f in counters] == n0
