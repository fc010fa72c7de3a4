"""The Q4K activation quantization folded into its producers, and K3 at
B = 1 on the integer form, against the JAX package on the CPU.

``rms_norm_q4k`` / ``swiglu_q4k`` (nano_tpu_torch/ops/norm_quant.py) write
the Q4K integer form of their rounded output (``Q4KAct``) that
``q4k_matvec_fq`` and ``q4k_matmul_w4a4`` take.  On the CPU the wrappers
run their plain versions; the same numpy inputs go through the JAX
functions, run op by op (``jax.disable_jit()``: jitted on the CPU, XLA
folds the fake-quant's magic-number rounding away;
tests/test_torch_q4k_slice.py):

* the norm's and SwiGLU's Q4K outputs are ``act_quant_q4k_packed_plain``
  of their own rounded output, bit for bit, and JAX's ``act_quant_q4k``
  of that output, bit for bit;
* the values rebuilt from the integer form (v * sa - ba) are
  ``fake_quant_act_plain``'s and JAX's ``fake_quant_act``'s, bit for bit;
* ``q4k_matvec_fq`` on the integer form is within 1e-5 of max|y| of JAX's
  ``q4k_matmul_ref`` (f32 dequant dot; sums in another order);
* ``matvec_plan`` covers every output row once, fits shared memory and
  takes the shapes alone.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py phase 3.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.ops import q4k as jq
from nano_tpu_torch.ops import norm_quant as tnq
from nano_tpu_torch.ops import q4k as tq

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# widths that are and are not multiples of 256 (a ragged last block)
WIDTHS = (64, 256, 320, 768)


def _jax_op_by_op(fn, *args):
    """fn(*args) with every JAX operation run on its own (no XLA fusion on
    the CPU, so the fake-quant's rounding survives)."""
    jax.clear_caches()
    try:
        with jax.disable_jit():
            return fn(*args)
    finally:
        jax.clear_caches()


def _rows(seed, B, n, scale=2.0):
    """Random rows with an all-zero 32-group and a constant one where the
    width has room for them."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, n) * scale).astype(np.float32)
    x[0, :min(n, 32)] = 0.0
    if n >= 64:
        x[-1, 32:64] = 1.75
    return x


def _unpack(vp, G):
    """vp (B, G * 16) u8 -> the values (B, G, 32) as int8."""
    p = vp.reshape(vp.shape[0], G, 16)
    return torch.cat([p & 0x0F, p >> 4], dim=-1).to(torch.int8)


def _check_act(act, y):
    """act is the Q4K integer form of y (..., n): act_quant_q4k_packed_plain
    of y bit for bit, and JAX's act_quant_q4k of y bit for bit."""
    n = y.shape[-1]
    y2 = y.reshape(-1, n)
    want = tq.act_quant_q4k_packed_plain(y2)
    for got, w in zip(act.parts(), want):
        assert got.dtype == w.dtype and torch.equal(got, w)
    assert act.shape == y.shape and act.rows == y2.shape[0]
    jv, js, jb = (np.asarray(a) for a in _jax_op_by_op(
        jq.act_quant_q4k, jnp.asarray(y2.float().numpy())))
    G = act.sa.shape[1]
    np.testing.assert_array_equal(_unpack(act.vp, G).numpy(), jv)
    np.testing.assert_array_equal(act.sa.numpy(), js)
    np.testing.assert_array_equal(act.ba.numpy(), jb)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("res", [False, True])
def test_rms_norm_q4k_output_is_the_act_quant_of_hn(n, B, dt, res):
    """rms_norm_q4k: h and hn those of rms_norm_q80; its Q4KAct the
    quantization of hn as the activation dtype rounds it, bit-equal to the
    port's plain act quant and to JAX's act_quant_q4k; want_hn=False gives
    the same form and no hn."""
    tdt = DTYPES[dt]
    x = torch.from_numpy(_rows(n + B, B, n)).to(tdt)
    a = torch.from_numpy(_rows(n + B + 1, B, n, 0.5)).to(tdt) if res else None
    w = torch.from_numpy(1 + 0.1 * np.random.RandomState(n).randn(n)
                         .astype(np.float32))
    h, hn, act = tnq.rms_norm_q4k(x, w, 1e-6, a)
    h8, hn8, none = tnq.rms_norm_q80(x, w, 1e-6, a)
    assert none is None and torch.equal(hn, hn8) and hn.dtype == tdt
    assert (h is None and h8 is None) if a is None else torch.equal(h, h8)
    _check_act(act, hn)
    _, no_hn, act2 = tnq.rms_norm_q4k(x, w, 1e-6, a, want_hn=False)
    assert no_hn is None
    assert all(torch.equal(p, q) for p, q in zip(act2.parts(), act.parts()))


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_swiglu_q4k_output_is_the_act_quant_of_its_output(n, B, dt):
    """swiglu_q4k: the hidden tensor that of swiglu_q80; its Q4KAct the
    quantization of that tensor as the activation dtype rounds it, bit-equal
    to the port's plain act quant and to JAX's act_quant_q4k."""
    tdt = DTYPES[dt]
    h13 = torch.from_numpy(_rows(2 * n + B, B, 2 * n)).to(tdt)
    y, act = tnq.swiglu_q4k(h13)
    y8, _ = tnq.swiglu_q80(h13)
    assert torch.equal(y, y8) and y.dtype == tdt
    _check_act(act, y)
    none, act2 = tnq.swiglu_q4k(h13, want_hidden=False)
    assert none is None
    assert all(torch.equal(p, q) for p, q in zip(act2.parts(), act.parts()))


@pytest.mark.parametrize("n", (40, 64, 256, 320, 1024, 3072))
def test_rebuilt_values_are_the_fake_quant(n):
    """v * sa - ba from the integer form, 0 at and past n: bit-equal to
    fake_quant_act_plain and to JAX's fake_quant_act (a packed 0 past n
    would rebuild to -ba: the rebuild writes 0 there)."""
    x = torch.from_numpy(_rows(7 * n, 3, n, 0.7))
    act = tq.Q4KAct(*tq.act_quant_q4k_packed_plain(x), x.shape)
    got = tq.fake_quant_packed_plain(act)
    assert torch.equal(got, tq.fake_quant_act_plain(x))
    assert got.shape == (3, tq.n_blocks_per_line(n) * 256)
    assert not got[:, n:].any()
    want = np.asarray(_jax_op_by_op(jq.fake_quant_act, jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(got[:, :n].numpy(), want)


def _weights(out, inn, seed):
    w = (np.random.RandomState(seed).randn(out, inn) * 0.05).astype(np.float32)
    return jq.quantize_lines_np(w)


@pytest.mark.parametrize("inn,out", [(40, 3), (64, 128), (320, 96),
                                     (1024, 64), (3072, 32)])
def test_matvec_on_the_integer_form_matches_jax(inn, out, monkeypatch):
    """q4k_matvec_fq on a norm's Q4KAct (one row) within 1e-5 of max|y| of
    JAX's q4k_matmul_ref on the same rounded row (f32 dequant dot,
    NANO_TPU_DEQUANT=f32, op by op), and bit-equal to the raw row's path
    (q4k_act_quant, then the same kernel) and to q4k_matmul, which takes
    the Q4KAct; with_act gives the rebuilt row, the fake-quant's bits; no
    launch on the CPU."""
    blocks = _weights(out, inn, inn + out)
    jw = jq.Q4KTensor.from_blocks(blocks, out, inn)
    tw = tq.Q4KTensor.from_blocks(blocks, out, inn)
    x = torch.from_numpy(_rows(inn, 1, inn))
    nw = torch.ones(inn)
    _, hn, act = tnq.rms_norm_q4k(x, nw, 1e-6)
    monkeypatch.setenv("NANO_TPU_DEQUANT", "f32")
    want = np.asarray(_jax_op_by_op(
        lambda a: jq.q4k_matmul_ref(a, jw, jnp.float32),
        jnp.asarray(hn.numpy())))
    monkeypatch.delenv("NANO_TPU_DEQUANT")
    before = (tq.q4k_matvec_fq.launches, tq.act_quant_q4k_packed.launches)
    got, xf = tq.q4k_matvec_fq(act, tw, torch.float32, with_act=True)
    assert got.shape == (1, out)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert torch.equal(xf, tq.fake_quant_act_plain(hn))
    assert torch.equal(tq.q4k_matvec_fq(hn, tw, torch.float32), got)
    assert torch.equal(tq.q4k_matmul(act, tw, torch.float32), got)
    assert torch.equal(tq.q4k_matvec_fq_plain(act, tw, torch.float32), got)
    assert (tq.q4k_matvec_fq.launches,
            tq.act_quant_q4k_packed.launches) == before


@pytest.mark.parametrize("B", [2, 3, 9])
def test_q4k_matmul_takes_the_integer_form_at_more_rows(B):
    """More rows: q4k_matmul hands a Q4KAct (..., n) straight to
    q4k_matmul_w4a4, the same product as from the tensor it was made
    from."""
    inn, out = 320, 48
    tw = tq.Q4KTensor.from_blocks(_weights(out, inn, B), out, inn)
    x = torch.from_numpy(_rows(B, B, inn)).reshape(1, B, inn)
    y, act = tnq.swiglu_q4k(torch.cat([x, x], dim=-1))
    got = tq.q4k_matmul(act, tw, torch.float32)
    assert got.shape == (1, B, out)
    assert torch.equal(got, tq.q4k_matmul(y, tw, torch.float32))
    with pytest.raises(ValueError):
        tq.q4k_matmul(act, tq.Q4KTensor.from_blocks(_weights(8, 64, 0), 8, 64))


@pytest.mark.parametrize("cut", [(0, 256), (256, 512), (512, 704)])
def test_a_rank_slice_cut_on_whole_blocks_quantizes_as_the_whole_row(cut):
    """Under tensor parallelism a row-parallel input is cut on whole
    256-blocks (parallel/mesh.py), so the SwiGLU of a rank's slice writes
    the integer form of the whole row's blocks it holds: the Q4K
    quantization is per block."""
    F = 704
    h13 = torch.from_numpy(_rows(F, 3, 2 * F))
    _, whole = tnq.swiglu_q4k(h13)
    lo, hi = cut
    part = torch.cat([h13[:, lo:hi], h13[:, F + lo:F + hi]], dim=-1)
    _, mine = tnq.swiglu_q4k(part)
    g0, g1 = lo // 32, -(-hi // 256) * 8
    assert torch.equal(mine.vp, whole.vp[:, lo // 2:g1 * 16])
    for p, q in ((mine.sa, whole.sa), (mine.ba, whole.ba), (mine.c, whole.c)):
        assert torch.equal(p, q[:, g0:g1])


PLAN_SHAPES = [
    # Qwen3-0.6B Q4K: wqkv, wo, w13, w2
    (4096, 1024), (1024, 2048), (6144, 1024), (1024, 3072),
    # the tiny fixtures (in 64 / 128: n_pad 256), a ragged in_dim
    (128, 64), (64, 64), (256, 64), (64, 128), (200, 40), (3, 40),
    # a head's rows, Qwen3-4B's w2, the widest row taken
    (151936, 1024), (2560, 9728), (1024, 32768),
]


@pytest.mark.parametrize("N,inn", PLAN_SHAPES)
@pytest.mark.parametrize("n_sm", [132, 114])
def test_matvec_plan_covers_every_row_once_and_fits(N, inn, n_sm):
    """matvec_plan: every output row in exactly one block's range and one
    tile of it; the ring within 227 KB (and MATVEC_SMEM where it has more
    than one stage); T whole warps giving every group of a row a lane, at
    most 4 groups a lane; the same plan for the same shapes, whatever the
    values."""
    n_pad = tq.n_blocks_per_line(inn) * 256
    blocks, R, S, T = tq.matvec_plan(N, n_pad, n_sm)
    assert (blocks, R, S, T) == tq.matvec_plan(N, n_pad, n_sm)
    assert 1 <= blocks <= min(N, 2 * n_sm) and R >= 1 and 1 <= S <= 16
    assert T % 32 == 0 and 32 <= T <= 256 and R == 256 // T
    G = n_pad // 32
    assert -(-G // T) <= 4 and (T == 256 or T >= G)
    smem = tq.matvec_smem(R, n_pad, S)
    assert smem <= 232448 and (S == 1 or smem <= tq.MATVEC_SMEM)
    seen = np.zeros(N, np.int64)
    for b in range(blocks):
        lo, hi = N * b // blocks, N * (b + 1) // blocks
        assert hi > lo
        for t in range(-(-(hi - lo) // R)):
            seen[lo + t * R:min(hi, lo + (t + 1) * R)] += 1
    assert (seen == 1).all()


def test_rows_wider_than_the_matvec_go_as_tensors(monkeypatch):
    """A Q4K weight wider than q4k_matvec_fq takes (n_pad past
    MAX_MATVEC_PAD): the model's norm writes no Q4KAct for it but the
    normed tensor (on the card the raw row then takes q4k_fake_quant +
    q4k_matmul), and one row's product is within 1e-5 of max|y| of JAX's
    q4k_matmul_ref on it."""
    from nano_tpu_torch.models import gpt as tgpt
    inn, out = tq.MAX_MATVEC_PAD + 200, 4
    blocks = _weights(out, inn, 1)
    jw = jq.Q4KTensor.from_blocks(blocks, out, inn)
    tw = tq.Q4KTensor.from_blocks(blocks, out, inn)
    assert tw.n_pad > tq.MAX_MATVEC_PAD
    assert not tgpt._q4k_out([tw]) and tgpt._q4k_out(
        [tq.Q4KTensor.from_blocks(_weights(out, 320, 2), out, 320)])
    x = torch.from_numpy(_rows(3, 1, inn))
    _, hn, _ = tgpt._norm(x, torch.ones(inn), 1e-6, [tw])
    assert isinstance(hn, torch.Tensor) and hn.shape == (1, inn)
    monkeypatch.setenv("NANO_TPU_DEQUANT", "f32")
    want = np.asarray(_jax_op_by_op(
        lambda a: jq.q4k_matmul_ref(a, jw, jnp.float32),
        jnp.asarray(hn.numpy())))
    monkeypatch.delenv("NANO_TPU_DEQUANT")
    got = tq.q4k_matmul(hn, tw, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
