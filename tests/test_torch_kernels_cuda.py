"""The CUDA kernels of nano_tpu_torch against their plain PyTorch versions
on the card.  Every test here needs a GPU (marker `cuda`) and skips
without one: a CUDA kernel has no CPU mode.  This file imports neither
jax nor nano_tpu, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

from nano_tpu_torch.ops import decode_attn as tda
from nano_tpu_torch.ops import flash_attn as tfa
from nano_tpu_torch.ops import norm_quant as tnq
from nano_tpu_torch.ops import q4k as tq4
from nano_tpu_torch.ops import qmatmul as tqm


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _q80(rng, out, inn, gs):
    q = rng.randint(-127, 128, (out, inn)).astype(np.int8)
    s = (rng.rand(out, inn // gs).astype(np.float32) * 0.02 + 1e-3)
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 64])
def test_q80_kernels_match_plain(B):
    _need_card()
    rng = np.random.RandomState(B)
    for K, N, gs in ((1024, 4096, 256), (3072, 1024, 256), (256, 264, 256),
                     (1024, 384, 512), (128, 256, 32), (64, 72, 32)):
        q, s = _q80(rng, N, K, gs)
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.randn(B, K).astype(np.float32)).to(
                "cuda", xdt)
            w = tqm.Q80Tensor(q=torch.from_numpy(q).cuda(),
                              scales=torch.from_numpy(s).cuda(),
                              group_size=gs, w8a8=gs >= tqm.MIN_W8A8_GS)
            if w.w8a8:
                kq, ks = tqm.act_quant_q80(x, gs)
                pq, ps = tqm.act_quant_q80_plain(x, gs)
                torch.cuda.synchronize()
                assert torch.equal(kq, pq) and torch.equal(ks, ps)
                want = tqm.q80_matmul_int8_plain(x, w, torch.float32)
            else:
                want = tqm.q80_matmul_rows_plain(x, w, torch.float32)
            got = tqm.q80_matmul(x, w, torch.float32)
            got16 = tqm.q80_matmul(x, w, torch.bfloat16)
            torch.cuda.synchronize()
            # same integer decisions / same f32 dequant; f32 sums in
            # another order
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * want.abs().max().item())
            torch.testing.assert_close(got16, want.to(torch.bfloat16),
                                       rtol=1e-2, atol=1e-2 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,gs", [(1024, 4096, 256), (2048, 1024, 256),
                                    (1024, 6144, 256), (3072, 1024, 256),
                                    (1024, 151936, 256), (256, 264, 256),
                                    (1024, 384, 512)])
def test_q80_matvec_fq_matches_plain(K, N, gs):
    """The B = 1 W8A8 kernel with the activation quantization folded in, at
    the five Qwen3-0.6B products and two small shapes, from f32 and bf16
    rows (an all-zero group, .5 ties) into f32 and bf16: the int8 row and
    scales it writes equal act_quant_q80_plain's, y is within 1e-5 of
    max|y| of the plain version (the same integer decisions, f32 sums in
    another order), two runs give the same bits and a bf16 y is the f32 y
    rounded."""
    _need_card()
    rng = np.random.RandomState(K + N + gs)
    q, s = _q80(rng, N, K, gs)
    w = tqm.Q80Tensor(q=torch.from_numpy(q).cuda(),
                      scales=torch.from_numpy(s).cuda(), group_size=gs,
                      w8a8=True)
    x = rng.randn(1, K).astype(np.float32) * 2
    x[0, :9] = [127.0, 0.5, -0.5, 1.5, -2.5, 126.5, -126.5, 0.25, -0.75]
    x[0, 9:gs] = np.clip(x[0, 9:gs], -100, 100)
    x[0, gs:2 * gs] = 0.0 if K >= 2 * gs else x[0, gs:2 * gs]
    x = torch.from_numpy(x).cuda()
    for xt in (x, x.to(torch.bfloat16)):
        pq, ps = tqm.act_quant_q80_plain(xt, gs)
        want = tqm.q80_matvec_fq_plain(xt, w, torch.float32)
        y, kq, ks = tqm.q80_matvec_fq(xt, w, torch.float32, with_act=True)
        y2 = tqm.q80_matvec_fq(xt, w, torch.float32)
        y16 = tqm.q80_matvec_fq(xt, w, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(kq, pq) and torch.equal(ks, ps)
        assert y.shape == (1, N) and y16.dtype == torch.bfloat16
        assert torch.equal(y, y2)
        assert torch.equal(y16, y.to(torch.bfloat16))
        torch.testing.assert_close(y, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,gs,L", [(256, 3, 256, 3), (512, 7, 256, 2),
                                      (1024, 5, 512, 3)])
def test_q80_matvec_fq_takes_unaligned_scales_and_rows(K, N, gs, L):
    """Every layer of a stacked (L, N, K) weight: past the first, the
    layers' scales start off a 16-byte boundary, so the kernel copies their
    ends by plain loads; a row x that starts off a 16-byte boundary (a view
    at an odd offset) the same way.  The same integer decisions, so within
    1e-5 of max|y| of the plain version."""
    _need_card()
    rng = np.random.RandomState(K + N + L)
    q, s = _q80(rng, L * N, K, gs)
    w = tqm.Q80Tensor(q=torch.from_numpy(q.reshape(L, N, K)).cuda(),
                      scales=torch.from_numpy(s.reshape(L, N, K // gs)).cuda(),
                      group_size=gs, w8a8=True)
    buf = torch.from_numpy(rng.randn(K + 3).astype(np.float32)).cuda()
    for i in range(L):
        wl = w.layer(i)
        for x in (buf[None, :K], buf[None, 3:], buf[None, 1:K + 1].to(torch.bfloat16),
                  buf.to(torch.bfloat16)[None, 3:]):
            y = tqm.q80_matvec_fq(x, wl, torch.float32)
            want = tqm.q80_matvec_fq_plain(x, wl, torch.float32)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, want, rtol=0,
                                       atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_q80_dispatch_sends_one_row_to_matvec_and_refuses_other_shapes():
    _need_card()
    rng = np.random.RandomState(5)
    q, s = _q80(rng, 128, 512, 256)
    w = tqm.Q80Tensor(q=torch.from_numpy(q).cuda(),
                      scales=torch.from_numpy(s).cuda(), group_size=256,
                      w8a8=True)
    x = torch.randn(4, 512, device="cuda")
    counters = (tqm.act_quant_q80, tqm.q80_w8a8, tqm.q80_matvec_fq)
    n0 = [c.launches for c in counters]
    one = tqm.q80_matmul(x[:1][None], w, torch.float32)      # (1, 1, K)
    assert [c.launches - n for c, n in zip(counters, n0)] == [0, 0, 1]
    many = tqm.q80_matmul(x, w, torch.float32)
    assert [c.launches - n for c, n in zip(counters, n0)] == [1, 1, 1]
    torch.cuda.synchronize()
    torch.testing.assert_close(one[0], many[:1], rtol=0,
                               atol=1e-5 * many.abs().max().item())
    w32 = tqm.Q80Tensor(q=w.q, scales=torch.rand(128, 16, device="cuda"),
                        group_size=32, w8a8=True)
    w768 = tqm.Q80Tensor(q=torch.zeros(8, 1536, dtype=torch.int8,
                                       device="cuda"),
                         scales=torch.ones(8, 2, device="cuda"),
                         group_size=768, w8a8=True)
    for bad in ((x, w, torch.float32),                  # two rows
                (x[:1, :256], w, torch.float32),        # wrong width
                (x[:1].half(), w, torch.float32),       # f16 row
                (x[:1], w, torch.float16),              # f16 out
                (x[:1], w32, torch.float32),            # group size 32
                (torch.randn(1, 1536, device="cuda"), w768, torch.float32)):
        with pytest.raises(ValueError):
            tqm.q80_matvec_fq(*bad)


def _rows_weight(rng, N, K, gs, L=1):
    q, s = _q80(rng, L * N, K, gs)
    return tqm.Q80Tensor(q=torch.from_numpy(q.reshape(L, N, K)).cuda(),
                         scales=torch.from_numpy(
                             s.reshape(L, N, K // gs)).cuda(), group_size=gs)


def _hold_rows(y, want, label):
    """f32 out within 1e-5 of max|y| of the plain version (f32 dequant, f32
    sums in another order); bf16 out also within one bf16 rounding of it
    (2^-8 of |y|: the two f32 sums may round to neighbouring bf16 values)."""
    tol = 1e-5 * want.abs().max().item()
    err = (y.float() - want).abs()
    if y.dtype == torch.float32:
        assert err.max().item() <= tol, label
    else:
        assert (err <= tol + 2.0 ** -8 * want.abs()).all(), label


# the rows form's kernels at shapes of a GGUF file's products (a Qwen3-0.6B
# layer's at gs 16 / 32, 64 and 128 too), a product of 40 rows of K = 80 at
# gs 16 (scale rows of 20 bytes, off every 16-byte boundary past the
# first), and small ones
ROWS_CASES = [(1024, 6144), (3072, 1024), (2048, 1024), (256, 264), (80, 40),
              (64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2, 5, 8, 9, 64, 65, 320])
@pytest.mark.parametrize("gs", [16, 32, 64, 128])
def test_rows_kernels_match_plain(gs, B):
    """q80_matvec_rows (B = 1), q80_matmul_rows (every B) and the warp-a-row
    q80_matmul_rows_warp against q80_matmul_rows_plain, from f32 and bf16
    rows into f32 and bf16, on layer 1 of a stacked weight (its scales off a
    16-byte boundary where N * K / gs is not a multiple of 4); two runs give
    the same bits; q80_rows picks the kernel by shape and the counters
    count each launch."""
    _need_card()
    rng = np.random.RandomState(gs + B)
    kernels = [tqm.q80_matmul_rows, tqm.q80_matmul_rows_warp]
    if B == 1:
        kernels.append(tqm.q80_matvec_rows)
    for K, N in ROWS_CASES:
        if K % gs:
            continue
        w = _rows_weight(rng, N, K, gs, L=2).layer(1)
        x32 = torch.from_numpy(rng.randn(B, K).astype(np.float32)).cuda()
        for x in (x32, x32.to(torch.bfloat16)):
            want = tqm.q80_matmul_rows_plain(x, w, torch.float32)
            for fn in kernels:
                for odt in (torch.float32, torch.bfloat16):
                    y = fn(x, w, odt)
                    again = fn(x, w, odt)
                    torch.cuda.synchronize()
                    label = f"{fn.__name__} K={K} N={N} {x.dtype}->{odt}"
                    _hold_rows(y, want, label)
                    assert torch.equal(y, again), label
            n0 = [f.launches for f in (tqm.q80_matvec_rows,
                                       tqm.q80_matmul_rows,
                                       tqm.q80_matmul_rows_warp)]
            y = tqm.q80_matmul(x, w, torch.float32)
            n1 = [f.launches for f in (tqm.q80_matvec_rows,
                                       tqm.q80_matmul_rows,
                                       tqm.q80_matmul_rows_warp)]
            assert [b - a for a, b in zip(n0, n1)] == ([1, 0, 0] if B == 1
                                                       else [0, 1, 0])
            torch.cuda.synchronize()
            _hold_rows(y, want, f"q80_matmul K={K} N={N}")


@pytest.mark.cuda
@pytest.mark.parametrize("gs", [16, 32])
def test_rows_kernels_at_the_head(gs):
    """The tied head of a Qwen3-0.6B GGUF file, 151 936 rows of 1024: one
    f32 row (decode, the prefill's last position) through q80_matvec_rows
    and q80_matmul_rows, and 8 and 64 rows (batched steps) through
    q80_matmul_rows, into f32."""
    _need_card()
    rng = np.random.RandomState(gs)
    w = _rows_weight(rng, 151936, 1024, gs).layer(0)
    for B in (1, 8, 64):
        x = torch.from_numpy(rng.randn(B, 1024).astype(np.float32)).cuda()
        want = tqm.q80_matmul_rows_plain(x, w, torch.float32)
        fns = ([tqm.q80_matvec_rows] if B == 1 else []) + [tqm.q80_matmul_rows]
        for fn in fns:
            y = fn(x, w, torch.float32)
            torch.cuda.synchronize()
            _hold_rows(y, want, f"{fn.__name__} head B={B}")
            assert torch.equal(y, fn(x, w, torch.float32))


@pytest.mark.cuda
def test_rows_dispatch_by_shape_and_refusals():
    """q80_rows sends a group size that is not a power of two from 16 to
    the warp-a-row kernel at every B; the new wrappers refuse it, and refuse more
    than one row (matvec), f16 and a wrong width."""
    _need_card()
    rng = np.random.RandomState(9)
    w48 = _rows_weight(rng, 64, 96, 48).layer(0)
    w32 = _rows_weight(rng, 64, 96, 32).layer(0)
    x = torch.randn(3, 96, device="cuda")
    for B in (1, 3):
        n0 = tqm.q80_matmul_rows_warp.launches
        y = tqm.q80_rows(x[:B], w48, torch.float32)
        assert tqm.q80_matmul_rows_warp.launches == n0 + 1
        torch.cuda.synchronize()
        _hold_rows(y, tqm.q80_matmul_rows_plain(x[:B], w48, torch.float32),
                   f"q80_rows gs=48 B={B}")
    for fn, bad in ((tqm.q80_matvec_rows, (x, w32)),
                    (tqm.q80_matvec_rows, (x[:1], w48)),
                    (tqm.q80_matmul_rows, (x, w48)),
                    (tqm.q80_matmul_rows, (x[:, :64], w32)),
                    (tqm.q80_matmul_rows, (x.half(), w32))):
        with pytest.raises(ValueError):
            fn(*bad, torch.float32)


# the five Qwen3-0.6B products: (N, K)
QWEN3_PRODUCTS = {"wqkv": (4096, 1024), "wo": (1024, 2048),
                  "w13": (6144, 1024), "w2": (1024, 3072),
                  "head": (151936, 1024)}
_WEIGHTS = {}


def _card_weight(N, K, gs):
    """A random Q80 weight on the card, made once per shape."""
    if (N, K, gs) not in _WEIGHTS:
        q, s = _q80(np.random.RandomState(N + K + gs), N, K, gs)
        _WEIGHTS[(N, K, gs)] = tqm.Q80Tensor(
            q=torch.from_numpy(q).cuda(), scales=torch.from_numpy(s).cuda(),
            group_size=gs, w8a8=True)
    return _WEIGHTS[(N, K, gs)]


def _check_w8a8(w, B, seed):
    """q80_w8a8 on quantized bf16 rows against q80_w8a8_plain: f32 within
    1e-5 of max|y| (the same exact int32 group dots, f32 sums in another
    order), two runs the same bits, the bf16 output the f32 one rounded."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, w.in_dim, device="cuda", generator=g).to(torch.bfloat16)
    xq, sa = tqm.act_quant_q80(x, w.group_size)
    y = tqm.q80_w8a8(xq, sa, w, torch.float32)
    y2 = tqm.q80_w8a8(xq, sa, w, torch.float32)
    y16 = tqm.q80_w8a8(xq, sa, w, torch.bfloat16)
    want = tqm.q80_w8a8_plain(xq, sa, w, torch.float32)
    torch.cuda.synchronize()
    assert y.shape == (B, w.out_dim) and y16.dtype == torch.bfloat16
    assert torch.equal(y, y2)
    assert torch.equal(y16, y.to(torch.bfloat16))
    torch.testing.assert_close(y, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 3, 5, 7, 8, 9, 16, 40, 63, 64, 65, 200,
                               320])
@pytest.mark.parametrize("product", sorted(QWEN3_PRODUCTS))
def test_q80_w8a8_tensor_core_kernel_matches_plain(product, B):
    """K1 at B > 1 on the int8 tensor cores at the five Qwen3-0.6B products,
    one slot tile up to 64 rows (ragged below), two to five tiles above;
    among them the rows of a speculative verify round (k + 1 = 2, 3, 5, 8,
    9; batched 16, 40, 320)."""
    _need_card()
    _check_w8a8(_card_weight(*QWEN3_PRODUCTS[product], 256), B, B)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [9, 64, 65])
@pytest.mark.parametrize("N,K", [(4096, 1024), (1024, 3072), (384, 1536)])
def test_q80_w8a8_tensor_core_kernel_group_size_512(N, K, B):
    """A group spans two chunks of K: its int32 fragment carries over."""
    _need_card()
    _check_w8a8(_card_weight(N, K, 512), B, B + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [7, 100])
def test_q80_w8a8_on_a_stacked_layer_view(N):
    """Every layer of a stacked (3, N, 768) weight through Q80Tensor.layer:
    past the first, a layer's scales start off a 16-byte boundary (N * 3
    scales a layer), and N is not a multiple of the 64-row tile."""
    _need_card()
    L, K, gs = 3, 768, 256
    q, s = _q80(np.random.RandomState(N), L * N, K, gs)
    w = tqm.Q80Tensor(q=torch.from_numpy(q.reshape(L, N, K)).cuda(),
                      scales=torch.from_numpy(s.reshape(L, N, K // gs)).cuda(),
                      group_size=gs, w8a8=True)
    for i in range(L):
        for B in (5, 64):
            _check_w8a8(w.layer(i), B, 10 * i + B)


@pytest.mark.cuda
@pytest.mark.parametrize("gs", [256, 512])
@pytest.mark.parametrize("B", [8, 65])
def test_q80_w8a8_integer_witness(B, gs):
    """All scales 1.0 and int8 values at +-127 and random: y must be the
    exact sum of the int32 group dots (every partial sum an integer below
    2^24, so any f32 order gives it exactly), torch.equal; the groups split
    over a cluster (N = 200: 4 row tiles)."""
    _need_card()
    rng = np.random.RandomState(B + gs)
    N, K = 200, 1024
    q = rng.randint(-127, 128, (N, K)).astype(np.int8)
    xq = rng.randint(-127, 128, (B, K)).astype(np.int8)
    q[:3] = [[127], [-127], [127]]
    xq[:2] = [[127], [-127]]
    q[3, ::2], q[3, 1::2] = 127, -127
    w = tqm.Q80Tensor(q=torch.from_numpy(q).cuda(),
                      scales=torch.ones(N, K // gs, device="cuda"),
                      group_size=gs, w8a8=True)
    want = (xq.astype(np.int64) @ q.astype(np.int64).T).astype(np.float32)
    assert np.abs(want).max() == 127 * 127 * K
    y = tqm.q80_w8a8(torch.from_numpy(xq).cuda().reshape(B, K // gs, gs),
                     torch.ones(B, K // gs, device="cuda"), w, torch.float32)
    torch.cuda.synchronize()
    assert tqm.w8a8_plan(B, N, K, gs)[2] > 1
    assert torch.equal(y.cpu(), torch.from_numpy(want))


@pytest.mark.cuda
def test_q80_w8a8_under_graph_capture_and_refusals():
    """A slot tile no other test launches (BN = 32) met first inside a
    CUDA-graph capture gives the eager launch's bits on replay; misaligned
    or mis-shaped activations raise."""
    _need_card()
    w = _card_weight(1024, 2048, 256)
    g = torch.Generator(device="cuda").manual_seed(20)
    x = torch.randn(20, 2048, device="cuda", generator=g)
    xq, sa = tqm.act_quant_q80(x, 256)
    assert tqm.w8a8_plan(20, 1024, 2048, 256)[1] == 32
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = tqm.q80_w8a8(xq, sa, w, torch.float32)
    graph.replay()
    eager = tqm.q80_w8a8(xq, sa, w, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(y, eager)
    flat = torch.zeros(20 * 2048 + 1, dtype=torch.int8, device="cuda")
    for bad in ((flat[1:].reshape(20, 8, 256), sa, w),        # misaligned
                (xq, sa[:, :4], w),                           # scales shape
                (xq.reshape(20, 16, 128), sa, w),             # group size
                (xq[:0], sa[:0], w)):                         # no rows
        with pytest.raises(ValueError):
            tqm.q80_w8a8(*bad, torch.float32)


def _decode_case(rng, B, T, n_kv, rep, D, cache_dtype, q_dtype):
    q = torch.from_numpy(rng.randn(B, n_kv * rep, D).astype(np.float32)
                         ).to("cuda", q_dtype)
    if cache_dtype == torch.int8:
        kc = torch.from_numpy(rng.randint(-127, 128, (B, T, n_kv, D)).astype(np.int8))
        vc = torch.from_numpy(rng.randint(-127, 128, (B, T, n_kv, D)).astype(np.int8))
        ks = torch.from_numpy(rng.rand(B, T, n_kv).astype(np.float32) * 0.02).cuda()
        vs = torch.from_numpy(rng.rand(B, T, n_kv).astype(np.float32) * 0.02).cuda()
    else:
        kc = torch.from_numpy(rng.randn(B, T, n_kv, D).astype(np.float32)).to(cache_dtype)
        vc = torch.from_numpy(rng.randn(B, T, n_kv, D).astype(np.float32)).to(cache_dtype)
        ks = vs = None
    return [q, kc.cuda(), vc.cuda(), ks, vs]


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8,
                                         torch.float32])
def test_decode_attention_kernel_matches_plain(cache_dtype):
    _need_card()
    for B, T, n_kv, rep, D in ((1, 1024, 8, 2, 128), (3, 256, 2, 4, 64),
                               (2, 64, 2, 2, 16), (2, 128, 1, 8, 256)):
        rng = np.random.RandomState(T + D)
        args = _decode_case(rng, B, T, n_kv, rep, D, cache_dtype,
                            torch.float32)
        for p in (0, T // 2, T - 1):
            for pos in (torch.full((B,), p, dtype=torch.int32, device="cuda"),
                        torch.tensor([p], dtype=torch.int32, device="cuda")):
                got = tda.decode_attention(*args, pos, n_kv, rep)
                want = tda.decode_attention_plain(*args, pos, n_kv, rep)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("D", [16, 32, 48, 64, 128])
def test_decode_attention_kernel_shapes_it_is_built_for(D, rep, q_dtype):
    """Every D and every instance of the heads per KV head (rep 3 runs in
    the instance for 4, rep 7 in the one for 8), f32 and bf16 q, the three cache types, at
    batch 1 (positions split over the grid: pos 0, pos T - 1, a pos inside
    a split, a pos that leaves whole splits empty) and batch 64 (one block
    per head, every row its own pos).  Same f32 arithmetic as the plain
    version (which sees the same, already rounded q), sums in another
    order: 2e-5.  Two calls on one workspace give the same bits: the ticket
    counters are back at zero after each."""
    _need_card()
    rng = np.random.RandomState(1000 * D + 10 * rep)
    n_kv, T = 2, 512
    for cache_dtype in (torch.bfloat16, torch.int8, torch.float32):
        args = _decode_case(rng, 1, T, n_kv, rep, D, cache_dtype, q_dtype)
        chunk, n_split = tda.choose_splits(n_kv, T)
        assert n_split > 2
        for p in (0, T - 1, chunk + chunk // 2, 2 * chunk - 1, 2 * chunk):
            pos = torch.tensor([p], dtype=torch.int32, device="cuda")
            n0 = tda.decode_attention.launches
            got = tda.decode_attention(*args, pos, n_kv, rep)
            again = tda.decode_attention(*args, pos, n_kv, rep)
            want = tda.decode_attention_plain(*args, pos, n_kv, rep)
            torch.cuda.synchronize()
            assert tda.decode_attention.launches == n0 + 2
            assert got.dtype == torch.float32 and got.shape == (1, n_kv * rep * D)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
            assert torch.equal(got, again)
        args = _decode_case(rng, 64, 128, n_kv, rep, D, cache_dtype, q_dtype)
        pos = torch.from_numpy(rng.randint(0, 128, (64,)).astype(np.int32)).cuda()
        pos[0], pos[1] = 0, 127
        got = tda.decode_attention(*args, pos, n_kv, rep)
        again = tda.decode_attention(*args, pos, n_kv, rep)
        want = tda.decode_attention_plain(*args, pos, n_kv, rep)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_decode_attention_is_one_launch_and_refuses_other_shapes():
    """On the model's path (bf16 q, bf16 cache) the call puts one kernel on
    the stream: no memset, no cast, no allocation of scratch after the
    first call."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(7)
    args = _decode_case(rng, 1, 512, 8, 2, 128, torch.bfloat16, torch.bfloat16)
    pos = torch.tensor([318], dtype=torch.int32, device="cuda")
    tda.decode_attention(*args, pos, 8, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            tda.decode_attention(*args, pos, 8, 2)
        torch.cuda.synchronize()
    events = [(e.key, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if events:      # a profiler that records no device activity shows nothing
        assert len(events) == 1 and events[0][1] == 4, events
        assert "decode_attn_kernel" in events[0][0]
    lib = tda._build.lib("decode_attn")
    for rep, held, D in ((1, 1, 16), (2, 2, 128), (3, 4, 32), (7, 8, 48),
                         (4, 4, 256)):
        assert (lib.decode_attention_part_stride(rep, D)
                == held * D + (2 * held + 3) // 4 * 4)
    bad = _decode_case(rng, 1, 64, 1, 9, 64, torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="rep <="):
        tda.decode_attention(*bad, pos, 1, 9)
    bad = _decode_case(rng, 1, 64, 2, 2, 40, torch.bfloat16, torch.float32)
    with pytest.raises(ValueError, match="D in"):
        tda.decode_attention(*bad, pos, 2, 2)


def _act_rows(rng, B, n):
    """Random rows with an all-zero group and constant groups."""
    x = (rng.randn(B, n) * 0.7).astype(np.float32)
    x[0, :min(n, 32)] = 0.0
    if n >= 64:
        x[-1, 32:64] = 2.5
    if n >= 128:
        x[0, 64:96] = -1.25
    return torch.from_numpy(x).cuda()


@pytest.mark.cuda
def test_q4k_fast_division_is_ieee_where_it_says_so():
    """The Q4K quantization's divisions (csrc/q4k_quant.cuh:FastDiv, the
    reciprocal fast path of __fdiv_rn written out) against __fdiv_rn over
    2^24 random pairs of every exponent (and the quantization's own:
    dividends near integer multiples of the divisor, the divisors 15 and
    63): bit-equal wherever FastDiv calls the pair exact, and it calls
    exact every pair whose operands are 0 or normal within 2^-60 .. 2^60."""
    _need_card()
    from nano_tpu_torch.ops import _build
    lib = _build.lib("q4k")
    g = torch.Generator(device="cuda").manual_seed(5)
    n = 1 << 24
    bits = torch.randint(-(1 << 31), 1 << 31, (2, n), device="cuda",
                         generator=g, dtype=torch.int64).to(torch.int32)
    a, b = bits.view(torch.float32)          # every exponent, both signs
    b = b.abs()
    m = torch.rand(n, device="cuda", generator=g)
    k = torch.randint(0, 16, (n,), device="cuda", generator=g).float()
    s = torch.exp2(torch.randint(-40, 40, (n,), device="cuda",
                                 generator=g).float()) * (1 + m)
    tie = (k + 0.5) * s * (1 + (m - 0.5) * 2 ** -22)   # near half-integers
    for aa, bb in ((a, b), (tie, s), (m * 37, torch.full_like(m, 15.0)),
                   (m * 37, torch.full_like(m, 63.0)),
                   (torch.zeros_like(m), s)):
        aa, bb = aa.contiguous(), bb.contiguous()
        fast, ieee = torch.empty_like(aa), torch.empty_like(aa)
        exact = torch.empty(n, dtype=torch.int32, device="cuda")
        assert lib.q4k_fast_div_check(aa.data_ptr(), bb.data_ptr(), n,
                                      fast.data_ptr(), ieee.data_ptr(),
                                      exact.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        ok = exact.bool()
        moderate = lambda t: (t == 0) | ((t.abs() >= 2.0 ** -60)
                                         & (t.abs() < 2.0 ** 61))
        finite_b = bb > 0
        assert bool((ok == (moderate(aa) & moderate(bb))).all())
        assert torch.equal(fast[ok & finite_b].view(torch.int32),
                           ieee[ok & finite_b].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 64, 128, 256, 1024, 2048, 3072])
def test_q4k_fake_quant_kernel_is_bit_equal(n):
    _need_card()
    rng = np.random.RandomState(n)
    for B in (1, 64):
        x = _act_rows(rng, B, n)
        for xt in (x, x.to(torch.bfloat16)):
            got = tq4.fake_quant_act(xt)
            want = tq4.fake_quant_act_plain(xt)
            torch.cuda.synchronize()
            assert got.shape == (B, tq4.n_blocks_per_line(n) * 256)
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("inn,out", [(1024, 4096), (2048, 1024), (1024, 6144),
                                     (3072, 1024), (64, 128), (128, 64),
                                     (40, 3)])
def test_q4k_matmul_kernel_matches_plain(inn, out):
    _need_card()
    rng = np.random.RandomState(inn + out)
    npad = tq4.n_blocks_per_line(inn) * 256
    w = tq4.Q4KTensor(
        packed=torch.from_numpy(rng.randint(0, 256, (out, npad // 2)).astype(np.uint8)).cuda(),
        scales=torch.from_numpy(rng.rand(out, npad // 32).astype(np.float32) * 0.02 + 1e-3).cuda(),
        biases=torch.from_numpy(rng.rand(out, npad // 32).astype(np.float32) * 0.02).cuda(),
        in_dim=inn)
    for B in (1, 5, 64):
        xq = tq4.fake_quant_act(_act_rows(rng, B, inn))
        want = tq4.q4k_matmul_plain(xq, w, torch.float32)
        got = tq4.q4k_matmul_f32(xq, w, torch.float32)
        got16 = tq4.q4k_matmul_f32(xq, w, torch.bfloat16)
        torch.cuda.synchronize()
        # the same f32 dequant and products; sums in another order
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())
        torch.testing.assert_close(got16, want.to(torch.bfloat16),
                                   rtol=1e-2, atol=1e-2 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("inn,out", [(1024, 4096), (2048, 1024), (1024, 6144),
                                     (3072, 1024), (40, 3), (64, 128),
                                     (128, 64), (40, 200), (9728, 300)])
def test_q4k_matvec_fq_rebuilds_the_fake_quant_and_matches_plain(inn, out):
    """K3 at B = 1 on the activation's integer form, at the Qwen3-0.6B Q4K
    products, the tiny fixture's widths, a ragged row against 0xE pad
    nibbles and a row of 2 groups a lane (T = 256), from f32 and bf16 rows
    with an all-zero and constant groups: (a) the row the kernel rebuilt
    from q4k_act_quant's integer form torch.equal to q4k_fake_quant's; (b)
    y within 1e-5 of max|y| of the plain version (f32 sums in another
    order), bf16 y the f32 y rounded; (c) two runs bit-equal, from the raw
    row and from its Q4KAct; q4k_matmul takes it for one row (q4k_act_quant,
    then the kernel) and for a norm's Q4KAct."""
    _need_card()
    rng = np.random.RandomState(7 * inn + out)
    w = _q4k_card_weight(rng, inn, out, pad_nibble=0xE)
    for x in (_act_rows(rng, 1, inn), _act_rows(rng, 1, inn).to(torch.bfloat16)):
        n0 = (tq4.q4k_matvec_fq.launches, tq4.act_quant_q4k_packed.launches)
        got, xf = tq4.q4k_matvec_fq(x, w, torch.float32, with_act=True)
        again = tq4.q4k_matvec_fq(x, w, torch.float32)
        got16 = tq4.q4k_matvec_fq(x, w, torch.bfloat16)
        via = tq4.q4k_matmul(x[0], w, torch.float32)
        act = tq4.Q4KAct(*tq4.act_quant_q4k_packed(x), x.shape)
        other = tq4.q4k_matvec_fq(act, w, torch.float32)
        plain = tq4.q4k_matvec_fq_plain(x, w, torch.float32)
        torch.cuda.synchronize()
        assert (tq4.q4k_matvec_fq.launches - n0[0],
                tq4.act_quant_q4k_packed.launches - n0[1]) == (5, 5)
        assert torch.equal(xf, tq4.fake_quant_act(x))
        assert got.shape == (1, out) and got16.dtype == torch.bfloat16
        torch.testing.assert_close(got, plain, rtol=0,
                                   atol=1e-5 * plain.abs().max().item())
        assert torch.equal(got16, got.to(torch.bfloat16))
        for same in (again, via[None], other):
            assert torch.equal(same, got)
    x = _act_rows(rng, 1, inn).to(torch.bfloat16)
    _, hn, act = tnq.rms_norm_q4k(x, torch.ones(inn, device="cuda"), 1e-6)
    assert torch.equal(tq4.q4k_matmul(act, w, torch.float32),
                       tq4.q4k_matvec_fq(hn, w, torch.float32))


@pytest.mark.cuda
def test_q4k_matvec_fq_after_its_producers_under_graph_capture():
    """A decode step's chain: rms_norm_q4k -> q4k_matvec_fq, swiglu_q4k ->
    q4k_matvec_fq, decode's attention output -> q4k_act_quant ->
    q4k_matvec_fq, captured in a CUDA graph (with the programmatic edges)
    and replayed on new inputs: every product torch.equal to the same chain
    run eagerly; the refusals raise."""
    _need_card()
    rng = np.random.RandomState(11)
    E, Fh = 1024, 3072
    w_in = _q4k_card_weight(rng, E, 2048)
    w_ffn = _q4k_card_weight(rng, Fh, 1024)
    w_wo = _q4k_card_weight(rng, 2048, 1024)
    nw = torch.from_numpy(1 + 0.1 * rng.randn(E).astype(np.float32)).cuda()
    x = torch.randn(1, E, device="cuda").to(torch.bfloat16)
    h13 = torch.randn(1, 2 * Fh, device="cuda").to(torch.bfloat16)
    att = torch.randn(1, 2048, device="cuda").to(torch.bfloat16)

    def chain():
        return (tq4.q4k_matmul(tnq.rms_norm_q4k(x, nw, 1e-6)[2], w_in),
                tq4.q4k_matmul(tnq.swiglu_q4k(h13, want_hidden=False)[1], w_ffn),
                tq4.q4k_matmul(att, w_wo))

    chain()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = chain()
    for _ in range(3):
        x.copy_(torch.randn_like(x))
        h13.copy_(torch.randn_like(h13))
        att.copy_(torch.randn_like(att))
        graph.replay()
        want = chain()
        torch.cuda.synchronize()
        for got, ref in zip(outs, want):
            assert torch.equal(got, ref)
    act = tq4.Q4KAct(*tq4.act_quant_q4k_packed(att), att.shape)
    with pytest.raises(ValueError):
        tq4.q4k_matvec_fq(act, w_in)          # 2048 values for a 1024 weight
    with pytest.raises(ValueError):
        tq4.q4k_matvec_fq(att[:, :100], w_wo)


@pytest.mark.cuda
def test_q4k_matvec_fq_takes_wider_rows_through_the_two_kernels():
    """A raw row wider than q4k_matvec_fq's registers take (n_pad past
    MAX_MATVEC_PAD) goes through q4k_fake_quant + q4k_matmul: y torch.equal
    to the two kernels' and within 1e-5 of max|y| of the plain version, no
    q4k_matvec_fq launch; its Q4KAct is refused, and the model writes none
    for it (gpt._q4k_out)."""
    _need_card()
    from nano_tpu_torch.models import gpt as tgpt
    rng = np.random.RandomState(5)
    inn = tq4.MAX_MATVEC_PAD + 200
    w = _q4k_card_weight(rng, inn, 96, pad_nibble=0xE)
    assert w.n_pad > tq4.MAX_MATVEC_PAD and not tgpt._q4k_out([w])
    x = _act_rows(rng, 1, inn).to(torch.bfloat16)
    n0 = (tq4.q4k_matvec_fq.launches, tq4.fake_quant_act.launches,
          tq4.q4k_matmul_f32.launches)
    got, xf = tq4.q4k_matvec_fq(x, w, torch.float32, with_act=True)
    via = tq4.q4k_matmul(x, w, torch.float32)
    torch.cuda.synchronize()
    assert (tq4.q4k_matvec_fq.launches - n0[0],
            tq4.fake_quant_act.launches - n0[1],
            tq4.q4k_matmul_f32.launches - n0[2]) == (0, 2, 2)
    assert torch.equal(xf, tq4.fake_quant_act(x))
    assert torch.equal(got, tq4.q4k_matmul_f32(xf, w, torch.float32))
    assert torch.equal(via, got)
    plain = tq4.q4k_matvec_fq_plain(x, w, torch.float32)
    torch.testing.assert_close(got, plain, rtol=0,
                               atol=1e-5 * plain.abs().max().item())
    act = tq4.Q4KAct(*tq4.act_quant_q4k_packed(x), x.shape)
    with pytest.raises(ValueError):
        tq4.q4k_matvec_fq(act, w)


def _q4k_card_weight(rng, inn, out, pad_nibble=None):
    """A random packed Q4K weight on the card; with pad_nibble, every
    nibble at a position >= inn holds it (a right product never reads
    them)."""
    npad = tq4.n_blocks_per_line(inn) * 256
    p = rng.randint(0, 256, (out, npad // 2)).astype(np.uint8)
    if pad_nibble is not None:
        pos = np.arange(npad).reshape(-1, 2, 16)        # (G, lo/hi, 16)
        for half, shift, keep in ((0, 0, 0xF0), (1, 4, 0x0F)):
            past = (pos[:, half] >= inn).reshape(-1)
            p[:, past] = (p[:, past] & keep) | (pad_nibble << shift)
    return tq4.Q4KTensor(
        packed=torch.from_numpy(p).cuda(),
        scales=torch.from_numpy(rng.rand(out, npad // 32).astype(np.float32) * 0.02 + 1e-3).cuda(),
        biases=torch.from_numpy(rng.rand(out, npad // 32).astype(np.float32) * 0.02).cuda(),
        in_dim=inn)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [40, 64, 128, 1024, 2048, 3072])
def test_q4k_act_quant_kernel_is_bit_equal(n):
    """The activation's Q4K quantization in integer form (K3 at B > 1): the
    packed values, sa, ba and c torch.equal to the plain version, from f32
    and bf16 rows with an all-zero and constant groups."""
    _need_card()
    rng = np.random.RandomState(n + 1)
    for B in (2, 3, 5, 8, 9, 16, 40, 64, 65, 320):
        x = _act_rows(rng, B, n)
        for xt in (x, x.to(torch.bfloat16)):
            got = tq4.act_quant_q4k_packed(xt)
            want = tq4.act_quant_q4k_packed_plain(xt)
            torch.cuda.synchronize()
            assert got[0].shape == (B, tq4.n_blocks_per_line(n) * 128)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 1024, 3072])
def test_q4k_quantization_is_bit_equal_at_every_magnitude(n):
    """The quantizers (q4k_act_quant, q4k_fake_quant, rms_norm_q4k's and
    swiglu_q4k's epilogues, by FastDiv or, for a block that leaves its
    exact range, by __fdiv_rn) against the plain version on rows whose
    32-groups range over 2^-140 .. 2^70 (denormal, tiny, huge, mixed
    within a block, constant, all-zero): torch.equal everywhere."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(n)
    B = 64
    base = torch.randn(B, n, device="cuda", generator=g)
    scale = torch.exp2(torch.randint(-140, 70, (B, -(-n // 32)), device="cuda",
                                     generator=g).float())
    x = base * scale.repeat_interleave(32, dim=1)[:, :n]
    x[1, :min(n, 32)] = 3e-39          # a denormal constant group
    x[2] = 0
    x[3, ::7] = 1e-42                  # denormals among zeros
    for xt in (x, x.to(torch.bfloat16)):
        got = tq4.act_quant_q4k_packed(xt)
        want = tq4.act_quant_q4k_packed_plain(xt)
        fq = tq4.fake_quant_act(xt)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(fq, tq4.fake_quant_act_plain(xt))
    _, act = tnq.swiglu_q4k(torch.cat([torch.full_like(x, 30.0), x], dim=-1))
    y = torch.nn.functional.silu(torch.full_like(x, 30.0)) * x
    want = tq4.act_quant_q4k_packed_plain(y)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(act.parts(), want))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 3, 5, 8, 9, 16, 40, 64, 65, 320])
@pytest.mark.parametrize("inn,out", [(1024, 4096), (2048, 1024), (1024, 6144),
                                     (3072, 1024), (64, 128), (128, 64),
                                     (40, 3), (40, 200), (320, 72)])
def test_q4k_matmul_w4a4_matches_plain(inn, out, B):
    """K3 at B > 1 on the int8 tensor cores at the four Qwen3-0.6B products
    and the tiny and ragged widths (in = 40 with 0xE in every nibble past
    in): within 1e-5 of max|y| of the plain version on the same integer
    form (the same integers, f32 sums in another order), two runs the same
    bits, the bf16 output the f32 one rounded."""
    _need_card()
    rng = np.random.RandomState(inn * 7 + out + B)
    w = _q4k_card_weight(rng, inn, out, pad_nibble=0xE if inn % 256 else None)
    act = tq4.act_quant_q4k_packed(_act_rows(rng, B, inn))
    y = tq4.q4k_matmul_w4a4(*act, w, torch.float32)
    y2 = tq4.q4k_matmul_w4a4(*act, w, torch.float32)
    y16 = tq4.q4k_matmul_w4a4(*act, w, torch.bfloat16)
    want = tq4.q4k_matmul_w4a4_plain(*act, w, torch.float32)
    torch.cuda.synchronize()
    assert y.shape == (B, out) and y16.dtype == torch.bfloat16
    assert torch.equal(y, y2)
    assert torch.equal(y16, y.to(torch.bfloat16))
    torch.testing.assert_close(y, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_q4k_w4a4_under_graph_capture_and_refusals():
    """q4k_matmul at 16 rows (a slot tile no other test launches, BN = 16)
    met first inside a CUDA-graph capture gives the eager launches' bits
    on replay; misaligned or mis-shaped activations raise."""
    _need_card()
    rng = np.random.RandomState(16)
    w = _q4k_card_weight(rng, 2048, 1024)
    x = _act_rows(rng, 16, 2048)
    assert tq4.w4a4_plan(16, 1024, 2048)[1] == 16
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = tq4.q4k_matmul(x, w, torch.bfloat16)
    graph.replay()
    eager = tq4.q4k_matmul(x, w, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(y, eager)
    vp, sa, ba, c = tq4.act_quant_q4k_packed(x)
    flat = torch.zeros(16 * 1024 + 1, dtype=torch.uint8, device="cuda")
    for bad in ((flat[1:].reshape(16, 1024), sa, ba, c),   # misaligned
                (vp, sa[:, :32], ba, c),                   # sa shape
                (vp[:, :512], sa, ba, c),                  # width
                (vp[:0], sa[:0], ba[:0], c[:0])):          # no rows
        with pytest.raises(ValueError):
            tq4.q4k_matmul_w4a4(*bad, w, torch.float32)


def _flash_case(B, S, H, KV, D, dtype, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *shape: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to("cuda", dtype)
    return mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, D), mk(B, S, H * D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (2, 512, 16, 8, 48), (1, 1024, 16, 8, 128), (2, 200, 4, 2, 64),
    (3, 67, 4, 4, 48), (2, 33, 4, 1, 16), (1, 130, 6, 3, 64),
    (2, 63, 4, 2, 48), (2, 64, 8, 2, 64), (2, 65, 4, 1, 48),
    (1, 127, 8, 2, 128), (1, 129, 8, 1, 128), (2, 256, 12, 4, 48),
    (2, 512, 16, 8, 32)])
def test_flash_attention_kernels_match_plain(B, S, H, KV, D, dtype):
    """Forward and backward against the plain version differentiated by
    autograd.  f32: the same f32 arithmetic in another order, 1e-5 of
    max|ref| forward and 1e-4 backward; bf16: the kernel keeps the
    probabilities in f32 where the plain version rounds them to bf16, and
    both round the result, 2e-2 of max|ref|."""
    _need_card()
    q, k, v, g = _flash_case(B, S, H, KV, D, dtype, S + D)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = (tfa.flash_attention.launches, tfa.flash_attention.backward_launches)
    got = tfa.flash_attention(*leaves)
    got.backward(g)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention.backward_launches) == (n0[0] + 1, n0[1] + 1)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = tfa.flash_attention_plain(*ref_leaves)
    want.backward(g)
    f32 = dtype == torch.float32
    assert got.shape == (B, S, H * D) and got.dtype == dtype
    tol = (1e-5 if f32 else 2e-2) * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    for name, a, b in zip("qkv", leaves, ref_leaves):
        assert a.grad.shape == b.grad.shape and a.grad.dtype == dtype
        tol = (1e-4 if f32 else 2e-2) * b.grad.float().abs().max().item()
        err = (a.grad.float() - b.grad.float()).abs().max().item()
        assert err <= tol, (name, err, tol)
    # no atomics: a second backward gives the same bits
    again = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention(*again).backward(g)
    for a, b in zip(leaves, again):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (2, 512, 16, 8, 48), (1, 1, 4, 2, 48), (2, 63, 4, 2, 64), (2, 64, 4, 1, 48),
    (2, 65, 8, 2, 16), (1, 200, 16, 8, 128), (1, 129, 4, 1, 128),
    (2, 100, 3, 3, 48), (1, 191, 6, 1, 64), (2, 512, 16, 8, 32),
    (2, 65, 8, 2, 32), (1, 1, 4, 1, 32)])
def test_flash_attn_fwd_out_and_lse(B, S, H, KV, D, dtype):
    """The forward alone: out against the plain version and lse against
    the log-sum-exp of the plain scaled scores (what the backward kernels
    read), 1e-5 absolute in f32 and 1e-3 in bf16 (bf16 inputs, f32 sums on
    both sides); two runs give the same bits."""
    _need_card()
    q, k, v, _ = _flash_case(B, S, H, KV, D, dtype, 3 * S + D)
    out, lse = tfa.flash_attn_fwd(q, k, v)
    out2, lse2 = tfa.flash_attn_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    want, want_lse = tfa.flash_attn_fwd_plain(q, k, v)
    f32 = dtype == torch.float32
    tol = (1e-5 if f32 else 2e-2) * want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= tol
    assert lse.shape == want_lse.shape == (B, H, S)
    assert (lse - want_lse).abs().max().item() <= (1e-5 if f32 else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [16, 32, 48, 64, 128])
def test_flash_attn_bwd_matches_plain_on_strided_views(D, rep, dtype):
    """The backward kernels alone, on q, k, v cut from one fused (B, S,
    (H + 2 KV) D) projection as the model cuts them, at S = 1, below and
    past one 64-row tile, two tiles and a bit, and 512: dq, dk, dv against
    the plain version differentiated by autograd (1e-4 of max|ref| in f32,
    2e-2 in bf16, as above, and 1e-5 absolute: at S = 1 dq is zero, and
    the kernel's dP and delta, f32 sums of the same products in other
    orders, cancel only to their last bits), and a second run gives the
    same bits (no atomics, every sum in a fixed order)."""
    _need_card()
    KV = 2
    H = KV * rep
    rng = np.random.RandomState(100 * D + rep)
    for S in (1, 63, 65, 130, 512):
        B = 2 if S < 512 else 1
        qkv = torch.from_numpy(rng.randn(B, S, (H + 2 * KV) * D).astype(
            np.float32)).to("cuda", dtype)
        q = qkv[..., :H * D].reshape(B, S, H, D)
        k = qkv[..., H * D:(H + KV) * D].reshape(B, S, KV, D)
        v = qkv[..., (H + KV) * D:].reshape(B, S, KV, D)
        g = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).to(
            "cuda", dtype)
        out, lse = tfa.flash_attn_fwd(q, k, v)
        n0 = tfa.flash_attention.backward_launches
        got = tfa.flash_attn_bwd(q, k, v, out, lse, g)
        again = tfa.flash_attn_bwd(q, k, v, out, lse, g)
        torch.cuda.synchronize()
        assert tfa.flash_attention.backward_launches == n0 + 2
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        tfa.flash_attention_plain(*leaves).backward(g.reshape(B, S, H * D))
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for name, a, b, c in zip("qkv", got, leaves, again):
            assert a.shape == b.shape and a.dtype == dtype
            err = (a.float() - b.grad.float()).abs().max().item()
            lim = tol * b.grad.float().abs().max().item() + 1e-5
            assert err <= lim, (name, S, err, lim)
            assert torch.equal(a, c), (name, S)


# K4's offset form (a rank of sequence parallelism): (B, Sq, Skv, offset,
# H, KV, D) with offsets on a 64-row tile and inside one, Sq < Skv with
# keys past the last query, Sq not a multiple of the tile
OFFSET_CASES = [(2, 256, 512, 256, 16, 8, 48), (2, 256, 512, 0, 16, 8, 48),
                (2, 100, 512, 77, 16, 8, 48), (1, 130, 300, 131, 4, 2, 128),
                (2, 64, 256, 192, 8, 2, 64), (2, 37, 200, 5, 4, 1, 16),
                (1, 200, 256, 56, 8, 8, 32), (2, 65, 130, 65, 4, 4, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,offset,H,KV,D", OFFSET_CASES)
def test_flash_attention_offset_form_matches_plain(B, Sq, Skv, offset, H, KV,
                                                   D, dtype):
    """Queries at positions offset .. offset + Sq - 1 against Skv keys:
    out and lse against the plain version, dq, dk, dv against it
    differentiated by autograd (tolerances as above; lse 1e-5 absolute
    in f32 and 1e-3 in bf16), two backward runs bit-equal, dk and dv zero
    past the last query, and the rows of the call on the whole sequence
    within the plain tolerance of the offset call's."""
    _need_card()
    rng = np.random.RandomState(Sq + offset + D)
    mk = lambda *shape: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to("cuda", dtype)
    qf, k, v = mk(B, Skv, H, D), mk(B, Skv, KV, D), mk(B, Skv, KV, D)
    q = qf[:, offset:offset + Sq].contiguous()
    g = mk(B, Sq, H * D)
    out, lse = tfa.flash_attn_fwd(q, k, v, offset)
    want, want_lse = tfa.flash_attn_fwd_plain(q, k, v, offset)
    f32 = dtype == torch.float32
    tol = (1e-5 if f32 else 2e-2) * want.float().abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= (1e-5 if f32 else 1e-3)
    full, full_lse = tfa.flash_attn_fwd(qf, k, v)
    rows = full[:, offset:offset + Sq]
    assert (rows.float() - out.float()).abs().max().item() <= tol
    assert (full_lse[..., offset:offset + Sq] - lse).abs().max().item() <= \
        (1e-5 if f32 else 1e-3)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = (tfa.flash_attention.launches, tfa.flash_attention.backward_launches)
    tfa.flash_attention(*leaves, offset=offset).backward(g)
    again = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention(*again, offset=offset).backward(g)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention.backward_launches) == (n0[0] + 2, n0[1] + 2)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention_plain(*ref, offset=offset).backward(g)
    for name, a, b, c in zip("qkv", leaves, ref, again):
        assert a.grad.shape == b.grad.shape and a.grad.dtype == dtype
        lim = (1e-4 if f32 else 2e-2) * b.grad.float().abs().max().item()
        err = (a.grad.float() - b.grad.float()).abs().max().item()
        assert err <= lim + 1e-5, (name, err, lim)
        assert torch.equal(a.grad, c.grad), name
    if offset + Sq < Skv:
        assert not leaves[1].grad[:, offset + Sq:].any()
        assert not leaves[2].grad[:, offset + Sq:].any()


# the bf16 backward's routes at the widths the wgmma passes take: the
# offset cases above and two whole sequences (the training shapes' D)
ROUTE_CASES = [c for c in OFFSET_CASES if c[-1] in tfa.WGMMA_HEAD_DIMS] + [
    (4, 512, 512, 0, 16, 8, 48), (2, 512, 512, 0, 16, 8, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,offset,H,KV,D", ROUTE_CASES)
def test_flash_bwd_routes_match_plain_and_each_other(B, Sq, Skv, offset, H,
                                                      KV, D):
    """K4's bf16 backward through each route's passes alone, on the
    forward's out and lse: the wgmma passes (one and, where the heads of a
    KV head are even, two query heads a dq block) and the mma.sync passes, each
    within 2e-2 of max|grad| of the plain version differentiated by
    autograd, two runs bit-equal, dk and dv zero past the last query, the
    wgmma passes within the same tolerance of the mma.sync passes'; the wgmma counter
    counts the route's calls."""
    _need_card()
    rng = np.random.RandomState(Sq + offset + D + 7)
    mk = lambda *shape: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to("cuda", torch.bfloat16)
    q, k, v = mk(B, Sq, H, D), mk(B, Skv, KV, D), mk(B, Skv, KV, D)
    g = mk(B, Sq, H, D)
    out, lse = tfa.flash_attn_fwd(q, k, v, offset)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tfa.flash_attention_plain(*ref, offset=offset).backward(
        g.reshape(B, Sq, H * D))
    routes = [tfa.BwdRoute("wgmma", h) for h in (1, 2) if (H // KV) % h == 0]
    assert tfa.bwd_route(B, Sq, Skv, offset, H, KV, D, torch.bfloat16) in \
        routes + [tfa.BwdRoute("mma")]
    got = {}
    for route in routes + [tfa.BwdRoute("mma")]:
        n0 = tfa.flash_attention.wgmma_launches
        a = tfa.flash_attn_bwd(q, k, v, out, lse, g, offset, route=route)
        b = tfa.flash_attn_bwd(q, k, v, out, lse, g, offset, route=route)
        torch.cuda.synchronize()
        assert tfa.flash_attention.wgmma_launches - n0 == \
            (2 if route.passes == "wgmma" else 0)
        for name, x, y, r in zip("qkv", a, b, ref):
            lim = 2e-2 * r.grad.float().abs().max().item() + 1e-5
            err = (x.float() - r.grad.float()).abs().max().item()
            assert err <= lim, (route, name, err, lim)
            assert torch.equal(x, y), (route, name)
        if offset + Sq < Skv:
            assert not a[1][:, offset + Sq:].any()
            assert not a[2][:, offset + Sq:].any()
        got[route] = a
    old = got.pop(tfa.BwdRoute("mma"))
    for a in got.values():
        for x, y, r in zip(a, old, ref):
            assert (x.float() - y.float()).abs().max().item() <= \
                2e-2 * r.grad.float().abs().max().item() + 1e-5


# the forward's routes at the widths the wgmma kernel takes: the route
# cases above, a query tile one row short of and past 64, one query, and
# four query heads a KV head
FWD_ROUTE_CASES = ROUTE_CASES + [
    (2, 63, 300, 100, 8, 8, 64), (2, 65, 400, 200, 16, 4, 16),
    (2, 1, 300, 299, 8, 2, 32), (2, 129, 129, 0, 8, 2, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,offset,H,KV,D", FWD_ROUTE_CASES)
def test_flash_fwd_routes_match_plain_and_each_other(B, Sq, Skv, offset, H,
                                                      KV, D):
    """K4's bf16 forward through each route's kernel alone on a strided
    view of q: the wgmma kernel (one and, where the heads of a KV head are
    even, two query heads a block) and the mma.sync kernel, out within 2e-2
    of max|out| and lse within 1e-3 of the plain version, two runs
    bit-equal, the wgmma kernel within the same tolerance of the mma.sync
    kernel; the wgmma counter counts the route's calls."""
    _need_card()
    rng = np.random.RandomState(Sq + offset + D + 11)
    mk = lambda *shape: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to("cuda", torch.bfloat16)
    qf, k, v = mk(B, Skv, H, D), mk(B, Skv, KV, D), mk(B, Skv, KV, D)
    q = qf[:, offset:offset + Sq]
    want, want_lse = tfa.flash_attn_fwd_plain(q, k, v, offset)
    lim = 2e-2 * want.float().abs().max().item()
    routes = [tfa.FwdRoute("wgmma", h) for h in (1, 2) if (H // KV) % h == 0]
    got = {}
    for route in routes + [tfa.FwdRoute("mma")]:
        n0 = tfa.flash_attention.forward_wgmma_launches
        a, la = tfa.flash_attn_fwd(q, k, v, offset, route=route)
        b, lb = tfa.flash_attn_fwd(q, k, v, offset, route=route)
        torch.cuda.synchronize()
        assert tfa.flash_attention.forward_wgmma_launches - n0 == \
            (2 if route.kernel == "wgmma" else 0)
        assert (a.float() - want.float()).abs().max().item() <= lim, route
        assert (la - want_lse).abs().max().item() <= 1e-3, route
        assert torch.equal(a, b) and torch.equal(la, lb), route
        got[route] = a
    old = got.pop(tfa.FwdRoute("mma"))
    for a in got.values():
        assert (a.float() - old.float()).abs().max().item() <= lim


@pytest.mark.cuda
def test_wgmma_forward_fits_an_sm_and_is_captured_in_a_graph():
    """The wgmma forward takes at most the 227 KB of shared memory a block
    may have on the H100 and a block fits an SM (D = 128 is not built);
    captured in a CUDA graph and replayed it gives the eager call's
    bits."""
    _need_card()
    from nano_tpu_torch.ops import _build
    lib = _build.lib("flash_fwd_wgmma")
    for D in tfa.WGMMA_HEAD_DIMS:
        for hpb in (1, 2):
            assert 0 < lib.flash_fwd_wgmma_smem(D, hpb) <= 232448
    assert lib.flash_fwd_wgmma_smem(128, 1) == -1
    rng = np.random.RandomState(12)
    mk = lambda *shape: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to("cuda", torch.bfloat16)
    B, Sq, Skv, offset, H, KV, D = 2, 256, 512, 256, 16, 8, 48
    q, k, v = mk(B, Sq, H, D), mk(B, Skv, KV, D), mk(B, Skv, KV, D)
    route = tfa.fwd_route(B, Sq, Skv, offset, H, KV, D, torch.bfloat16)
    assert route.kernel == "wgmma"
    want = tfa.flash_attn_fwd(q, k, v, offset)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfa.flash_attn_fwd(q, k, v, offset)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tfa.flash_attn_fwd(q, k, v, offset)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1024, 320, 40])
def test_fused_final_norm_is_the_two_launches_it_replaces(E):
    """rms_norm_q4k_fq: fq torch.equal to q4k_fake_quant of rms_norm_q80's
    hn and to its plain version, zeros past E; h, hn torch.equal to
    rms_norm_q80's; bf16 and f32, with and without a residual, one row and
    more; one launch."""
    _need_card()
    rng = np.random.RandomState(E)
    w = torch.from_numpy(1 + 0.1 * rng.randn(E).astype(np.float32)).cuda()
    for B in (1, 3, 64):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.from_numpy(rng.randn(B, E).astype(np.float32) * 2).to(
                "cuda", dt)
            r = torch.from_numpy(rng.randn(B, E).astype(np.float32)).to(
                "cuda", dt)
            for res in (None, r):
                n0 = (tnq.rms_norm_q4k_fq.launches, tq4.fake_quant_act.launches)
                h, hn, fq = tnq.rms_norm_q4k_fq(x, w, 1e-6, res)
                assert (tnq.rms_norm_q4k_fq.launches,
                        tq4.fake_quant_act.launches) == (n0[0] + 1, n0[1])
                h8, hn8, _ = tnq.rms_norm_q80(x, w, 1e-6, res)
                two = tq4.fake_quant_act(hn8)
                torch.cuda.synchronize()
                assert torch.equal(fq, two)
                assert torch.equal(fq, tq4.fake_quant_act_plain(hn8))
                assert not fq[:, E:].any() and torch.equal(hn, hn8)
                assert h is None if res is None else torch.equal(h, h8)


@pytest.mark.cuda
def test_wgmma_passes_fit_an_sm():
    """Each wgmma pass as built takes at most the 227 KB of shared memory a
    block may have on the H100, and a block of each fits an SM; D = 128 is
    not built."""
    _need_card()
    from nano_tpu_torch.ops import _build
    lib = _build.lib("flash_bwd_wgmma")
    for D in tfa.WGMMA_HEAD_DIMS:
        for pass_, hpb in ((0, 1), (0, 2), (1, 1)):
            assert 0 < lib.flash_bwd_wgmma_smem(D, pass_, hpb) <= 232448
            assert lib.flash_bwd_wgmma_blocks_per_sm(D, pass_, hpb) >= 1
    assert lib.flash_bwd_wgmma_smem(128, 1, 1) == -1


@pytest.mark.cuda
def test_wgmma_backward_captured_in_a_graph_gives_the_eager_bits():
    """The two passes (the dk/dv pass a programmatic dependent of the dq
    pass) captured in a CUDA graph and replayed: the eager call's bits."""
    _need_card()
    rng = np.random.RandomState(11)
    mk = lambda *shape: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to("cuda", torch.bfloat16)
    B, Sq, Skv, offset, H, KV, D = 2, 256, 512, 256, 16, 8, 48
    q, k, v, g = mk(B, Sq, H, D), mk(B, Skv, KV, D), mk(B, Skv, KV, D), \
        mk(B, Sq, H, D)
    out, lse = tfa.flash_attn_fwd(q, k, v, offset)
    want = tfa.flash_attn_bwd(q, k, v, out, lse, g, offset)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tfa.flash_attn_bwd(q, k, v, out, lse, g, offset)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tfa.flash_attn_bwd(q, k, v, out, lse, g, offset)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_attention_takes_strided_views_and_refuses_other_head_dims():
    _need_card()
    B, S, H, KV, D = 2, 96, 4, 2, 48
    qkv = torch.randn(B, S, (H + 2 * KV) * D, device="cuda")
    q = qkv[..., :H * D].reshape(B, S, H, D)
    k = qkv[..., H * D:(H + KV) * D].reshape(B, S, KV, D)
    v = qkv[..., (H + KV) * D:].reshape(B, S, KV, D)
    assert not q.is_contiguous()
    got = tfa.flash_attention(q, k, v)
    want = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    with pytest.raises(ValueError, match="D in"):
        tfa.flash_attention(torch.randn(1, 8, 2, 40, device="cuda"),
                            torch.randn(1, 8, 2, 40, device="cuda"),
                            torch.randn(1, 8, 2, 40, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_operator_is_the_two_kernels(dtype):
    """The registered operator nano_tpu_torch::flash_attn_fwd returns the
    forward kernel's out and lse bit for bit, one launch; its gradient is
    the backward kernel's on that out and lse, one launch."""
    _need_card()
    B, S, H, KV, D = 2, 130, 8, 2, 48
    q, k, v, g = _flash_case(B, S, H, KV, D, dtype, 7)
    out, lse = tfa.flash_attn_fwd(q, k, v)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = (tfa.flash_attention.launches, tfa.flash_attention.backward_launches)
    o2, l2 = torch.ops.nano_tpu_torch.flash_attn_fwd(*leaves)
    o2.backward(g.reshape(B, S, H, D))
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches,
            tfa.flash_attention.backward_launches) == (n0[0] + 1, n0[1] + 1)
    assert torch.equal(o2, out) and torch.equal(l2, lse)
    want = tfa.flash_attn_bwd(q, k, v, out, lse, g.reshape(B, S, H, D))
    for a, b in zip(leaves, want):
        assert torch.equal(a.grad, b)


def _remat_step(remat, dtype, over=None):
    """loss_fn + backward of a 4-layer Nano-shaped model (heads of 48) on
    the card under `remat` -> (loss, grads, K4 forward and backward
    launches)."""
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.models import gpt
    cfg = ModelConfig(**dict(dict(block_size=128, vocab_size=512, n_layer=4,
                                  n_embd=192, n_head=4, n_kv_head=2,
                                  n_hidden=384), **(over or {})))
    params = gpt.init_params(torch.Generator().manual_seed(5), cfg,
                             device="cuda")
    rng = np.random.RandomState(6)
    x, y = (torch.from_numpy(rng.randint(0, 512, (4, 128))).cuda()
            for _ in range(2))
    m = torch.from_numpy((rng.rand(4, 128) < 0.6).astype(np.int64)).cuda()
    n0 = (tfa.flash_attention.launches, tfa.flash_attention.backward_launches)
    loss = gpt.loss_fn(params, x, y, m, cfg, dtype=dtype, remat=remat)
    loss.backward()
    torch.cuda.synchronize()
    n = (tfa.flash_attention.launches - n0[0],
         tfa.flash_attention.backward_launches - n0[1])
    return loss.detach(), [p.grad for _, p in gpt.param_leaves(params)], n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("remat", ["dots", "heads"])
def test_selective_remat_matches_full_remat_on_the_card(remat, dtype):
    """"dots" and "heads" give full remat's loss bit for bit (the same
    forward) and its gradients (each within 1e-5 of its max|grad|: the
    same kernels on the same inputs, the saved tensors those the recompute
    would give); K4's forward runs twice a layer under "dots" and once
    under "heads", whose backward reads the operator's saved out and
    lse."""
    _need_card()
    l0, g0, n0 = _remat_step("full", dtype)
    l1, g1, n1 = _remat_step(remat, dtype)
    assert torch.equal(l0, l1) and torch.isfinite(l1)
    for a, b in zip(g0, g1):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 1e-5 * max(a.float().abs().max().item(), 1e-12)
    assert n0 == (8, 4)
    assert n1 == ((8, 4) if remat == "dots" else (4, 4))


@pytest.mark.cuda
def test_launch_counters_count_kernel_launches():
    _need_card()
    x = torch.randn(2, 256, device="cuda")
    w = tqm.Q80Tensor(q=torch.randint(-127, 128, (64, 256), dtype=torch.int8,
                                      device="cuda"),
                      scales=torch.rand(64, 1, device="cuda"),
                      group_size=256, w8a8=True)
    n0 = (tqm.act_quant_q80.launches, tqm.q80_w8a8.launches)
    tqm.q80_matmul(x, w, torch.float32)
    assert (tqm.act_quant_q80.launches, tqm.q80_w8a8.launches) == (
        n0[0] + 1, n0[1] + 1)
    wr = tqm.Q80Tensor(q=w.q, scales=torch.rand(64, 8, device="cuda"),
                       group_size=32)
    rows = (tqm.q80_matvec_rows, tqm.q80_matmul_rows, tqm.q80_matmul_rows_warp)
    n0 = [f.launches for f in rows]
    tqm.q80_matmul(x, wr, torch.float32)
    tqm.q80_matmul(x[:1], wr, torch.float32)
    tqm.q80_matmul_rows_warp(x, wr, torch.float32)
    assert [f.launches for f in rows] == [n0[0] + 1, n0[1] + 1, n0[2] + 1]
    w4 = tq4.Q4KTensor(packed=torch.zeros(64, 128, dtype=torch.uint8,
                                          device="cuda"),
                       scales=torch.ones(64, 8, device="cuda"),
                       biases=torch.zeros(64, 8, device="cuda"), in_dim=256)
    counters = (tq4.act_quant_q4k_packed, tq4.q4k_matmul_w4a4,
                tq4.q4k_matvec_fq, tq4.fake_quant_act, tq4.q4k_matmul_f32)
    n0 = [f.launches for f in counters]
    tq4.q4k_matmul(x, w4, torch.float32)
    assert [f.launches for f in counters] == [n0[0] + 1, n0[1] + 1, n0[2],
                                              n0[3], n0[4]]
    tq4.q4k_matmul(x[:1], w4, torch.float32)
    assert [f.launches for f in counters] == [n0[0] + 2, n0[1] + 1,
                                              n0[2] + 1, n0[3], n0[4]]
    norms = (tnq.rms_norm_q4k, tnq.swiglu_q4k, tnq.rms_norm_q80,
             tnq.swiglu_q80)
    n0 = [f.launches for f in norms + counters]
    _, _, act = tnq.rms_norm_q4k(x[:1], torch.ones(256, device="cuda"), 1e-6)
    tq4.q4k_matmul(act, w4, torch.float32)
    _, act = tnq.swiglu_q4k(torch.cat([x, x], dim=-1))
    tq4.q4k_matmul(act, w4, torch.float32)
    assert [f.launches for f in norms + counters] == [
        n0[0] + 1, n0[1] + 1, n0[2], n0[3], n0[4], n0[5] + 1, n0[6] + 1,
        n0[7], n0[8]]


@pytest.mark.cuda
def test_python_scalar_division_is_not_ieee_on_the_card():
    """Why the plain versions divide by tensors: on a CUDA tensor,
    `x / 127.0` multiplies by the f32 reciprocal of 127, which moves some
    quotients by an ulp and with them the int8 rounding decisions."""
    _need_card()
    x = torch.randn(1 << 20, device="cuda") * 100
    by_scalar = x / 127.0
    assert torch.equal(by_scalar, x * (1.0 / 127.0))
    assert not torch.equal(by_scalar, x / torch.full_like(x, 127.0))
    xq, sa = tqm.act_quant_q80(x.reshape(-1, 256), 256)
    pq, ps = tqm.act_quant_q80_plain(x.reshape(-1, 256), 256)
    assert torch.equal(xq, pq) and torch.equal(sa, ps)


# ---------------------------------------------------------------------
# decode on the device: the graphed step against the eager one
# ---------------------------------------------------------------------

FIX = os.path.join(os.path.dirname(__file__), "js", "fixtures")


def _fixture_ctx(name, penalty=1.1, **kw):
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.ops import sampling
    return engine.LLMContext.from_bin(
        os.path.join(FIX, name), max_seq_len=64, dtype=torch.float32,
        sampler=sampling.SamplerConfig(temperature=0.0,
                                       repetition_penalty=penalty), **kw)


def _eager_stream(ctx, prompt_ids, n_tokens, cache_len):
    """The engine's decode step called from Python, step by step."""
    from nano_tpu_torch.infer import engine
    cache = ctx.new_cache(1, seq_len=cache_len)
    gen = ctx.generator()
    tok, seen = engine._prefill_first_token(ctx, prompt_ids, cache, gen)
    pos = torch.tensor([len(prompt_ids)], dtype=torch.int32, device="cuda")
    out = [int(tok[0])]
    for _ in range(n_tokens - 1):
        tok = engine._decode_step(ctx, tok, pos, cache, seen, gen)
        pos += 1
        out.append(int(tok[0]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny_f32.bin", "tiny_q80.bin",
                                  "tiny_q4k.bin"])
@pytest.mark.parametrize("graph_steps", [1, 4])
def test_graphed_decode_equals_eager_loop(name, graph_steps):
    """The captured step replayed (generate_on_device at one step a graph,
    the context's decoder through a graph of `graph_steps` steps): the
    same tokens as the eager step loop, bit for bit, with exact launch
    counts on the first call (warm-up + capture) and on a second (replays
    only); the committed streams through Session."""
    _need_card()
    from nano_tpu_torch.infer import engine
    ctx = _fixture_ctx(name)
    ids = ctx.encode("helloworldabc")
    want = _eager_stream(ctx, ids, 29, 64)

    def graphed():
        if graph_steps == 1:
            return engine.generate_on_device(ctx, ids, 29).tolist()
        dec = ctx.decoder()
        with ctx.on_stream():
            dec.claim()
            dec.prefill(ids)
            for _ in range(28 // graph_steps):
                dec._graph(graph_steps).run()
            return dec.out[:29].tolist()

    for _ in range(2):
        n0 = tda.decode_attention.launches
        got = graphed()
        torch.cuda.synchronize()
        assert got == want
        assert tda.decode_attention.launches - n0 == ctx.cfg.n_layer * 28
    with open(os.path.join(FIX, "expected.json")) as f:
        expected = json.load(f)
    plain = _fixture_ctx(name, penalty=1.0)
    s = engine.generate_sync(plain, expected["prompt"], max_new_tokens=16)
    assert s.output_ids == expected["greedy"][name[5:-4]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny_q80.bin", "tiny_q4k.bin"])
def test_batched_engine_equals_solo_on_the_card(name):
    """Streams joining a graphed batched engine at different times give
    their solo greedy streams (int8 KV too), across a growth 128 -> 256."""
    _need_card()
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.serve.batching import BatchedEngine
    for kv in (None, torch.int8):
        ctx = _fixture_ctx(name, kv_cache_dtype=kv)
        ctx.max_seq_len = 256
        be = BatchedEngine(ctx, n_slots=4)
        prompts = [ctx.encode(p) for p in ("hello", "abcabcabc", "xyz" * 30)]
        outs, slots = {}, {}
        for i, p in enumerate(prompts):
            slot, first = be.add(p, max_new_tokens=100 - 20 * i,
                                 temperature=0.0, repetition_penalty=1.1)
            slots[slot], outs[slot] = i, [first]
            for s, toks in be.step_burst(5).items():   # all advance
                outs[s].extend(toks)
        while be.n_active:
            for s, toks in be.step_burst(7).items():
                outs[s].extend(toks)
        assert be._cache_len() == 256
        for s, i in slots.items():
            solo = engine.generate_on_device(ctx, prompts[i], 100 - 20 * i)
            assert outs[s] == solo.tolist()[:len(outs[s])]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny_q80.bin", "tiny_q4k.bin"])
def test_speculative_rounds_on_the_card(name):
    """Verify rounds replayed from their graphs (spec_k = 7): the
    committed streams through Session and generate_on_device, and the
    launches of each round on the second call: none of the decode kernel,
    a whole number of rounds."""
    _need_card()
    from nano_tpu_torch.infer import engine, speculative
    with open(os.path.join(FIX, "expected.json")) as f:
        expected = json.load(f)
    ctx = _fixture_ctx(name, penalty=1.0)
    ctx.spec_k = 7
    want = expected["greedy"][name[5:-4]]
    s = engine.generate_sync(ctx, expected["prompt"], max_new_tokens=16)
    assert s.output_ids == want and s.steps_by["round"] > 0
    ids = ctx.encode(expected["prompt"])
    assert engine.generate_on_device(ctx, ids, 16).tolist() == want
    n0 = tda.decode_attention.launches
    assert engine.generate_on_device(ctx, ids, 16).tolist() == want
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == n0
    assert speculative.LAST_STATS["rounds"] < 15


@pytest.mark.cuda
def test_speculative_batched_sampled_slot_is_the_plain_one():
    """A sampled slot in a speculative BatchedEngine (its row 0 through the
    decode kernel) draws the plain engine's stream bit for bit, beside a
    greedy slot that verifies drafts.  The stream ends as the engine
    ends one: at max_new_tokens, or earlier at a stop token of the
    context, the same way in both engines."""
    _need_card()
    from nano_tpu_torch.serve.batching import BatchedEngine
    outs, reasons = [], []
    for spec_k in (0, 4):
        ctx = _fixture_ctx("tiny_q80.bin")
        ctx.spec_k = spec_k
        be = BatchedEngine(ctx, n_slots=4)
        g, gf = be.add(ctx.encode("abcabcabc"), max_new_tokens=30,
                       temperature=0.0, repetition_penalty=1.0)
        t, tf = be.add(ctx.encode("hello"), max_new_tokens=30,
                       temperature=0.8, repetition_penalty=1.1)
        got = {g: [gf], t: [tf]}
        while be.n_active:
            for sl, toks in be.step_burst(4).items():
                got[sl].extend(toks)
        outs.append(got[t])
        reasons.append(be.slots[t].finished_reason)
        if spec_k:
            assert be.bursts_by["spec"] > 0
    assert outs[0] == outs[1] and reasons[0] == reasons[1]
    if reasons[0] == "length":
        assert len(outs[0]) == 30
    else:
        assert reasons[0] == "stop" and 0 < len(outs[0]) < 30


def _random_adapters(cfg, tmp_path, ranks):
    """LoRA files of the given ranks for `cfg`, random A and B from a
    seed each, written by write_lora."""
    from nano_tpu_torch.io import binfmt
    HD = cfg.n_head * cfg.head_dim
    KD = cfg.n_kv_head * cfg.head_dim
    paths = []
    for i, r in enumerate(ranks):
        rng = np.random.RandomState(i)
        lora = {}
        for name, inn, out in (("wq", cfg.n_embd, HD), ("wk", cfg.n_embd, KD),
                               ("wv", cfg.n_embd, KD), ("wo", HD, cfg.n_embd)):
            lora[name + "_a"] = rng.randn(cfg.n_layer, inn, r) * 0.3
            lora[name + "_b"] = rng.randn(cfg.n_layer, r, out) * 0.3
        paths.append(str(tmp_path / f"lora{i}.bin"))
        binfmt.write_lora(paths[-1], lora, cfg, rank=r, alpha=2 * r)
    return paths


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny_f32.bin", "tiny_q80.bin"])
def test_lora_hot_swap_under_the_decode_graph(name, tmp_path):
    """An adapter attached, swapped for one of the same rank (copied into
    the buffers the captured graph reads: no capture) and detached: each
    stream that of a fresh context with that adapter, the graph stream the
    eager step loop's."""
    _need_card()
    from nano_tpu_torch.infer import engine
    ctx = _fixture_ctx(name, penalty=1.0, stop_tokens=())
    a, b = _random_adapters(ctx.cfg, tmp_path, (4, 4))
    ids = ctx.encode("abcdefgh")
    base = engine.generate_on_device(ctx, ids, 24).tolist()
    streams = []
    for path in (a, b):
        ctx.load_lora(path)
        got = engine.generate_on_device(ctx, ids, 24).tolist()
        fresh = _fixture_ctx(name, penalty=1.0, stop_tokens=())
        fresh.load_lora(path)
        assert got == engine.generate_on_device(fresh, ids, 24).tolist()
        streams.append(got)
    dec = ctx.decoder()
    assert sorted(str(k[-1]) for k in dec.graphs) == [
        str(tuple(ctx.lora["wq_a"].shape)), "None"]
    cache = ctx.new_cache(1)
    gen = ctx.generator()
    tok, seen = engine._prefill_first_token(ctx, ids, cache, gen, ctx.lora,
                                            ctx.lora_scale)
    pos = torch.tensor([len(ids)], dtype=torch.int32, device="cuda")
    eager = [int(tok[0])]
    for _ in range(23):
        tok = engine._decode_step(ctx, tok, pos, cache, seen, gen, ctx.lora,
                                  ctx.lora_scale)
        pos += 1
        eager.append(int(tok[0]))
    assert eager == streams[1]
    ctx.unload_lora()
    assert engine.generate_on_device(ctx, ids, 24).tolist() == base
    assert streams[0] != base and streams[1] != streams[0]


@pytest.mark.cuda
def test_lora_batched_engine_per_slot_adapters(tmp_path):
    """Adapters of ranks 2 and 4 and a base slot in one BatchedEngine on
    tiny_f32.bin, replayed from its graphs: each slot's stream that of a
    context with its adapter alone."""
    _need_card()
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.serve.batching import BatchedEngine
    ctx = _fixture_ctx("tiny_f32.bin", penalty=1.0, stop_tokens=())
    a, b = _random_adapters(ctx.cfg, tmp_path, (2, 4))
    be = BatchedEngine(ctx, n_slots=4, adapters={"a": a, "b": b})
    joins = [("abcdef", "a"), ("ghijk", None), ("lmnop", "b")]
    got = {}
    for prompt, adapter in joins:
        slot, first = be.add(ctx.encode(prompt), max_new_tokens=16,
                             temperature=0.0, repetition_penalty=1.0,
                             adapter=adapter)
        got[slot] = (prompt, adapter, [first])
    while be.n_active:
        for slot, toks in be.step_burst(4).items():
            got[slot][2].extend(toks)
    for prompt, adapter, toks in got.values():
        solo = _fixture_ctx("tiny_f32.bin", penalty=1.0, stop_tokens=())
        if adapter:
            solo.load_lora({"a": a, "b": b}[adapter])
        assert toks == engine.generate_on_device(
            solo, solo.encode(prompt), 16).tolist(), adapter


@pytest.mark.cuda
def test_join_from_another_thread_during_captures():
    """One thread serves bursts that grow the cache and capture a graph at
    each new capacity while clients join from the main thread: no capture
    fails, and every stream is its solo greedy stream."""
    _need_card()
    import threading
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.serve.batching import BatchedEngine
    ctx = _fixture_ctx("tiny_q80.bin")
    ctx.max_seq_len = 256
    be = BatchedEngine(ctx, n_slots=4)
    prompts = [ctx.encode(p) for p in ("xyz" * 40, "hello", "abcabcabc")]
    outs, slots, errors = {}, {}, []
    slot, first = be.add(prompts[0], max_new_tokens=60, temperature=0.0,
                         repetition_penalty=1.1)
    slots[slot], outs[slot] = 0, [first]

    def serve():
        try:
            while be.n_active:
                for s, toks in be.step_burst(3).items():
                    outs[s].extend(toks)
        except BaseException as e:          # re-raised below
            errors.append(e)

    server = threading.Thread(target=serve)
    server.start()
    for i, p in enumerate(prompts[1:], 1):
        slot, first = be.add(p, max_new_tokens=30, temperature=0.0,
                             repetition_penalty=1.1)
        slots[slot], outs[slot] = i, [first]
    server.join(120)
    assert not server.is_alive() and not errors
    assert be._cache_len() == 256
    for s, i in slots.items():
        solo = engine.generate_on_device(ctx, prompts[i], len(outs[s]))
        assert outs[s] == solo.tolist()


@pytest.mark.cuda
def test_stochastic_sampling_under_the_graph():
    """A stochastic sampler's draws come from the context's generator,
    which the graph registers: two calls from the same seed give the same
    stream.  Where this PyTorch cannot register a generator with a graph,
    the capture raises and says so."""
    _need_card()
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.ops import sampling
    ctx = _fixture_ctx("tiny_q80.bin")
    ctx.sampler = sampling.SamplerConfig(temperature=0.9, top_p=0.9,
                                         repetition_penalty=1.1)
    ids = ctx.encode("helloworldabc")
    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        with pytest.raises(RuntimeError, match="register_generator_state"):
            engine.generate_on_device(ctx, ids, 20)
        return
    a = engine.generate_on_device(ctx, ids, 40).tolist()
    b = engine.generate_on_device(ctx, ids, 40).tolist()
    assert a == b and all(0 <= t < ctx.cfg.vocab_size for t in a)


def _ulps(a, b):
    """The distance in units in the last place between two tensors of one
    float dtype (f32 or bf16), element by element."""
    it, mag = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
               else (torch.int32, 0x7FFFFFFF))
    mono = lambda t: (lambda i: torch.where(i < 0, -(i & mag), i))(
        t.contiguous().view(it).long())
    return (mono(a) - mono(b)).abs()


def _rms_norm_kernel_order(h, w, eps):
    """rms_norm of h (B, E) with the sum of squares taken in rms_norm_q80's
    order (tnq.plan: T threads of P chunks of 4 values; a thread's squares
    in order, a warp's xor butterfly, the warps' sums in order), each step
    an f32 PyTorch op.  -> (hn in h's dtype, the f32 factor (B, 1))."""
    B, E = h.shape
    T, P = tnq.plan(E)
    hf = h.float()
    sq = torch.zeros(B, P * T * 4, device=h.device)
    sq[:, :E] = hf * hf
    sq = sq.view(B, P, T, 4)
    s = torch.zeros(B, T, device=h.device)
    for p in range(P):
        for j in range(4):
            s = s + sq[:, p, :, j]
    s = s.view(B, T // 32, 32)
    lane = torch.arange(32, device=h.device)
    for off in (16, 8, 4, 2, 1):
        s = s + s[:, :, lane ^ off]
    tot = torch.zeros(B, device=h.device)
    for k in range(T // 32):
        tot = tot + s[:, k, 0]
    r = torch.rsqrt(tot * (torch.ones((), device=h.device) / E) + eps)[:, None]
    return ((hf * r) * w.float()).to(h.dtype), r


def _check_hn(hn, h, w, eps):
    """hn torch.equal to the eager ops summed in the kernel's order; against
    eager rms_norm within one bf16 ulp, or 2 k + 2 f32 ulps in a row whose
    two f32 factors rsqrt(mean + eps) are k apart (an f32 value's ulp may
    be half the factor's, relatively, and each of the two products'
    roundings adds one).  -> the largest distance from eager, in ulps."""
    ordered, r_k = _rms_norm_kernel_order(h, w, eps)
    assert torch.equal(hn, ordered)
    hf = h.float()
    r_e = torch.rsqrt(torch.mean(hf * hf, dim=-1, keepdim=True) + eps)
    k = _ulps(r_k, r_e)
    u = _ulps(hn, tnq.rms_norm(h, w, eps)).amax(dim=-1, keepdim=True)
    limit = (torch.ones_like(k) if hn.dtype == torch.bfloat16
             else torch.where(k > 0, 2 * k + 2, 0))
    assert bool((u <= limit).all())
    return int(u.max())


def _norm_quant_inputs(rng, B, E, dtype, zero_row=True):
    x = torch.from_numpy(rng.randn(B, E).astype(np.float32) * 2).to(
        "cuda", dtype)
    a = torch.from_numpy(rng.randn(B, E).astype(np.float32)).to("cuda", dtype)
    if zero_row and B > 2:
        x[2] = 0
        a[2] = 0
    return x, a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 40, 64, 65, 320])
def test_rms_norm_q80_matches_eager(B, dtype):
    """At the Qwen3-0.6B width (E = 1024), with and without the residual,
    at group sizes 0, 256 and 512: h torch.equal to the eager add; hn as
    _check_hn holds it (torch.equal to the eager ops summed in the kernel's
    order, near eager rms_norm); xq and sa torch.equal to q80_act_quant (and its plain
    version) of the kernel's own hn; the Q80 outputs the same with and
    without hn; two runs bit-equal; an all-zero row scale 0 and values 0."""
    _need_card()
    rng = np.random.RandomState(B)
    E, eps = 1024, 1e-6
    x, a = _norm_quant_inputs(rng, B, E, dtype)
    w = torch.from_numpy(1 + 0.1 * rng.randn(E).astype(np.float32)).cuda()
    worst = 0
    for res in (None, a):
        want_h = x if res is None else x + res
        for gs in (0, 256, 512):
            h, hn, act = tnq.rms_norm_q80(x, w, eps, res, gs)
            h2, hn2, act2 = tnq.rms_norm_q80(x, w, eps, res, gs)
            _, none, act3 = tnq.rms_norm_q80(x, w, eps, res, gs,
                                             want_hn=False)
            torch.cuda.synchronize()
            if res is None:
                assert h is None
            else:
                assert torch.equal(h, want_h) and torch.equal(h2, h)
            assert hn.dtype == dtype and torch.equal(hn2, hn) and none is None
            worst = max(worst, _check_hn(hn, want_h, w, eps))
            if not gs:
                assert act is None and act3 is None
                continue
            kq, ks = tqm.act_quant_q80(hn, gs)
            pq, ps = tqm.act_quant_q80_plain(hn, gs)
            assert torch.equal(act.xq, kq) and torch.equal(act.sa, ks)
            assert torch.equal(act.xq, pq) and torch.equal(act.sa, ps)
            for other in (act2, act3):
                assert (torch.equal(other.xq, act.xq)
                        and torch.equal(other.sa, act.sa))
            assert act.shape == x.shape and act.group_size == gs
            if B > 2:
                assert (act.sa[2] == 0).all() and (act.xq[2] == 0).all()
    print(f"rms_norm_q80 B={B} {dtype}: hn at most {worst} ulp from eager")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 3, 8, 9, 40, 64, 65, 320])
def test_swiglu_q80_matches_eager(B, dtype):
    """At the Qwen3-0.6B width (2F = 6144), at group sizes 0, 256 and 512:
    the output torch.equal to eager F.silu(h1) * h3 on the card; xq and sa
    torch.equal to q80_act_quant of it; two runs bit-equal; an all-zero row
    scale 0 and values 0."""
    _need_card()
    rng = np.random.RandomState(100 + B)
    Fh = 3072
    h13, _ = _norm_quant_inputs(rng, B, 2 * Fh, dtype)
    want = torch.nn.functional.silu(h13[:, :Fh]) * h13[:, Fh:]
    for gs in (0, 256, 512):
        y, act = tnq.swiglu_q80(h13, gs)
        y2, act2 = tnq.swiglu_q80(h13, gs)
        none, act3 = tnq.swiglu_q80(h13, gs, want_hidden=False)
        torch.cuda.synchronize()
        assert torch.equal(y, want) and torch.equal(y2, y) and none is None
        if not gs:
            assert act is None and act3 is None
            continue
        kq, ks = tqm.act_quant_q80(y, gs)
        assert torch.equal(act.xq, kq) and torch.equal(act.sa, ks)
        for other in (act2, act3):
            assert torch.equal(other.xq, act.xq) and torch.equal(other.sa, act.sa)
        if B > 2:
            assert (act.sa[2] == 0).all() and (act.xq[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_quant_rows_do_not_depend_on_the_row_count(dtype):
    """A row's h, hn, xq and sa (and SwiGLU's output and Q80 outputs) are
    the same bits in a launch of one row as inside one of 64."""
    _need_card()
    rng = np.random.RandomState(7)
    E, Fh, eps = 1024, 3072, 1e-6
    x, a = _norm_quant_inputs(rng, 64, E, dtype)
    h13, _ = _norm_quant_inputs(rng, 64, 2 * Fh, dtype)
    w = torch.from_numpy(1 + 0.1 * rng.randn(E).astype(np.float32)).cuda()
    h, hn, act = tnq.rms_norm_q80(x, w, eps, a, 256)
    y, yact = tnq.swiglu_q80(h13, 256)
    for r in (0, 2, 37, 63):
        h1, hn1, act1 = tnq.rms_norm_q80(x[r:r + 1], w, eps, a[r:r + 1], 256)
        y1, yact1 = tnq.swiglu_q80(h13[r:r + 1], 256)
        torch.cuda.synchronize()
        assert torch.equal(h1[0], h[r]) and torch.equal(hn1[0], hn[r])
        assert torch.equal(act1.xq[0], act.xq[r])
        assert torch.equal(act1.sa[0], act.sa[r])
        assert torch.equal(y1[0], y[r]) and torch.equal(yact1.xq[0], yact.xq[r])
        assert torch.equal(yact1.sa[0], yact.sa[r])


@pytest.mark.cuda
@pytest.mark.parametrize("E,gs", [(64, 32), (48, 16), (768, 256),
                                  (4096, 512), (8192, 256), (50, 0)])
def test_norm_quant_small_wide_and_unaligned_rows(E, gs):
    """Widths below a warp's chunk, several passes (8192) and a width that
    is not a multiple of 4 (scalar loads); rows that start off an aligned
    boundary (views at an odd offset) take scalar loads too: the same
    checks as at the Qwen3-0.6B width."""
    _need_card()
    rng = np.random.RandomState(E + gs)
    eps = 1e-5
    for dtype in (torch.float32, torch.bfloat16):
        buf = torch.from_numpy(rng.randn(5 * E + 1).astype(np.float32)).to(
            "cuda", dtype)
        w = torch.from_numpy(1 + 0.1 * rng.randn(E).astype(np.float32)).cuda()
        for x, a in ((buf[:4 * E].view(4, E), buf[E:5 * E].view(4, E)),
                     (buf[1:4 * E + 1].view(4, E), buf[E + 1:].view(4, E))):
            h, hn, act = tnq.rms_norm_q80(x, w, eps, a, gs)
            want_h = x + a
            torch.cuda.synchronize()
            assert torch.equal(h, want_h)
            _check_hn(hn, want_h, w, eps)
            if gs:
                pq, ps = tqm.act_quant_q80_plain(hn, gs)
                assert torch.equal(act.xq, pq) and torch.equal(act.sa, ps)
            if E % 2 == 0:
                y, yact = tnq.swiglu_q80(x, gs if gs and (E // 2) % gs == 0
                                         else 0)
                want = (torch.nn.functional.silu(x[:, :E // 2])
                        * x[:, E // 2:])
                torch.cuda.synchronize()
                assert torch.equal(y, want)
                if yact is not None:
                    pq, ps = tqm.act_quant_q80_plain(y, yact.group_size)
                    assert torch.equal(yact.xq, pq) and torch.equal(yact.sa, ps)


@pytest.mark.cuda
def test_norm_quant_refuses_bad_shapes_and_counts_launches():
    _need_card()
    x = torch.randn(3, 1024, device="cuda")
    w = torch.ones(1024, device="cuda")
    n0 = (tnq.rms_norm_q80.launches, tnq.swiglu_q80.launches)
    tnq.rms_norm_q80(x, w, 1e-6, None, 256)
    tnq.swiglu_q80(x, 512)
    assert (tnq.rms_norm_q80.launches, tnq.swiglu_q80.launches) == (
        n0[0] + 1, n0[1] + 1)
    for bad in (lambda: tnq.rms_norm_q80(x, w, 1e-6, None, 384),
                lambda: tnq.rms_norm_q80(x, w[:512], 1e-6),
                lambda: tnq.rms_norm_q80(x.half(), w, 1e-6),
                lambda: tnq.rms_norm_q80(x, w, 1e-6, x[:, :512]),
                lambda: tnq.swiglu_q80(x[:, :1023]),
                lambda: tnq.swiglu_q80(x, 1024)):
        with pytest.raises(ValueError):
            bad()
    assert (tnq.rms_norm_q80.launches, tnq.swiglu_q80.launches) == (
        n0[0] + 1, n0[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E", [64, 320, 1024, 3072])
def test_norm_quant_q4k_outputs_are_q4k_act_quant(E, dtype):
    """rms_norm_q4k and swiglu_q4k at B = 1, 3, 64 and 65, with and
    without the residual: h, hn and the SwiGLU output torch.equal to
    rms_norm_q80's / swiglu_q80's; vp, sa, ba and c torch.equal to
    q4k_act_quant (and its plain version) of the kernel's own rounded
    output, with and without that output written; two runs bit-equal; a
    row the same bits alone as inside 64; an all-zero row all zero; one
    launch each, and the refusals launch nothing."""
    _need_card()
    rng = np.random.RandomState(E)
    eps = 1e-6
    w = torch.from_numpy(1 + 0.1 * rng.randn(E).astype(np.float32)).cuda()

    def same(p, q):
        return all(torch.equal(a, b) for a, b in zip(p.parts(), q.parts()))

    def is_act_quant(act, y):
        k = tq4.act_quant_q4k_packed(y.reshape(-1, y.shape[-1]))
        p = tq4.act_quant_q4k_packed_plain(y.reshape(-1, y.shape[-1]))
        return (all(torch.equal(a, b) for a, b in zip(act.parts(), k))
                and all(torch.equal(a, b) for a, b in zip(act.parts(), p)))

    for B in (1, 3, 64, 65):
        x, a = _norm_quant_inputs(rng, B, E, dtype)
        h13, _ = _norm_quant_inputs(rng, B, 2 * E, dtype)
        if B > 2:
            h13[2] = 0
        for res in (None, a):
            n0 = (tnq.rms_norm_q4k.launches, tnq.rms_norm_q80.launches)
            h, hn, act = tnq.rms_norm_q4k(x, w, eps, res)
            _, none, act2 = tnq.rms_norm_q4k(x, w, eps, res, want_hn=False)
            h8, hn8, _ = tnq.rms_norm_q80(x, w, eps, res)
            torch.cuda.synchronize()
            assert (tnq.rms_norm_q4k.launches - n0[0],
                    tnq.rms_norm_q80.launches - n0[1]) == (2, 1)
            assert torch.equal(hn, hn8) and none is None
            assert h is None if res is None else torch.equal(h, h8)
            assert is_act_quant(act, hn) and same(act2, act)
            assert act.shape == x.shape
            if B > 2:
                assert not act.vp[2].any() and not act.sa[2].any()
            if B == 64:
                for r in (0, 2, 37, 63):
                    one = tnq.rms_norm_q4k(x[r:r + 1], w, eps,
                                           None if res is None else res[r:r + 1])[2]
                    assert all(torch.equal(p[0], q[r])
                               for p, q in zip(one.parts(), act.parts()))
        y, act = tnq.swiglu_q4k(h13)
        none, act2 = tnq.swiglu_q4k(h13, want_hidden=False)
        y8, _ = tnq.swiglu_q80(h13)
        torch.cuda.synchronize()
        assert torch.equal(y, y8) and none is None
        assert is_act_quant(act, y) and same(act2, act)
        if B > 2:
            assert not act.vp[2].any() and not act.sa[2].any()
    n0 = (tnq.rms_norm_q4k.launches, tnq.swiglu_q4k.launches)
    for bad in (lambda: tnq.rms_norm_q4k(x, w[:E // 2], eps),
                lambda: tnq.rms_norm_q4k(x.half(), w, eps),
                lambda: tnq.swiglu_q4k(h13[:, :-1])):
        with pytest.raises(ValueError):
            bad()
    assert (tnq.rms_norm_q4k.launches, tnq.swiglu_q4k.launches) == n0


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,gs", [(1024, 4096, 256), (2048, 1024, 256),
                                    (1024, 6144, 256), (3072, 1024, 256),
                                    (1024, 151936, 256), (768, 264, 256),
                                    (1024, 384, 512)])
def test_w8a8_rows_equal_the_matvec_at_every_batch(K, N, gs):
    """q80_matmul_w8a8 and q80_matvec_fq add a row's group terms in one
    order (csrc/q80_matmul.cu:RangeSum; the plan's cluster is
    w8a8_ranges(G)): every row of a batch of 2, 8, 64 or 65 is torch.equal
    to the same row through the B = 1 kernel, in f32 and bf16."""
    _need_card()
    rng = np.random.RandomState(K + N)
    q, s = _q80(rng, N, K, gs)
    w = tqm.Q80Tensor(q=torch.from_numpy(q).cuda(),
                      scales=torch.from_numpy(s).cuda(), group_size=gs,
                      w8a8=True)
    for B in (2, 3, 5, 8, 9, 16, 40, 64, 65, 320):
        x = torch.from_numpy(rng.randn(B, K).astype(np.float32)).to(
            "cuda", torch.bfloat16)
        for dt in (torch.float32, torch.bfloat16):
            y = tqm.q80_w8a8(*tqm.act_quant_q80(x, gs), w, dt)
            for i in range(B):
                assert torch.equal(y[i], tqm.q80_matvec_fq(x[i:i + 1], w,
                                                           dt)[0]), (B, i)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [32, 128, 256, 1024])
def test_decode_attention_rows_do_not_depend_on_the_batch(T):
    """The split comes from (KV, T) alone: every row of a batch of 8 or 64
    is torch.equal to the same row alone, bf16 and int8 caches."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T)
    KV, rep, D = 8, 2, 128
    for B in (8, 64):
        q = torch.randn(B, KV * rep, D, device="cuda", generator=g).to(
            torch.bfloat16)
        pos = torch.randint(0, T, (B,), dtype=torch.int32, device="cuda",
                            generator=g)
        k = torch.randn(B, T, KV, D, device="cuda", generator=g)
        v = torch.randn(B, T, KV, D, device="cuda", generator=g)
        ks = torch.rand(B, T, KV, device="cuda", generator=g) * 0.02
        vs = torch.rand(B, T, KV, device="cuda", generator=g) * 0.02
        for kc, vc, ksc, vsc in (
                (k.to(torch.bfloat16), v.to(torch.bfloat16), None, None),
                ((k * 40).clamp(-127, 127).to(torch.int8),
                 (v * 40).clamp(-127, 127).to(torch.int8), ks, vs)):
            out = tda.decode_attention(q, kc, vc, ksc, vsc, pos, KV, rep)
            for i in range(B):
                one = tda.decode_attention(
                    q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                    None if ksc is None else ksc[i:i + 1],
                    None if vsc is None else vsc[i:i + 1], pos[i:i + 1], KV,
                    rep)
                assert torch.equal(out[i], one[0]), (B, i)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny_q80.bin", "tiny_q4k.bin"])
def test_observer_summary_rows_inside_the_captured_graph(name, monkeypatch):
    """A summary observer (NANO_TPU_OBSERVE=fallback) keeps the decode
    step a CUDA graph: each step one replay of a graph of its own, the
    stream the unobserved one's, each RESIDUAL row's mean|x| within 1e-4
    of the callback mode's (eager) mean(|data|), the LOGITS rows' top-6
    ids those of the callback mode's logits."""
    _need_card()
    from nano_tpu_torch import observe
    from nano_tpu_torch.infer import engine

    def run(mode):
        events = []
        monkeypatch.setattr(observe, "_FORCE_FALLBACK", mode == "summary")
        ctx = _fixture_ctx(name, penalty=1.0, stop_tokens=(),
                           observation=None if mode == "none"
                           else events.append)
        for _ in range(2):            # the second session replays
            events.clear()
            s = engine.Session(ctx, "abcdefgh", max_new_tokens=12)
            while s.step() is not None:
                pass
        return ctx, events, s.output_ids

    _, _, plain = run("none")
    _, cb, cb_ids = run("callback")
    ctx, sm, sm_ids = run("summary")
    assert cb_ids == plain and sm_ids == plain
    dec = ctx.decoder()
    keys = [k for k in dec.graphs if k[2] == "fallback"]
    assert len(keys) == 1 and dec.graphs[keys[0]].graph is not None
    by_key = lambda evs: sorted((int(e.phase), e.layer) for e in evs)
    assert by_key(sm) == by_key(cb)
    assert len([e for e in sm if e.phase == observe.Phase.SAMPLE]) == 11
    pick = lambda evs, ph: [e for e in evs if e.phase == ph]
    for c, s in zip(pick(cb, observe.Phase.RESIDUAL),
                    pick(sm, observe.Phase.RESIDUAL)):
        want = float(np.abs(c.data.astype(np.float64)).mean())
        assert (c.layer == s.layer and s.summary
                and abs(s.mean_abs - want) <= 1e-4 * want)
    lc, ls = pick(cb, observe.Phase.LOGITS), pick(sm, observe.Phase.LOGITS)
    assert len(lc) == len(ls) == 12
    for c, s in zip(lc, ls):
        np.testing.assert_array_equal(
            s.top_ids, observe.top_candidates(c.data, 6)[0])


@pytest.mark.cuda
def test_one_decoder_across_gateway_requests(tmp_path):
    """NativeGGUFGateway on the card: one context and one SingleDecoder
    across requests with three samplers, a captured graph each, replayed
    by a later request with a sampler seen before; the pieces the
    context's Session stream."""
    _need_card()
    import asyncio
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.io import gguf
    from nano_tpu_torch.ops import sampling
    from nano_tpu_torch.serve import gateway
    from nano_tpu_torch.tokenizer.bpe import BpeTokenizer
    cfg = ModelConfig(block_size=64, vocab_size=256, n_layer=2, n_embd=64,
                      n_head=2, n_kv_head=1, n_hidden=96, head_dim=32,
                      use_qk_norm=True, rope_style="half", rope_theta=1e6,
                      norm_eps=1e-6, tie_embeddings=True)
    g = torch.Generator().manual_seed(0)
    w = lambda *s: torch.randn(*s, generator=g) * 0.05
    L, E, F, V, D = 2, 64, 96, 256, 32
    params = {"tok_embeddings": w(V, E), "norm": w(E) + 1, "blocks": {
        "attn_norm": w(L, E) + 1, "ffn_norm": w(L, E) + 1,
        "wq": w(L, E, 2 * D), "wk": w(L, E, D), "wv": w(L, E, D),
        "wo": w(L, 2 * D, E), "w1": w(L, E, F), "w2": w(L, F, E),
        "w3": w(L, E, F), "q_norm": w(L, D) + 1, "k_norm": w(L, D) + 1}}
    path = str(tmp_path / "m.gguf")
    gguf.write_gguf(path, params, cfg, BpeTokenizer(
        [bytes([i]) for i in range(256)], [0.0] * 256), quant="q8_0")
    gw = gateway.NativeGGUFGateway(path, n_ctx=64)
    assert gw.ctx.device.type == "cuda"

    class Conn:
        def __init__(self, msg):
            self.inbox = [msg]
            self.frames = []

        async def recv(self):
            if self.inbox:
                return self.inbox.pop()
            while not (self.frames and "done" in self.frames[-1]):
                await asyncio.sleep(0.01)
            raise ConnectionError("closed")

        async def send(self, m):
            self.frames.append(m)

    decoders = set()
    for rp in (1.0, 1.2, 1.5, 1.0):
        conn = Conn(json.dumps({"prompt": "hello", "template": False,
                                "max_new_tokens": 16, "temperature": 0.0,
                                "repetition_penalty": rp}))
        asyncio.run(gw.handle(conn))
        text = "".join(json.loads(f).get("text", "") for f in conn.frames)
        decoders.add(id(gw.ctx._decoder))
        gw.ctx.sampler = sampling.SamplerConfig(temperature=0.0, top_p=0.8,
                                                repetition_penalty=rp)
        s = engine.generate_sync(gw.ctx, "hello", max_new_tokens=16)
        sdec = gw.ctx.stream_decoder()
        assert text == "".join(sdec.feed(t) for t in s.output_ids) + \
            sdec.flush()
    graphs = gw.ctx._decoder.graphs
    assert len(decoders) == 1 and len(graphs) == 3
    assert all(gr.graph is not None for gr in graphs.values())
