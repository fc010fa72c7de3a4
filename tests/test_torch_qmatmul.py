"""nano_tpu_torch.ops.qmatmul against nano_tpu.ops.qmatmul on the CPU.

The same numpy inputs go through the JAX functions and the port's plain
PyTorch versions (what the wrappers run for CPU tensors).  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nano_tpu.ops import qmatmul as jqm
from nano_tpu_torch.ops import int8_mma
from nano_tpu_torch.ops import q4k as tq4
from nano_tpu_torch.ops import qmatmul as tqm


def _q80(rng, out, inn, gs):
    q = rng.randint(-127, 128, (out, inn)).astype(np.int8)
    s = (rng.rand(out, inn // gs).astype(np.float32) * 0.02 + 1e-3)
    return q, s


def test_act_quant_bit_equal_with_ties_and_zero_group():
    gs = 32
    rng = np.random.RandomState(0)
    ties = np.zeros(gs, np.float32)
    # absmax 127 -> scale exactly 1, so x / scale hits the .5 ties and
    # the f32 edge 0.49999997 (floor(|v| + 0.5) rounds it UP; roundf not)
    ties[:9] = [127.0, 0.5, -0.5, 1.5, -2.5, 126.5, -126.5,
                np.float32(0.49999997), -np.float32(0.49999997)]
    x = np.stack([
        np.concatenate([ties, np.zeros(gs, np.float32)]),      # zero group
        (rng.randn(2 * gs) * 3).astype(np.float32),
        (rng.randn(2 * gs) * 1e-3).astype(np.float32),
    ])
    jq, js = jqm.act_quant_q80(jnp.asarray(x), gs)
    tq, ts = tqm.act_quant_q80(torch.from_numpy(x), gs)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))   # bitwise
    assert ts[0, 1] == 0 and (tq[0, 1] == 0).all()
    assert tq[0, 0, 1] == 1 and tq[0, 0, 4] == -3 and tq[0, 0, 7] == 1


@pytest.mark.parametrize("B,K,N,gs", [(1, 512, 384, 256), (5, 1024, 256, 256),
                                      (3, 1024, 128, 512), (9, 1024, 256, 256),
                                      (65, 512, 128, 256), (65, 1024, 96, 512)])
def test_w8a8_plain_matches_jax_int8(B, K, N, gs):
    rng = np.random.RandomState(B + K + N + gs)
    q, s = _q80(rng, N, K, gs)
    x = rng.randn(B, K).astype(np.float32)
    jw = jqm.Q80Tensor(q=jnp.asarray(q), scales=jnp.asarray(s),
                       group_size=gs).to_grouped()
    want = np.asarray(jqm.q80_matmul_int8(jnp.asarray(x), jw, jnp.float32))
    tw = tqm.Q80Tensor(q=torch.from_numpy(q), scales=torch.from_numpy(s),
                       group_size=gs, w8a8=True)
    got = tqm.q80_matmul_int8(torch.from_numpy(x), tw, torch.float32).numpy()
    jq, js = jqm.act_quant_q80(jnp.asarray(x), gs)
    tq, ts = tqm.act_quant_q80(torch.from_numpy(x), gs)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # integer decisions exact (same int8 activations, exact int32 group
    # dots); only the f32 combine order differs -> 1e-5 relative
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # and through the model-facing dispatcher, with a leading batch dim
    got2 = tqm.q80_matmul(torch.from_numpy(x)[None], tw, torch.float32)
    np.testing.assert_array_equal(got2[0].numpy(), got)


@pytest.mark.parametrize("B,K,N,gs", [(1, 128, 256, 32), (8, 256, 128, 64),
                                      (1, 128, 256, 16), (64, 256, 384, 32),
                                      (64, 80, 200, 16), (9, 128, 72, 32)])
def test_rows_plain_matches_pallas_interpret(B, K, N, gs):
    """The rows form against the Pallas kernel in interpret mode, at group
    sizes 16 (GGUF Q6_K) to 64, one row to a 64-token prompt, and a ragged
    N (the Pallas kernel takes 128-row tiles: it gets the weight padded with
    zero rows, and its first N rows are compared)."""
    rng = np.random.RandomState(7 + B + K)
    q, s = _q80(rng, N, K, gs)
    x = rng.randn(B, K).astype(np.float32)
    Np = -(-N // 128) * 128
    qp = np.concatenate([q, np.zeros((Np - N, K), np.int8)])
    sp = np.concatenate([s, np.zeros((Np - N, K // gs), np.float32)])
    want = np.asarray(jqm._q80_matmul_2d(jnp.asarray(x), jnp.asarray(qp),
                                         jnp.asarray(sp), gs,
                                         interpret=True))[:, :N]
    tw = tqm.Q80Tensor(q=torch.from_numpy(q), scales=torch.from_numpy(s),
                       group_size=gs)
    got = tqm.q80_matmul(torch.from_numpy(x), tw, torch.float32).numpy()
    # same f32 dequant, f32 dot; summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _matvec_row(rng, K, gs, bf16):
    """One activation row: group 0 holds the .5 ties and the f32 edge of
    test_act_quant_bit_equal_with_ties_and_zero_group (absmax 127, so the
    scale is exactly 1), group 1 is all zero, the rest random; bf16=True
    rounds it to bf16-representable f32."""
    x = (rng.randn(1, K) * 2).astype(np.float32)
    x[0, :gs] = 0.0
    x[0, :9] = [127.0, 0.5, -0.5, 1.5, -2.5, 126.5, -126.5,
                np.float32(0.49999997), -np.float32(0.49999997)]
    x[0, gs:2 * gs] = 0.0
    if bf16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("K,N,gs", [(1024, 4096, 256), (2048, 1024, 256),
                                    (3072, 1024, 256), (1024, 384, 512)])
def test_matvec_fq_matches_jax_int8(K, N, gs, bf16):
    """q80_matvec_fq (its plain version on the CPU) against the JAX
    package's act_quant_q80 + q80_matmul_int8 at the Qwen3-0.6B decode
    shapes and gs 512, with .5 ties and an all-zero group."""
    rng = np.random.RandomState(K + N + gs + bf16)
    q, s = _q80(rng, N, K, gs)
    x = _matvec_row(rng, K, gs, bf16)
    jw = jqm.Q80Tensor(q=jnp.asarray(q), scales=jnp.asarray(s),
                       group_size=gs).to_grouped()
    want = np.asarray(jqm.q80_matmul_int8(jnp.asarray(x), jw, jnp.float32))
    jq, js = jqm.act_quant_q80(jnp.asarray(x), gs)
    tw = tqm.Q80Tensor(q=torch.from_numpy(q), scales=torch.from_numpy(s),
                       group_size=gs, w8a8=True)
    xt = torch.from_numpy(x)
    got, tq, ts = tqm.q80_matvec_fq(xt, tw, torch.float32, with_act=True)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))   # bitwise
    assert ts[0, 1] == 0 and (tq[0, 1] == 0).all()
    assert tq[0, 0, 1] == 1 and tq[0, 0, 4] == -3 and tq[0, 0, 7] == 1
    # the same integer decisions; only the f32 combine order differs
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # the dispatcher takes it for one row, with any leading dims
    via = tqm.q80_matmul(xt[None], tw, torch.float32)
    np.testing.assert_array_equal(via[0].numpy(), got.numpy())
    if bf16:   # a bf16 row gives the same as its f32 copy
        got16 = tqm.q80_matvec_fq(xt.to(torch.bfloat16), tw, torch.float32)
        np.testing.assert_array_equal(got16.numpy(), got.numpy())


@pytest.mark.parametrize("N,K,gs", [(4096, 1024, 256), (1024, 2048, 256),
                                    (6144, 1024, 256), (1024, 3072, 256),
                                    (151936, 1024, 256), (264, 256, 256),
                                    (384, 1024, 512), (3, 256, 256),
                                    (1024, 16384, 256)])
def test_matvec_plan_covers_the_rows_and_fits(N, K, gs):
    """The kernel's work split from shapes alone: every row in exactly one
    block, no block without rows, up to two blocks an SM, both blocks'
    shared memory on an SM, a stage's weight bytes within its budget, the
    head streaming through a ring of 32-row stages, and the layer products
    in tiles of 8 rows, all in flight at once."""
    G = K // gs
    blocks, R, S, T = tqm.matvec_plan(N, K, gs)
    edges = [N * b // blocks for b in range(blocks + 1)]
    assert edges[0] == 0 and edges[-1] == N
    assert all(b > a for a, b in zip(edges, edges[1:]))
    sms = tqm._build.H100_SMS
    assert 1 <= blocks <= 2 * sms and T in (8, 16, 32)
    if N >= 2 * sms * 4:      # every SM gets work
        assert blocks == 2 * sms
    assert 1 <= S <= tqm.MATVEC_MAX_STAGES and 1 <= R <= 256 // T
    assert R * K <= max(tqm.MATVEC_STAGE_BYTES, K)
    assert 2 * tqm.matvec_smem(K, G, R, S) <= 227 * 1024
    if N == 151936:
        assert (R, S, T) == (32, 3, 8)
    elif K <= 3072 and N <= 6144:      # every tile of a block in flight at once
        per_block = -(-N // blocks)
        assert T == (16 if gs == 256 and K <= 1024 else 32)
        assert R == min(256 // T, per_block) and R * S >= per_block


# the rows form's products (N, K): a Qwen3-0.6B GGUF file's, fused as
# from_gguf serves it (wqkv, wo, w13, w2, the tied head), and the tiny
# fixtures' (tests/js/fixtures/tiny_q80.bin: width 64, 2 layers; K = 80 at
# gs 16, a scale range off 16-byte boundaries)
ROWS_SHAPES = [(4096, 1024), (1024, 2048), (6144, 1024), (1024, 3072),
               (151936, 1024), (128, 64), (64, 64), (256, 64), (64, 128),
               (40, 80)]


@pytest.mark.parametrize("N,K,gs", [(N, K, gs) for N, K in ROWS_SHAPES
                                    for gs in (16, 32) if K % gs == 0])
def test_matvec_rows_plan_covers_the_rows_and_fits(N, K, gs):
    """q80_matvec_rows's split from shapes alone: every row in exactly one
    block, no block without rows, up to two blocks an SM and both blocks'
    shared memory on an SM (of the H100's 227 KB) for an f32 row, a stage's
    weight bytes within its budget, 8 lanes a row where a block streams
    many tiles (the head), a warp a row elsewhere."""
    G = K // gs
    blocks, R, S, T = tqm.matvec_rows_plan(N, K, gs)
    edges = [N * b // blocks for b in range(blocks + 1)]
    assert edges[0] == 0 and edges[-1] == N
    assert all(b > a for a, b in zip(edges, edges[1:]))
    sms = tqm._build.H100_SMS
    assert 1 <= blocks <= 2 * sms and T in (8, 32)
    if N >= 2 * sms * 4:
        assert blocks == 2 * sms
    per_block = -(-N // blocks)
    assert T == (8 if per_block >= 64 else 32)
    assert 1 <= S <= tqm.MATVEC_MAX_STAGES and 1 <= R <= 256 // T
    assert R * K <= max(tqm.MATVEC_STAGE_BYTES, K) and S <= -(-per_block // R)
    assert 2 * tqm.matvec_rows_smem(K, G, R, S) <= 227 * 1024
    assert tqm.matvec_rows_fits(N, K, gs)
    if N == 151936:
        assert (R, S, T) == (32, 2, 8)


@pytest.mark.parametrize("B", [1, 2, 8, 9, 64, 65, 320])
@pytest.mark.parametrize("N,K", ROWS_SHAPES)
def test_rows_plan_covers_every_output_once_and_fits(N, K, B):
    """q80_matmul_rows's split from shapes alone: every (weight row,
    activation row, chunk of K) in exactly one block; up to 64 rows one
    tile (32 for a weight that stays in L2), so that each weight byte
    leaves device memory once; the chunks split over a cluster of at most 8
    blocks (a power of two, no rank without chunks) until the grid has 1.5
    blocks for every SM (4 for tiles of up to 16 rows) or the split is at
    its cap; 3 stages, or as many as a rank has chunks; two blocks' shared
    memory on an SM for f32 rows (bf16 rows take less)."""
    MB, BN, CS, S = tqm.rows_plan(B, N, K)
    pieces = -(-K // tqm.ROWS_KC)
    blocks = _tile_blocks(B, N, pieces, (MB, BN, CS, S))
    count = np.zeros((N, B, pieces), np.int8) if N * B * pieces <= 2e7 else None
    for rows, slots, chunks in blocks:
        assert len(rows) > 0 and len(slots) > 0 and len(chunks) > 0
        if count is not None:
            count[rows.start:rows.stop, slots.start:slots.stop,
                  chunks.start:chunks.stop] += 1
    if count is not None:
        assert (count == 1).all()
    else:   # too many cells to count: each tile's chunks, then the tiles
        by_tile = {}
        for rows, slots, chunks in blocks:
            by_tile.setdefault((rows.start, rows.stop, slots.start,
                                slots.stop), []).append(chunks)
        for chunk_list in by_tile.values():
            got = sorted((c.start, c.stop) for c in chunk_list)
            assert got[0][0] == 0 and got[-1][1] == pieces
            assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
        area = sum((r1 - r0) * (s1 - s0) for r0, r1, s0, s1 in by_tile)
        assert area == N * B and len(by_tile) == -(-N // MB) * -(-B // BN)
    in_l2 = N * K <= int8_mma.L2_WEIGHT
    assert MB in (64, 128) and BN in (8, 16, 32, 64)
    assert BN >= min(B, 32 if in_l2 else 64)
    assert BN == 8 or BN // 2 < min(B, 64)
    if B <= (32 if in_l2 else 64):
        assert BN >= B      # one tile: each weight byte read once
    assert CS in (1, 2, 4, 8) and CS <= pieces
    sms = tqm._build.H100_SMS
    want = 4 * sms if BN <= 16 else 1.5 * sms
    assert len(blocks) >= want or 2 * CS > min(8, pieces)
    assert len(blocks) < 2 * want or CS == 1
    per_rank = -(-pieces // CS)
    assert S == min(3, per_rank)      # a chunk in flight past the next one
    assert 2 * tqm.rows_smem(MB, BN, CS, S, 4) <= 227 * 1024
    assert tqm.rows_smem(MB, BN, CS, S, 2) <= tqm.rows_smem(MB, BN, CS, S, 4)


# the five Qwen3-0.6B products: (N, K)
QWEN3_PRODUCTS = {"wqkv": (4096, 1024), "wo": (1024, 2048),
                  "w13": (6144, 1024), "w2": (1024, 3072),
                  "head": (151936, 1024)}


@pytest.mark.parametrize("B", [1, 2, 7, 8, 9, 63, 64, 65, 200])
@pytest.mark.parametrize("product", sorted(QWEN3_PRODUCTS))
def test_w8a8_plan_covers_every_output_once_and_fits(product, B):
    """The B > 1 kernel's work split from shapes alone: every (weight row,
    slot, group) in exactly one block; up to 64 slots one slot tile (32
    for a weight that stays in L2), so that each weight byte leaves device
    memory once; the groups split over a cluster of at most 8 blocks (a
    power of two, no rank without groups) until the grid has 1.5 blocks
    for every SM, or the split is at its cap; at most 4 stages, two blocks' shared
    memory on an SM (of the H100's 227 KB), no more stages than a block
    has chunks."""
    N, K = QWEN3_PRODUCTS[product]
    _w8a8_plan_checks(B, N, K, 256)


@pytest.mark.parametrize("B,N,K,gs", [(9, 4096, 1024, 512), (64, 1024, 3072, 512),
                                      (65, 384, 1536, 512), (3, 7, 768, 256),
                                      (8, 264, 256, 256), (300, 1000, 2048, 1024)])
def test_w8a8_plan_other_shapes(B, N, K, gs):
    _w8a8_plan_checks(B, N, K, gs)


@pytest.mark.parametrize("B", [2, 8, 9, 64, 65, 200])
@pytest.mark.parametrize("N,n_pad", [(4096, 1024), (1024, 2048), (6144, 1024),
                                     (1024, 3072), (64, 256), (7, 768)])
def test_w4a4_plan_covers_every_output_once_and_fits(N, n_pad, B):
    """q4k_matmul_w4a4's split (the same rule, int8_mma.plan, over chunks
    of 256 values of K, a stage each): the checks above."""
    _plan_checks(B, N, n_pad // 256, 1, N * n_pad * 3 // 4,
                 tq4.w4a4_plan(B, N, n_pad), tq4.w4a4_smem)


def _tile_blocks(B, N, pieces, plan):
    """Every block of a launch as the int8 tensor-core kernels split the
    work (csrc/int8_mma.cuh): [(rows, slots, pieces of K)] in grid order,
    ranges clipped to the tensors (the kernels read past them as zeros)."""
    MB, BN, CS, _ = plan
    out = []
    for by in range(-(-B // BN)):
        for bx in range(-(-N // MB) * CS):
            n0, r = bx // CS * MB, bx % CS
            out.append((range(n0, min(n0 + MB, N)),
                        range(by * BN, min(by * BN + BN, B)),
                        range(pieces * r // CS, pieces * (r + 1) // CS)))
    return out


def _w8a8_plan_checks(B, N, K, gs):
    _plan_checks(B, N, K // gs, gs // tqm.W8A8_KC, N * K,
                 tqm.w8a8_plan(B, N, K, gs), tqm.w8a8_smem,
                 cluster_fixed=True)
    # a cluster of w8a8_ranges blocks at every B, the plan's own choice at
    # RANGES_AT slots: each block one range of the kernels' order of
    # summation (csrc/q80_matmul.cu:RangeSum)
    R = tqm.w8a8_ranges(N, K, gs)
    assert tqm.w8a8_plan(B, N, K, gs)[2] == R
    assert R == int8_mma.plan(tqm.RANGES_AT, N, N * K, K // gs,
                              gs // tqm.W8A8_KC, tqm._w8a8_stage)[2]


def _plan_checks(B, N, G, piece_chunks, weight_bytes, plan, smem,
                 cluster_fixed=False):
    MB, BN, CS, S = plan
    blocks = _tile_blocks(B, N, G, plan)
    count = np.zeros((N, B, G), np.int8) if N * B * G <= 2e7 else None
    for rows, slots, groups in blocks:
        assert len(groups) > 0 and len(slots) > 0 and len(rows) > 0
        if count is not None:
            count[rows.start:rows.stop, slots.start:slots.stop,
                  groups.start:groups.stop] += 1
    if count is not None:
        assert (count == 1).all()
    else:   # the head: rows x groups once for each slot tile, tiles disjoint
        by_tile = {}
        for rows, slots, groups in blocks:
            by_tile.setdefault((slots.start, slots.stop), []).append(
                (rows.start, rows.stop, groups.start, groups.stop))
        assert sorted(by_tile) == [(b, min(b + BN, B)) for b in range(0, B, BN)]
        for cells in by_tile.values():
            assert sum((r1 - r0) * (g1 - g0) for r0, r1, g0, g1 in cells) == N * G
            assert len(set(cells)) == len(cells)
    in_l2 = weight_bytes <= int8_mma.L2_WEIGHT
    assert MB in (64, 128) and BN in (8, 16, 32, 64)
    assert BN >= min(B, 32 if in_l2 else 64)
    assert BN == 8 or BN // 2 < min(B, 64)
    assert CS in (1, 2, 4, 8) and CS <= G
    n_blocks = len(blocks)
    assert n_blocks == -(-N // MB) * CS * -(-B // BN)
    if B <= (32 if in_l2 else 64):
        assert -(-B // BN) == 1   # one slot tile: each weight byte read once
    # 1.5 blocks for every SM, or the split can grow no further (where the
    # product fixes its cluster, q80_matmul_w8a8's, the rule that fixed it)
    if not cluster_fixed:
        assert 2 * n_blocks >= 3 * tqm._build.H100_SMS or 2 * CS > min(8, G)
    chunks = -(-G // CS) * piece_chunks
    most = int8_mma.MAX_STAGES if n_blocks < 4 * tqm._build.H100_SMS else 2
    assert 1 <= S <= min(most, chunks)
    assert 2 * smem(MB, BN, CS, S) <= 227 * 1024
    if S < min(most, chunks):   # cut by the budget only
        assert smem(MB, BN, CS, S + 1) > int8_mma.SMEM


def test_cpu_wrappers_launch_nothing():
    rng = np.random.RandomState(3)
    q, s = _q80(rng, 64, 256, 256)
    x = torch.from_numpy(rng.randn(2, 256).astype(np.float32))
    counters = (tqm.act_quant_q80, tqm.q80_w8a8, tqm.q80_matmul_rows,
                tqm.q80_matvec_fq, tqm.q80_matvec_rows,
                tqm.q80_matmul_rows_warp)
    before = tuple(c.launches for c in counters)
    for w8a8 in (False, True):
        tw = tqm.Q80Tensor(q=torch.from_numpy(q), scales=torch.from_numpy(s),
                           group_size=256, w8a8=w8a8)
        tqm.q80_matmul(x, tw, torch.bfloat16)
        tqm.q80_matmul(x[:1], tw, torch.bfloat16)     # one row: B = 1 path
    tqm.q80_matvec_fq(x[:1], tw, torch.float32, with_act=True)
    tw = tqm.Q80Tensor(q=torch.from_numpy(q), scales=torch.from_numpy(
        s.repeat(8, axis=1) / 8), group_size=32)
    want = tqm.q80_matmul_rows_plain(x, tw, torch.float32)
    assert torch.equal(tqm.q80_matvec_rows(x[:1], tw, torch.float32),
                       tqm.q80_matmul_rows_plain(x[:1], tw, torch.float32))
    for fn in (tqm.q80_matmul_rows, tqm.q80_matmul_rows_warp, tqm.q80_rows):
        assert torch.equal(fn(x, tw, torch.float32), want)
    assert tuple(c.launches for c in counters) == before


def test_dequant_reference_matches_jax():
    rng = np.random.RandomState(11)
    q, s = _q80(rng, 96, 128, 32)
    x = rng.randn(3, 128).astype(np.float32)
    jw = jqm.Q80Tensor(q=jnp.asarray(q), scales=jnp.asarray(s), group_size=32)
    tw = tqm.Q80Tensor(q=torch.from_numpy(q), scales=torch.from_numpy(s),
                       group_size=32)
    np.testing.assert_array_equal(tw.dequantize().numpy(),
                                  np.asarray(jw.dequantize()))
    want = np.asarray(jqm.q80_matmul_ref(jnp.asarray(x), jw, jnp.float32))
    got = tqm.q80_matmul_ref(torch.from_numpy(x), tw, torch.float32).numpy()
    # f32 dot of the same dequantized table; sum order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
