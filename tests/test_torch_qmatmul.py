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
                                      (3, 1024, 128, 512)])
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


@pytest.mark.parametrize("B,K,N,gs", [(1, 128, 256, 32), (8, 256, 128, 64)])
def test_rows_plain_matches_pallas_interpret(B, K, N, gs):
    rng = np.random.RandomState(7 + B + K)
    q, s = _q80(rng, N, K, gs)
    x = rng.randn(B, K).astype(np.float32)
    want = np.asarray(jqm._q80_matmul_2d(jnp.asarray(x), jnp.asarray(q),
                                         jnp.asarray(s), gs, interpret=True))
    tw = tqm.Q80Tensor(q=torch.from_numpy(q), scales=torch.from_numpy(s),
                       group_size=gs)
    got = tqm.q80_matmul(torch.from_numpy(x), tw, torch.float32).numpy()
    # same f32 dequant, f32 dot; summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_launch_nothing():
    rng = np.random.RandomState(3)
    q, s = _q80(rng, 64, 256, 256)
    x = torch.from_numpy(rng.randn(2, 256).astype(np.float32))
    before = (tqm.act_quant_q80.launches, tqm.q80_w8a8.launches,
              tqm.q80_matmul_rows.launches)
    for w8a8 in (False, True):
        tw = tqm.Q80Tensor(q=torch.from_numpy(q), scales=torch.from_numpy(s),
                           group_size=256, w8a8=w8a8)
        tqm.q80_matmul(x, tw, torch.bfloat16)
    assert (tqm.act_quant_q80.launches, tqm.q80_w8a8.launches,
            tqm.q80_matmul_rows.launches) == before


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
