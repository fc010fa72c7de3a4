"""nano_tpu_torch.ops.decode_attn against the Pallas kernel of
nano_tpu.ops.decode_attn run in interpret mode on the CPU, for bf16 and
int8 caches.  The parametrisation is tests/test_decode_attn.py's."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from nano_tpu.ops import decode_attn as jda
from nano_tpu_torch.ops import decode_attn as tda


def _inputs(quant, B, T, n_kv, rep, D, seed):
    rng = np.random.RandomState(seed)
    H = n_kv * rep
    q = rng.randn(B, H, D).astype(np.float32)
    if quant:
        kc = rng.randint(-127, 128, (B, T, n_kv, D)).astype(np.int8)
        vc = rng.randint(-127, 128, (B, T, n_kv, D)).astype(np.int8)
        ks = rng.rand(B, T, n_kv).astype(np.float32) * 0.02
        vs = rng.rand(B, T, n_kv).astype(np.float32) * 0.02
    else:
        # bf16 cache values: draw f32 and round once, shared by both sides
        kc = np.asarray(jnp.asarray(rng.randn(B, T, n_kv, D), jnp.bfloat16))
        vc = np.asarray(jnp.asarray(rng.randn(B, T, n_kv, D), jnp.bfloat16))
        ks = vs = None
    pos = rng.randint(0, T, (B,)).astype(np.int32)
    return q, kc, vc, ks, vs, pos


def _torch_cache(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("B,T,n_kv,rep,D", [
    (1, 128, 2, 2, 128),     # GQA single stream
    (3, 256, 2, 1, 128),     # MHA batched, per-slot positions
    (2, 128, 1, 4, 256),     # wide rep, D=256
])
def test_plain_matches_pallas_interpret(quant, B, T, n_kv, rep, D):
    q, kc, vc, ks, vs, pos = _inputs(quant, B, T, n_kv, rep, D,
                                     B * 1000 + T + n_kv + rep + D + quant)
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs),
        jnp.asarray(pos), n_kv, rep, interpret=True))
    launches = tda.decode_attention.launches
    got = tda.decode_attention(
        torch.from_numpy(q), _torch_cache(kc), _torch_cache(vc),
        None if ks is None else torch.from_numpy(ks),
        None if vs is None else torch.from_numpy(vs),
        torch.from_numpy(pos), n_kv, rep).numpy()
    assert tda.decode_attention.launches == launches    # CPU: plain version
    # f32 scores and softmax on both sides; sum order differs
    # (tolerance of tests/test_decode_attn.py)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_shared_position_broadcasts():
    q, kc, vc, _, _, _ = _inputs(False, 3, 64, 2, 2, 64, 5)
    args = (torch.from_numpy(q), _torch_cache(kc), _torch_cache(vc),
            None, None)
    one = tda.decode_attention(*args, torch.tensor([17], dtype=torch.int32),
                               2, 2)
    each = tda.decode_attention(*args, torch.full((3,), 17, dtype=torch.int32),
                                2, 2)
    torch.testing.assert_close(one, each, rtol=0, atol=0)
