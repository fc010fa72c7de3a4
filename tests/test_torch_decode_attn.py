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


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("edge", ["first", "last"])
@pytest.mark.parametrize("rep,D", [(1, 128), (4, 64), (4, 128)])
def test_plain_matches_pallas_interpret_bf16_q_and_edge_positions(
        rep, D, edge, quant):
    """What the card's kernel special-cases: q in bf16 (read in its own
    type), one and four query heads per KV head, and the first and the
    last cache row as the position.  Both sides get the same bf16-rounded
    q and widen it to f32; f32 scores and softmax, sum order differs:
    2e-5, as above."""
    B, T, n_kv = 2, 128, 2
    q, kc, vc, ks, vs, _ = _inputs(quant, B, T, n_kv, rep, D,
                                   rep * 100 + D + quant)
    q16 = np.asarray(jnp.asarray(q, jnp.bfloat16))
    pos = np.full((B,), 0 if edge == "first" else T - 1, np.int32)
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q16), jnp.asarray(kc), jnp.asarray(vc),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs),
        jnp.asarray(pos), n_kv, rep, interpret=True))
    got = tda.decode_attention(
        _torch_cache(q16), _torch_cache(kc), _torch_cache(vc),
        None if ks is None else torch.from_numpy(ks),
        None if vs is None else torch.from_numpy(vs),
        torch.from_numpy(pos), n_kv, rep)
    assert got.dtype == torch.float32 and got.shape == (B, n_kv * rep * D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_sm", [132, 108])
@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("n_kv,T", [(8, 512), (8, 1024), (2, 64), (1, 4096),
                                    (8, 32768), (4, 100)])
def test_split_choice_fills_the_card_and_covers_every_row_once(B, n_kv, T,
                                                               n_sm):
    """`choose_splits` is pure Python on shapes (it is never handed `pos`)
    and never sees the batch, so that a row's partials and their merge are
    the same at every B: the chunks tile [0, T) exactly once in order, at
    most MAX_SPLITS of them; one row's grid KV * n_split stays within two
    blocks per SM unless KV alone exceeds that (then one block per head),
    and reaches one block per SM wherever T has MIN_CHUNK rows for each
    split; B rows take it in blocks of splits_per_block splits."""
    chunk, n_split = tda.choose_splits(n_kv, T, n_sm)
    assert 1 <= n_split <= tda.MAX_SPLITS
    assert n_split == -(-T // chunk)
    # every row t in [0, T) (so every t <= pos) lies in exactly one split
    covered = np.zeros(T, np.int64)
    for s in range(n_split):
        covered[s * chunk:min((s + 1) * chunk, T)] += 1
    assert (covered == 1).all()
    row_blocks = n_kv * n_split
    if n_kv >= 2 * n_sm:
        assert n_split == 1
    else:
        assert row_blocks <= 2 * n_sm
        could = min(tda.MAX_SPLITS, -(-T // tda.MIN_CHUNK))   # splits T allows
        if n_kv * could >= 2 * n_sm:
            assert row_blocks >= n_sm
        elif n_split < could:
            assert n_kv * (n_split + 1) > 2 * n_sm
    # B rows: each block takes per_block splits in turn (each its own
    # partial), so that the grid stays near two blocks per SM; it moves the
    # grid only
    per = tda.splits_per_block(B, n_kv, n_split, n_sm)
    assert 1 <= per <= n_split
    grid = B * n_kv * -(-n_split // per)
    assert grid <= 2 * n_sm or per == n_split
    if per > 1:   # the fewest that do
        assert B * n_kv * -(-n_split // (per - 1)) > 2 * n_sm
    # a position anywhere leaves the splits past it empty and the rest whole
    for p in (0, chunk - 1, chunk, T - 1):
        active = min(n_split, p // chunk + 1)
        assert (active - 1) * chunk <= p < active * chunk or active == n_split


def test_wrapper_never_reads_pos_on_the_host():
    """The call must stay capturable in a CUDA graph: `choose_splits` takes
    shapes only, and the wrapper's source hands `pos` to the kernel by
    pointer without `.item()`, `.tolist()`, `.cpu()` or `int(pos...)`."""
    import inspect
    src = inspect.getsource(tda.decode_attention)
    assert "choose_splits(n_kv, T" in src
    for banned in (".item()", ".tolist()", ".cpu()", "int(pos"):
        assert banned not in src, banned
    params = inspect.signature(tda.choose_splits).parameters
    assert "pos" not in params and "B" not in params
