"""nano_tpu_torch.ops.norm_quant against the JAX package on the CPU, and
the cached forward's use of it.

The fused RMSNorm (with the residual add) and SwiGLU with the Q80
quantization of their output: the same numpy inputs go through the JAX
functions (``gpt.rms_norm``, ``block``'s add, ``jax.nn.silu(h1) * h3``,
``qmatmul.act_quant_q80``) and the port's plain versions (what the
wrappers run for CPU tensors).  The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_kernels_cuda.py
and chip_smoke.py.

Then the dispatch: on a random Qwen3-tiny Q80 model the cached forward asks
the norms and SwiGLU for Q80 outputs exactly where a W8A8 product takes
more than one row (so q80_act_quant runs only on wo's input), never at one
row or on the Q4K model, and its logits are bit-equal to the same forward
through the eager ops it replaced.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import qmatmul as jqm
from nano_tpu_torch.config import ModelConfig
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.ops import norm_quant as tnq
from nano_tpu_torch.ops import q4k as tq4
from nano_tpu_torch.ops import qmatmul as tqm

FIX = os.path.join(os.path.dirname(__file__), "js", "fixtures")

_T = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32,
                                                      jnp.float32)}


def _to_torch(a, tdt):
    """A JAX array -> a torch tensor of the same bits."""
    return torch.from_numpy(np.array(a, np.float32)).to(tdt)


def _ulps(a, b):
    it, mag = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
               else (torch.int32, 0x7FFFFFFF))
    mono = lambda t: (lambda i: torch.where(i < 0, -(i & mag), i))(
        t.contiguous().view(it).long())
    return (mono(a) - mono(b)).abs()


# The f32 factor rsqrt(mean(h^2) + eps) of a row, JAX's against the
# port's, in f32 ulps: the mean of squares summed in another order, and
# XLA's rsqrt and PyTorch's apart by an ulp.  k ulps of the factor are up
# to 2 k ulps of an f32 hn value (its ulp may be half the factor's,
# relatively), and each of the two products' roundings adds up to one; a
# bf16 hn within one bf16 ulp
FACTOR_ULPS = 4
# JAX's silu (x * sigmoid(x), each rounded to the dtype) against PyTorch's
# (x / (1 + exp(-x)) in f32, rounded once), in ulps of the dtype (2 seen in
# bf16, 3 in f32)
SILU_ULPS = 3


def _inputs(seed, B, n, zero_row):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, n) * 2).astype(np.float32)
    a = rng.randn(B, n).astype(np.float32)
    if zero_row and B > 2:
        x[2] = a[2] = 0
    return x, a, (1 + 0.1 * rng.randn(n)).astype(np.float32)


def _check_quant_of(j_out, gs, tdt):
    """The port's act_quant_q80_plain of JAX's output is bit-equal to JAX's
    act_quant_q80 of it."""
    jq, js = jqm.act_quant_q80(j_out.reshape(-1, j_out.shape[-1]), gs)
    tq, ts = tqm.act_quant_q80_plain(_to_torch(j_out, tdt), gs)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    return tq, ts


NORM_CASES = [(E, gs, B, dt, res)
              for E, sizes in ((64, (32,)), (1024, (32, 256, 512)))
              for gs in sizes for B in (1, 8, 65) for dt in ("bf16", "f32")
              for res in (False, True)]


@pytest.mark.parametrize("E,gs,B,dt,res", NORM_CASES)
def test_rms_norm_q80_plain_matches_jax(E, gs, B, dt, res):
    """h bit-equal to JAX's add; hn bit-equal to JAX's rms_norm in the rows
    whose two f32 factors rsqrt(mean(h^2) + eps) agree, within one bf16 ulp
    (2 k + 2 f32 ulps, the factors k apart) where they differ; the port's quantization of JAX's hn bit-equal to JAX's
    act_quant_q80; the plain version's Q80Act the quantization of its own
    hn; an all-zero row scale 0 and values 0."""
    tdt, jdt = _T[dt]
    x, a, w = _inputs(E + gs + B, B, E, zero_row=True)
    jx, ja = jnp.asarray(x).astype(jdt), jnp.asarray(a).astype(jdt)
    jh = jx + ja if res else jx
    jhn = jgpt.rms_norm(jh, jnp.asarray(w), 1e-6)
    tx, ta = _to_torch(jx, tdt), _to_torch(ja, tdt)
    h, hn, act = tnq.rms_norm_q80(tx, torch.from_numpy(w), 1e-6,
                                  ta if res else None, gs)
    if res:
        assert h.dtype == tdt and torch.equal(h, _to_torch(jh, tdt))
    else:
        assert h is None
    want = _to_torch(jhn, tdt)
    # each row's f32 factor rsqrt(mean(h^2) + eps), as each side computes it
    jf = jh.astype(jnp.float32)
    jr = jax.lax.rsqrt(jnp.mean(jf * jf, axis=-1, keepdims=True) + 1e-6)
    tf = _to_torch(jh, tdt).float()
    tr = torch.rsqrt(torch.mean(tf * tf, dim=-1, keepdim=True) + 1e-6)
    ur = _ulps(torch.from_numpy(np.array(jr)), tr)[:, 0].numpy()
    u = _ulps(hn, want).max(dim=-1).values.numpy()
    apart = ur > 0
    assert (u[~apart] == 0).all() and ur.max() <= FACTOR_ULPS
    assert (u[apart] <= (1 if dt == "bf16" else 2 * ur[apart] + 2)).all()
    print(f"hn: {int((~apart).sum())} rows bit-equal where the two f32 "
          f"factors agree; {int(apart.sum())} rows whose factors are up to "
          f"{int(ur.max())} ulp apart, hn there up to {int(u.max())} ulp")
    tq, ts = _check_quant_of(jhn, gs, tdt)
    pq, ps = tqm.act_quant_q80_plain(hn.reshape(B, E), gs)
    assert torch.equal(act.xq, pq) and torch.equal(act.sa, ps)
    assert act.shape == tx.shape and act.group_size == gs
    if B > 2:
        assert (ts[2] == 0).all() and (tq[2] == 0).all()
        assert (act.sa[2] == 0).all() and (act.xq[2] == 0).all()
    _, none, act2 = tnq.rms_norm_q80(tx, torch.from_numpy(w), 1e-6,
                                     ta if res else None, gs, want_hn=False)
    assert none is None and torch.equal(act2.xq, act.xq)
    assert tnq.rms_norm_q80(tx, torch.from_numpy(w), 1e-6)[2] is None


SWIGLU_CASES = [(Fh, gs, B, dt)
                for Fh, sizes in ((64, (32,)), (1024, (32, 256, 512)))
                for gs in sizes for B in (1, 8, 65) for dt in ("bf16", "f32")]


@pytest.mark.parametrize("Fh,gs,B,dt", SWIGLU_CASES)
def test_swiglu_q80_plain_matches_jax(Fh, gs, B, dt):
    """silu(h1) * h3 against JAX's jax.nn.silu(h1) * h3: bit-equal where
    the two silus agree, at most one ulp of the dtype beyond their distance
    where they differ (twice their distance: the product's ulp may be half
    the silu's, relatively; the two silus within SILU_ULPS); the port's
    quantization of JAX's output bit-equal to JAX's act_quant_q80; the
    plain version's Q80Act the quantization of its own output."""
    tdt, jdt = _T[dt]
    x, _, _ = _inputs(Fh + gs + B + 1, B, 2 * Fh, zero_row=True)
    jx = jnp.asarray(x).astype(jdt)
    js = jax.nn.silu(jx[:, :Fh])
    jy = js * jx[:, Fh:]
    h13 = _to_torch(jx, tdt)
    y, act = tnq.swiglu_q80(h13, gs)
    us = _ulps(torch.nn.functional.silu(h13[:, :Fh]), _to_torch(js, tdt))
    u = _ulps(y, _to_torch(jy, tdt))
    assert int(us.max()) <= SILU_ULPS
    assert int(u[us == 0].max()) == 0 and bool((u <= 2 * us + 1).all())
    print(f"swiglu: the two silus agree at {int((us == 0).sum())} of "
          f"{us.numel()} values (output bit-equal there), at most "
          f"{int(us.max())} ulp apart elsewhere; output at most "
          f"{int(u.max())} ulp apart")
    tq, ts = _check_quant_of(jy, gs, tdt)
    pq, ps = tqm.act_quant_q80_plain(y, gs)
    assert torch.equal(act.xq, pq) and torch.equal(act.sa, ps)
    assert act.shape == (B, Fh) and y.dtype == tdt
    if B > 2:
        assert (ts[2] == 0).all() and (act.sa[2] == 0).all()
    none, act2 = tnq.swiglu_q80(_to_torch(jx, tdt), gs, want_hidden=False)
    assert none is None and torch.equal(act2.xq, act.xq)


def test_plan_takes_the_width_alone_and_cpu_wrappers_launch_nothing():
    assert tnq.plan(1024) == (256, 1)
    assert tnq.plan(3072) == (768, 1)
    assert tnq.plan(50) == (32, 1)
    assert tnq.plan(8192) == (1024, 2)
    with pytest.raises(ValueError):
        tnq.plan(16 * 4096 + 1)
    before = (tnq.rms_norm_q80.launches, tnq.swiglu_q80.launches)
    x = torch.randn(3, 256)
    tnq.rms_norm_q80(x, torch.ones(256), 1e-6, x, 256)
    tnq.swiglu_q80(x, 128)
    assert (tnq.rms_norm_q80.launches, tnq.swiglu_q80.launches) == before


# ---------------------------------------------------------------------
# the cached forward's dispatch
# ---------------------------------------------------------------------

# tests/test_torch_slice.py's Qwen3-tiny shape
QWEN3_TINY = dict(block_size=256, vocab_size=512, n_layer=2, n_embd=256,
                  n_head=2, n_kv_head=1, n_hidden=512, head_dim=128,
                  use_qk_norm=True, rope_style="half", rope_theta=1e6,
                  norm_eps=1e-6, tie_embeddings=True)
GS = 256


def _q80_params(cfg, seed=0):
    """The loader's layout of a Q80 group-size-256 model (fused wqkv / w13,
    stacked int8 rows, W8A8 form, the head sharing the embedding table),
    random from a seed."""
    rng = np.random.RandomState(seed)

    def qt(*shape):
        q = rng.randint(-127, 128, shape).astype(np.int8)
        s = (rng.rand(*shape[:-1], shape[-1] // GS).astype(np.float32)
             * 0.02 + 1e-3)
        return tqm.Q80Tensor(q=torch.from_numpy(q), scales=torch.from_numpy(s),
                             group_size=GS, w8a8=True)

    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_hidden, cfg.vocab_size
    HD, KVD, D = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim, \
        cfg.head_dim
    norm = lambda *s: torch.from_numpy(
        (1.0 + 0.1 * rng.randn(*s)).astype(np.float32))
    tok = qt(V, E)
    return {"tok_embeddings": tok, "output_q": tok, "norm": norm(E),
            "blocks": {"attn_norm": norm(L, E), "ffn_norm": norm(L, E),
                       "q_norm": norm(L, D), "k_norm": norm(L, D),
                       "wqkv": qt(L, HD + 2 * KVD, E), "wo": qt(L, E, HD),
                       "w13": qt(L, 2 * F, E), "w2": qt(L, E, F)}}


@pytest.fixture(scope="module")
def qwen_tiny():
    cfg = ModelConfig(**QWEN3_TINY)
    return cfg, _q80_params(cfg)


@pytest.fixture(scope="module")
def tiny_q4k():
    ctx = teng.LLMContext.from_bin(os.path.join(FIX, "tiny_q4k.bin"),
                                   max_seq_len=64, dtype=torch.float32,
                                   device="cpu")
    return ctx.cfg, ctx.params


def _spy(monkeypatch):
    """Count q80_act_quant's calls and record the group size each norm and
    SwiGLU call asks for ("q4k" for a call that asks for Q4K outputs,
    "q4k_fq" for one that asks for the Q4K fake-quant)."""
    seen = {"act_quant": 0, "norm": [], "swiglu": []}
    aq, rms, sw = tqm.act_quant_q80, tgpt.rms_norm_q80, tgpt.swiglu_q80
    rms4, sw4 = tgpt.rms_norm_q4k, tgpt.swiglu_q4k
    rms4fq = tgpt.rms_norm_q4k_fq

    def act_quant(x, gs):
        seen["act_quant"] += 1
        return aq(x, gs)

    def norm(x, w, eps, residual=None, group_size=0, want_hn=True):
        seen["norm"].append(group_size)
        return rms(x, w, eps, residual, group_size, want_hn)

    def swiglu(h13, group_size=0, want_hidden=True):
        seen["swiglu"].append(group_size)
        return sw(h13, group_size, want_hidden)

    def norm4(x, w, eps, residual=None, want_hn=True):
        seen["norm"].append("q4k")
        return rms4(x, w, eps, residual, want_hn)

    def swiglu4(h13, want_hidden=True):
        seen["swiglu"].append("q4k")
        return sw4(h13, want_hidden)

    def norm4fq(x, w, eps, residual=None, want_hn=True):
        seen["norm"].append("q4k_fq")
        return rms4fq(x, w, eps, residual, want_hn)

    monkeypatch.setattr(tqm, "act_quant_q80", act_quant)
    monkeypatch.setattr(tgpt, "rms_norm_q80", norm)
    monkeypatch.setattr(tgpt, "swiglu_q80", swiglu)
    monkeypatch.setattr(tgpt, "rms_norm_q4k", norm4)
    monkeypatch.setattr(tgpt, "swiglu_q4k", swiglu4)
    monkeypatch.setattr(tgpt, "rms_norm_q4k_fq", norm4fq)
    return seen


def _eager_block(x, layer, cfg, cos, sin, mask, dtype, kv_cache, start_pos,
                 pos_t, attn_len=None, layer_idx=-1):
    """The cached block through the eager ops the fused kernels replaced
    (`layer_idx` names the layer to an observer; none is attached here)."""
    xn = tgpt.rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    h = x + tgpt.attention(xn, layer, cfg, cos, sin, mask, dtype, kv_cache,
                           start_pos, pos_t, attn_len)
    hn = tgpt.rms_norm(h, layer["ffn_norm"], cfg.norm_eps)
    return h + tgpt.feed_forward(hn, layer, dtype)


def _eager_final(h, params, cfg, dtype, last_idx=None):
    hn = tgpt.rms_norm(h, params["norm"], cfg.norm_eps)
    if last_idx is not None:
        hn = hn[:, last_idx:last_idx + 1]
    return tgpt.compute_logits(hn, params, dtype)


def _decode_step(cfg, params, B, dtype, seed=1):
    """One forward_decode_batched step at B rows, each at its own position
    over a cache filled from a seed -> f32 logits (B, V)."""
    g = torch.Generator().manual_seed(seed)
    cache = tgpt.KVCache.create(cfg, B, 32, dtype)
    cache.k.normal_(generator=g)
    cache.v.normal_(generator=g)
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=g)
    pos = torch.randint(3, 30, (B,), dtype=torch.int32, generator=g)
    return tgpt.forward_decode_batched(params, tok, cache, pos, cfg, dtype)[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batched_step_quantizes_in_the_norms_and_equals_the_eager_path(
        qwen_tiny, monkeypatch, dtype):
    """B = 3: every norm (2 a layer + the final one, for the tied W8A8
    head) and every SwiGLU asks for Q80 outputs at group size 256, so
    q80_act_quant runs n_layer times (wo's input only); the logits are
    bit-equal to the same step through the eager ops."""
    cfg, params = qwen_tiny
    with monkeypatch.context() as m:
        seen = _spy(m)
        got = _decode_step(cfg, params, 3, dtype)
    assert seen == {"act_quant": cfg.n_layer,
                    "norm": [GS] * (2 * cfg.n_layer + 1),
                    "swiglu": [GS] * cfg.n_layer}
    with monkeypatch.context() as m:
        m.setattr(tgpt, "block", _eager_block)
        m.setattr(tgpt, "_final", _eager_final)
        seen = _spy(m)
        want = _decode_step(cfg, params, 3, dtype)
    assert seen["act_quant"] == 4 * cfg.n_layer + 1 and not seen["norm"]
    assert torch.equal(got, want) and torch.isfinite(got).all()


def test_one_row_asks_for_no_q80_output(qwen_tiny, monkeypatch):
    """B = 1: q80_matvec_fq quantizes its row itself, so no norm or SwiGLU
    asks for Q80 outputs and q80_act_quant never runs; the logits are
    bit-equal to the eager path's."""
    cfg, params = qwen_tiny
    with monkeypatch.context() as m:
        seen = _spy(m)
        got = _decode_step(cfg, params, 1, torch.bfloat16)
    assert seen == {"act_quant": 0, "norm": [0] * (2 * cfg.n_layer + 1),
                    "swiglu": [0] * cfg.n_layer}
    with monkeypatch.context() as m:
        m.setattr(tgpt, "block", _eager_block)
        m.setattr(tgpt, "_final", _eager_final)
        want = _decode_step(cfg, params, 1, torch.bfloat16)
    assert torch.equal(got, want)


def test_prefill_slices_before_the_final_norm(qwen_tiny, monkeypatch):
    """A prefill of 11 rows with last_idx: the layers' norms and SwiGLUs
    quantize (11 rows), the final norm runs on the one row the head reads
    (q80_matvec_fq, no Q80 output); the logits are bit-equal to the eager
    path's, which normalizes every row and then slices."""
    cfg, params = qwen_tiny
    ids = torch.tensor([[5, 17, 300, 42, 99, 7, 256, 1, 64, 128, 3]])

    def prefill():
        cache = tgpt.KVCache.create(cfg, 1, 32, torch.bfloat16)
        return tgpt.forward_with_cache(params, ids, cache, 0, cfg,
                                       torch.bfloat16, attn_len=16,
                                       last_idx=10)[0]

    with monkeypatch.context() as m:
        seen = _spy(m)
        got = prefill()
    assert seen == {"act_quant": cfg.n_layer,
                    "norm": [GS] * (2 * cfg.n_layer) + [0],
                    "swiglu": [GS] * cfg.n_layer}
    with monkeypatch.context() as m:
        m.setattr(tgpt, "block", _eager_block)
        m.setattr(tgpt, "_final", _eager_final)
        want = prefill()
    assert got.shape == (1, 1, cfg.vocab_size) and torch.equal(got, want)


@pytest.mark.parametrize("B", [1, 3])
def test_q4k_model_never_asks_for_q80_outputs(tiny_q4k, monkeypatch, B):
    """The Q4K model's norms and SwiGLUs write the Q4K integer form of
    their output for its products at every row count (rms_norm_q4k,
    swiglu_q4k), so q4k_act_quant runs only on wo's input, n_layer times;
    the final norm writes the Q4K fake-quant its requantized Q80 head takes
    (rms_norm_q4k_fq) and no norm or SwiGLU ever asks for Q80 outputs; the
    logits are bit-equal to the eager path's."""
    cfg, params = tiny_q4k
    aq4 = tq4.act_quant_q4k_packed
    calls = []

    def act_quant_q4k(x2d):
        calls.append(x2d.shape[0])
        return aq4(x2d)

    with monkeypatch.context() as m:
        seen = _spy(m)
        m.setattr(tq4, "act_quant_q4k_packed", act_quant_q4k)
        got = _decode_step(cfg, params, B, torch.float32)
    assert seen["norm"] == ["q4k"] * (2 * cfg.n_layer) + ["q4k_fq"]
    assert seen["swiglu"] == ["q4k"] * cfg.n_layer
    assert calls == [B] * cfg.n_layer
    with monkeypatch.context() as m:
        m.setattr(tgpt, "block", _eager_block)
        m.setattr(tgpt, "_final", _eager_final)
        want = _decode_step(cfg, params, B, torch.float32)
    assert torch.equal(got, want)
