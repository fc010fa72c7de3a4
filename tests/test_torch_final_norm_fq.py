"""The Q4K fake-quant of a Q4K model's head folded into its final norm,
against the two steps it replaces and the JAX package, on the CPU.

A Q4K model's tied head is the Q80 table requantized from its Q4K
embedding, and the C engine feeds it the Q4K fake-quant of the final
norm's output (``infer/infer.c:1012-1014``; JAX ``compute_logits`` applies
``fake_quant_act``).  The cached forward's ``_final`` now takes that row
from one kernel, ``rms_norm_q4k_fq`` (nano_tpu_torch/ops/norm_quant.py),
instead of ``rms_norm_q80`` and then ``q4k_fake_quant``.  On the CPU the
wrapper runs its plain version; the JAX side runs op by op
(``jax.disable_jit()``: jitted on the CPU, XLA folds the fake-quant's
magic-number rounding away; tests/test_torch_q4k_slice.py):

* the fused output is ``fake_quant_act_plain(rms_norm(x + residual))``
  bit for bit, zeros at and past E, and JAX's ``fake_quant_act`` of that
  rounded row bit for bit (JAX's own ``rms_norm`` gives the row within
  1e-6 relative in f32, its mean and rsqrt evaluated otherwise; exactly in
  bf16);
* the tiny Q4K model's ``_final`` logits equal the two-step path's (the
  eager norm, then ``compute_logits``) bit for bit, with and without
  ``last_idx`` and under an observer's tap, and JAX's ``compute_logits``
  of its ``rms_norm`` within 1e-4 of max|logit| (the Q80 head's f32 sums
  in another order).

The CUDA kernel is held bit-equal to ``rms_norm_q80`` + ``q4k_fake_quant``
on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py phase 3.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nano_tpu.infer import engine as jeng
from nano_tpu.models import gpt as jgpt
from nano_tpu.ops import q4k as jq
from nano_tpu_torch import observe
from nano_tpu_torch.infer import engine as teng
from nano_tpu_torch.models import gpt as tgpt
from nano_tpu_torch.ops import norm_quant as tnq
from nano_tpu_torch.ops import q4k as tq

FIX = os.path.join(os.path.dirname(__file__), "js", "fixtures")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
JDTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _jax_op_by_op(fn, *args):
    jax.clear_caches()
    try:
        with jax.disable_jit():
            return fn(*args)
    finally:
        jax.clear_caches()


def _rows(seed, B, n, scale=2.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n) * scale).astype(np.float32)


@pytest.mark.parametrize("n", (40, 64, 320, 1000))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("res", [False, True])
def test_fused_final_norm_is_the_norm_then_the_fake_quant(n, dt, res):
    tdt = DTYPES[dt]
    B = 3
    x = torch.from_numpy(_rows(n, B, n)).to(tdt)
    a = torch.from_numpy(_rows(n + 1, B, n, 0.5)).to(tdt) if res else None
    w = torch.from_numpy(1 + 0.1 * np.random.RandomState(n + 2).randn(n)
                         .astype(np.float32))
    h, hn, fq = tnq.rms_norm_q4k_fq(x, w, 1e-6, a)
    h8, hn8, _ = tnq.rms_norm_q80(x, w, 1e-6, a)
    assert torch.equal(hn, hn8) and hn.dtype == tdt
    assert (h is None and h8 is None) if a is None else torch.equal(h, h8)
    n_pad = tq.n_blocks_per_line(n) * 256
    assert fq.dtype == torch.float32 and fq.shape == (B, n_pad)
    assert torch.equal(fq, tq.fake_quant_act_plain(hn8))
    assert not fq[:, n:].any()
    _, none, fq2 = tnq.rms_norm_q4k_fq(x, w, 1e-6, a, want_hn=False)
    assert none is None and torch.equal(fq2, fq)
    # JAX's fake_quant_act of the same rounded row, op by op; and JAX's
    # residual add and rms_norm give that row within 1e-6 relative in f32
    # (its mean and rsqrt evaluated otherwise), exactly where it is rounded
    # to bf16
    want = np.asarray(_jax_op_by_op(jq.fake_quant_act,
                                    jnp.asarray(hn.float().numpy())))
    np.testing.assert_array_equal(fq[:, :n].numpy(), want)
    jx = jnp.asarray(x.float().numpy()).astype(JDTYPES[dt])
    if a is not None:
        jx = jx + jnp.asarray(a.float().numpy()).astype(JDTYPES[dt])
    jhn = np.asarray(_jax_op_by_op(
        lambda t: jgpt.rms_norm(t, jnp.asarray(w.numpy()), 1e-6), jx)
    ).astype(np.float32)
    if dt == "bf16":
        np.testing.assert_array_equal(hn.float().numpy(), jhn)
    else:
        np.testing.assert_allclose(hn.numpy(), jhn, rtol=1e-6, atol=0)


def test_fused_final_norm_keeps_the_leading_shape():
    x = torch.from_numpy(_rows(5, 6, 320)).reshape(2, 3, 320)
    w = torch.ones(320)
    _, hn, fq = tnq.rms_norm_q4k_fq(x, w, 1e-5)
    assert hn.shape == (2, 3, 320) and fq.shape == (2, 3, 512)
    assert torch.equal(fq.reshape(6, 512),
                       tq.fake_quant_act_plain(hn.reshape(6, 320)))


@pytest.fixture(scope="module")
def tiny_q4k():
    path = os.path.join(FIX, "tiny_q4k.bin")
    tctx = teng.LLMContext.from_bin(path, max_seq_len=64,
                                    dtype=torch.float32, device="cpu")
    jctx = jeng.LLMContext.from_bin(path, max_seq_len=64, dtype=jnp.float32)
    return tctx, jctx


def _two_steps(h, params, cfg, last_idx=None):
    """The path before the fold: the eager final norm, then compute_logits
    (which fake-quantizes the row for the requantized Q80 head)."""
    hn = tgpt.rms_norm(h, params["norm"], cfg.norm_eps)
    if last_idx is not None:
        hn = hn[:, last_idx:last_idx + 1]
    return tgpt.compute_logits(hn, params, torch.float32)


@pytest.mark.parametrize("S,last_idx", [(1, None), (5, None), (5, 3)])
def test_final_logits_equal_the_two_steps_and_jax(tiny_q4k, S, last_idx,
                                                  monkeypatch):
    tctx, jctx = tiny_q4k
    cfg, params = tctx.cfg, tctx.params
    assert tgpt._head_fq(params)
    h = torch.from_numpy(_rows(S, S, cfg.n_embd)).reshape(1, S, cfg.n_embd)
    calls = []
    fused, fq_act = tnq.rms_norm_q4k_fq, tq.fake_quant_act
    monkeypatch.setattr(tgpt, "rms_norm_q4k_fq",
                        lambda *a, **k: calls.append("fused") or fused(*a, **k))
    monkeypatch.setattr(tgpt, "fake_quant_act",
                        lambda *a, **k: calls.append("fq") or fq_act(*a, **k))
    got = tgpt._final(h, params, cfg, torch.float32, last_idx)
    assert calls == ["fused"]          # one kernel, no fake-quant after it
    rows = S if last_idx is None else 1
    assert got.shape == (1, rows, cfg.vocab_size)
    assert torch.equal(got, _two_steps(h, params, cfg, last_idx))
    # under an observer's tap the norm runs on every row; the tap sees the
    # normed rows, the head the fake-quantized one
    seen = []
    with observe.attached(seen.append):
        tapped = tgpt._final(h, params, cfg, torch.float32, last_idx)
    assert torch.equal(tapped, got)
    norms = [o.data for o in seen if o.phase == observe.Phase.FINAL_NORM]
    assert len(norms) == 1 and norms[0].shape == (1, S, cfg.n_embd)
    np.testing.assert_array_equal(
        norms[0], tgpt.rms_norm(h, params["norm"], cfg.norm_eps).numpy())
    # JAX: compute_logits of its rms_norm (the f32 dequant dots of the
    # tests' JAX side, op by op)
    monkeypatch.setenv("NANO_TPU_DEQUANT", "f32")
    jh = jnp.asarray(h.numpy())
    if last_idx is not None:
        jh = jh[:, last_idx:last_idx + 1]
    want = np.asarray(_jax_op_by_op(
        lambda t: jgpt.compute_logits(
            jgpt.rms_norm(t, jctx.params["norm"], jctx.cfg.norm_eps),
            jctx.params, jnp.float32), jh))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert (got.numpy().argmax(-1) == want.argmax(-1)).all()
