#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nano_tpu_torch) on one NVIDIA GPU.

Run from the repository root:   python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

  1. environment  card name and power limit, torch / CUDA / nvcc versions
  2. build        nvcc builds nano_tpu_torch/csrc/*.cu into
                  build/torch_kernels/ (one process per source, in parallel)
  3. kernels      each kernel against its plain PyTorch version on the
                  card, at the main paths' shapes (the five Q80 matmuls of
                  the Qwen3-0.6B shape at B=1 and B=64, decode attention
                  over bf16 and int8 caches, the Q4K activation fake-quant
                  at widths 1024/2048/3072 and 40/64/128, the four Q4K
                  matmuls at B=1 and B=64 and the tiny fixture's), and
                  timed over one decode step's launches: kernel, plain
                  version, one PyTorch library call as a yardstick, and the
                  least time the card needs for the bytes and operations
  4. tiny fixtures tests/js/fixtures/tiny_q80.bin and tiny_q4k.bin, greedy
                  through generate_sync, must give expected.json's streams
  5. full width   a Qwen3-0.6B-shaped Q80 model (group size 256) and a
                  Q4K model (tied head requantized to Q80), random weights
                  from a seed, 28 layers: per model 3 requests through
                  generate_sync, generate_on_device with a 64-token prompt
                  and 256 greedy tokens (TTFT, decode tok/s), the launch
                  count of every kernel on the path, a profile of the
                  decode step, and first-step logits against the plain
                  versions on the CPU

The last two lines of stdout are one JSON object listing the kernels and
then {"ok": true, "device": {...}}.  Without a CUDA device the script
exits non-zero before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores

# Qwen3-0.6B (config/model_0.6b.json; tools/bench_stages.py QWEN3_06B)
QWEN3_06B = dict(block_size=1024, vocab_size=151936, n_layer=28,
                 n_embd=1024, n_head=16, n_kv_head=8, n_hidden=3072,
                 head_dim=128, use_qk_norm=True, rope_style="half",
                 rope_theta=1e6, norm_eps=1e-6, tie_embeddings=True)
GS = 256
SEED = 1234
PROMPT_LEN, N_TOKENS = 64, 256
# operations per value of the Q4K fake-quant: max, min, add, divide, the
# two rounding operations, the dequant multiply and subtract
FQ_OPS_PER_VALUE = 8


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    """-> (least ms for the bytes and operations, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Timer:
    """Device time (ms) of one call of fn(): fn's launches are captured
    once in a CUDA graph and replayed `reps` times between CUDA events, so
    the time is the card's and not the host's launch rate."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps=20) -> float:
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm-up off the capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(end) / reps


def _shapes(cfg):
    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_hidden, cfg.vocab_size
    HD, KVD = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim
    return L, E, F, V, HD, KVD, cfg.head_dim


def random_q80_params(torch, np, cfg, device):
    """The loader's layout (binfmt.quantized_device_params + the load-time
    W8A8 decision): fused wqkv / w13, stacked (L, out, in) int8 rows with
    (L, out, G) f32 scales, the tied head sharing the embedding table.
    Random values from SEED, as tools/bench_stages.py:q80_params makes
    them (uniform int8, scales in [1e-3, 0.021))."""
    from nano_tpu_torch.ops.qmatmul import Q80Tensor
    rng = np.random.default_rng(SEED)

    def qt(*shape):
        q = rng.integers(-127, 128, size=shape, dtype=np.int8)
        s = (rng.random((*shape[:-1], shape[-1] // GS), dtype=np.float32)
             * np.float32(0.02) + np.float32(1e-3))
        return Q80Tensor(q=torch.from_numpy(q).to(device),
                         scales=torch.from_numpy(s).to(device),
                         group_size=GS, w8a8=True)

    L, E, F, V, HD, KVD, D = _shapes(cfg)
    ones = lambda *s: torch.ones(*s, device=device)
    blocks = {"attn_norm": ones(L, E), "ffn_norm": ones(L, E),
              "q_norm": ones(L, D), "k_norm": ones(L, D),
              "wqkv": qt(L, HD + 2 * KVD, E), "wo": qt(L, E, HD),
              "w13": qt(L, 2 * F, E), "w2": qt(L, E, F)}
    tok = qt(V, E)
    return {"tok_embeddings": tok, "output_q": tok, "norm": ones(E),
            "blocks": blocks}


def random_q4k_params(torch, np, cfg, device):
    """The Q4K loader's layout (binfmt._q4k_device_params): fused wqkv /
    w13 as stacked packed Q4KTensors, random nibbles, scales in
    [1e-3, 0.021) and biases in [0, 0.02) from SEED + 2, as
    tools/bench_stages.py:_q4t_packed makes them.  The tied head comes
    from the Q4K embedding table as the loader makes it: dequantized, then
    the port's binfmt.quantize_q80 at group size 256 (W8A8 form)."""
    from nano_tpu_torch.io import binfmt
    from nano_tpu_torch.ops.q4k import Q4KTensor
    from nano_tpu_torch.ops.qmatmul import Q80Tensor
    rng = np.random.default_rng(SEED + 2)

    def q4(*lead_out, inn):
        G = inn // 32
        p = rng.integers(0, 256, size=(*lead_out, inn // 2), dtype=np.uint8)
        s = (rng.random((*lead_out, G), dtype=np.float32) * np.float32(0.02)
             + np.float32(1e-3))
        b = rng.random((*lead_out, G), dtype=np.float32) * np.float32(0.02)
        return Q4KTensor(packed=torch.from_numpy(p).to(device),
                         scales=torch.from_numpy(s).to(device),
                         biases=torch.from_numpy(b).to(device), in_dim=inn)

    L, E, F, V, HD, KVD, D = _shapes(cfg)
    ones = lambda *s: torch.ones(*s, device=device)
    blocks = {"attn_norm": ones(L, E), "ffn_norm": ones(L, E),
              "q_norm": ones(L, D), "k_norm": ones(L, D),
              "wqkv": q4(L, HD + 2 * KVD, inn=E), "wo": q4(L, E, inn=HD),
              "w13": q4(L, 2 * F, inn=E), "w2": q4(L, E, inn=F)}
    tok = q4(V, inn=E)
    q, sc = binfmt.quantize_q80(tok.dequantize().cpu().numpy(), GS)
    head = Q80Tensor(q=torch.from_numpy(q.reshape(V, E)).to(device),
                     scales=torch.from_numpy(sc.reshape(V, E // GS)).to(device),
                     group_size=GS, w8a8=True)
    return {"tok_embeddings": tok, "output_q": head, "norm": ones(E),
            "blocks": blocks}


def params_to(params, device):
    from nano_tpu_torch.ops.qmatmul import Q80Tensor
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = params_to(v, device)
        else:
            out[k] = v.to(device)
    if (isinstance(params.get("tok_embeddings"), Q80Tensor)
            and params.get("output_q") is params["tok_embeddings"]):
        out["output_q"] = out["tok_embeddings"]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from dataclasses import replace
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.ops import _build, decode_attn, q4k, qmatmul, sampling
    from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    import torch.nn.functional as F

    t_start = time.time()
    timer = Timer(torch)
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream

    # ---------------- 1. environment ----------------
    card = card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True
                          ).stdout.strip().splitlines()[-1]
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[env] nvcc: {nvcc}")

    # ---------------- 2. build ----------------
    t0 = time.time()
    logs = _build.build_all()
    for stem, text in logs.items():
        regs = [ln.split("Used ")[1].split(",")[0] for ln in text.splitlines()
                if "Used " in ln and "registers" in ln]
        spills = [ln for ln in text.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        log(f"[build] {stem}.cu ok: {len(regs)} kernels, registers "
            f"{sorted(set(regs))}, spilling kernels {len(spills)}")
    log(f"[build] {time.time() - t0:.1f} s")

    cfg = ModelConfig(**QWEN3_06B)
    t0 = time.time()
    params = random_q80_params(torch, np, cfg, dev)
    torch.cuda.synchronize()
    log(f"[setup] Qwen3-0.6B-shaped Q80 weights from seed {SEED} on the "
        f"card in {time.time() - t0:.1f} s")
    t0 = time.time()
    params4 = random_q4k_params(torch, np, cfg, dev)
    torch.cuda.synchronize()
    log(f"[setup] Qwen3-0.6B-shaped Q4K weights from seed {SEED + 2} on the "
        f"card, head requantized to Q80 gs={GS}, in {time.time() - t0:.1f} s")
    L = cfg.n_layer
    blocks = params["blocks"]
    head = params["output_q"]
    # the five Q80 matmuls of a forward: (name, stacked or single weight)
    shapes = [("wqkv", blocks["wqkv"]), ("wo", blocks["wo"]),
              ("w13", blocks["w13"]), ("w2", blocks["w2"]), ("head", head)]

    # ---------------- 3. kernels vs plain ----------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = {}

    def entry(name, replaces, source):
        kernels[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, launches=0, max_abs_err=0.0,
                             ms=0.0, plain_ms=0.0, bound_ms=0.0,
                             bound_by="bytes", library_ms=0.0)

    entry("q80_act_quant", "nano_tpu/ops/qmatmul.py:250",
          "nano_tpu_torch/csrc/q80_matmul.cu")
    entry("q80_matmul_w8a8", "nano_tpu/ops/qmatmul.py:268",
          "nano_tpu_torch/csrc/q80_matmul.cu")
    entry("q80_matmul_rows", "nano_tpu/ops/qmatmul.py:129",
          "nano_tpu_torch/csrc/q80_matmul.cu")
    entry("decode_attention", "nano_tpu/ops/decode_attn.py:45",
          "nano_tpu_torch/csrc/decode_attn.cu")
    entry("q4k_fake_quant", "nano_tpu/ops/q4k.py:644",
          "nano_tpu_torch/csrc/q4k.cu")
    entry("q4k_matmul", "nano_tpu/ops/q4k.py:717",
          "nano_tpu_torch/csrc/q4k.cu")

    def note_err(name, err):
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)

    def set_bound(name, n_bytes, n_ops, ops_per_s):
        kernels[name]["bound_ms"], kernels[name]["bound_by"] = bound(
            n_bytes, n_ops, ops_per_s)

    def layer_weights(w):
        lead = w.q if isinstance(w, qmatmul.Q80Tensor) else w.packed
        return ([w.layer(i) for i in range(lead.shape[0])] if lead.dim() == 3
                else [w])

    for B in (1, 64):
        for name, w in shapes:
            w0 = layer_weights(w)[0]
            K, N = w0.in_dim, w0.out_dim
            x = torch.randn(B, K, device=dev, generator=gen).to(torch.bfloat16)
            kq, ks = qmatmul.act_quant_q80(x, GS)
            pq, ps = qmatmul.act_quant_q80_plain(x, GS)
            note_err("q80_act_quant", max((kq.int() - pq.int()).abs().max().item(),
                                          (ks - ps).abs().max().item()))
            if not (torch.equal(kq, pq) and torch.equal(ks, ps)):
                raise AssertionError(f"act_quant int8 decisions differ at "
                                     f"{name} B={B}")
            y = qmatmul.q80_w8a8(kq, ks, w0, torch.float32)
            ref = qmatmul.q80_w8a8_plain(pq, ps, w0, torch.float32)
            err = (y - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()
            log(f"[kernel] q80_matmul_w8a8 {name} {K}->{N} B={B}: int8 "
                f"equal, max_abs_err {err:.3e} (tol {tol:.3e} = 1e-5 of "
                f"max|y|)")
            if not err <= tol:
                raise AssertionError(f"q80_matmul_w8a8 {name} B={B} off by {err}")
            note_err("q80_matmul_w8a8", err)

    # rows form at the tiny fixture's shapes (its only user) and at one
    # main-path width with group size 32
    rng = np.random.default_rng(SEED)
    for K, N, gs, B in ((64, 128, 32, 1), (64, 256, 32, 16),
                        (128, 64, 32, 1), (1024, 4096, 32, 1)):
        w = qmatmul.Q80Tensor(
            q=torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8)).to(dev),
            scales=torch.from_numpy(rng.random((N, K // gs), dtype=np.float32) * 0.02).to(dev),
            group_size=gs)
        x = torch.randn(B, K, device=dev, generator=gen)
        y = qmatmul.q80_matmul_rows(x, w, torch.float32)
        ref = qmatmul.q80_matmul_rows_plain(x, w, torch.float32)
        err = (y - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        log(f"[kernel] q80_matmul_rows {K}->{N} gs={gs} B={B}: max_abs_err "
            f"{err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"q80_matmul_rows {K}->{N} off by {err}")
        note_err("q80_matmul_rows", err)

    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    for cdt in (torch.bfloat16, torch.int8):
        for T in (128, 512, 1024):
            q = torch.randn(1, H, D, device=dev, generator=gen)
            if cdt == torch.int8:
                kc = torch.randint(-127, 128, (1, T, KV, D), dtype=torch.int8,
                                   device=dev, generator=gen)
                vc = torch.randint(-127, 128, (1, T, KV, D), dtype=torch.int8,
                                   device=dev, generator=gen)
                ksc = torch.rand(1, T, KV, device=dev, generator=gen) * 0.02
                vsc = torch.rand(1, T, KV, device=dev, generator=gen) * 0.02
            else:
                kc = torch.randn(1, T, KV, D, device=dev, generator=gen).to(cdt)
                vc = torch.randn(1, T, KV, D, device=dev, generator=gen).to(cdt)
                ksc = vsc = None
            for p in sorted({0, T // 2, T - 1, min(T - 1, PROMPT_LEN + N_TOKENS - 2)}):
                pos = torch.tensor([p], dtype=torch.int32, device=dev)
                out = decode_attn.decode_attention(q, kc, vc, ksc, vsc, pos, KV, H // KV)
                ref = decode_attn.decode_attention_plain(q, kc, vc, ksc, vsc, pos, KV, H // KV)
                err = (out - ref).abs().max().item()
                log(f"[kernel] decode_attention {str(cdt)[6:]} T={T} pos={p}: "
                    f"max_abs_err {err:.3e} (tol 2e-5 + 2e-5*|ref|)")
                if not torch.allclose(out, ref, rtol=2e-5, atol=2e-5):
                    raise AssertionError(f"decode_attention T={T} pos={p} off by {err}")
                note_err("decode_attention", err)

    # Q4K activation fake-quant: bit-equal to its plain version (the same
    # IEEE operations), rows holding an all-zero group and constant groups
    def act_rows(B, n):
        x = torch.randn(B, n, device=dev, generator=gen) * 0.7
        x[0, :min(n, 32)] = 0.0
        if n >= 64:
            x[-1, 32:64] = 2.5
        if n >= 128:
            x[0, 64:96] = -1.25
        return x

    n_fq = 0
    for n in (1024, 2048, 3072, 40, 64, 128):
        for B in (1, 64):
            x = act_rows(B, n)
            for xt in (x, x.to(torch.bfloat16)):
                got = q4k.fake_quant_act(xt)
                want = q4k.fake_quant_act_plain(xt)
                note_err("q4k_fake_quant", (got - want).abs().max().item())
                if not torch.equal(got, want):
                    raise AssertionError(f"q4k_fake_quant differs at n={n} "
                                         f"B={B} {xt.dtype}")
                n_fq += 1
    log(f"[kernel] q4k_fake_quant: torch.equal with the plain version in "
        f"{n_fq} cases (n = 1024, 2048, 3072, 40, 64, 128; B = 1, 64; f32 "
        f"and bf16 input; all-zero and constant groups)")

    # Q4K matmul: the four matmuls of a layer of the Q4K model, and the
    # tiny fixture's widths (in 64 and 128, n_pad 256)
    b4 = params4["blocks"]
    q4_cases = [(name, b4[name].layer(0))
                for name in ("wqkv", "wo", "w13", "w2")]
    for inn, out in ((64, 128), (64, 64), (64, 256), (128, 64)):
        q4_cases.append((f"tiny {inn}->{out}", q4k.Q4KTensor(
            packed=torch.from_numpy(rng.integers(0, 256, (out, 128), dtype=np.uint8)).to(dev),
            scales=torch.from_numpy(rng.random((out, 8), dtype=np.float32) * 0.02 + 1e-3).to(dev),
            biases=torch.from_numpy(rng.random((out, 8), dtype=np.float32) * 0.02).to(dev),
            in_dim=inn)))
    for B in (1, 64):
        for name, w in q4_cases:
            xq = q4k.fake_quant_act(act_rows(B, w.in_dim))
            y = q4k.q4k_matmul_f32(xq, w, torch.float32)
            ref = q4k.q4k_matmul_plain(xq, w, torch.float32)
            err = (y - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()
            log(f"[kernel] q4k_matmul {name} {w.in_dim}->{w.out_dim} B={B}: "
                f"max_abs_err {err:.3e} (tol {tol:.3e} = 1e-5 of max|y|)")
            if not err <= tol:
                raise AssertionError(f"q4k_matmul {name} B={B} off by {err}")
            note_err("q4k_matmul", err)

    # ---- timing: one decode step's launches of each kernel, B=1 ----
    lib = _build.lib("q80_matmul")
    step_calls = []      # (weight, x bf16, xq, sa, y, dequantized bf16 weight)
    for name, w in shapes:
        for wl in layer_weights(w):
            x = torch.randn(1, wl.in_dim, device=dev, generator=gen).to(torch.bfloat16)
            xq, sa = qmatmul.act_quant_q80_plain(x, GS)
            step_calls.append((wl, x, xq, sa,
                               torch.empty(1, wl.out_dim, device=dev,
                                           dtype=torch.bfloat16),
                               wl.dequantize(torch.bfloat16)))
    assert len(step_calls) == 4 * L + 1

    def run_act_quant():
        for wl, x, xq, sa, y, _ in step_calls:
            lib.q80_act_quant(x.data_ptr(), 1, xq.data_ptr(), sa.data_ptr(),
                              1, wl.in_dim, GS, stream())

    def run_w8a8():
        for wl, x, xq, sa, y, _ in step_calls:
            lib.q80_matmul_w8a8(xq.data_ptr(), sa.data_ptr(), wl.q.data_ptr(),
                                wl.scales.data_ptr(), y.data_ptr(), 1, 1,
                                wl.in_dim, wl.out_dim, GS, stream())

    def run_act_quant_plain():
        for wl, x, *_ in step_calls:
            qmatmul.act_quant_q80_plain(x, GS)

    def run_w8a8_plain():
        for wl, x, xq, sa, *_ in step_calls:
            qmatmul.q80_w8a8_plain(xq, sa, wl, torch.bfloat16)

    def run_w8a8_library():
        for wl, x, *_, wd in step_calls:
            torch.matmul(x, wd.t())

    k = kernels["q80_act_quant"]
    k["ms"] = timer(run_act_quant)
    k["plain_ms"] = timer(run_act_quant_plain)
    k["library_ms"] = None
    set_bound("q80_act_quant",
              sum(wl.in_dim * 2 + wl.in_dim + wl.in_dim // GS * 4
                  for wl, *_ in step_calls),
              sum(3 * wl.in_dim for wl, *_ in step_calls), F32_OPS_PER_S)

    k = kernels["q80_matmul_w8a8"]
    k["ms"] = timer(run_w8a8)
    k["plain_ms"] = timer(run_w8a8_plain)
    k["library_ms"] = timer(run_w8a8_library)
    mm_bytes = sum(wl.q.numel() + wl.scales.numel() * 4 + wl.in_dim
                   + wl.in_dim // GS * 4 + wl.out_dim * 2
                   for wl, *_ in step_calls)
    set_bound("q80_matmul_w8a8", mm_bytes,
              sum(2 * wl.q.numel() for wl, *_ in step_calls), INT8_OPS_PER_S)
    log(f"[time] one Q80 decode step (B=1, {len(step_calls)} matmuls): "
        f"act_quant {kernels['q80_act_quant']['ms']:.4f} ms, w8a8 "
        f"{k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms for "
        f"{mm_bytes / 1e6:.1f} MB), bf16 torch.matmul on pre-dequantized "
        f"weights {k['library_ms']:.4f} ms")
    del step_calls

    # Q4K: the 112 matmuls of a decode step (real per-layer weights, so
    # nothing stays in L2) and the 113 fake-quants before them and the head
    lib4 = _build.lib("q4k")
    mm4 = []      # (weight, x bf16, xq f32 (1, n_pad), y bf16, bf16 weight)
    for name in ("wqkv", "wo", "w13", "w2"):
        for wl in layer_weights(b4[name]):
            x = torch.randn(1, wl.in_dim, device=dev, generator=gen).to(torch.bfloat16)
            mm4.append((wl, x, q4k.fake_quant_act_plain(x),
                        torch.empty(1, wl.out_dim, device=dev,
                                    dtype=torch.bfloat16),
                        wl.dequantize(torch.bfloat16)))
    assert len(mm4) == 4 * L
    x_head = torch.randn(1, cfg.n_embd, device=dev, generator=gen).to(torch.bfloat16)
    fq4 = [(x, xq) for _, x, xq, *_ in mm4] + [
        (x_head, q4k.fake_quant_act_plain(x_head))]

    def run_fq():
        for x, xq in fq4:
            lib4.q4k_fake_quant(x.data_ptr(), 1, xq.data_ptr(), 1,
                                x.shape[1], xq.shape[1], stream())

    def run_fq_plain():
        for x, _ in fq4:
            q4k.fake_quant_act_plain(x)

    def run_mm4():
        for wl, x, xq, y, _ in mm4:
            lib4.q4k_matmul(xq.data_ptr(), wl.packed.data_ptr(),
                            wl.scales.data_ptr(), wl.biases.data_ptr(),
                            y.data_ptr(), 1, 1, wl.n_pad, wl.in_dim,
                            wl.out_dim, stream())

    def run_mm4_plain():
        for wl, x, xq, *_ in mm4:
            q4k.q4k_matmul_plain(xq, wl, torch.bfloat16)

    def run_mm4_library():
        for wl, x, *_, wd in mm4:
            torch.matmul(x, wd.t())

    k = kernels["q4k_fake_quant"]
    k["ms"] = timer(run_fq)
    k["plain_ms"] = timer(run_fq_plain)
    k["library_ms"] = None
    fq_vals = sum(x.shape[1] for x, _ in fq4)
    set_bound("q4k_fake_quant",
              sum(x.shape[1] * 2 + xq.shape[1] * 4 for x, xq in fq4),
              FQ_OPS_PER_VALUE * fq_vals, F32_OPS_PER_S)
    k = kernels["q4k_matmul"]
    k["ms"] = timer(run_mm4)
    k["plain_ms"] = timer(run_mm4_plain)
    k["library_ms"] = timer(run_mm4_library)
    mm4_bytes = sum(wl.packed.numel() + 8 * wl.scales.numel()
                    + 4 * wl.n_pad + 2 * wl.out_dim for wl, *_ in mm4)
    mm4_ops = sum(2 * wl.out_dim * wl.in_dim for wl, *_ in mm4)
    set_bound("q4k_matmul", mm4_bytes, mm4_ops, F32_OPS_PER_S)
    log(f"[time] one Q4K decode step (B=1): {len(fq4)} fake-quants "
        f"{kernels['q4k_fake_quant']['ms']:.4f} ms (plain "
        f"{kernels['q4k_fake_quant']['plain_ms']:.4f} ms, bound "
        f"{kernels['q4k_fake_quant']['bound_ms']:.6f} ms for {fq_vals} "
        f"values); {len(mm4)} matmuls {k['ms']:.4f} ms (plain "
        f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms for "
        f"{mm4_bytes / 1e6:.1f} MB and {mm4_ops / 1e9:.3f} GFLOP f32), bf16 "
        f"torch.matmul on pre-dequantized weights {k['library_ms']:.4f} ms")
    del mm4, fq4

    # attention: the last step of the main path's decode (cache of 512
    # rows, position PROMPT_LEN + N_TOKENS - 2), one call per layer on its
    # own layer cache
    T_main = engine._bucket(PROMPT_LEN + N_TOKENS)
    p_main = PROMPT_LEN + N_TOKENS - 2
    cache = gpt.KVCache.create(cfg, 1, T_main, torch.bfloat16, dev)
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    qs = [torch.randn(1, H, D, device=dev, generator=gen) for _ in range(L)]
    pos = torch.tensor([p_main], dtype=torch.int32, device=dev)
    kvs = [(cache.k[i, :, :p_main + 1].transpose(1, 2).contiguous(),
            cache.v[i, :, :p_main + 1].transpose(1, 2).contiguous())
           for i in range(L)]
    q16 = [q.to(torch.bfloat16)[:, :, None, :] for q in qs]

    def run_attn():
        for i in range(L):
            decode_attn.decode_attention(qs[i], cache.k[i], cache.v[i], None,
                                         None, pos, KV, H // KV)

    def run_attn_plain():
        for i in range(L):
            decode_attn.decode_attention_plain(qs[i], cache.k[i], cache.v[i],
                                               None, None, pos, KV, H // KV)

    def run_attn_library():
        for i in range(L):
            F.scaled_dot_product_attention(q16[i], kvs[i][0], kvs[i][1],
                                           enable_gqa=True)

    k = kernels["decode_attention"]
    k["ms"] = timer(run_attn)
    k["plain_ms"] = timer(run_attn_plain)
    k["library_ms"] = timer(run_attn_library)
    rows = p_main + 1
    set_bound("decode_attention",
              L * (2 * rows * KV * D * 2 + H * D * 4 + H * D * 4),
              L * (4 * rows * H * D), F32_OPS_PER_S)
    log(f"[time] one decode step of attention ({L} layers, bf16 cache "
        f"T={T_main}, pos={p_main}): kernel {k['ms']:.4f} ms, plain "
        f"{k['plain_ms']:.4f} ms, SDPA(enable_gqa) {k['library_ms']:.4f} ms, "
        f"bound {k['bound_ms']:.4f} ms")
    del cache, kvs

    # ---------------- 4. tiny fixtures ----------------
    fix = os.path.join(ROOT, "tests", "js", "fixtures")
    with open(os.path.join(fix, "expected.json")) as f:
        expected = json.load(f)
    greedy = sampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    tiny = engine.LLMContext.from_bin(
        os.path.join(fix, "tiny_q80.bin"), max_seq_len=64,
        dtype=torch.float32, sampler=greedy)
    assert tiny.device.type == "cuda"
    # rows-form timing at the fixture's per-step shapes
    tiny_calls = []
    for name in ("wqkv", "wo", "w13", "w2"):
        for wl in layer_weights(tiny.params["blocks"][name]):
            tiny_calls.append(wl)
    tiny_calls.append(tiny.params["output_q"])
    xs = [torch.randn(1, wl.in_dim, device=dev, generator=gen)
          for wl in tiny_calls]
    wds = [wl.dequantize(torch.float32) for wl in tiny_calls]
    lib_rows = lib.q80_matmul_rows
    ys = [torch.empty(1, wl.out_dim, device=dev) for wl in tiny_calls]

    def run_rows():
        for wl, x, y in zip(tiny_calls, xs, ys):
            lib_rows(x.data_ptr(), 0, wl.q.data_ptr(), wl.scales.data_ptr(),
                     y.data_ptr(), 0, 1, wl.in_dim, wl.out_dim,
                     wl.group_size, stream())

    def run_rows_plain():
        for wl, x in zip(tiny_calls, xs):
            qmatmul.q80_matmul_rows_plain(x, wl, torch.float32)

    def run_rows_library():
        for x, wd in zip(xs, wds):
            torch.matmul(x, wd.t())

    k = kernels["q80_matmul_rows"]
    k["ms"] = timer(run_rows, reps=100)
    k["plain_ms"] = timer(run_rows_plain, reps=100)
    k["library_ms"] = timer(run_rows_library, reps=100)
    set_bound("q80_matmul_rows",
              sum(wl.q.numel() + wl.scales.numel() * 4 + wl.in_dim * 4
                  + wl.out_dim * 4 for wl in tiny_calls),
              sum(2 * wl.q.numel() for wl in tiny_calls), F32_OPS_PER_S)

    names = list(kernels)
    counters = dict(q80_act_quant=qmatmul.act_quant_q80,
                    q80_matmul_w8a8=qmatmul.q80_w8a8,
                    q80_matmul_rows=qmatmul.q80_matmul_rows,
                    decode_attention=decode_attn.decode_attention,
                    q4k_fake_quant=q4k.fake_quant_act,
                    q4k_matmul=q4k.q4k_matmul_f32)
    assert sorted(counters) == sorted(names)

    def reset():
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0

    def read():
        torch.cuda.synchronize()
        return {n: counters[n].launches for n in names}

    def tiny_stream(ctx, file, want, must_launch):
        reset()
        s = engine.generate_sync(ctx, expected["prompt"], max_new_tokens=16)
        counts = read()
        log(f"[tiny] {file} greedy: {s.output_ids} (expected {want}); "
            f"launches {counts}")
        if s.output_ids != want:
            raise AssertionError(f"{file} greedy stream differs from "
                                 f"expected.json")
        for name in must_launch:
            if counts[name] == 0:
                raise AssertionError(f"{file} path launched no {name}")
        return counts

    tiny_counts = tiny_stream(tiny, "tiny_q80.bin", expected["greedy"]["q80"],
                              ("q80_matmul_rows", "decode_attention"))
    kernels["q80_matmul_rows"]["launches"] = tiny_counts["q80_matmul_rows"]
    tiny4 = engine.LLMContext.from_bin(
        os.path.join(fix, "tiny_q4k.bin"), max_seq_len=64,
        dtype=torch.float32, sampler=greedy)
    head4 = tiny4.params["output_q"]
    assert (isinstance(tiny4.params["blocks"]["w13"], q4k.Q4KTensor)
            and isinstance(head4, qmatmul.Q80Tensor)
            and head4.group_size == 64 and not head4.w8a8)
    tiny_stream(tiny4, "tiny_q4k.bin", expected["greedy"]["q4k"],
                ("q4k_matmul", "q4k_fake_quant", "q80_matmul_rows",
                 "decode_attention"))
    del tiny, tiny4

    # ---------------- 5. full width ----------------
    tok = TrieTokenizer()
    tok.build_preset(32768)
    prng = np.random.default_rng(SEED + 1)
    prompts = [prng.integers(100, 30000, n).tolist() for n in (17, 40, 100)]
    budgets = (64, 128, 64)
    prompt = prng.integers(100, 30000, PROMPT_LEN).tolist()
    profile_keys = (("w8a8_kernel", "q80_matmul_w8a8"),
                    ("act_quant_kernel", "q80_act_quant"),
                    ("decode_attn_kernel", "decode_attention"),
                    ("q4k_mat", "q4k_matmul"),      # matvec (B=1), matmul
                    ("fake_quant_kernel", "q4k_fake_quant"),
                    ("rows_kernel", "q80_matmul_rows"))

    def drive(label, p, expect):
        """3 requests, then generate_on_device(prompt, N_TOKENS) with its
        launch counts held to `expect`, then a profile of 32 decode steps.
        -> (ctx, generated ids, launches of the requests + the run)."""
        ctx = engine.LLMContext(
            cfg=cfg, params=p, tokenizer=tok, max_seq_len=cfg.block_size,
            device=dev, dtype=torch.bfloat16, sampler=greedy,
            stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")
        engine.generate_on_device(ctx, prompts[0][:8], 4)       # warm-up
        reset()
        t0 = time.time()
        for pr, m in zip(prompts, budgets):
            parts = []
            sess = engine.generate_sync(
                ctx, "", max_new_tokens=m, prompt_ids=pr,
                on_decoding=lambda _s, _t, text: parts.append(text))
            log(f"[full {label}] request prompt {len(pr)} tokens -> "
                f"{len(sess.output_ids)} tokens (budget {m}), "
                f"{len(''.join(parts))} characters streamed, first ids "
                f"{sess.output_ids[:8]}, {sess.tps:.1f} tok/s")
            if not sess.output_ids or max(sess.output_ids) >= cfg.vocab_size:
                raise AssertionError("request produced no or out-of-range "
                                     "tokens")
        req_counts = read()
        log(f"[full {label}] 3 requests in {time.time() - t0:.2f} s; "
            f"launches {req_counts}")

        torch.cuda.synchronize()
        t0 = time.time()
        first = engine.generate_on_device(ctx, prompt, 1)
        ttft_ms = (time.time() - t0) * 1e3
        reset()
        t0 = time.time()
        out = engine.generate_on_device(ctx, prompt, N_TOKENS)
        torch.cuda.synchronize()
        t_all = time.time() - t0
        god_counts = read()
        decode_tok_s = (N_TOKENS - 1) / max(t_all - ttft_ms / 1e3, 1e-9)
        log(f"[full {label}] generate_on_device prompt {PROMPT_LEN}, "
            f"{N_TOKENS} greedy tokens on {card}: TTFT {ttft_ms:.2f} ms, "
            f"total {t_all:.3f} s, decode {decode_tok_s:.2f} tok/s; first "
            f"ids {out[:8].tolist()}")
        if out.shape != (N_TOKENS,) or out[0] != first[0]:
            raise AssertionError("generate_on_device output malformed")
        log(f"[full {label}] launches {god_counts}; expected {expect}")
        if god_counts != expect:
            raise AssertionError("launch counts differ from the per-step "
                                 "counts")

        # where a decode step's time goes: torch.profiler over 32 steps of
        # the same path (kernel time on the card vs the host's wall clock)
        from torch.profiler import ProfilerActivity, profile
        pcache = ctx.new_cache(1, seq_len=T_main)
        pgen = ctx.generator()
        ptok, pseen = engine._prefill_first_token(ctx, prompt, pcache, pgen)
        torch.cuda.synchronize()
        n_prof = 32
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for i in range(n_prof):
                ptok = engine._decode_step(ctx, ptok, PROMPT_LEN + i, pcache,
                                           pseen, pgen)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3 / n_prof
        groups = {name: 0.0 for _, name in profile_keys
                  if expect.get(name)}
        groups["other"] = 0.0
        n_kernels = 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", 0.0)
            n_kernels += e.count
            key = next((name for sub, name in profile_keys
                        if sub in e.key and name in groups), "other")
            groups[key] += us / 1e3 / n_prof
        busy_ms = sum(groups.values())
        if busy_ms > 0:
            log(f"[profile {label}] decode step (profiler on, {n_prof} "
                f"steps, {card}): wall {wall_ms:.3f} ms, card busy "
                f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
                f"{n_kernels / n_prof:.0f} kernels per step; busy ms per "
                f"step by kernel: "
                + ", ".join(f"{k} {v:.3f}" for k, v in groups.items()))
        else:
            log(f"[profile {label}] the profiler recorded no device time: "
                f"not measured")
        del pcache
        return ctx, out, {n: req_counts[n] + god_counts[n] for n in names}

    n_steps = N_TOKENS - 1
    expect80 = {n: 0 for n in names}
    expect80.update(q80_act_quant=113 * N_TOKENS,
                    q80_matmul_w8a8=113 * N_TOKENS,
                    decode_attention=28 * n_steps)
    log("[full Q80] expected launches: 113 Q80 matmuls = 4 x 28 + head per "
        "forward, 28 attentions per decode step")
    _, out80, counts80 = drive("Q80", params, expect80)
    for name in ("q80_act_quant", "q80_matmul_w8a8", "decode_attention"):
        kernels[name]["launches"] = counts80[name]
        if counts80[name] == 0:
            raise AssertionError(f"main path launched no {name}")

    expect4 = {n: 0 for n in names}
    expect4.update(q4k_matmul=112 * N_TOKENS, q4k_fake_quant=113 * N_TOKENS,
                   q80_act_quant=N_TOKENS, q80_matmul_w8a8=N_TOKENS,
                   decode_attention=28 * n_steps)
    log("[full Q4K] expected launches: 112 Q4K matmuls = 4 x 28 per forward, "
        "113 fake-quants (one before each and before the requantized Q80 "
        "head), one W8A8 head, 28 attentions per decode step")
    _, out4, counts4 = drive("Q4K", params4, expect4)
    for name in ("q4k_matmul", "q4k_fake_quant"):
        kernels[name]["launches"] = counts4[name]
        if counts4[name] == 0:
            raise AssertionError(f"Q4K path launched no {name}")

    # first-step logits, kernels on the card vs plain versions on the CPU
    # (weights moved to the CPU), both in the f32 oracle dtype.
    # (a) layer by layer: each layer of the CPU run takes the card's input
    #     to that layer, so every layer, the final norm and the head are
    #     held at full width.  A quantized activation flips a rounding
    #     decision now and then where an f32 sum taken in another order
    #     crosses a rounding edge, and the next matmul then sees an input a
    #     quantization step apart.  W8A8: tolerance 4/127 (four int8 steps);
    #     Q4K: 1/15 (one 4-bit step of a group's range).  The same layers
    #     with no activation quantization (Q80 rows form; K3 on the
    #     unquantized activation and a rows-form head) must agree to 1e-4.
    # (b) end to end: over 28 random layers those flips compound, so the
    #     argmax must agree and the error is reported.
    f32 = torch.float32
    rope_g = gpt.precompute_rope(cfg.head_dim, 128, cfg.rope_theta, dev)
    rope_c = tuple(r.cpu() for r in rope_g)
    ids = torch.tensor([prompt], dtype=torch.int64)

    def rows_form(p):
        """The same weights (shared storage) with every Q80 tensor in the
        rows form."""
        conv = lambda v: (replace(v, w8a8=False)
                          if isinstance(v, qmatmul.Q80Tensor) else v)
        out = {**p, "blocks": {k: conv(v) for k, v in p["blocks"].items()},
               "tok_embeddings": conv(p["tok_embeddings"])}
        out["output_q"] = (out["tok_embeddings"]
                           if p["output_q"] is p["tok_embeddings"]
                           else conv(p["output_q"]))
        return out

    def pad_only(x2d):
        """The activation as K3 takes it, without the fake-quant."""
        n = x2d.shape[1]
        xp = torch.zeros(x2d.shape[0], -(-n // 256) * 256,
                         dtype=torch.float32, device=x2d.device)
        xp[:, :n] = x2d
        return xp

    @contextlib.contextmanager
    def fake_quant(on):
        saved = q4k.fake_quant_act
        if not on:
            q4k.fake_quant_act = gpt.fake_quant_act = pad_only
        try:
            yield
        finally:
            q4k.fake_quant_act = gpt.fake_quant_act = saved

    def layer_by_layer(gp, cp, tokens, start, caches, last):
        """-> (worst per-layer relative error, logits rel error, logits)."""
        S = tokens.shape[1]
        h = gpt.embed_tokens(gp, tokens.to(dev), f32)
        worst = ((h.cpu() - gpt.embed_tokens(cp, tokens, f32)).abs().max()
                 / h.abs().max()).item()
        per_dev = []
        for p, d, rope in ((gp, dev, rope_g), (cp, "cpu", rope_c)):
            cos, sin = rope[0][start:start + S], rope[1][start:start + S]
            mask = pos_t = None
            if S > 1:
                j = torch.arange(start + S, device=d)[None, :]
                seen = j <= start + torch.arange(S, device=d)[:, None]
                mask = torch.where(seen, 0.0, -float("inf"))
            else:
                pos_t = torch.full((1,), start, dtype=torch.int32, device=d)
            per_dev.append((p, cos, sin, mask, pos_t))
        attn_len = start + S if S > 1 else None
        for i in range(L):
            outs = []
            for (p, cos, sin, mask, pos_t), c, x in zip(
                    per_dev, caches, (h, h.cpu())):
                outs.append(gpt.block(
                    x, gpt.layer_params(p["blocks"], i), cfg, cos, sin, mask,
                    f32, c.layer(i), start, pos_t, attn_len))
            worst = max(worst, ((outs[0].cpu() - outs[1]).abs().max()
                                / outs[1].abs().max()).item())
            h = outs[0]
        hn = gpt.rms_norm(h, gp["norm"], cfg.norm_eps)[:, last:last + 1]
        lg = gpt.compute_logits(hn, gp, f32)[0, 0].cpu()
        lc = gpt.compute_logits(hn.cpu(), cp, f32)[0, 0]
        return worst, ((lg - lc).abs().max() / lc.abs().max()).item(), lg

    def first_steps(p, device, dtype, first_tok):
        c = gpt.KVCache.create(cfg, 1, 128, dtype, device)
        rope = tuple(r.to(device) for r in rope_c)
        l0, _ = gpt.forward_with_cache(p, ids.to(device), c, 0, cfg, dtype,
                                       attn_len=PROMPT_LEN,
                                       last_idx=PROMPT_LEN - 1, rope=rope)
        t = torch.tensor([[first_tok]], device=device)
        l1, _ = gpt.forward_with_cache(p, t, c, PROMPT_LEN, cfg, dtype,
                                       rope=rope)
        return l0[0, 0].float().cpu(), l1[0, 0].float().cpu()

    def logits_checks(label, gp, forms, out):
        t0 = time.time()
        cpu_p = params_to(gp, "cpu")
        for form, conv, fq_on, tol in forms:
            caches = (gpt.KVCache.create(cfg, 1, 128, f32, dev),
                      gpt.KVCache.create(cfg, 1, 128, f32, "cpu"))
            with fake_quant(fq_on):
                w0, r0, lg0 = layer_by_layer(conv(gp), conv(cpu_p), ids, 0,
                                             caches, PROMPT_LEN - 1)
                nxt = torch.tensor([[int(lg0.argmax())]])
                w1, r1, _ = layer_by_layer(conv(gp), conv(cpu_p), nxt,
                                           PROMPT_LEN, caches, 0)
            for tag, w, r in (("prefill", w0, r0), ("decode step 1", w1, r1)):
                log(f"[full {label}] {tag}, {form}, layer by layer (same "
                    f"input to each layer): worst layer max|d|/max|ref| "
                    f"{w:.3e} (tol {tol:.3e}), logits {r:.3e} (tol "
                    f"{tol:.3e})")
                if not (w <= tol and r <= tol and torch.isfinite(lg0).all()):
                    raise AssertionError(f"{label} {tag}, {form}: kernels "
                                         f"disagree with the plain versions")
        g0, g1 = first_steps(gp, dev, f32, int(out[0]))
        b0, b1 = first_steps(gp, dev, torch.bfloat16, int(out[0]))
        c0, c1 = first_steps(cpu_p, "cpu", f32, int(out[0]))
        del cpu_p
        for tag, g, c, b in (("prefill", g0, c0, b0),
                             ("decode step 1", g1, c1, b1)):
            rel = ((g - c).abs().max() / c.abs().max()).item()
            rel16 = ((b - c).abs().max() / c.abs().max()).item()
            log(f"[full {label}] {tag} logits end to end, f32 kernels vs "
                f"f32 plain on CPU: max|d|/max|ref| {rel:.3e}, argmax "
                f"{int(g.argmax())} vs {int(c.argmax())} (must agree); bf16 "
                f"main path {rel16:.3e}, argmax {int(b.argmax())}")
            if not (torch.isfinite(g).all() and g.shape == (cfg.vocab_size,)
                    and int(g.argmax()) == int(c.argmax())):
                raise AssertionError(f"{label} {tag} logits disagree with "
                                     f"the plain versions")
        if int(b0.argmax()) != int(out[0]):
            raise AssertionError(f"{label}: bf16 first token differs from "
                                 f"generate_on_device")
        log(f"[full {label}] logits checks {time.time() - t0:.1f} s")

    same = lambda p: p
    logits_checks("Q80", params, [("W8A8 form", same, True, 4 / 127),
                                  ("rows form", rows_form, True, 1e-4)],
                  out80)
    del params
    logits_checks("Q4K", params4,
                  [("Q4K with activation fake-quant", same, True, 1 / 15),
                   ("Q4K without activation fake-quant, rows-form head",
                    rows_form, False, 1e-4)], out4)

    # ---------------- result ----------------
    for k in kernels.values():
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"):
            if k[key] is not None:
                k[key] = float(k[key])
        lib_ms = ("none" if k["library_ms"] is None
                  else f"{k['library_ms']:.4f} ms")
        log(f"[summary] {k['name']}: {k['launches']} launches, max_abs_err "
            f"{k['max_abs_err']:.3e}; per decode step {k['ms']:.4f} ms, plain "
            f"{k['plain_ms']:.4f} ms, library {lib_ms}, bound "
            f"{k['bound_ms']:.6f} ms ({k['bound_by']})")
    log(f"[done] {time.time() - t_start:.1f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
