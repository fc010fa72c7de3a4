#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nano_tpu_torch) on one NVIDIA GPU.

Run from the repository root:   python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

  1. environment  card name and power limit, torch / CUDA / nvcc versions
  2. build        nvcc builds nano_tpu_torch/csrc/*.cu into
                  build/torch_kernels/ (one process per source, in parallel)
  3. kernels      each kernel against its plain PyTorch version on the
                  card, at the main path's shapes (the five Q80 matmuls of
                  the Qwen3-0.6B shape at B=1 and B=64, decode attention
                  over bf16 and int8 caches), and timed: kernel, plain
                  version, one PyTorch library call as a yardstick, and the
                  least time the card needs for the bytes and operations
  4. tiny fixture tests/js/fixtures/tiny_q80.bin, greedy through
                  generate_sync, must give expected.json's stream
  5. full width   a Qwen3-0.6B-shaped Q80 model (group size 256, random
                  weights from a seed, 28 layers): 3 requests through
                  generate_sync, generate_on_device with a 64-token prompt
                  and 256 greedy tokens (TTFT, decode tok/s), first-step
                  logits against the plain versions on the CPU, and the
                  launch count of every kernel on the path

The last two lines of stdout are one JSON object listing the kernels and
then {"ok": true, "device": {...}}.  Without a CUDA device the script
exits non-zero before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

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


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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

    L, E, F, V = cfg.n_layer, cfg.n_embd, cfg.n_hidden, cfg.vocab_size
    HD, KVD, D = cfg.n_head * cfg.head_dim, cfg.n_kv_head * cfg.head_dim, \
        cfg.head_dim
    ones = lambda *s: torch.ones(*s, device=device)
    blocks = {"attn_norm": ones(L, E), "ffn_norm": ones(L, E),
              "q_norm": ones(L, D), "k_norm": ones(L, D),
              "wqkv": qt(L, HD + 2 * KVD, E), "wo": qt(L, E, HD),
              "w13": qt(L, 2 * F, E), "w2": qt(L, E, F)}
    tok = qt(V, E)
    return {"tok_embeddings": tok, "output_q": tok, "norm": ones(E),
            "blocks": blocks}


def params_to(params, device):
    from nano_tpu_torch.ops.qmatmul import Q80Tensor
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = params_to(v, device)
        else:
            out[k] = v.to(device)
    if out.get("output_q") is not None and isinstance(
            params["tok_embeddings"], Q80Tensor):
        out["output_q"] = out["tok_embeddings"]
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.ops import _build, decode_attn, qmatmul, sampling
    from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    import torch.nn.functional as F

    t_start = time.time()
    timer = Timer(torch)
    dev = torch.device("cuda")

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
    L = cfg.n_layer
    blocks = params["blocks"]
    head = params["output_q"]
    # the five Q80 matmuls of a forward: (name, stacked or single weight)
    shapes = [("wqkv", blocks["wqkv"]), ("wo", blocks["wo"]),
              ("w13", blocks["w13"]), ("w2", blocks["w2"]), ("head", head)]

    # ---------------- 3. kernels vs plain ----------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = {}

    def q80_entry(name, replaces, source):
        kernels[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, launches=0, max_abs_err=0.0,
                             ms=0.0, plain_ms=0.0, bound_ms=0.0,
                             bound_by="bytes", library_ms=0.0)

    q80_entry("q80_act_quant", "nano_tpu/ops/qmatmul.py:250",
              "nano_tpu_torch/csrc/q80_matmul.cu")
    q80_entry("q80_matmul_w8a8", "nano_tpu/ops/qmatmul.py:268",
              "nano_tpu_torch/csrc/q80_matmul.cu")
    q80_entry("q80_matmul_rows", "nano_tpu/ops/qmatmul.py:129",
              "nano_tpu_torch/csrc/q80_matmul.cu")
    q80_entry("decode_attention", "nano_tpu/ops/decode_attn.py:45",
              "nano_tpu_torch/csrc/decode_attn.cu")

    def layer_weights(w):
        return ([w.layer(i) for i in range(w.q.shape[0])] if w.q.dim() == 3
                else [w])

    for B in (1, 64):
        for name, w in shapes:
            w0 = layer_weights(w)[0]
            K, N = w0.in_dim, w0.out_dim
            x = torch.randn(B, K, device=dev, generator=gen).to(torch.bfloat16)
            kq, ks = qmatmul.act_quant_q80(x, GS)
            pq, ps = qmatmul.act_quant_q80_plain(x, GS)
            aerr = max((kq.int() - pq.int()).abs().max().item(),
                       (ks - ps).abs().max().item())
            kernels["q80_act_quant"]["max_abs_err"] = max(
                kernels["q80_act_quant"]["max_abs_err"], aerr)
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
            kernels["q80_matmul_w8a8"]["max_abs_err"] = max(
                kernels["q80_matmul_w8a8"]["max_abs_err"], err)

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
        kernels["q80_matmul_rows"]["max_abs_err"] = max(
            kernels["q80_matmul_rows"]["max_abs_err"], err)

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
                kernels["decode_attention"]["max_abs_err"] = max(
                    kernels["decode_attention"]["max_abs_err"], err)

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
                              1, wl.in_dim, GS,
                              torch.cuda.current_stream().cuda_stream)

    def run_w8a8():
        for wl, x, xq, sa, y, _ in step_calls:
            lib.q80_matmul_w8a8(xq.data_ptr(), sa.data_ptr(), wl.q.data_ptr(),
                                wl.scales.data_ptr(), y.data_ptr(), 1, 1,
                                wl.in_dim, wl.out_dim, GS,
                                torch.cuda.current_stream().cuda_stream)

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
    act_bytes = sum(wl.in_dim * 2 + wl.in_dim + wl.in_dim // GS * 4
                    for wl, *_ in step_calls)
    act_ops = sum(3 * wl.in_dim for wl, *_ in step_calls)
    k["bound_ms"] = max(act_bytes / HBM_BYTES_PER_S, act_ops / F32_OPS_PER_S) * 1e3
    k["bound_by"] = ("bytes" if act_bytes / HBM_BYTES_PER_S
                     >= act_ops / F32_OPS_PER_S else "operations")

    k = kernels["q80_matmul_w8a8"]
    k["ms"] = timer(run_w8a8)
    k["plain_ms"] = timer(run_w8a8_plain)
    k["library_ms"] = timer(run_w8a8_library)
    mm_bytes = sum(wl.q.numel() + wl.scales.numel() * 4 + wl.in_dim
                   + wl.in_dim // GS * 4 + wl.out_dim * 2
                   for wl, *_ in step_calls)
    mm_ops = sum(2 * wl.q.numel() for wl, *_ in step_calls)
    k["bound_ms"] = max(mm_bytes / HBM_BYTES_PER_S, mm_ops / INT8_OPS_PER_S) * 1e3
    k["bound_by"] = ("bytes" if mm_bytes / HBM_BYTES_PER_S
                     >= mm_ops / INT8_OPS_PER_S else "operations")
    log(f"[time] one decode step (B=1, {len(step_calls)} matmuls): "
        f"act_quant {kernels['q80_act_quant']['ms']:.4f} ms, w8a8 "
        f"{k['ms']:.4f} ms (bound {k['bound_ms']:.4f} ms for "
        f"{mm_bytes / 1e6:.1f} MB), bf16 torch.matmul on pre-dequantized "
        f"weights {k['library_ms']:.4f} ms")
    del step_calls

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
    at_bytes = L * (2 * rows * KV * D * 2 + H * D * 4 + H * D * 4)
    at_ops = L * (4 * rows * H * D)
    k["bound_ms"] = max(at_bytes / HBM_BYTES_PER_S, at_ops / F32_OPS_PER_S) * 1e3
    k["bound_by"] = ("bytes" if at_bytes / HBM_BYTES_PER_S
                     >= at_ops / F32_OPS_PER_S else "operations")
    log(f"[time] one decode step of attention ({L} layers, bf16 cache "
        f"T={T_main}, pos={p_main}): kernel {k['ms']:.4f} ms, plain "
        f"{k['plain_ms']:.4f} ms, SDPA(enable_gqa) {k['library_ms']:.4f} ms, "
        f"bound {k['bound_ms']:.4f} ms")
    del cache, kvs

    # ---------------- 4. tiny fixture ----------------
    fix = os.path.join(ROOT, "tests", "js", "fixtures")
    with open(os.path.join(fix, "expected.json")) as f:
        expected = json.load(f)
    tiny = engine.LLMContext.from_bin(
        os.path.join(fix, "tiny_q80.bin"), max_seq_len=64,
        dtype=torch.float32,
        sampler=sampling.SamplerConfig(temperature=0.0,
                                       repetition_penalty=1.0))
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
                     wl.group_size, torch.cuda.current_stream().cuda_stream)

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
    rw_bytes = sum(wl.q.numel() + wl.scales.numel() * 4 + wl.in_dim * 4
                   + wl.out_dim * 4 for wl in tiny_calls)
    rw_ops = sum(2 * wl.q.numel() for wl in tiny_calls)
    k["bound_ms"] = max(rw_bytes / HBM_BYTES_PER_S, rw_ops / F32_OPS_PER_S) * 1e3
    k["bound_by"] = ("bytes" if rw_bytes / HBM_BYTES_PER_S
                     >= rw_ops / F32_OPS_PER_S else "operations")

    counters = [qmatmul.act_quant_q80, qmatmul.q80_w8a8,
                qmatmul.q80_matmul_rows, decode_attn.decode_attention]
    names = ["q80_act_quant", "q80_matmul_w8a8", "q80_matmul_rows",
             "decode_attention"]

    def reset():
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0

    def read():
        torch.cuda.synchronize()
        return dict(zip(names, (c.launches for c in counters)))

    reset()
    s = engine.generate_sync(tiny, expected["prompt"], max_new_tokens=16)
    tiny_counts = read()
    want = expected["greedy"]["q80"]
    log(f"[tiny] tiny_q80.bin greedy: {s.output_ids} (expected {want}); "
        f"launches {tiny_counts}")
    if s.output_ids != want:
        raise AssertionError("tiny_q80.bin greedy stream differs from "
                             "expected.json")
    for name in ("q80_matmul_rows", "decode_attention"):
        if tiny_counts[name] == 0:
            raise AssertionError(f"tiny fixture path launched no {name}")
    kernels["q80_matmul_rows"]["launches"] = tiny_counts["q80_matmul_rows"]

    # ---------------- 5. full width ----------------
    tok = TrieTokenizer()
    tok.build_preset(32768)
    ctx = engine.LLMContext(
        cfg=cfg, params=params, tokenizer=tok, max_seq_len=cfg.block_size,
        device=dev, dtype=torch.bfloat16,
        sampler=sampling.SamplerConfig(temperature=0.0,
                                       repetition_penalty=1.0),
        stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")
    prng = np.random.default_rng(SEED + 1)
    prompts = [prng.integers(100, 30000, n).tolist() for n in (17, 40, 100)]
    budgets = (64, 128, 64)

    engine.generate_on_device(ctx, prompts[0][:8], 4)       # warm-up
    reset()
    t0 = time.time()
    for p, m in zip(prompts, budgets):
        parts = []
        sess = engine.generate_sync(
            ctx, "", max_new_tokens=m, prompt_ids=p,
            on_decoding=lambda _s, _t, text: parts.append(text))
        log(f"[full] request prompt {len(p)} tokens -> {len(sess.output_ids)} "
            f"tokens (budget {m}), {len(''.join(parts))} characters "
            f"streamed, first ids {sess.output_ids[:8]}, "
            f"{sess.tps:.1f} tok/s")
        if not sess.output_ids or max(sess.output_ids) >= cfg.vocab_size:
            raise AssertionError("request produced no or out-of-range tokens")
    req_counts = read()
    log(f"[full] 3 requests in {time.time() - t0:.2f} s; launches {req_counts}")

    prompt = prng.integers(100, 30000, PROMPT_LEN).tolist()
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
    log(f"[full] generate_on_device prompt {PROMPT_LEN}, {N_TOKENS} greedy "
        f"tokens on {card}: TTFT {ttft_ms:.2f} ms, total {t_all:.3f} s, "
        f"decode {decode_tok_s:.2f} tok/s; first ids {out[:8].tolist()}")
    if out.shape != (N_TOKENS,) or out[0] != first[0]:
        raise AssertionError("generate_on_device output malformed")
    n_steps = N_TOKENS - 1
    expect = {"q80_act_quant": 113 * N_TOKENS, "q80_matmul_w8a8": 113 * N_TOKENS,
              "q80_matmul_rows": 0, "decode_attention": 28 * n_steps}
    log(f"[full] launches {god_counts}; expected {expect} (113 Q80 matmuls = "
        f"4 x 28 + head per forward, 28 attentions per decode step)")
    if god_counts != expect:
        raise AssertionError("launch counts differ from the per-step counts")
    for name in ("q80_act_quant", "q80_matmul_w8a8", "decode_attention"):
        kernels[name]["launches"] = req_counts[name] + god_counts[name]
        if kernels[name]["launches"] == 0:
            raise AssertionError(f"main path launched no {name}")

    # where a decode step's time goes: torch.profiler over 32 steps of the
    # same path (kernel time on the card vs the host's wall clock)
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
    groups = {"q80_matmul_w8a8": 0.0, "q80_act_quant": 0.0,
              "decode_attention": 0.0, "other": 0.0}
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        n_kernels += e.count
        key = ("q80_matmul_w8a8" if "w8a8_kernel" in e.key else
               "q80_act_quant" if "act_quant_kernel" in e.key else
               "decode_attention" if "decode_attn_kernel" in e.key else
               "other")
        groups[key] += us / 1e3 / n_prof
    busy_ms = sum(groups.values())
    if busy_ms > 0:
        log(f"[profile] decode step (profiler on, {n_prof} steps, {card}): "
            f"wall {wall_ms:.3f} ms, card busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / wall_ms:.3f}, {n_kernels / n_prof:.0f} kernels "
            f"per step; busy ms per step by kernel: "
            + ", ".join(f"{k} {v:.3f}" for k, v in groups.items()))
    else:
        log("[profile] the profiler recorded no device time: not measured")
    del pcache

    # first-step logits, kernels on the card vs plain versions on the CPU
    # (weights moved to the CPU), both in the f32 oracle dtype.
    # (a) layer by layer: each layer of the CPU run takes the card's input
    #     to that layer, so every layer, the final norm and the head are
    #     held at full width.  In the W8A8 form an f32 sum taken in another
    #     order flips an int8 rounding now and then, and the next matmul
    #     then sees inputs a quantization step apart, so its tolerance is
    #     4/127 (four steps); the same layers with the weights in the rows
    #     form (f32 dequant, no activation quantization) must agree to 1e-4.
    # (b) end to end: over 28 random layers those flips compound, so the
    #     argmax must agree and the error is reported.
    f32 = torch.float32
    cpu_params = params_to(params, "cpu")
    rope_g = gpt.precompute_rope(cfg.head_dim, 128, cfg.rope_theta, dev)
    rope_c = tuple(r.cpu() for r in rope_g)
    ids = torch.tensor([prompt], dtype=torch.int64)
    t0 = time.time()

    def rows_form(p):
        """The same weights (shared storage) in the rows form."""
        from dataclasses import replace
        blocks = {k: (replace(v, w8a8=False)
                      if isinstance(v, qmatmul.Q80Tensor) else v)
                  for k, v in p["blocks"].items()}
        tok = replace(p["tok_embeddings"], w8a8=False)
        return {**p, "blocks": blocks, "tok_embeddings": tok, "output_q": tok}

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

    for form, gp, cp, tol in (("W8A8", params, cpu_params, 4 / 127),
                              ("rows", rows_form(params),
                               rows_form(cpu_params), 1e-4)):
        caches = (gpt.KVCache.create(cfg, 1, 128, f32, dev),
                  gpt.KVCache.create(cfg, 1, 128, f32, "cpu"))
        w0, r0, lg0 = layer_by_layer(gp, cp, ids, 0, caches, PROMPT_LEN - 1)
        nxt = torch.tensor([[int(lg0.argmax())]])
        w1, r1, _ = layer_by_layer(gp, cp, nxt, PROMPT_LEN, caches, 0)
        for tag, w, r in (("prefill", w0, r0), ("decode step 1", w1, r1)):
            log(f"[full] {tag}, {form} form, layer by layer (same input to "
                f"each layer): worst layer max|d|/max|ref| {w:.3e} (tol "
                f"{tol:.3e}), logits {r:.3e} (tol {tol:.3e})")
            if not (w <= tol and r <= tol and torch.isfinite(lg0).all()):
                raise AssertionError(f"{tag}, {form}: kernels disagree with "
                                     f"the plain versions")

    def first_steps(p, device, dtype):
        c = gpt.KVCache.create(cfg, 1, 128, dtype, device)
        rope = tuple(r.to(device) for r in rope_c)
        l0, _ = gpt.forward_with_cache(p, ids.to(device), c, 0, cfg, dtype,
                                       attn_len=PROMPT_LEN,
                                       last_idx=PROMPT_LEN - 1, rope=rope)
        t = torch.tensor([[int(out[0])]], device=device)
        l1, _ = gpt.forward_with_cache(p, t, c, PROMPT_LEN, cfg, dtype,
                                       rope=rope)
        return l0[0, 0].float().cpu(), l1[0, 0].float().cpu()

    g0, g1 = first_steps(params, dev, f32)
    b0, b1 = first_steps(params, dev, torch.bfloat16)
    c0, c1 = first_steps(cpu_params, "cpu", f32)
    del cpu_params
    for tag, g, c, b in (("prefill", g0, c0, b0), ("decode step 1", g1, c1, b1)):
        rel = ((g - c).abs().max() / c.abs().max()).item()
        rel16 = ((b - c).abs().max() / c.abs().max()).item()
        log(f"[full] {tag} logits end to end, f32 kernels vs f32 plain on "
            f"CPU: max|d|/max|ref| {rel:.3e}, argmax {int(g.argmax())} vs "
            f"{int(c.argmax())} (must agree); bf16 main path {rel16:.3e}, "
            f"argmax {int(b.argmax())}")
        if not (torch.isfinite(g).all() and g.shape == (cfg.vocab_size,)
                and int(g.argmax()) == int(c.argmax())):
            raise AssertionError(f"{tag} logits disagree with the plain "
                                 f"versions")
    if int(b0.argmax()) != int(out[0]):
        raise AssertionError("bf16 first token differs from generate_on_device")
    log(f"[full] logits checks {time.time() - t0:.1f} s")

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
