#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nano_tpu_torch) on one NVIDIA GPU.

Run from the repository root:   python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

  1. environment  card name and power limit, torch / CUDA / nvcc versions
  2. build        nvcc builds nano_tpu_torch/csrc/*.cu into
                  build/torch_kernels/ (one process per source, in parallel)
  3. kernels      each kernel against its plain PyTorch version on the
                  card, at the main paths' shapes (the five Q80 matmuls of
                  the Qwen3-0.6B shape at B=1, 8, 64 and 65 through the
                  int8 tensor-core kernel, two runs bit-equal, decode attention
                  over bf16 and int8 caches, the Q4K activation fake-quant
                  at widths 1024/2048/3072 and 40/64/128, the four Q4K
                  matmuls at B=1 and B=64 and the tiny fixture's, and the
                  decode kernel with the fake-quant folded in, bit-equal to
                  the two; K3 at B > 1 on the int8 tensor cores: the Q4K
                  activation quantization in integer form torch.equal at
                  B=2, 8, 64, 65, the product within 1e-5 of max|y| at the
                  four matmuls, the tiny widths and in=40 with 0xE pad
                  nibbles, two runs bit-equal; the Q80 decode kernel with the activation
                  quantization folded in at the five products and two small
                  shapes, its int8 row and scales torch.equal to the plain
                  act quant, two runs bit-equal; every row of K1 at B = 8,
                  64, 65 torch.equal to that row through the B = 1 kernel,
                  and every row of decode attention at B = 8 and 64 to
                  that row alone: one order of summation at every batch
                  size; the residual add + RMSNorm and SwiGLU kernels
                  with the Q80 quantization as their epilogue at E = 1024
                  and 2F = 6144, B = 1, 8, 64, 65, bf16 and f32, group
                  sizes 0, 256, 512: the add and SwiGLU torch.equal to the
                  eager ops, the norm torch.equal to the eager ops summed
                  in the kernel's order and within one bf16 ulp of eager
                  rms_norm, int8 rows and scales torch.equal to
                  q80_act_quant of the kernel's own output, a row the same
                  bits alone and in a batch; the Q4K model's final norm
                  with the head's fake-quant as its epilogue,
                  rms_norm_q4k_fq, torch.equal to rms_norm_q80 +
                  q4k_fake_quant), and
                  timed over one decode step's launches (K1 also by
                  product, the fused kernel beside the pair; the pairs of
                  K1 and K3 at B > 1 over a 64-token prefill's 112 layer
                  products, their main path; the norm and SwiGLU kernels
                  over a step's 57 + 28 launches at B = 1, 8 and 64 beside
                  the eager chain they replace): kernel, plain
                  version, one PyTorch library call as a yardstick, and the
                  least time the card needs for the bytes and operations
  4. tiny fixtures tests/js/fixtures/tiny_q80.bin and tiny_q4k.bin, greedy
                  through generate_sync (a graph replay a token) and
                  generate_on_device (graph replays), and both again with
                  spec_k = 7 (verify rounds replayed from their graphs),
                  must give expected.json's streams; tiny_q80.bin through
                  BatchedEngine, joined after two other streams, too
  5. full width   a Qwen3-0.6B-shaped Q80 model (group size 256) and a
                  Q4K model (tied head requantized to Q80), random weights
                  from a seed, 28 layers: per model 3 requests through
                  generate_sync, generate_on_device with a 64-token prompt
                  and 256 greedy tokens twice (the first call captures the
                  decode step as a CUDA graph, the second replays it; TTFT,
                  decode tok/s), the launch count of every kernel on the
                  path on both calls, the stream's first EAGER_TOKENS
                  torch.equal to the eager step loop, the stream torch.equal
                  to a graph of GRAPH_STEPS steps, a profile
                  of the eager loop and of the graph (wall and busy ms a
                  step, idle share, kernels a step; each kernel's launches
                  as the profiler saw them held to the per-step counts),
                  and first-step logits against the plain versions on the
                  CPU; then each model's B = 1 decode step and TTFT with
                  the fused norms and SwiGLU and, rebound here, with the
                  eager ops they replaced, in turns in one call
  5b. batching    the Q80 model in BatchedEngine: 8 prompts of 16-64
                  tokens joining 8 steps apart, 128 greedy tokens each,
                  the cache growing 128 -> 256, launch counts exact, one
                  batched step's logits within BATCH_TOL of each slot's
                  single stream; every slot's batched stream fed back a
                  token a step through B = 8 and B = 1 (bf16; the f32
                  witnesses: W8A8, and the rows form with no activation
                  rounding): B = 1 reproduces the single stream up to
                  where they part, the bf16 drift stays below the single
                  stream's own rounding error, the rows-form drift below
                  ROWS_DRIFT_TOL, tokens equal where the margin exceeds
                  the bound; ms per batched step, aggregate tok/s and idle share at
                  8 and 64 slots; and the kernels of one batched step at 8
                  and 64 slots (the W8A8 pair, decode attention per-row
                  positions; K3 at B > 1 and the pair it replaced) beside
                  one library call and the bound; 8 and 64 slots also with
                  the eager norms, SwiGLU and q80_act_quant rebound, in
                  turns in one call; the Q4K model the same
                  way: the same joins, BATCH_NEW4 tokens each, launch
                  counts exact, one batched step's logits within
                  Q4K_BATCH_TOL of each slot's single stream (two faulty
                  B > 1 paths, rebound here, must read above it), and 8
                  and 64 slots timed with its B > 1 products through K3's int8
                  kernels and, rebound here, through the pair they replaced
  5c. speculative decode (spec_phase) on both full-width models:
                  generate_on_device (SPEC_TOKENS tokens) with spec_k =
                  SPEC_K against plain in turns on phase 5's prompt and a repeated 8-token pattern
                  (tok/s, tokens a round, the agreeing prefix, launches of
                  each replayed round asserted), a round's card ms at k = 1,
                  3, 7 beside the plain step's (busy ms by the profiler),
                  verify rounds' logits row by row against the plain
                  step's within SPEC_LOGITS_TOL and a control above it,
                  a Session's k trajectory, BatchedEngine at 8 slots (a
                  sampled slot whose stream must be the plain engine's)
                  and 64, spec against plain in turns, and one 64-slot
                  speculative burst profiled; then on a trained model:
                  tools/make_trained_fixture.py's toy (4 layers, width
                  128, a memorized chorus) trained on the card for 900
                  steps through loss_fn and AdamW (final loss under
                  0.15), written as toy_{f32,q80,q4k}.bin by the port's
                  writer, each served: greedy continues the chorus, and
                  spec_k = 7 gives the plain stream with more than one
                  token a verify round
  6. training     Nano-168M (config/model_168m.json: 24 layers, width 768,
                  16/8 heads of 48) under config/pretrain.json (batch 64 x
                  512, bf16, remat "ffn"), random weights from the config's
                  seed: a corpus under build/ made by repeating
                  dataset/pretrain_sample.txt, tokenized into shards by
                  generate_pretrain_dataset; Trainer init / load_data /
                  start for 12 steps with an eval and a checkpoint at step
                  6; the loss must start at ln 16384 and fall, every
                  attention must go through the flash-attention kernels
                  (launch counts asserted), a second Trainer resumed from
                  the step-12 checkpoint must reproduce step 13's loss bit
                  for bit; ms/step, tokens/s, peak memory and a profile of
                  one step; Nano-56M (config/model_56m.json, heads of 32,
                  config/pretrain_56m.json: batch 64 x 512, bf16, full
                  remat) for 3 steps with its launch counts and a falling
                  loss; and one f32 step (4 layers, batch 2) on the card
                  against the same step on the CPU through the plain versions
  7. export and import (export_phase)
                  7a: phase 6's step-12 Nano-168M checkpoint served by
                  LLMContext.from_checkpoint, exported by
                  nano_tpu_torch.export's main to f32, Q80 (group size 256)
                  and Q4K .bin files, each served by from_bin: the f32
                  stream token-identical to the checkpoint's, the Q80 and
                  Q4K launches exact (K1's W8A8 pair and K3), their
                  first-step logits within EXPORT_LOGITS_TOL of the f32
                  file's, repack f32 -> f32 byte-identical, tok/s and TTFT
                  of each; 7b: Qwen3-0.6B at full width and depth, dense
                  f32 random weights written by write_gguf as Q8_0 and
                  served by from_gguf (wq/wk/wv and w1/w3 fused: 113
                  rows-form launches a step at group size 32, one row
                  through q80_matvec_rows, more through q80_matmul_rows,
                  launches exact), in turns with the same weights unfused
                  through the warp-a-row q80_matmul_rows_warp (197 a step: the
                  "before"); in BatchedEngine at 8 and 64 slots (launches
                  exact, one batched step's logits within GGUF_BATCH_TOL
                  of each slot's single stream beside a control, ms per
                  step, tok/s); the rows form timed over a decode step, 8
                  and 64 slots and a 64-token prefill (old, new, new, old)
                  beside its plain version, bf16 and f32 torch.matmul and
                  the bound; convert_gguf to Q80 at group size 256 served
                  by from_bin through K1's W8A8 pair, the two streams'
                  agreeing prefix
  8. LoRA (lora_phase)
                  8a: phase 5's Q80 model with a random rank-16 adapter
                  written by write_lora: the graph stream torch.equal to
                  the eager step loop, launches exact with and without the
                  adapter (the branch is torch.matmul), a swap to a second
                  adapter under the captured graph giving a fresh
                  context's stream, an unload giving phase 5's stream,
                  decode tok/s with and without the adapter in turns and a
                  profile of each (the branch's busy ms and kernels a
                  step), spec_k = 7 with the adapter; phase 5's Q4K model
                  and phase 7b's GGUF model with the adapter (launches
                  exact, unload gives the base stream); 8b: BatchedEngine
                  at 8 and 64 slots with adapters of ranks 16 and 8 and
                  base slots mixed: one batched step's logits within
                  BATCH_TOL of each slot's single stream with its adapter
                  beside a control (two slots' adapters swapped), ms a
                  step and tok/s beside the engine without adapters in
                  turns; 8c: --merge-lora's f32 export of phase 6's step-12
                  checkpoint served against the checkpoint + adapter (f32
                  logits within MERGE_LOGITS_TOL, a control above it,
                  tokens equal where the margin allows); 8d: a LoRA
                  fine-tune of that checkpoint (LORA_STEPS steps: the held
                  batch's loss falls, the base bit-unchanged, K4 launches
                  exact, ms/step beside phase 6's), its LoRA-only
                  checkpoint served by load_lora_checkpoint
  9. training lifecycle (lifecycle_phase)
                  9a: `python -m nano_tpu_torch.data sft` (its main) makes
                  SFT shards of dataset/sft_*.jsonl (nano_16384, block 512);
                  a Trainer under config/sft.json fine-tunes phase 6's
                  step-12 checkpoint SFT_STEPS steps (masked loss,
                  accumulation 2, full remat; warmup cut to 1): the held
                  batch's loss falls, K4's launches exact, ms/step, tokens/s,
                  peak memory; 9b: the remat policies "full", "ffn", "dots"
                  and "heads" at the pretrain shape (batch 64 x 512, bf16)
                  on the same weights and batches, REMAT_STEPS steps each:
                  step 1's loss torch.equal, the gradient norm within
                  REMAT_NORM_TOL of "full"'s, K4's launches per microbatch
                  exact (48 / 24 under "full" and "dots", 24 / 24 under
                  "ffn" and "heads"), ms/step, busy ms and peak memory; 9c:
                  model_ppl of phase 5c's toy_{f32,q80,q4k}.bin on the card
                  (launches exact) and on the CPU over two spans of its
                  corpus (the fixture's bars, the card within
                  PPL_CARD_CPU_TOL, a planted fault's control beyond it),
                  one 512-token f32 window of phase 5's
                  Q80 model (K1's W8A8 pair and K4 exact, tokens scored/s);
                  9d: run_problem("sort") (>= SORT_MIN_ACC, the JAX soak
                  test's bar) and run_problem("calculator") (K4 at D = 16,
                  launches exact), each exported and served: seq2seq on the
                  sort model, denoise_generate at top_k = 1 twice
 10. parallel (parallel_phase; nano_tpu_torch/parallel)
                  two gloo ranks sharing the card (``parallel.launch``,
                  rank functions parallel_rank / nccl_rank below): 10a
                  serve phase 5's Q80 and Q4K models at TP = 2 (each
                  kernel at its shard shapes): first-step logits against
                  the one-device context within PAR_LOGITS_TOL (control: a
                  planted collective that adds nothing), the agreeing
                  prefix of PAR_TOKENS greedy tokens, every kernel's
                  launches per rank exact, TP decode tok/s (eager: a gloo
                  collective cannot be captured); 10b one NCCL rank decodes
                  the Q80 model from captured graphs with its all-reduces
                  inside, its stream torch.equal to the unsharded graphs'
                  (and TP = 2 over NCCL where the machine has two cards);
                  10c Nano-168M at full width (PAR_LAYERS layers, batch
                  PAR_BATCH x 512, bf16) under {"data": 2} and {"model":
                  2}: PAR_STEPS steps and one resumed step, losses within
                  PAR_LOSS_TOL of one device's, the resume bit-exact, K4's
                  launches per rank exact, ms/step; 10d the same under
                  {"seq": 2} (each rank 256 of the 512 positions, its
                  queries at their offset against the K/V gathered over
                  "seq": K4's offset form) and 10e under {"pipe": 2} (two
                  layers a stage, PAR_MICRO microbatches, GPipe); 10f phase
                  8's rank-16 adapter on the Q80 model at TP = 2 (logits,
                  control, stream, launches as 10a), a BatchedEngine of 4
                  slots with two adapters and the base (each slot's
                  stream its stream alone), and a LoRA fine-tune of 10c's
                  one-device checkpoint at {"model": 2}, losses within
                  PAR_LOSS_TOL of one device's

Phase 3 also holds K1 (q80_matmul_w8a8, every row torch.equal to the
B = 1 kernel's), K3 at B > 1 and the norm kernels at the row counts of a
verify round (SPEC_ROWS: k + 1 and B (k + 1)), and K1's rows form
(q80_matvec_rows at one row, q80_matmul_rows and the warp-a-row
q80_matmul_rows_warp at 1, 8 and 64) at the tiny fixtures' shapes, K = 80
at group size 16, and a Qwen3-0.6B GGUF file's products and head at group
sizes 32 and 16, within 1e-5 of max|y| of the plain version, two runs
bit-equal.

Phase 3 also holds the two flash-attention kernels (forward, backward)
against the plain version at every head width (the Nano-168M, Nano-56M and
Qwen3-0.6B head shapes, D = 32 at Nano-56M's training shape, batch 64 x
512), bf16 and f32, ragged lengths, rep = 1 and rep = 4, two backward runs
bit-equal, and at the training
shape itself (batch 64 x 512, bf16, each of the 24 layers' tensors); the
forward alone (out and the row log-sum-exp the backward reads, two runs
bit-equal) at S = 1, below one tile and at 64 k +- 1; K4's offset form
(OFFSET_CASES: queries at an offset against longer K/V, offsets 0, S / 2
and inside a tile, D = 16 to 128, bf16 and f32, out, lse and the three
gradients, two backward runs bit-equal, the rows of the call on the whole
sequence; in bf16 at D <= 64 each route's forward and backward kernels
alone against the plain version and against each other, two runs
bit-equal), timed at a rank's shapes of 10d, each direction by route;
decode attention at
every D and heads-per-KV-head instance it is built for with f32 and bf16
q, three cache types,
positions that end inside a split or leave splits empty, batch 64, and
two calls on one workspace bit-equal.  It times a training step's 24
forward and 24 backward launches beside the plain version,
scaled_dot_product_attention and the bound, and a decode step's 28
attention launches both on f32 q and as the model feeds them (bf16 q,
result cast to bf16).

`python3 chip_smoke.py bench [flash [clocks]] [routes [clocks]] [decode] [q4k [batched [sweep] |
step] [clocks]] [q80 [batched [sweep] [clocks]]] [pipes] [spec] [toy] [export] [rows [sweep] [clocks]]
[lora] [lifecycle] [parallel] [nccl] [gloo]` runs none of the phases: it times the two
attention kernels alone beside SDPA (the flash forward and backward, a
ladder over the decode kernel's rows per block; `routes` each direction's
routes alone at ROUTE_SHAPES, as `flash` ends), a Q4K decode step's
matmuls with the fake-quant folded in or not, a Q80 decode step's W8A8
products by product, q80_matvec_fq against q80_act_quant +
q80_matmul_w8a8, what an SM sustains of mma.sync and ex2, and with
`clocks` where the attention kernels' warps spend their cycles, for work
on those kernels.  `bench q80 batched` times K1 at B > 1 instead: a batched step's
113 products at 8 and 64 slots and a 64-token prefill's 112, by product,
beside the bf16 torch.matmul and the bound (`sweep`: every work split of
the kernel; `clocks`: where a block's time goes).  `bench q4k batched`
times K3 at B > 1 the same way: a Q4K forward's 112 layer products at 8 and
64 rows, by product, q4k_matmul_w4a4 alone, with q4k_act_quant, the pair it
replaced (q4k_fake_quant + q4k_matmul) and the bf16 torch.matmul, beside
the bound.  `bench q4k clocks` also splits a q4k_matvec_fq launch into its
wait for the activation and the first tile, the dot and the store;
`bench q4k step` drives the Q4K model's decode step and 8 / 64 slots
through entry points every tree of the port has, so that a copy of this
file in an older tree times that tree.  `bench spec` runs phase 5c alone, `bench toy` its trained
toy, `bench export` phase 7 (on an untrained Nano-168M checkpoint), and
`bench lora` phase 8 (on the same, without the GGUF model).
`bench lifecycle` runs phase 9 alone (on a Nano-168M checkpoint of its
initial weights and a freshly trained toy), `bench parallel` phase 10,
`bench nccl` its NCCL part (10b) alone, `bench gloo` reports which
collectives gloo takes on CUDA tensors in the card's torch.  `bench rows` times the rows form (K1 below group size 256) over a
Qwen3-0.6B GGUF model's products at group sizes 32 and 16 as phase 7b
does, on random weights; `sweep` adds every work split of its two kernels
at 1, 8 and 64 rows beside the plan's, `clocks` where a tiled block's time
goes.

The last two lines of stdout are one JSON object listing the kernels and
then {"ok": true, "device": {...}}.  Without a CUDA device the script
exits non-zero before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores

# Qwen3-0.6B (config/model_0.6b.json; tools/bench_stages.py QWEN3_06B)
QWEN3_06B = dict(block_size=1024, vocab_size=151936, n_layer=28,
                 n_embd=1024, n_head=16, n_kv_head=8, n_hidden=3072,
                 head_dim=128, use_qk_norm=True, rope_style="half",
                 rope_theta=1e6, norm_eps=1e-6, tie_embeddings=True)
GS = 256
SEED = 1234
PROMPT_LEN, N_TOKENS = 64, 256
GRAPH_STEPS = 8                    # decode steps in one graph, measured beside 1
# phase 5: tokens of the eager step loop, held to the graphed stream's first
EAGER_TOKENS = 64
BATCH_SLOTS, BATCH_NEW, BATCH_JOIN_EVERY = 8, 128, 8
BATCH_TOL = 1e-3                   # batched vs single-stream logits, of max|logit|
ROWS_DRIFT_TOL = 1e-3              # the same, f32 rows form, after 127 steps fed
TRAIN_STEPS, TRAIN_EVAL_AT = 12, 6
# operations per value of the Q4K fake-quant: max, min, add, divide, the
# two rounding operations, the dequant multiply and subtract
FQ_OPS_PER_VALUE = 8
# of q4k_act_quant: the same without the dequant, and the group sum
AQ_OPS_PER_VALUE = 7
# of rms_norm_q80 with its Q80 epilogue: the residual add, the square and
# its sum, two multiplies, the group's max, the divide, floor and add
NORM_OPS_PER_VALUE = 9
# of swiglu_q80: the negation, exp, add and divide of silu, the product,
# the group's max, the divide, floor and add
SWIGLU_OPS_PER_VALUE = 9
# f32 operations of q4k_matmul_w4a4's combine per (slot, row, group):
# sa * s, then three multiply-adds (sa s P, c m, ba s Q)
W4_COMBINE_OPS = 7
# Q4K batched drive: tokens per stream (the Q80 drive above grows the cache)
BATCH_NEW4 = 32
# batched vs single-stream logits of the Q4K model, of max|logit|: the
# same 4-bit decisions with f32 sums in another order, where one 4-bit step
# could flip as an int8 step can for the Q80 model, so the same limit as
# BATCH_TOL.  It lies between the readings of phase 5b: the sound path
# (0.0 in every run so far) and its two controls, faulty B > 1 paths that
# must read above it (see k3_route)
Q4K_BATCH_TOL = 1e-3
# rows of the products in a speculative verify round: k + 1 for one stream
# (k = 1, 2, 4, 7, 8) and B (k + 1) batched (8 slots at k = 1 and 4, 64 at
# k = 4); phase 3 holds the kernels at these row counts too
SPEC_ROWS = (2, 3, 5, 8, 9, 16, 40, 320)
# phase 5c: the draft caps of generate_on_device, Session and BatchedEngine
SPEC_K, SPEC_SESSION_K, SPEC_BATCH_K = 7, 8, 4
# phase 5c: tokens of each generate_on_device stream, spec and plain
SPEC_TOKENS = 128
# phase 5c: verify rounds of 8 rows held row by row against the plain step
SPEC_LOGIT_ROUNDS = 8
# a verify row's logits against the plain step's at the same prefix, of
# max|logit|, by model: the round attends by einsum where the plain step
# has the decode kernel (both with f32 probabilities, summed in other
# orders), so the bf16 heads differ in an ulp here and there, which the next
# product's activation quantization can turn into a flipped int8 or 4-bit
# step, compounding over 28 random layers.  Each limit lies between the
# reading and its control, the causal mask shifted by one position (each
# row also sees the next row), which must read above it: Q80 0.108 against
# 1.22, Q4K 3.16e-3 against 5.38e-3 on an NVIDIA H100 80GB HBM3 at 700 W
# (its random weights, positive on average, make the model nearly blind
# to which rows it attends: a weak control)
SPEC_LOGITS_TOL = {"Q80": 0.25, "Q4K": 4e-3}
# phase 5c on a trained model: tools/make_trained_fixture.py's recipe
TOY_CHORUS = "滚滚长江东逝水，浪花淘尽英雄。是非成败转头空。"
TOY_N_CHORUS, TOY_SEED, TOY_STEPS, TOY_BATCH = 40, 20260820, 900, 16
TOY_LR, TOY_TARGET_LOSS = 1.5e-3, 0.15
TOY_SPEC_TOKENS = 64
# phase 7: prompt and greedy tokens of every stream
EXPORT_PROMPT, EXPORT_NEW = 64, 64
# phase 7a: the first-step logits of the Q80 and Q4K exports against the f32
# export's, of max|logit|, all three served in bf16.  On Nano-168M's initial
# weights (`bench export`) they read 4.9e-2 (Q80: weights and activations
# rounded to 1/254 of a 256-group's max) and 0.42 (Q4K: 1/15 of a 32-group's
# range, 4-bit activations), compounding through 24 layers; the f32 file's
# own logits at another prompt (the control) read 1.50: a writer that
# misplaces or mis-scales a matrix reads at that level.  Limits 3x and 2x
# the readings, below the control.
EXPORT_LOGITS_TOL = {"Q80": 0.15, "Q4K": 0.8}
# phase 7b: a GGUF model's batched logits (q80_matmul_rows) against each
# slot's single stream (q80_matvec_rows), of max|logit|: the same f32
# dequant with f32 sums in other orders, so the bf16 activations between
# the products differ in an ulp here and there, compounding over 28
# random layers.  At 8 slots it read 1.39e-2 against a control (each
# slot's batched logits against the next slot's single stream: another
# prompt) of 1.32 on an NVIDIA H100 80GB HBM3 at 700 W; the limit is 7x
# the reading and 13x below the control.
GGUF_BATCH_TOL = 0.1
# phase 8: the adapters' rank and alpha (scale 2), the tokens of each
# stream, the LoRA fine-tune's steps and learning rate (an adapter takes a
# larger one than a full fine-tune), and the tokens of its held batch
LORA_RANK, LORA_ALPHA = 16, 32
LORA_NEW = 64
LORA_STEPS, LORA_LR = 6, 2e-3
# phase 8: the --merge-lora f32 export's logits against the base
# checkpoint with the adapter attached, both served in f32, of max|logit|:
# W + s A B folded once in f32 against x W + s (x A) B at every step, the
# same sums rounded in other places over 24 layers.  It read 3.1e-7 on an
# NVIDIA H100 80GB HBM3 at 700 W; the control, the base without the
# adapter, must read above the limit (2.8e-3 with B ~ N(0, 0.01^2), so B is
# drawn at 0.05)
MERGE_LOGITS_TOL = 1e-3
# phase 3: K4's offset form, (B, Sq, Skv, offset, H, KV, D): Nano-168M's
# head shape and D = 128 at offsets 0, S / 2 and inside a 64-row tile, and
# keys past the last query; the wgmma kernels' other widths (32, 64, 16)
# and an odd count of query heads a KV head; one query, and a query tile
# one row short of and past 64, at offsets inside a tile, with 4, 1 and 4
# query heads a KV head
OFFSET_CASES = ((2, 256, 512, 0, 16, 8, 48), (2, 256, 512, 256, 16, 8, 48),
                (2, 256, 512, 77, 16, 8, 48), (2, 200, 512, 131, 16, 8, 48),
                (1, 256, 512, 256, 16, 8, 128), (1, 256, 512, 77, 16, 8, 128),
                (1, 130, 300, 131, 8, 2, 128), (2, 256, 512, 256, 16, 8, 32),
                (2, 100, 300, 37, 8, 2, 64), (2, 37, 200, 5, 4, 1, 16),
                (1, 130, 300, 131, 6, 2, 48), (2, 1, 300, 299, 8, 2, 32),
                (2, 63, 300, 100, 8, 8, 64), (2, 65, 400, 200, 16, 4, 16))
# phase 9: SFT steps on phase 6's step-12 checkpoint (config/sft.json,
# warmup cut to 1 step so that a few steps move the held batch), steps of
# each remat policy, and the problems' sizes (the sort run is the JAX
# package's soak test, tests/test_problems.py, which must reach
# SORT_MIN_ACC; the calculator's is cut to fit the phase's time)
SFT_STEPS = 4
REMAT_POLICIES = ("full", "ffn", "dots", "heads")
REMAT_STEPS = 2
REMAT_NORM_TOL = 1e-5
SORT_RUN = dict(seq_length=4, max_steps=800, batch_size=64, n_train=8000,
                n_val=500, n_eval=300, learning_rate=2e-3, dtype="float32")
SORT_MIN_ACC = 0.9
CALC_RUN = dict(max_steps=300, batch_size=64, n_train=4000, n_val=200,
                n_eval=300, learning_rate=1e-3, dtype="bfloat16")
# phase 9c: the PPL bars of tests/test_trained_fixture.py on the toy's
# first PPL_CHARS characters, and the card's PPL against the CPU plain
# versions' (relative) on those and the next PPL_CHARS.  Each tolerance
# is the geometric mean, to one digit, of the larger sound reading and
# its asserted control (PPL_CONTROLS), read on an NVIDIA H100 80GB HBM3
# at 700 W (the toy trains deterministically: every run reads the same):
# f32 5.68e-8 / 5.62e-8 against K4 run in bf16 2.67e-5; Q80 4.28e-8 /
# 6.99e-8 against its rows form's products in bf16 1.33e-6; Q4K 1.98e-3
# / 6.48e-4 against 8 of 32 values a group a step off 4.99e-2.  f32 and
# the Q80 rows form do the same f32 arithmetic with sums in other
# orders.  Q4K quantizes every activation to 4 bits, where an f32 sum
# taken in another order flips a rounding now and then and the flips
# spread through the layers, so its sound run diverges as far as one
# value a group a step off (1.63e-3).  That fault and K4's output alone
# in bf16 (f32: 1.15e-7) are read, not asserted: the PPL of a model this
# sure of its text cannot tell them from sound; phase 3 holds
# q4k_act_quant torch.equal and K4's f32 output within 1e-5 of the
# plain version's largest value.
PPL_CHARS = 1200
PPL_F32_MAX, PPL_DQ80_MAX, PPL_DQ4K_MAX = 1.5, 0.05, 0.2
PPL_CARD_CPU_TOL = {"f32": 1e-6, "q80": 3e-7, "q4k": 1e-2}
PPL_WINDOW = 512


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ulps(a, b):
    """The distance in units in the last place between two tensors of one
    float dtype (f32 or bf16), element by element."""
    import torch
    it, mag = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
               else (torch.int32, 0x7FFFFFFF))
    mono = lambda t: (lambda i: torch.where(i < 0, -(i & mag), i))(
        t.contiguous().view(it).long())
    return (mono(a) - mono(b)).abs()


def rms_norm_kernel_order(torch, norm_quant, h, w, eps):
    """rms_norm of h (B, E) with the sum of squares taken in rms_norm_q80's
    order (ops/norm_quant.plan: T threads of P chunks of 4 values; a
    thread's squares in order, a warp's xor butterfly, the warps' sums in
    order), each step an f32 PyTorch op, and the f32 factor it gives.
    -> (hn in h's dtype, factor (B, 1))."""
    B, E = h.shape
    T, P = norm_quant.plan(E)
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
    inv_e = torch.ones((), device=h.device) / E
    r = torch.rsqrt(tot * inv_e + eps)[:, None]
    return ((hf * r) * w.float()).to(h.dtype), r


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


# cycles of the spin kernel at each end of a profiled window: about 50 ms
# on an H100, many times the stretch the trace has cut off a window's end
PROFILE_EDGE_CYCLES = 100_000_000


def profile_steps(torch, step, n, keys, expect,
                  edge_cycles=PROFILE_EDGE_CYCLES):
    """torch.profiler over n calls of step() -> ({kernel: busy ms in all
    calls} for the kernels of `keys` that `expect` counts, plus "other";
    {kernel of `keys`: launches the profiler saw in all calls}; kernels in
    all calls; wall ms a call with the profiler on; {name: busy ms in all
    calls} of the kernels in "other")."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # a spin kernel of edge_cycles before and one after the window, left
    # out of the sums: the trace drops records at its ends now and then (a
    # tail of the window's last step behind a spin of 1000 cycles: `bench
    # profile`), which are then none of the window's
    edge = lambda: torch.cuda._sleep(edge_cycles)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edge()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / n
        edge()
        torch.cuda.synchronize()
    groups = {name: 0.0 for _, name in keys if expect.get(name)}
    groups["other"] = 0.0
    seen = {name: 0 for _, name in keys}
    others = {}
    n_kernels = 0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or "spin_kernel" in e.key):
            continue
        n_kernels += e.count
        name = next((name for sub, name in keys if sub in e.key), None)
        if name is not None:
            seen[name] += e.count
        key = name if name in groups else "other"
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3
        groups[key] += ms
        if key == "other":
            others[e.key] = others.get(e.key, 0.0) + ms
    return groups, seen, n_kernels, wall_ms, others


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


def random_lora(np, cfg, rank, seed, std_b):
    """A LoRA adapter for `cfg` in the stacked (L, in, out) layout, f32
    numpy from `seed`: A ~ N(0, 1/in) (the branch keeps the activation's
    size), B ~ N(0, std_b^2) (a trained adapter's B is no longer zero)."""
    rng = np.random.default_rng(seed)
    L, E, _, _, HD, KVD, _ = _shapes(cfg)
    out = {}
    for name, inn, o in (("wq", E, HD), ("wk", E, KVD), ("wv", E, KVD),
                         ("wo", HD, E)):
        out[name + "_a"] = (rng.standard_normal((L, inn, rank), np.float32)
                            / np.float32(np.sqrt(inn)))
        out[name + "_b"] = (rng.standard_normal((L, rank, o), np.float32)
                            * np.float32(std_b))
    return out


def pretrain_corpus(ttok, tcfg, work):
    """dataset/pretrain_sample.txt repeated to at least 1100 blocks of
    block_size + 1 tokens, tokenized into shards under `work` by
    generate_pretrain_dataset.  -> (train shard, val shard, copies,
    blocks)."""
    from nano_tpu_torch.data import preprocess
    with open(os.path.join(ROOT, "dataset", "pretrain_sample.txt"),
              encoding="utf-8") as f:
        sample = f.read()
    width = tcfg.block_size + 1
    n_copies = -(-1100 * width // len(ttok.encode(sample)))
    corpus = os.path.join(work, "corpus.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write(sample * n_copies)
    train_p, val_p = preprocess.generate_pretrain_dataset(
        [corpus], ttok, tcfg.block_size, os.path.join(work, "pt"))
    n_blocks = sum(len(preprocess.load_shard(p_)[0]) for p_ in (train_p, val_p))
    return train_p, val_p, n_copies, n_blocks


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


def q4k_padded_weight(torch, rng, inn, out, device, pad_nibble=0xE):
    """A random packed Q4K weight (out, inn) whose every nibble at a
    position >= inn holds pad_nibble (a right product never reads them)."""
    import numpy as np
    from nano_tpu_torch.ops.q4k import Q4KTensor, n_blocks_per_line
    npad = n_blocks_per_line(inn) * 256
    p = rng.integers(0, 256, (out, npad // 2), dtype=np.uint8)
    pos = np.arange(npad).reshape(-1, 2, 16)      # (G, low / high, 16)
    for half, shift, keep in ((0, 0, 0xF0), (1, 4, 0x0F)):
        past = (pos[:, half] >= inn).reshape(-1)
        p[:, past] = (p[:, past] & keep) | (pad_nibble << shift)
    G = npad // 32
    return Q4KTensor(
        packed=torch.from_numpy(p).to(device),
        scales=torch.from_numpy(rng.random((out, G), dtype=np.float32) * 0.02
                                + 1e-3).to(device),
        biases=torch.from_numpy(rng.random((out, G), dtype=np.float32) * 0.02
                                ).to(device), in_dim=inn)


def w4a4_bound(ws, B):
    """The least time (ms) of q4k_matmul_w4a4 over the weights ws at B
    rows, what bounds it, and its bytes: the packed weights with their f32
    scales and biases once, the packed rows with their sa, ba and c in, the
    bf16 result out; the operations, the int8 tensor cores' 2 per weight
    value and slot and, beside them on the CUDA cores, the f32 combine's
    W4_COMBINE_OPS per (slot, row, group), whichever takes longer."""
    nb = sum(w.packed.numel() + 8 * w.scales.numel()
             + B * (w.n_pad // 2 + 12 * (w.n_pad // 32)) + 2 * B * w.out_dim
             for w in ws)
    f32_ops = sum(W4_COMBINE_OPS * B * w.out_dim * -(-w.in_dim // 32)
                  for w in ws)
    int8_ops = sum(2 * B * w.out_dim * w.in_dim for w in ws)
    ms, by = bound(nb, max(f32_ops, int8_ops * F32_OPS_PER_S / INT8_OPS_PER_S),
                   F32_OPS_PER_S)
    return ms, by, nb


def k3_batched_times(torch, prods, B, tag, label, by_product=False):
    """K3 at B > 1 over the layer products `prods` ((name, Q4KTensor) of
    the 28 layers' wqkv, wo, w13, w2, random per-layer weights as
    random_q4k_params makes them) on random bf16 rows, replayed from a CUDA
    graph: q4k_matmul_w4a4 alone on rows quantized ahead and the bf16
    torch.matmul on weights dequantized ahead, in the order kernel,
    library, library, kernel; then the pair as the model calls it
    (q4k_act_quant + q4k_matmul_w4a4) and the pair it replaced
    (q4k_fake_quant + q4k_matmul); beside the bound.  By product too with
    by_product.  -> the ms of all the launches: {kernel, library, pair,
    old_pair, bound}."""
    from nano_tpu_torch.ops import q4k
    gen = torch.Generator(device="cuda").manual_seed(SEED + B)
    bf16 = torch.bfloat16
    xs = [torch.randn(B, w.in_dim, device="cuda", generator=gen).to(bf16)
          for _, w in prods]
    acts = [q4k.act_quant_q4k_packed_plain(x) for x in xs]
    wds = [w.dequantize(bf16) for _, w in prods]
    timer = Timer(torch)
    card = card_line()
    out = None
    for name in (("wqkv", "wo", "w13", "w2") if by_product else ()) + ("all",):
        idx = [j for j, (n, _) in enumerate(prods) if name in ("all", n)]
        run_k = lambda: [q4k.q4k_matmul_w4a4(*acts[j], prods[j][1], bf16)
                         for j in idx]
        run_l = lambda: [torch.matmul(xs[j], wds[j].t()) for j in idx]
        run_p = lambda: [q4k.q4k_matmul_w4a4(*q4k.act_quant_q4k_packed(xs[j]),
                                             prods[j][1], bf16) for j in idx]
        run_o = lambda: [q4k.q4k_matmul_f32(q4k.fake_quant_act(xs[j]),
                                            prods[j][1], bf16) for j in idx]
        t_k = [timer(run_k)]
        t_l = [timer(run_l), timer(run_l)]
        t_k.append(timer(run_k))
        t_p, t_o = timer(run_p), timer(run_o)
        ws = [prods[j][1] for j in idx]
        b_ms, b_by, nb = w4a4_bound(ws, B)
        w0 = ws[0]
        what = (f"{len(idx)} launches" if name == "all" else
                f"{len(idx)} x {w0.in_dim}->{w0.out_dim}, plan (MB, BN, CS, "
                f"S) {q4k.w4a4_plan(B, w0.out_dim, w0.n_pad)}")
        log(f"[{tag}] {label}, {name} ({what}): q4k_matmul_w4a4 "
            f"{t_k[0]:.4f} / {t_k[1]:.4f} ms, bf16 torch.matmul "
            f"{t_l[0]:.4f} / {t_l[1]:.4f} ms (kernel / library "
            f"{min(t_k) / min(t_l):.2f}); with q4k_act_quant {t_p:.4f} ms "
            f"(pair / library {t_p / min(t_l):.2f}); the pair it replaced, "
            f"q4k_fake_quant + q4k_matmul, {t_o:.4f} ms; bound {b_ms:.4f} "
            f"ms ({b_by}, {nb / 1e6:.1f} MB); {card}")
        out = dict(kernel=min(t_k), library=min(t_l), pair=t_p, old_pair=t_o,
                   bound=b_ms)
    return out


# ---------------------------------------------------------------------
# `python3 chip_smoke.py bench [flash [clocks]] [decode] [q4k [batched]] [q80
# [batched [sweep] [clocks]]] [pipes]`: the attention kernels timed alone
# beside SDPA, a Q4K or Q80 decode step's matmuls, K1 and K3 at B > 1
# (batched step, prefill),
# and what an SM sustains of mma.sync and ex2.  A measuring mode
# for work on those kernels (about a minute and a half with the build); it
# checks little and prints no result lines.
# ---------------------------------------------------------------------

def _best_of(torch, fn, reps=5):
    """Best device time (ms) of fn() over `reps` runs, after one warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


class BwdSplit:
    """K4's bf16 backward on the wgmma passes, pass by pass, for a split of
    its time: flash_bwd_wgmma with a pass mask, on scratch outputs.  run(1)
    launches the dq pass, which leaves the row statistics in self.stats;
    run(2) the dk/dv pass alone on them; run(3) both, as the route does (the
    dk/dv pass a programmatic dependent of the dq pass).  `lib`: a build of
    csrc/flash_bwd_wgmma.cu (the package's by default)."""

    def __init__(self, torch, q, k, v, out, lse, dout, offset, hpb, lib=None):
        from nano_tpu_torch.ops import _build, flash_attn
        B, Sq, H, D = q.shape
        Skv, KV = k.shape[1], k.shape[2]
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        self.stats = torch.empty(B, H, -(-Sq // 64), 2, 64, device=q.device)
        self.keep = (q, k, v, out, lse, dout, dq, dk, dv)
        self.args = [*(x.data_ptr() for x in (q, k, v, out, lse, dout, dq, dk,
                                              dv, self.stats)),
                     B, Sq, Skv, offset, H, KV, D, hpb,
                     *flash_attn.wgmma_spreads(q.device.index, B, Sq, Skv, H,
                                               KV, D, hpb)]
        self.tail = [*(x.stride(i) for x in (q, k, v) for i in range(3)),
                     D ** -0.5]
        self.torch = torch
        self.lib = lib or _build.lib("flash_bwd_wgmma")

    def run(self, passes):
        # the current stream: a graph capture's, in a Timer
        assert self.lib.flash_bwd_wgmma(
            *self.args, passes, *self.tail,
            self.torch.cuda.current_stream().cuda_stream) == 0


def bench_flash(torch, clocks=False):
    """One Nano-168M training step's 24 forward launches of flash_attn_fwd
    (B=64, S=512, H=16, KV=8, D=48, bf16, each layer on its own tensors) and
    the Qwen3 head shape (D=128), no autograd, beside
    scaled_dot_product_attention(is_causal, enable_gqa): CUDA events around
    the step, best of five, in the order library, kernel, kernel, library;
    then the route's kernel in turns with the mma.sync kernel.
    Then the step's 24 backward launches of flash_attn_bwd (its route's
    kernels: the wgmma passes at D = 48, the mma.sync passes at D = 128) beside SDPA's
    backward (autograd of the same call) the same way; the backward by
    route at 10d's ranks and the training shapes (bench_routes); and
    what bounds the backward: the kernels' instruction mix in the SASS and
    the cycles each warp spends in each phase (bench_bwd_clocks for the mma.sync
    passes, bench_wgmma_clocks for the wgmma passes, with `bench flash
    clocks`)."""
    import torch.nn.functional as F
    from nano_tpu_torch.ops import _build, flash_attn
    lib = _build.lib("flash_attn")
    occ = lib.flash_attn_fwd_blocks_per_sm
    log("[bench flash] blocks of flash_fwd_mma_kernel per SM by (D, query "
        "heads a block): " + ", ".join(f"({d}, {h}) {occ(d, h)}" for d, h in (
            (32, 2), (48, 1), (48, 2), (48, 4), (64, 2), (128, 1), (128, 2))))
    bocc = lib.flash_attn_bwd_blocks_per_sm
    log("[bench flash] blocks per SM of the backward by D: dq (1 / 2 query "
        "heads a block), dk/dv: " + ", ".join(
            f"D={d} {bocc(d, 1)} / {bocc(d, 2)}, {bocc(d, 0)}"
            for d in (32, 48, 64, 128)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, KV, D, L in ((64, 512, 16, 8, 48, 24), (8, 1024, 16, 8, 128, 8)):
        mk = lambda *s: torch.randn(*s, device="cuda", generator=gen
                                    ).to(torch.bfloat16)
        layers = [(mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, D))
                  for _ in range(L)]

        def kernel(route=None):
            for q, k, v in layers:
                flash_attn.flash_attn_fwd(q, k, v, route=route)

        def library():
            for q, k, v in layers:
                F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True)

        t = [_best_of(torch, f) for f in (library, kernel, kernel, library)]
        mma = lambda: kernel(flash_attn.FwdRoute("mma"))
        tm = [_best_of(torch, f) for f in (mma, kernel, kernel, mma)]
        flops = L * 2 * 2 * B * H * D * S * (S + 1) // 2
        log(f"[bench flash] {L} x flash_attn_fwd B={B} S={S} H={H} KV={KV} "
            f"D={D} bf16, the route "
            f"{tuple(flash_attn.fwd_route(B, S, S, 0, H, KV, D, torch.bfloat16))}"
            f": kernel {t[1]:.3f} / {t[2]:.3f} ms "
            f"({flops / min(t[1], t[2]) / 1e9:.1f} TFLOP/s on the causal "
            f"work), SDPA {t[0]:.3f} / {t[3]:.3f} ms, kernel / SDPA "
            f"{min(t[1], t[2]) / min(t[0], t[3]):.2f}; in turns with the "
            f"mma.sync kernel: route {tm[1]:.3f} / {tm[2]:.3f} ms, mma.sync "
            f"{tm[0]:.3f} / {tm[3]:.3f} ms")

        # the backward: the kernel on what the forward wrote, SDPA's
        # backward through autograd on its own forward (graph kept)
        fwd = [flash_attn.flash_attn_fwd(q, k, v) for q, k, v in layers]
        douts = [mk(B, S, H, D) for _ in range(L)]
        lib_graphs = []
        for q, k, v in layers:
            leaves = [x.detach().transpose(1, 2).requires_grad_(True)
                      for x in (q, k, v)]
            lib_graphs.append((F.scaled_dot_product_attention(
                *leaves, is_causal=True, enable_gqa=True), leaves))

        def kernel_bwd():
            for (q, k, v), (o, lse), g in zip(layers, fwd, douts):
                flash_attn.flash_attn_bwd(q, k, v, o, lse, g)

        def library_bwd():
            for (o, leaves), g in zip(lib_graphs, douts):
                torch.autograd.grad(o, leaves, g.transpose(1, 2),
                                    retain_graph=True)

        t = [_best_of(torch, f) for f in (library_bwd, kernel_bwd, kernel_bwd,
                                          library_bwd)]
        log(f"[bench flash] {L} x flash_attn_bwd B={B} S={S} H={H} KV={KV} "
            f"D={D} bf16: kernel {t[1]:.3f} / {t[2]:.3f} ms "
            f"({2.5 * flops / min(t[1], t[2]) / 1e9:.1f} TFLOP/s on the five "
            f"causal products), SDPA backward {t[0]:.3f} / {t[3]:.3f} ms, "
            f"kernel / SDPA {min(t[1], t[2]) / min(t[0], t[3]):.2f}")
        if D == 48 and clocks:
            bench_bwd_clocks(torch, layers[0], fwd[0], douts[0])
        del layers, fwd, douts, lib_graphs
    bench_routes(torch, clocks)
    bench_bwd_sass()


# bench_routes' shapes, (B, Sq, Skv, offset, H, KV, D): phase 10d's two
# ranks (B=8, 256 queries at offsets 256 and 0 against 512 keys), the
# training shapes of Nano-168M (D=48) and Nano-56M (D=32), B=64 x 512;
# 10d's rank at D = 32, 16 and 64; the calculator of phase 9d (B=64 x 64,
# 8 heads on 4 KV heads, D = 16); a whole sequence of B=64 x 512 at D = 64
ROUTE_SHAPES = (
    (8, 256, 512, 256, 16, 8, 48), (8, 256, 512, 0, 16, 8, 48),
    (64, 512, 512, 0, 16, 8, 48), (64, 512, 512, 0, 16, 8, 32),
    (8, 256, 512, 256, 16, 8, 32), (8, 256, 512, 256, 16, 8, 16),
    (64, 64, 64, 0, 8, 4, 16), (8, 256, 512, 256, 16, 8, 64),
    (64, 512, 512, 0, 16, 8, 64))


def bench_routes(torch, clocks=False):
    """K4 by route, alone (no autograd), 4 layers' launches replayed from a
    CUDA graph, at ROUTE_SHAPES.  The forward: the wgmma kernel (the route's
    heads a block, or two where the route keeps the mma.sync kernel and
    the heads of a KV head are even) in turns with the mma.sync kernel
    (old, new, new, old), then with one and two heads a block.  The
    backward: the wgmma passes with one query head a dq block, in turns
    with the mma.sync passes, then with two where the heads of a KV head
    are even, and the wgmma passes split: dq, dk/dv alone, the two.  The
    routes' choices beside them.  With `clocks`, where the wgmma kernels'
    warps spend their cycles (bench_wgmma_clocks)."""
    from nano_tpu_torch.ops import _build, flash_attn
    timer = Timer(torch)
    wl = _build.lib("flash_bwd_wgmma")
    fl = _build.lib("flash_fwd_wgmma")
    log("[bench flash] blocks per SM of the wgmma forward by D (1 / 2 "
        "query heads a block): " + ", ".join(
            f"D={d} {fl.flash_fwd_wgmma_blocks_per_sm(d, 1)} / "
            f"{fl.flash_fwd_wgmma_blocks_per_sm(d, 2)}"
            for d in flash_attn.WGMMA_HEAD_DIMS))
    log("[bench flash] blocks per SM of the wgmma passes by D: dq (1 / 2 "
        "query heads a block), dk/dv: " + ", ".join(
            f"D={d} {wl.flash_bwd_wgmma_blocks_per_sm(d, 0, 1)} / "
            f"{wl.flash_bwd_wgmma_blocks_per_sm(d, 0, 2)}, "
            f"{wl.flash_bwd_wgmma_blocks_per_sm(d, 1, 1)}"
            for d in flash_attn.WGMMA_HEAD_DIMS))
    gen = torch.Generator(device="cuda").manual_seed(1)
    mk = lambda *s_: torch.randn(*s_, device="cuda", generator=gen).to(
        torch.bfloat16)
    for B, Sq, Skv, off, H, KV, D in ROUTE_SHAPES:
        layers = []
        for _ in range(4):
            q, k, v, g = (mk(B, Sq, H, D), mk(B, Skv, KV, D),
                          mk(B, Skv, KV, D), mk(B, Sq, H, D))
            o, l = flash_attn.flash_attn_fwd(q, k, v, off)
            layers.append((q, k, v, o, l, g))
        shape = (f"B={B} Sq={Sq} Skv={Skv} offset={off} H={H} KV={KV} D={D} "
                 f"bf16, graph replays")
        # the forward
        run_f = lambda rt: timer(lambda: [flash_attn.flash_attn_fwd(
            q_, k_, v_, off, route=rt) for q_, k_, v_, *_ in layers])
        froute = flash_attn.fwd_route(B, Sq, Skv, off, H, KV, D,
                                      torch.bfloat16)
        fold = flash_attn.FwdRoute("mma")
        fnew = (froute if froute.kernel == "wgmma" else flash_attn.FwdRoute(
            "wgmma", 2 if (H // KV) % 2 == 0 else 1))
        tf = [run_f(r_) for r_ in (fold, fnew, fnew, fold)]
        tv = {h: run_f(flash_attn.FwdRoute("wgmma", h)) for h in (1, 2)
              if (H // KV) % h == 0}
        log(f"[bench flash] 4 x flash_attn_fwd {shape}: {tuple(fnew)} "
            f"{tf[1]:.4f} / {tf[2]:.4f} ms, the mma.sync kernel {tf[0]:.4f} / "
            f"{tf[3]:.4f} ms (wgmma / mma.sync "
            f"{min(tf[1], tf[2]) / min(tf[0], tf[3]):.3f}); by heads a block "
            + ", ".join(f"{h} {t_:.4f}" for h, t_ in tv.items())
            + f"; the route {tuple(froute)}; {card_line()}")
        # the backward
        run = lambda rt: timer(lambda: [flash_attn.flash_attn_bwd(
            *x, off, route=rt) for x in layers])
        route = flash_attn.bwd_route(B, Sq, Skv, off, H, KV, D, torch.bfloat16)
        old, new = flash_attn.BwdRoute("mma"), flash_attn.BwdRoute("wgmma", 1)
        t = [run(r_) for r_ in (old, new, new, old)]
        t2 = (run(flash_attn.BwdRoute("wgmma", 2)) if (H // KV) % 2 == 0
              else None)
        hpb = route.hpb if route.passes == "wgmma" else 1
        splits = [BwdSplit(torch, *x, off, hpb) for x in layers]
        for sp in splits:
            sp.run(1)
        by_pass = [timer(lambda: [sp.run(p_) for sp in splits])
                   for p_ in (1, 2, 3)]
        log(f"[bench flash] 4 x flash_attn_bwd {shape}: "
            f"('wgmma', 1) {t[1]:.4f} / {t[2]:.4f} ms, the mma.sync passes "
            f"{t[0]:.4f} / {t[3]:.4f} ms (wgmma / mma.sync "
            f"{min(t[1], t[2]) / min(t[0], t[3]):.3f}), ('wgmma', 2) "
            + ("-" if t2 is None else f"{t2:.4f} ms")
            + f"; the route {tuple(route)}; ('wgmma', {hpb}) by pass: dq "
            f"{by_pass[0]:.4f}, dk/dv alone {by_pass[1]:.4f}, the two "
            f"{by_pass[2]:.4f}; {card_line()}")
        if clocks and (B, off, D) in ((8, 256, 48), (64, 0, 48)):
            bench_wgmma_clocks(torch, layers[0], off, hpb, fnew)
        del layers, splits


def clocks_lib(stem):
    """csrc/<stem>.cu built once more with -DNANO_BWD_CLOCKS into
    build/flash_clocks/, loaded, its entry point's and clock reader's
    argument types set."""
    import ctypes
    from nano_tpu_torch.ops import _build
    work = os.path.join(ROOT, "build", "flash_clocks")
    os.makedirs(work, exist_ok=True)
    so = os.path.join(work, f"lib{stem}_clocks.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-DNANO_BWD_CLOCKS", "-o", so,
                    os.path.join(_build.CSRC_DIR, stem + ".cu")], check=True)
    lib = ctypes.CDLL(so)
    getattr(lib, stem).argtypes = _build.SIGNATURES[stem][0]
    getattr(lib, stem + "_clocks").argtypes = [ctypes.c_void_p]
    return lib


def bench_wgmma_clocks(torch, layer, off, hpb, fwd_route):
    """Builds flash_fwd_wgmma.cu and flash_bwd_wgmma.cu once more with
    -DNANO_BWD_CLOCKS and runs one layer's wgmma forward (`fwd_route`) and
    two wgmma passes through them: the cycles every consumer warp spends in
    each phase, summed over the grid, as shares of the kernel's total."""
    import ctypes
    from nano_tpu_torch.ops import flash_attn
    q, k, v = layer[:3]
    B, Sq, H, D = q.shape
    fl = clocks_lib("flash_fwd_wgmma")
    clk = (ctypes.c_ulonglong * 6)()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, device=q.device)
    args = [*(x.data_ptr() for x in (q, k, v, out, lse)), B, Sq, k.shape[1],
            off, H, k.shape[2], D, fwd_route.hpb,
            flash_attn.fwd_spread(q.device.index, B, Sq, H, D, fwd_route),
            *(x.stride(i) for x in (q, k, v) for i in range(3)), D ** -0.5]
    for _ in range(2):      # the first run warms up; its counts are dropped
        assert fl.flash_fwd_wgmma_clocks(clk) == 0
        assert fl.flash_fwd_wgmma(
            *args, torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
    assert fl.flash_fwd_wgmma_clocks(clk) == 0
    c = list(clk)
    tot = sum(c) or 1
    log(f"[bench flash] clock64 per consumer warp, wgmma forward "
        f"{tuple(fwd_route)}, one layer B={B} Sq={Sq} Skv={k.shape[1]} "
        f"offset={off} D={D} (instrumented build): " + ", ".join(
            f"{p} {x / tot:.3f}" for p, x in zip(
                ("prologue", "waits", "S product", "softmax", "P V product",
                 "epilogue"), c)) + f" of {tot / 1e9:.3f} G warp-cycles")
    lib = clocks_lib("flash_bwd_wgmma")
    sp = BwdSplit(torch, *layer, off, hpb, lib=lib)
    clocks = (ctypes.c_ulonglong * 12)()
    for _ in range(2):      # the first run warms up; its counts are dropped
        assert lib.flash_bwd_wgmma_clocks(clocks) == 0
        sp.run(3)
        torch.cuda.synchronize()
    assert lib.flash_bwd_wgmma_clocks(clocks) == 0
    q, k = layer[0], layer[1]
    phases = ("prologue", "waits", "S/dP products", "softmax, dS",
              "gradient products", "epilogue")
    for i, kname in enumerate(("dq", "dk/dv")):
        c = list(clocks)[6 * i:6 * i + 6]
        tot = sum(c) or 1
        log(f"[bench flash] clock64 per consumer warp, wgmma {kname} pass, "
            f"one layer B={q.shape[0]} Sq={q.shape[1]} Skv={k.shape[1]} "
            f"offset={off} D={q.shape[3]} (instrumented build): "
            + ", ".join(f"{p} {x / tot:.3f}" for p, x in zip(phases, c))
            + f" of {tot / 1e9:.3f} G warp-cycles")


def bench_bwd_sass():
    """Instruction mix of the bf16 backward kernels at D = 48 as built, the
    mma.sync passes and the wgmma passes: cuobjdump's SASS of libflash_attn.so
    and libflash_bwd_wgmma.so, opcodes counted per kernel (the whole
    kernel, every unrolled variant included).  The full listing goes to
    build/flash_bwd_sass.txt."""
    from nano_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = "".join(subprocess.run(
        [tool, "-sass", _build._lib_path(stem)], capture_output=True,
        text=True, check=True).stdout for stem in ("flash_attn",
                                                   "flash_bwd_wgmma"))
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    kernels, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            keep = ("flash_bwd_dq_v3_kernelILi48ELi2E" in name
                    or "flash_bwd_dkdv_v3_kernelILi48E" in name
                    or "flash_bwd_dq_wgmma_kernelILi48ELi2E" in name
                    or "flash_bwd_dkdv_wgmma_kernelILi48E" in name)
            name = name if keep else None
            if name:
                kernels[name] = []
        elif name and line.strip().startswith("/*") and ";" in line:
            op = line.split("*/", 1)[1].strip().split(";")[0].split()
            if op and op[0].startswith("@"):
                op = op[1:]
            if op:
                kernels[name].append(op[0])
    with open(os.path.join(out_dir, "flash_bwd_sass.txt"), "w") as f:
        f.write(text)
    groups = (("HMMA", "mma"), ("HGMMA", "wgmma"), ("UTMALDG", "tma"),
              ("MUFU.EX2", "ex2"), ("LDSM", "ldmatrix"),
              ("LDGSTS", "cp.async"), ("BAR", "barrier"),
              ("FFMA", "ffma"), ("FMUL", "fmul"), ("FADD", "fadd"),
              ("F2FP", "bf16 pack"), ("IMAD", "imad"), ("IADD3", "iadd"),
              ("LEA", "lea"), ("MOV", "mov"), ("ISETP", "isetp"),
              ("FSEL", "fsel"), ("SHFL", "shfl"), ("STS", "sts"), ("LDS", "lds"))
    for name, ops in kernels.items():
        counts = {label: sum(1 for o in ops if o.startswith(prefix))
                  for prefix, label in groups}
        known = sum(counts.values())
        short = (("wgmma " if "wgmma" in name else "mma.sync ")
                 + ("dq" if "_dq_" in name else "dk/dv"))
        log(f"[bench flash] SASS of the {short} kernel at D=48: {len(ops)} "
            f"instructions: " + ", ".join(f"{k} {v}" for k, v in counts.items()
                                          if v) + f", other {len(ops) - known}")


def bench_bwd_clocks(torch, qkv, fwd, dout):
    """Builds flash_attn.cu once more with -DNANO_BWD_CLOCKS into
    build/flash_clocks/ and runs one layer's backward (training shape)
    through it: the cycles every warp spends in each phase of the two
    kernels, summed over the grid, as shares of the kernel's total."""
    import ctypes
    from nano_tpu_torch.ops import _build
    work = os.path.join(ROOT, "build", "flash_clocks")
    os.makedirs(work, exist_ok=True)
    so = os.path.join(work, "libflash_clocks.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-DNANO_BWD_CLOCKS", "-o", so,
                    os.path.join(_build.CSRC_DIR, "flash_attn.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.flash_attn_bwd.argtypes = _build.SIGNATURES["flash_attn_bwd"][0]
    lib.flash_attn_bwd_clocks.argtypes = [ctypes.c_void_p]
    q, k, v = qkv
    o, lse = fwd
    B, S, H, D = q.shape
    KV = k.shape[2]
    grads = [torch.empty_like(x) for x in (q, k, v)]
    delta = torch.empty(B, H, S, device="cuda")
    clocks = (ctypes.c_ulonglong * 12)()
    strides = [x.stride(i) for x in (q, k, v) for i in range(3)]
    for _ in range(2):      # the first run warms up; its counts are dropped
        assert lib.flash_attn_bwd_clocks(clocks) == 0
        rc = lib.flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), *(g.data_ptr() for g in grads),
            delta.data_ptr(), 1, B, S, S, 0, H, KV, D, *strides, D ** -0.5, 3,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        torch.cuda.synchronize()
    assert lib.flash_attn_bwd_clocks(clocks) == 0
    phases = ("prologue", "waits+barrier", "S/dP products", "softmax, dS",
              "gradient products", "epilogue")
    for i, kname in enumerate(("dq", "dk/dv")):
        c = list(clocks)[6 * i:6 * i + 6]
        tot = sum(c) or 1
        log(f"[bench flash] clock64 per warp, {kname} kernel, one layer B={B} "
            f"S={S} H={H} KV={KV} D={D} (instrumented build): "
            + ", ".join(f"{p} {x / tot:.3f}" for p, x in zip(phases, c))
            + f" of {tot / 1e9:.3f} G warp-cycles")


def bench_decode(torch):
    """One Qwen3-0.6B decode step's 28 launches of decode_attention (KV=8,
    rep=2, D=128, bf16 cache of 512 rows, pos 318) fed as the model feeds it
    (bf16 q, f32 result cast to bf16), replayed from a CUDA graph, beside
    SDPA fed the same way; for three choices of the least rows per block
    (MIN_CHUNK), at batch 1, 8 and 64."""
    import torch.nn.functional as F
    from nano_tpu_torch.ops import decode_attn
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    L, KV, rep, D, T, p = 28, 8, 2, 128, 512, 318
    H = KV * rep
    for B in (1, 8, 64):
        mk = lambda *s: torch.randn(*s, device="cuda", generator=gen
                                    ).to(torch.bfloat16)
        kc = [mk(B, T, KV, D) for _ in range(L)]
        vc = [mk(B, T, KV, D) for _ in range(L)]
        qs = [mk(B, H, D) for _ in range(L)]
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        kv_lib = [(k[:, :p + 1].transpose(1, 2), v[:, :p + 1].transpose(1, 2))
                  for k, v in zip(kc, vc)]

        def kernel():
            for i in range(L):
                decode_attn.decode_attention(
                    qs[i], kc[i], vc[i], None, None, pos, KV, rep
                ).to(torch.bfloat16)

        def library():
            for i in range(L):
                F.scaled_dot_product_attention(
                    qs[i][:, :, None, :], kv_lib[i][0], kv_lib[i][1],
                    enable_gqa=True)

        lib_ms = timer(library, reps=50)
        line = [f"[bench decode] {L} x decode_attention B={B} KV={KV} "
                f"rep={rep} D={D} bf16 cache T={T} pos={p}, bf16 q, result "
                f"cast to bf16: SDPA {lib_ms:.4f} ms"]
        saved = decode_attn.MIN_CHUNK
        for min_chunk in (16, 32, 64):
            decode_attn.MIN_CHUNK = min_chunk
            chunk, n_split = decode_attn.choose_splits(KV, T)
            ms = timer(kernel, reps=50)
            line.append(f"MIN_CHUNK {min_chunk} (chunk {chunk}, {n_split} "
                        f"splits) {ms:.4f} ms = {ms / lib_ms:.2f} x SDPA")
        decode_attn.MIN_CHUNK = saved
        log("; ".join(line))


def bench_pipes(torch):
    """Builds nano_tpu_torch/csrc/bench/pipes.cu into build/pipes/ and times
    its four modes with every SM filled by 8, 16 and 32 warps."""
    import ctypes
    from nano_tpu_torch.ops import _build
    work = os.path.join(ROOT, "build", "pipes")
    os.makedirs(work, exist_ok=True)
    so = os.path.join(work, "libpipes.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-o", so,
                    os.path.join(_build.CSRC_DIR, "bench", "pipes.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(4, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters, chains = 20000, 8
    for threads, per_sm in ((128, 2), (256, 2), (256, 4)):
        blocks = sms * per_sm
        warps = blocks * threads // 32
        row = [f"[bench pipes] {per_sm * threads // 32} warps an SM "
               f"({per_sm} blocks of {threads} threads):"]
        for mode, name in ((1, "mma"), (2, "ex2"), (3, "mixed"), (4, "split")):
            def run(n):
                rc = lib.run(out.data_ptr(), blocks, threads, n, mode, stream)
                assert rc == 0, rc
            ms = _best_of(torch, lambda: run(iters), reps=2)
            mma_warps = warps if mode in (1, 3) else warps // 2 if mode == 4 else 0
            ex2_warps = warps if mode in (2, 3) else warps // 2 if mode == 4 else 0
            n_mma = mma_warps * iters * chains
            n_ex2 = ex2_warps * iters * chains * (1 if mode == 3 else 2) * 32
            row.append(f"{name} {ms:.3f} ms"
                       + (f", {n_mma * 4096 / ms / 1e9:.0f} TFLOP/s" if n_mma else "")
                       + (f", {n_ex2 / ms / 1e6 / sms:.2f} ex2/ns/SM" if n_ex2 else ""))
        log("; ".join(row))
    log("[bench pipes] published: 989 TFLOP/s dense bf16 (wgmma); 16 ex2 per "
        "clock per SM = 31.7 ex2/ns/SM at 1980 MHz")


def bench_q4k(torch, batched=False, sweep=False, clocks=False, step=False):
    """With `batched`, bench_q4k_batched and nothing else; with `step`,
    bench_q4k_step and nothing else.  Else: one Qwen3-0.6B Q4K decode
    step's 112 products (4 per layer, random per-layer weights as
    random_q4k_params makes them, bf16 rows) replayed from a CUDA graph:
    the two kernels K3 at B = 1 was first (q4k_fake_quant + q4k_matmul, 113
    fake-quants with the head's) against q4k_matvec_fq on the rows'
    integer form (as the norms, SwiGLU and q4k_act_quant write it), in the
    order two, new, new, two; each product's 28 launches alone; every new
    product within 1e-5 of max|y| of the pair's in f32 (the same
    fake-quantized row, f32 sums in another order).  With `clocks`,
    bench_q4k_clocks on layer 0's four products."""
    if batched:
        return bench_q4k_batched(torch, sweep)
    if step:
        return bench_q4k_step(torch)
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.ops import _build, q4k
    cfg = ModelConfig(**QWEN3_06B)
    L, E, F, V, HD, KVD, D = _shapes(cfg)
    rng = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    calls = []
    for _ in range(L):
        for name, (out, inn) in zip(("wqkv", "wo", "w13", "w2"), (
                (HD + 2 * KVD, E), (E, HD), (2 * F, E), (E, F))):
            G = inn // 32
            w = q4k.Q4KTensor(
                packed=torch.from_numpy(rng.integers(0, 256, (out, inn // 2), dtype=np.uint8)).cuda(),
                scales=torch.from_numpy(rng.random((out, G), dtype=np.float32) * 0.02 + 1e-3).cuda(),
                biases=torch.from_numpy(rng.random((out, G), dtype=np.float32) * 0.02).cuda(),
                in_dim=inn)
            x = torch.randn(1, inn, device="cuda", generator=gen).to(torch.bfloat16)
            act = q4k.Q4KAct(*q4k.act_quant_q4k_packed(x), x.shape)
            calls.append((name, w, x, act, torch.empty(1, w.n_pad, device="cuda"),
                          torch.empty(1, out, device="cuda", dtype=torch.bfloat16)))
    head_x = torch.randn(1, E, device="cuda", generator=gen).to(torch.bfloat16)
    head_xq = torch.empty(1, q4k.n_blocks_per_line(E) * 256, device="cuda")
    lib = _build.lib("q4k")
    st = lambda: torch.cuda.current_stream().cuda_stream

    def two():
        lib.q4k_fake_quant(head_x.data_ptr(), 1, head_xq.data_ptr(), 1, E,
                           head_xq.shape[1], st())
        for _, w, x, _, xq, y in calls:
            lib.q4k_fake_quant(x.data_ptr(), 1, xq.data_ptr(), 1, w.in_dim,
                               w.n_pad, st())
            lib.q4k_matmul(xq.data_ptr(), w.packed.data_ptr(), w.scales.data_ptr(),
                           w.biases.data_ptr(), y.data_ptr(), 1, 1, w.n_pad,
                           w.in_dim, w.out_dim, st())

    def new(only=None):
        for name, w, _, act, _, _ in calls:
            if only in (None, name):
                q4k.q4k_matvec_fq(act, w, torch.bfloat16)

    timer = Timer(torch)
    t = {"two": [], "new": []}
    for which in ("two", "new", "new", "two"):
        t[which].append(timer(two if which == "two" else new, reps=50))
    worst = 0.0
    for name, w, x, act, _, _ in calls[:4]:
        y = q4k.q4k_matvec_fq(act, w, torch.float32)
        ref = q4k.q4k_matmul_f32(q4k.fake_quant_act(x), w, torch.float32)
        err = (y - ref).abs().max().item() / ref.abs().max().item()
        worst = max(worst, err)
    card = card_line()
    log(f"[bench q4k] one Q4K decode step, {len(calls)} products ({card}): "
        f"q4k_fake_quant + q4k_matmul "
        f"{'/'.join(f'{v:.4f}' for v in t['two'])} ms; q4k_matvec_fq on the "
        f"integer form {'/'.join(f'{v:.4f}' for v in t['new'])} ms (in "
        f"turns); the new products within {worst:.2e} of max|y| of the "
        f"pair's")
    if not worst <= 1e-5:
        raise AssertionError("q4k_matvec_fq differs from the two kernels")
    for name in ("wqkv", "wo", "w13", "w2"):
        w = next(c[1] for c in calls if c[0] == name)
        byt = w.packed.numel() + 8 * w.scales.numel()
        per = timer(lambda: new(name)) / L * 1e3
        log(f"[bench q4k] {name} {w.in_dim}->{w.out_dim}, plan (blocks, R, S, "
            f"T) {q4k.matvec_plan(w.out_dim, w.n_pad, _build.sm_count(w.packed.device))}: "
            f"{per:.2f} us a launch, bound {byt / HBM_BYTES_PER_S * 1e6:.2f} "
            f"us ({byt / 1e6:.2f} MB)")
    if clocks:
        bench_q4k_clocks(torch, [c for c in calls[:4]])


def bench_q4k_clocks(torch, calls):
    """q4k_matvec_fq built with -DNANO_Q4K_CLOCKS into build/q4k_clocks/,
    each of `calls` (name, weight, x, its integer form, ...) launched alone
    with the L2 cleared before it (a 256 MB write): the span from the first
    block's entry to the last block's end, the spread of the entries, and
    the median over blocks of each stamp after the block's entry (the
    activation in, first tile in, the last tile's dot done, the last row
    stored), in ns of %globaltimer (and in cycles of clock64)."""
    import ctypes
    import statistics
    from nano_tpu_torch.ops import _build, q4k
    work = os.path.join(ROOT, "build", "q4k_clocks")
    os.makedirs(work, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    so = os.path.join(work, "libq4k_clocks.so")
    subprocess.run([_build.nvcc_path(), *flags, "-DNANO_Q4K_CLOCKS", "-o", so,
                    os.path.join(_build.CSRC_DIR, "q4k.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.q4k_matvec_fq.argtypes = _build.SIGNATURES["q4k_matvec_fq"][0]
    lib.q4k_matvec_fq_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    assert lib.q4k_matvec_fq_init() == 0
    flush = torch.empty(64 << 20, device="cuda")
    n_sm = _build.sm_count(flush.device)
    for name, w, _, act, _, y in calls:
        plan = q4k.matvec_plan(w.out_dim, w.n_pad, n_sm)
        for _ in range(2):    # the first launch warms up
            flush.zero_()
            assert lib.q4k_matvec_fq(
                act.vp.data_ptr(), act.sa.data_ptr(), act.ba.data_ptr(),
                w.packed.data_ptr(), w.scales.data_ptr(), w.biases.data_ptr(),
                y.data_ptr(), 1, None, w.n_pad, w.in_dim, w.out_dim, *plan,
                torch.cuda.current_stream().cuda_stream) == 0
            torch.cuda.synchronize()
        nb = plan[0]
        buf = (ctypes.c_ulonglong * (10 * nb))()
        assert lib.q4k_matvec_fq_clocks(buf, nb) == 0
        t = [list(buf)[10 * b:10 * b + 10] for b in range(nb)]
        t0 = min(r[0] for r in t)
        med = [statistics.median(r[k] - r[0] for r in t) for k in range(1, 5)]
        cyc = [statistics.median(r[5 + k] - r[5] for r in t) for k in range(1, 5)]
        mhz = statistics.median((r[9] - r[5]) * 1e3 / max(r[4] - r[0], 1)
                                for r in t)
        log(f"[bench q4k clocks] {name}, weights cold: span "
            f"{max(r[4] for r in t) - t0} ns, entries spread over "
            f"{max(r[0] for r in t) - t0} ns; median after entry: activation "
            f"in {med[0]:.0f}, first tile in {med[1]:.0f}, dot done "
            f"{med[2]:.0f}, rows stored {med[3]:.0f} ns ("
            + "/".join(f"{c:.0f}" for c in cyc)
            + f" cycles, SM clock ~{mhz:.0f} MHz)")


def timeline_by_kernel(torch, fn, n, keys):
    """torch.profiler over n calls of fn(): the card's kernels on one time
    line, each charged the time it adds to the span (its end past the
    latest end so far), the gaps charged to the kernel after them; named
    by `keys` (substring, name), else "other".  -> (span ms, {name: ms
    added}, {name: ms of gaps before it}), each a call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = sorted(((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name), key=lambda t: t[0])
    added, gaps = {}, {}
    cur = ev[0][0]
    for t0, t1, name in ev:
        key = next((k for sub, k in keys if sub in name), "other")
        if t0 > cur:
            gaps[key] = gaps.get(key, 0.0) + (t0 - cur) / 1e3 / n
        added[key] = added.get(key, 0.0) + max(0.0, t1 - max(cur, t0)) / 1e3 / n
        cur = max(cur, t1)
    return (cur - ev[0][0]) / 1e3 / n, added, gaps


def bench_q4k_step(torch):
    """The Qwen3-0.6B Q4K model's decode step end to end through the entry
    points every tree of the port has (LLMContext, generate_on_device, the
    decoder's graph, gpt's functions, BatchedEngine), so that a copy of
    this file in an older tree (git archive into a gitignored directory)
    times that tree.  The model's Q4K chain alone (28 layers of norms,
    SwiGLU and products, as the cached forward calls them at one row);
    generate_on_device tok/s (a
    64-token prompt, N_TOKENS tokens) and TTFT; the one-step graph's ms a
    step between CUDA events over 64 replays (the least and the median of
    5 windows), its card busy ms by kernel (torch.profiler over 32
    replays) and one replay's time line (timeline_by_kernel); 8 and 64
    slots' ms per batched step."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.ops import _build, sampling
    from nano_tpu_torch.serve.batching import BatchedEngine
    from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    _build.build_all()
    dev, cfg = torch.device("cuda"), ModelConfig(**QWEN3_06B)
    tok = TrieTokenizer()
    tok.build_preset(32768)
    ctx = engine.LLMContext(
        cfg=cfg, params=random_q4k_params(torch, np, cfg, dev), tokenizer=tok,
        max_seq_len=cfg.block_size, device=dev, dtype=torch.bfloat16,
        sampler=sampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0),
        stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")
    prompt = np.random.default_rng(SEED + 1).integers(
        100, 30000, PROMPT_LEN).tolist()
    card = card_line()
    timer = Timer(torch)

    def timed_ms(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3

    layers = [gpt.layer_params(ctx.params["blocks"], i)
              for i in range(cfg.n_layer)]
    g = torch.Generator(device=dev).manual_seed(SEED)
    xs = [torch.randn(1, 1, cfg.n_embd, device=dev, generator=g
                      ).to(torch.bfloat16) for _ in layers]
    ats = [torch.randn(1, 1, cfg.n_head * cfg.head_dim, device=dev,
                       generator=g).to(torch.bfloat16) for _ in layers]

    def chain():
        for lp, x, at in zip(layers, xs, ats):
            _, xn, _ = gpt._norm(x, lp["attn_norm"], cfg.norm_eps, [lp["wqkv"]])
            gpt._dense(xn, lp["wqkv"], torch.bfloat16)
            a = gpt._dense(at, lp["wo"], torch.bfloat16)
            _, hn, _ = gpt._norm(x, lp["ffn_norm"], cfg.norm_eps, [lp["w13"]],
                                 residual=a)
            gpt.feed_forward_cached(hn, lp, torch.bfloat16)

    t_chain = [timer(chain) for _ in range(3)]
    del xs, ats
    engine.generate_on_device(ctx, prompt, 8)          # the capture
    ttft = min(timed_ms(lambda: engine.generate_on_device(ctx, prompt, 1))
               for _ in range(3))
    t_all = timed_ms(lambda: engine.generate_on_device(ctx, prompt, N_TOKENS))
    step_ms = (t_all - ttft) / (N_TOKENS - 1)
    dec = ctx.decoder()
    names = [n for _, n in PROFILE_KEYS]
    with ctx.on_stream():
        dec.claim()
        dec.prefill(prompt)
        run = dec._graph().run
        run()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        windows = []
        for _ in range(5):
            e0.record()
            for _ in range(64):
                run()
            e1.record()
            torch.cuda.synchronize()
            windows.append(e0.elapsed_time(e1) / 64)
        groups, seen, n_k, _, _ = profile_steps(
            torch, run, 32, PROFILE_KEYS, {n: 1 for n in names})
        span, added, gaps = min((timeline_by_kernel(torch, run, 1,
                                                    PROFILE_KEYS)
                                 for _ in range(3)), key=lambda r: r[0])
    del dec
    busy = sum(groups.values()) / 32
    log(f"[bench q4k step] {card}: the model's Q4K chain "
        f"{'/'.join(f'{t:.4f}' for t in t_chain)} ms; generate_on_device "
        f"{1e3 / step_ms:.2f} tok/s ({step_ms:.3f} ms a step), TTFT "
        f"{ttft:.2f} ms; one-step graph {min(windows):.4f} ms a step (least "
        f"of 5 windows of 64 replays; median "
        f"{sorted(windows)[2]:.4f}); card busy {busy:.3f} ms a step, "
        f"{n_k / 32:.0f} kernels; busy ms a step by kernel: "
        + ", ".join(f"{k} {v / 32:.3f}" for k, v in groups.items() if v)
        + f"; one replay's time line {span:.4f} ms, time added by kernel: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(added.items()))
        + "; gaps before: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(gaps.items())))
    for n_slots in (8, 64):
        eng = BatchedEngine(ctx, n_slots=n_slots)
        trng = np.random.default_rng(SEED + n_slots)
        for _ in range(n_slots):
            eng.add(trng.integers(100, 30000, 32).tolist(),
                    max_new_tokens=10 ** 6, temperature=0.0,
                    repetition_penalty=1.0)
        eng.step_burst(8)
        ms = timed_ms(lambda: [eng.step_burst(16) for _ in range(3)]) / 48
        groups, _, n_k, _, _ = profile_steps(
            torch, lambda: eng.step_burst(16), 1, PROFILE_KEYS,
            {n: 1 for n in names})
        log(f"[bench q4k step] {n_slots} slots ({card}): {ms:.3f} ms "
            f"per batched step; card busy {sum(groups.values()) / 16:.3f} ms "
            f"a step by kernel: " + ", ".join(
                f"{k} {v / 16:.3f}" for k, v in groups.items() if v))
        del eng
        torch.cuda.empty_cache()


def bench_q4k_batched(torch, sweep=False):
    """K3 at B > 1 as batched serving and prefill call it: the 112 layer
    products of a Qwen3-0.6B Q4K forward (the head is Q80) at 8 rows (a
    batched step at 8 slots) and 64 (a batched step at 64 slots, or a
    64-token prefill), by product and in total: k3_batched_times.  Layer 0
    of each product is held to q4k_matmul_w4a4_plain first (f32 out, 1e-5
    of max|y|).  With `sweep`, also bench_w4a4_plans."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.ops import q4k
    cfg = ModelConfig(**QWEN3_06B)
    blocks = random_q4k_params(torch, np, cfg, "cuda")["blocks"]
    prods = [(name, blocks[name].layer(i)) for name in ("wqkv", "wo", "w13", "w2")
             for i in range(cfg.n_layer)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for B, label in ((8, "a batched step, 8 slots"),
                     (64, "a batched step at 64 slots or a 64-token prefill")):
        for name in ("wqkv", "wo", "w13", "w2"):
            w = blocks[name].layer(0)
            act = q4k.act_quant_q4k_packed(
                torch.randn(B, w.in_dim, device="cuda", generator=gen))
            y = q4k.q4k_matmul_w4a4(*act, w, torch.float32)
            ref = q4k.q4k_matmul_w4a4_plain(*act, w, torch.float32)
            err = (y - ref).abs().max().item() / ref.abs().max().item()
            if not err <= 1e-5:
                raise AssertionError(f"q4k_matmul_w4a4 {name} B={B}: "
                                     f"max|d|/max|y| {err:.2e}")
        k3_batched_times(torch, prods, B, "bench q4k batched", label,
                         by_product=True)
        if sweep:
            bench_w4a4_plans(torch, B, prods)
    torch.cuda.synchronize()


def bench_w4a4_plans(torch, B, prods):
    """Every work split q4k_matmul_w4a4 takes (MB rows a block; BN slots a
    tile, w4a4_plan's, half and twice it within 8-64; CS blocks a cluster;
    S stages) at each product's launches (all layers) on random rows, the
    fastest first, beside w4a4_plan's choice: for work on the plan."""
    from nano_tpu_torch.ops import _build, int8_mma, q4k
    lib = _build.lib("q4k")
    int8_mma.init(torch.device("cuda", 0), "q4k_matmul_w4a4_init")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timer = Timer(torch)
    for name in ("wqkv", "wo", "w13", "w2"):
        idx = [j for j, (n, _) in enumerate(prods) if n == name]
        w0 = prods[idx[0]][1]
        N, n_pad = w0.out_dim, w0.n_pad
        nck = n_pad // q4k.BLOCK_LEN
        acts = [q4k.act_quant_q4k_packed(torch.randn(
            B, w0.in_dim, device="cuda", generator=gen)) for _ in idx]
        ys = [torch.empty(B, N, dtype=torch.bfloat16, device="cuda")
              for _ in idx]
        chosen = q4k.w4a4_plan(B, N, n_pad)
        res = []
        for MB in (64, 128):
            for BN in (8, 16, 32, 64):
                if not chosen[1] // 2 <= BN <= 2 * chosen[1]:
                    continue
                for CS in (1, 2, 4, 8):
                    for S in (1, 2, 3, 4):
                        if (CS > nck or S > -(-nck // CS)
                                or q4k.w4a4_smem(MB, BN, CS, S) > 232448):
                            continue
                        pl = (MB, BN, CS, S)

                        def run(pl=pl):
                            for j, act, y in zip(idx, acts, ys):
                                wl = prods[j][1]
                                _build.check(lib.q4k_matmul_w4a4(
                                    *(t.data_ptr() for t in act),
                                    wl.packed.data_ptr(), wl.scales.data_ptr(),
                                    wl.biases.data_ptr(), y.data_ptr(), 1, B,
                                    n_pad, wl.in_dim, N, *pl,
                                    torch.cuda.current_stream().cuda_stream),
                                    "q4k_matmul_w4a4")
                        res.append((timer(run, reps=10), pl))
        res.sort()
        at = next(t for t, pl in res if pl == chosen)
        log(f"[bench q4k plans] B={B} {name} ({len(idx)} x {w0.in_dim}->{N}): "
            + ", ".join(f"{pl} {t:.4f}" for t, pl in res[:8])
            + f"; w4a4_plan {chosen} {at:.4f} ms ({len(res)} splits)")


def bench_q80(torch, clocks=False, batched=False, sweep=False):
    """With `batched`, bench_q80_batched and nothing else.  Else: one
    Qwen3-0.6B Q80 decode step's 113 W8A8 products (random per-layer
    weights as random_q80_params makes them, bf16 rows) replayed from a
    CUDA graph, by product and in total: q80_act_quant + q80_matmul_w8a8
    against q80_matvec_fq, in the order pair, fused, fused, pair; the fused
    bf16 results must be within 1e-2 of max|y| of the pair's (the same
    integer decisions, f32 sums in another order).  With `clocks`, where a
    launch's time goes (bench_q80_clocks)."""
    if batched:
        return bench_q80_batched(torch, sweep, clocks)
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.ops import _build, int8_mma, qmatmul
    cfg = ModelConfig(**QWEN3_06B)
    params = random_q80_params(torch, np, cfg, "cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lib = _build.lib("q80_matmul")
    int8_mma.init(torch.device("cuda", 0), "q80_matmul_init")
    st = lambda: torch.cuda.current_stream().cuda_stream
    calls = []    # (product, weight, x, xq, sa, y pair, y fused, plan)
    for name in ("wqkv", "wo", "w13", "w2", "head"):
        w = params["output_q"] if name == "head" else params["blocks"][name]
        for wl in ([w] if w.q.dim() == 2 else [w.layer(i) for i in range(w.q.shape[0])]):
            K, N = wl.in_dim, wl.out_dim
            calls.append((name, wl,
                          torch.randn(1, K, device="cuda", generator=gen).to(torch.bfloat16),
                          torch.empty(1, K, dtype=torch.int8, device="cuda"),
                          torch.empty(1, K // GS, device="cuda"),
                          torch.empty(1, N, device="cuda", dtype=torch.bfloat16),
                          torch.empty(1, N, device="cuda", dtype=torch.bfloat16),
                          qmatmul.matvec_plan(N, K, GS, sms)))

    def pair(cs):
        for _, wl, x, xq, sa, y, *_ in cs:
            lib.q80_act_quant(x.data_ptr(), 1, xq.data_ptr(), sa.data_ptr(), 1,
                              wl.in_dim, GS, st())
            _build.check(lib.q80_matmul_w8a8(
                xq.data_ptr(), sa.data_ptr(), wl.q.data_ptr(),
                wl.scales.data_ptr(), y.data_ptr(), 1, 1, wl.in_dim,
                wl.out_dim, GS, *qmatmul.w8a8_plan(1, wl.out_dim, wl.in_dim,
                                                   GS, sms), st()),
                "q80_matmul_w8a8")

    def fused(cs):
        for _, wl, x, _, _, _, y, plan in cs:
            _build.check(lib.q80_matvec_fq(
                x.data_ptr(), 1, wl.q.data_ptr(), wl.scales.data_ptr(),
                y.data_ptr(), 1, None, None, wl.in_dim, wl.out_dim, GS, *plan,
                qmatmul.w8a8_ranges(wl.out_dim, wl.in_dim, GS, sms), st()),
                "q80_matvec_fq")

    timer = Timer(torch)
    for name in ("wqkv", "wo", "w13", "w2", "head", "step"):
        cs = calls if name == "step" else [c for c in calls if c[0] == name]
        t = [timer(lambda: f(cs), reps=50) for f in (pair, fused, fused, pair)]
        b_ms, _ = bound(sum(c[1].q.numel() + 4 * c[1].scales.numel()
                            + 2 * c[1].in_dim + 2 * c[1].out_dim for c in cs), 0, 1)
        log(f"[bench q80] {name} ({len(cs)} launches, plan {cs[0][7]}): pair "
            f"{t[0]:.4f} / {t[3]:.4f} ms, q80_matvec_fq {t[1]:.4f} / "
            f"{t[2]:.4f} ms, bound {b_ms:.4f} ms")
    torch.cuda.synchronize()
    worst = max(((c[6].float() - c[5].float()).abs().max()
                 / c[5].float().abs().max()).item() for c in calls)
    log(f"[bench q80] fused vs pair, worst max|d|/max|y| {worst:.2e}")
    if not worst <= 1e-2:
        raise AssertionError("q80_matvec_fq differs from the pair")
    if clocks:
        bench_q80_clocks(torch, [next(c for c in calls if c[0] == n)
                                 for n in ("wqkv", "wo", "w13", "w2", "head")])


def bench_q80_batched(torch, sweep=False, clocks=False):
    """K1 at B > 1 as batched serving and prefill call it: a batched decode
    step's 113 Q80 products (28 layers' wqkv, wo, w13, w2 on random
    per-layer weights as random_q80_params makes them, and the head) at 8
    and 64 slots, and a 64-token prefill's 112 (the layer products; its
    head is one q80_matvec_fq row), replayed from a CUDA graph, by product
    and in total: q80_matmul_w8a8 alone on rows quantized ahead, the pair
    q80_act_quant + q80_matmul_w8a8 as the model calls it, and the bf16
    torch.matmul on weights dequantized ahead, in the order kernel, library,
    library, kernel, beside the bound.  Layer 0 of each product is held
    to q80_w8a8_plain first (f32 out, 1e-5 of max|y|).  It uses only the
    wrappers' interface, which the warp-per-row kernel before it had too,
    so a copy of this file in an older tree times that tree's kernel.  With `sweep`, also bench_w8a8_plans, and
    with `clocks` bench_w8a8_clocks, at 8 and 64 slots."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.ops import qmatmul
    cfg = ModelConfig(**QWEN3_06B)
    params = random_q80_params(torch, np, cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16
    prods = [(name, wl) for name in ("wqkv", "wo", "w13", "w2", "head")
             for wl in ([params["output_q"]] if name == "head" else
                        [params["blocks"][name].layer(i)
                         for i in range(cfg.n_layer)])]
    wds = [wl.dequantize(bf16) for _, wl in prods]
    plan = getattr(qmatmul, "w8a8_plan", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = Timer(torch)
    for label, B, names in (("step, 8 slots", 8, None),
                            ("step, 64 slots", 64, None),
                            ("prefill, 64 rows", 64, ("wqkv", "wo", "w13", "w2"))):
        xs = [torch.randn(B, wl.in_dim, device="cuda", generator=gen).to(bf16)
              for _, wl in prods]
        qs = [qmatmul.act_quant_q80_plain(x, GS) for x in xs]
        if names is None:
            for name in ("wqkv", "wo", "w13", "w2", "head"):
                i = next(j for j, (n, _) in enumerate(prods) if n == name)
                y = qmatmul.q80_w8a8(*qs[i], prods[i][1], torch.float32)
                ref = qmatmul.q80_w8a8_plain(*qs[i], prods[i][1], torch.float32)
                err = (y - ref).abs().max().item() / ref.abs().max().item()
                if not err <= 1e-5:
                    raise AssertionError(f"q80_matmul_w8a8 {name} B={B}: "
                                         f"max|d|/max|y| {err:.2e}")
        for name in ("wqkv", "wo", "w13", "w2", "head", "all"):
            if name == "all":
                idx = [j for j, (n, _) in enumerate(prods)
                       if names is None or n in names]
            elif names is not None and name not in names:
                continue
            else:
                idx = [j for j, (n, _) in enumerate(prods) if n == name]
            run_k = lambda idx=idx: [qmatmul.q80_w8a8(*qs[j], prods[j][1], bf16)
                                     for j in idx]
            run_p = lambda idx=idx: [qmatmul.q80_w8a8(
                *qmatmul.act_quant_q80(xs[j], GS), prods[j][1], bf16) for j in idx]
            run_l = lambda idx=idx: [torch.matmul(xs[j], wds[j].t()) for j in idx]
            t_k = [timer(run_k, reps=20)]
            t_l = [timer(run_l, reps=20), timer(run_l, reps=20)]
            t_k.append(timer(run_k, reps=20))
            t_p = timer(run_p, reps=20)
            ws = [prods[j][1] for j in idx]
            nb = sum(wl.q.numel() + 4 * wl.scales.numel() + B * wl.in_dim
                     + 4 * B * wl.in_dim // GS + 2 * B * wl.out_dim for wl in ws)
            b_ms, b_by = bound(nb, sum(2 * B * wl.q.numel() for wl in ws),
                               INT8_OPS_PER_S)
            wl = ws[0]
            what = (f"{len(idx)} launches" if name == "all" else
                    f"{len(idx)} x {wl.in_dim}->{wl.out_dim}" + (
                        f", plan (MB, BN, CS, S) "
                        f"{plan(B, wl.out_dim, wl.in_dim, GS, sms)}" if plan else ""))
            log(f"[bench q80 batched] {label}, {name} ({what}): q80_matmul_w8a8 "
                f"{t_k[0]:.4f} / {t_k[1]:.4f} ms, bf16 torch.matmul "
                f"{t_l[0]:.4f} / {t_l[1]:.4f} ms (kernel / library "
                f"{min(t_k) / min(t_l):.2f}), with q80_act_quant {t_p:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}, {nb / 1e6:.1f} MB)")
        if sweep and names is None:
            bench_w8a8_plans(torch, B, prods, qs)
        if clocks and names is None:
            bench_w8a8_clocks(torch, B, prods, qs)
        del xs, qs
    torch.cuda.synchronize()


def bench_w8a8_clocks(torch, B, prods, qs):
    """Builds q80_matmul.cu once more with -DNANO_W8A8_CLOCKS into
    build/q80_clocks/ and launches layer 0 of each product once with
    w8a8_plan's split, the L2 cleared before it (a 256 MB write): per
    launch the span from the first block's entry to the last block's exit,
    the spread of the entries, and the median over blocks of each stamp
    (first chunk in, products done, the cluster's tiles met, exit) after
    the block's entry, in ns of %globaltimer."""
    import ctypes
    import statistics
    from nano_tpu_torch.ops import _build, qmatmul
    work = os.path.join(ROOT, "build", "q80_clocks")
    os.makedirs(work, exist_ok=True)
    so = os.path.join(work, "libq80_w8a8_clocks.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-DNANO_W8A8_CLOCKS", "-o", so,
                    os.path.join(_build.CSRC_DIR, "q80_matmul.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.q80_matmul_init()
    lib.q80_matmul_w8a8.argtypes = _build.SIGNATURES["q80_matmul_w8a8"][0]
    lib.q80_matmul_w8a8_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 << 20, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    for name in ("wqkv", "wo", "w13", "w2", "head"):
        j = next(i for i, (n, _) in enumerate(prods) if n == name)
        wl = prods[j][1]
        K, N = wl.in_dim, wl.out_dim
        plan = qmatmul.w8a8_plan(B, N, K, GS, sms)
        y = torch.empty(B, N, dtype=torch.bfloat16, device="cuda")
        for _ in range(2):    # the first launch warms up
            flush.zero_()
            assert lib.q80_matmul_w8a8(
                qs[j][0].data_ptr(), qs[j][1].data_ptr(), wl.q.data_ptr(),
                wl.scales.data_ptr(), y.data_ptr(), 1, B, K, N, GS, *plan,
                st) == 0
            torch.cuda.synchronize()
        MB, BN, CS, _ = plan
        nb = min(8192, -(-N // MB) * CS * -(-B // BN))
        buf = (ctypes.c_ulonglong * (5 * nb))()
        assert lib.q80_matmul_w8a8_clocks(buf, nb) == 0
        t = [list(buf)[5 * b:5 * b + 5] for b in range(nb)]
        t0 = min(r[0] for r in t)
        med = [statistics.median(r[k] - r[0] for r in t) for k in range(1, 5)]
        log(f"[bench q80 clocks] B={B} {name} plan {plan}, {nb} blocks: span "
            f"{max(r[4] for r in t) - t0} ns, entries spread over "
            f"{max(r[0] for r in t) - t0} ns; median after entry: first "
            f"chunk in {med[0]:.0f}, products done {med[1]:.0f}, tiles met "
            f"{med[2]:.0f}, exit {med[3]:.0f} ns")


def bench_w8a8_plans(torch, B, prods, qs):
    """Every work split q80_matmul_w8a8 takes (MB rows a block, BN slots a
    tile: w8a8_plan's, half or a quarter of it, CS blocks a cluster, S
    stages) at each product's launches (all layers), the fastest first,
    beside w8a8_plan's choice: for work on the plan."""
    from nano_tpu_torch.ops import _build, int8_mma, qmatmul
    lib = _build.lib("q80_matmul")
    int8_mma.init(torch.device("cuda", 0), "q80_matmul_init")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = Timer(torch)
    for name in ("wqkv", "wo", "w13", "w2", "head"):
        idx = [j for j, (n, _) in enumerate(prods) if n == name]
        wl0 = prods[idx[0]][1]
        K, N = wl0.in_dim, wl0.out_dim
        G = K // GS
        ys = [torch.empty(B, N, dtype=torch.bfloat16, device="cuda") for _ in idx]
        chosen = qmatmul.w8a8_plan(B, N, K, GS, sms)
        res = []
        for MB, BN in ((mb, bn) for mb in (64, 128)
                       for bn in sorted({max(8, chosen[1] >> k) for k in range(3)})):
            for CS in (1, 2, 4, 8):
                if CS > min(8, G):
                    continue
                for S in (1, 2, 3, 4):
                    if (S > -(-G // CS) * GS // qmatmul.W8A8_KC
                            or qmatmul.w8a8_smem(MB, BN, CS, S) > 232448):
                        continue
                    pl = (MB, BN, CS, S)

                    def run(pl=pl):
                        for j, y in zip(idx, ys):
                            wl = prods[j][1]
                            _build.check(lib.q80_matmul_w8a8(
                                qs[j][0].data_ptr(), qs[j][1].data_ptr(),
                                wl.q.data_ptr(), wl.scales.data_ptr(),
                                y.data_ptr(), 1, B, K, N, GS, *pl,
                                torch.cuda.current_stream().cuda_stream),
                                "q80_matmul_w8a8")
                    res.append((timer(run, reps=10), pl))
        res.sort()
        at = next(t for t, pl in res if pl == chosen)
        log(f"[bench q80 plans] B={B} {name} ({len(idx)} x {K}->{N}): "
            + ", ".join(f"{pl} {t:.4f}" for t, pl in res[:8])
            + f"; w8a8_plan {chosen} {at:.4f} ms ({len(res)} splits)")


def bench_q80_clocks(torch, calls):
    """Builds q80_matmul.cu once more with -DNANO_MV_CLOCKS into
    build/q80_clocks/ and launches each product once (layer 0) with the L2
    cleared before it (a 256 MB write), x cold and x just written (as in a
    decode step, where x comes from the kernel before): per launch the
    span from the first block's entry to the last block's dot, the spread
    of the entries, and the median over blocks of each stamp (x in shared
    memory, x quantized, first tile in, dot done) after the block's entry, in ns of
    %globaltimer (and in cycles of clock64)."""
    import ctypes
    import statistics
    from nano_tpu_torch.ops import _build, qmatmul
    work = os.path.join(ROOT, "build", "q80_clocks")
    os.makedirs(work, exist_ok=True)
    so = os.path.join(work, "libq80_clocks.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-DNANO_MV_CLOCKS", "-o", so,
                    os.path.join(_build.CSRC_DIR, "q80_matmul.cu")], check=True)
    lib = ctypes.CDLL(so)
    lib.q80_matvec_fq.argtypes = _build.SIGNATURES["q80_matvec_fq"][0]
    lib.q80_matvec_fq_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    flush = torch.empty(64 << 20, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    for (name, wl, x, _, _, _, y, plan), hot in (
            (c, h) for c in calls for h in (False, True)):
        for _ in range(2):    # the first launch warms up
            flush.zero_()
            if hot:
                x.mul_(1)
            assert lib.q80_matvec_fq(
                x.data_ptr(), 1, wl.q.data_ptr(), wl.scales.data_ptr(),
                y.data_ptr(), 1, None, None, wl.in_dim, wl.out_dim, GS, *plan,
                qmatmul.w8a8_ranges(wl.out_dim, wl.in_dim, GS,
                                    _build.sm_count(x.device)), st) == 0
            torch.cuda.synchronize()
        nb = plan[0]
        buf = (ctypes.c_ulonglong * (10 * nb))()
        assert lib.q80_matvec_fq_clocks(buf, nb) == 0
        t = [list(buf)[10 * b:10 * b + 10] for b in range(nb)]
        t0 = min(r[0] for r in t)
        med = [statistics.median(r[k] - r[0] for r in t) for k in range(1, 5)]
        cyc = [statistics.median(r[5 + k] - r[5] for r in t) for k in range(1, 5)]
        mhz = statistics.median((r[9] - r[5]) * 1e3 / max(r[4] - r[0], 1)
                                for r in t)
        log(f"[bench q80 clocks] {name} plan {plan}, x "
            f"{'just written' if hot else 'cold'}: span "
            f"{max(r[4] for r in t) - t0} ns, entries spread over "
            f"{max(r[0] for r in t) - t0} ns; median after entry: x in "
            f"{med[0]:.0f}, x quantized {med[1]:.0f}, first tile in "
            f"{med[2]:.0f}, dot done {med[3]:.0f} ns ("
            + "/".join(f"{c:.0f}" for c in cyc)
            + f" cycles, SM clock ~{mhz:.0f} MHz)")


# (substring of a kernel's name in a profile, the kernel): the witness of
# profile_witness
PROFILE_KEYS = (("w8a8_kernel", "q80_matmul_w8a8"),
                ("w4a4_kernel", "q4k_matmul_w4a4"),
                ("q4k_act_quant_kernel", "q4k_act_quant"),
                ("act_quant_kernel", "q80_act_quant"),   # after q4k's
                ("q80_matvec_fq_kernel", "q80_matvec_fq"),
                ("rms_norm_q80_kernel", "rms_norm_q80"),
                ("swiglu_q80_kernel", "swiglu_q80"),
                ("rms_norm_q4k_kernel", "rms_norm_q4k"),
                ("rms_norm_fq_kernel", "rms_norm_q4k_fq"),
                ("swiglu_q4k_kernel", "swiglu_q4k"),
                ("decode_attn_kernel", "decode_attention"),
                ("q4k_matvec_fq_kernel", "q4k_matvec_fq"),
                ("q4k_mat", "q4k_matmul"),      # matvec (B=1), matmul
                ("fake_quant_kernel", "q4k_fake_quant"),
                ("q80_matvec_rows_kernel", "q80_matvec_rows"),
                ("q80_matmul_rows_kernel", "q80_matmul_rows"),
                ("rows_kernel", "q80_matmul_rows_warp"))   # after the two


def profile_witness(torch, card, label, kind, step, n, steps_per_call,
                    wall_bare_ms, per_step):
    """torch.profiler over n calls of step(), each steps_per_call decode
    steps: card busy ms a step by kernel, kernels a step, and the idle
    share against the step timed with the profiler off.  The launches
    of each kernel of PROFILE_KEYS that the profiler saw are a witness
    of what the card ran, apart from the Python counters: never more
    than per_step's count times the steps (0 where it has none), and
    equal to it in one of at most three profiles (the trace loses a
    record now and then: each short profile is logged with what it
    lost, and the window profiled again).  -> {"busy": card busy ms,
    "kernels": kernels, "other": busy ms of the kernels PROFILE_KEYS
    does not name, each a step}, or None where the profiler recorded
    no device time."""
    per = n * steps_per_call
    for attempt in range(1, 4):
        groups, seen, n_kernels, wall_ms, others = profile_steps(
            torch, step, n, PROFILE_KEYS, per_step)
        want = {name: per_step.get(name, 0) * per for name in seen}
        lost = {k: want[k] - seen[k] for k in seen if seen[k] < want[k]}
        log(f"[profile {label}] {kind}: launches by kernel as the "
            f"profiler saw them {seen}; expected {want}"
            + (f"; short by {lost} in profile {attempt}" if lost else ""))
        if sum(groups.values()) <= 0:
            log(f"[profile {label}] {kind}: the profiler recorded no "
                f"device time: not measured")
            return None
        if any(seen[k] > want[k] for k in seen):
            raise AssertionError(f"{label} {kind}: the card ran kernels "
                                 f"beyond the per-step counts")
        if not lost:
            break
    else:
        raise AssertionError(f"{label} {kind}: three profiles lost "
                             f"records of the per-step counts")
    wall_ms /= steps_per_call
    busy_ms = sum(groups.values()) / per
    log(f"[profile {label}] {kind} ({per} steps, {card}): wall "
        f"{wall_ms:.3f} ms/step with the profiler on, {wall_bare_ms:.3f} "
        f"off; card busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f} (profiler on) / "
        f"{1 - busy_ms / wall_bare_ms:.3f} (off), {n_kernels / per:.0f} "
        f"kernels per step; busy ms per step by kernel: "
        + ", ".join(f"{k} {v / per:.3f}" for k, v in groups.items())
        + "; the most of other: " + ", ".join(
            f"{k[:60]} {v / per:.3f}" for k, v in sorted(
                others.items(), key=lambda kv: -kv[1])[:4]))
    return dict(busy=busy_ms, kernels=n_kernels / per,
                other=groups["other"] / per)


# each kernel's launch counter: (its wrapper in ops.launches.COUNTERS, the
# count's name)
COUNTER_OF = dict(
    q80_act_quant=("act_quant_q80", "launches"),
    q80_matmul_w8a8=("q80_w8a8", "launches"),
    q80_matmul_rows=("q80_matmul_rows", "launches"),
    q80_matvec_rows=("q80_matvec_rows", "launches"),
    q80_matmul_rows_warp=("q80_matmul_rows_warp", "launches"),
    q80_matvec_fq=("q80_matvec_fq", "launches"),
    rms_norm_q80=("rms_norm_q80", "launches"),
    swiglu_q80=("swiglu_q80", "launches"),
    rms_norm_q4k=("rms_norm_q4k", "launches"),
    rms_norm_q4k_fq=("rms_norm_q4k_fq", "launches"),
    swiglu_q4k=("swiglu_q4k", "launches"),
    decode_attention=("decode_attention", "launches"),
    q4k_fake_quant=("fake_quant_act", "launches"),
    q4k_matmul=("q4k_matmul_f32", "launches"),
    q4k_matvec_fq=("q4k_matvec_fq", "launches"),
    q4k_act_quant=("act_quant_q4k_packed", "launches"),
    q4k_matmul_w4a4=("q4k_matmul_w4a4", "launches"),
    flash_attn_fwd=("flash_attention", "launches"),
    flash_attn_bwd=("flash_attention", "backward_launches"),
    # of those, the calls whose route took the wgmma kernels
    # (csrc/flash_fwd_wgmma.cu, csrc/flash_bwd_wgmma.cu): the counters that
    # show a main path went through them, read beside flash_attn_fwd and
    # flash_attn_bwd (no rows of their own)
    flash_attn_fwd_wgmma=("flash_attention", "forward_wgmma_launches"),
    flash_attn_bwd_wgmma=("flash_attention", "wgmma_launches"))
WGMMA_COUNTERS = ["flash_attn_fwd_wgmma", "flash_attn_bwd_wgmma"]


def zero_launches(torch):
    """Every kernel's launch counter set to 0, the card idle first (where
    there is one: phase 10's ranks rehearse on the CPU)."""
    from nano_tpu_torch.ops import launches
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches.restore({key: 0 for key in launches.counts()})


def read_launches(torch, names):
    """{kernel: its launch count} for the kernels `names`, the card idle
    first (where there is one)."""
    from nano_tpu_torch.ops import launches
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    counts = launches.counts()
    return {n: counts[COUNTER_OF[n]] for n in names}


def decode_counts(model, steps, names, L=28):
    """Launches of an L-layer Qwen3 model's 64-row prefill and `steps`
    decode steps, over the kernels `names` (0 where none).  The Q4K
    model's norms and SwiGLUs write its products' Q4K activations at every
    row count (rms_norm_q4k, swiglu_q4k), so q4k_act_quant runs on wo's
    input alone, L times a forward; its final norm writes the fake-quantized
    row that the requantized Q80 head reads (rms_norm_q4k_fq: no
    q4k_fake_quant launch)."""
    e = {n: 0 for n in names}
    if model == "Q80":
        e.update(q80_act_quant=L, q80_matmul_w8a8=4 * L,
                 q80_matvec_fq=(4 * L + 1) * steps + 1,
                 rms_norm_q80=(2 * L + 1) * (1 + steps),
                 swiglu_q80=L * (1 + steps))
    else:
        e.update(q4k_act_quant=L * (1 + steps), q4k_matmul_w4a4=4 * L,
                 q4k_matvec_fq=4 * L * steps, q80_matvec_fq=1 + steps,
                 rms_norm_q4k_fq=1 + steps, rms_norm_q4k=2 * L * (1 + steps),
                 swiglu_q4k=L * (1 + steps))
    e.update(decode_attention=L * steps)
    return e


def spec_round_counts(model, L=28):
    """Launches of one verify round of an L-layer Qwen3 model, any k
    (Qwen3-0.6B: 113 q80_matmul_w8a8, 28 q80_act_quant, 57 rms_norm_q80, 28
    swiglu_q80 and no decode_attention or q80_matvec_fq for Q80)."""
    if model == "Q80":
        return dict(q80_matmul_w8a8=4 * L + 1, q80_act_quant=L,
                    rms_norm_q80=2 * L + 1, swiglu_q80=L)
    return dict(q4k_act_quant=L, q4k_matmul_w4a4=4 * L, q80_act_quant=1,
                q80_matmul_w8a8=1, rms_norm_q4k_fq=1, rms_norm_q4k=2 * L,
                swiglu_q4k=L)


def runs_of(xs) -> str:
    """[1, 1, 2, 0, 0] -> "1x2 2 0x2"."""
    out = []
    for x in xs:
        if out and out[-1][0] == x:
            out[-1][1] += 1
        else:
            out.append([x, 1])
    return " ".join(f"{x}x{n}" if n > 1 else f"{x}" for x, n in out)


def agreeing(a, b) -> int:
    """The length of the common prefix of two token lists."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def spec_phase(torch, np, h):
    """Phase 5c, speculative decode on the full-width models: h holds the
    model config, the contexts' keywords, the models [(label, params,
    expect_for)], phase 5's prompt, the card line, the launch counters'
    names, reset / read, profile_line and timed_ms.  For each model:

      * generate_on_device with spec_k = SPEC_K and without, in turns
        (spec, plain, plain, spec), on phase 5's prompt and on a 64-token
        prompt of a repeated 8-token pattern: tok/s, tokens, rounds and
        tokens a round, the agreeing prefix of the two streams, the launch
        counts of each call (the prefill's, then spec_round_counts per
        replayed round, a multiple of SPEC_READ_EVERY replays);
      * the busy ms of one verify round at k = 1, 3, 7 (profiler, launches
        held to spec_round_counts) beside the plain step's;
      * SPEC_LOGIT_ROUNDS verify rounds of 8 rows fed the plain stream,
        each row's logits against the plain step's at the same prefix,
        within SPEC_LOGITS_TOL of max|logit|, and the control (the causal
        mask shifted by one position) above it;
      * a Session with spec_k = SPEC_SESSION_K: its k after every token and
        its decode calls by kind;
      * BatchedEngine at 8 and 64 slots with spec_k = SPEC_BATCH_K and
        without, in turns: slot 0 at temperature 0.8 (its stream must be
        the plain engine's), half the greedy slots on an 8-token pattern;
        ms a batched step, aggregate tok/s, tokens a slot-step, the greedy
        slots' agreeing prefixes, bursts by kind, launch counts."""
    from nano_tpu_torch.infer import engine, speculative
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.serve.batching import BatchedEngine
    dev, cfg, card = h.dev, h.cfg, h.card
    srng = np.random.default_rng(SEED + 7)
    pattern = srng.integers(100, 30000, 8).tolist()
    prompts = {"random": h.prompt, "repetitive": pattern * (PROMPT_LEN // 8)}

    def ctx_of(p, spec_k):
        return engine.LLMContext(params=p, spec_k=spec_k, **h.ctx_kw)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def shifted_mask(on):
        """The control: every block of the verify forward given its causal
        mask shifted by one position (row i also sees row i + 1), rebound
        here for the measurement."""
        saved = gpt.block

        def block(x, layer, cfg_, cos, sin, mask, *a, **kw):
            if mask is not None:
                mask = torch.cat([mask[..., :1], mask[..., :-1]], dim=-1)
            return saved(x, layer, cfg_, cos, sin, mask, *a, **kw)

        if on:
            gpt.block = block
        try:
            yield
        finally:
            gpt.block = saved

    def round_rows(p, ctx, pr, cont, shift=False, first=False):
        """SPEC_LOGIT_ROUNDS verify rounds of 8 rows fed `cont` after
        prompt `pr`, each on a copy of the plain steps' cache (the same
        prefix), each row's logits against the plain step's
        (forward_decode_batched, the kernels the decode graph replays).
        `shift`: the control's mask; `first`: row 0 through the decode
        kernel (first_row_kernel).  -> (the worst max|d| / max|logit|, the
        rounds whose row 0 is torch.equal to the plain step's)."""
        k = 7
        rope = ctx.rope_tables()
        cp = ctx.new_cache(1)
        engine._prefill(ctx, pr, cp)
        full = torch.tensor(pr + cont, device=dev)
        worst, same0, pos = 0.0, 0, len(pr)
        for _ in range(SPEC_LOGIT_ROUNDS):
            cs = gpt.KVCache(*(None if t is None else t.clone() for t in (
                cp.k, cp.v, cp.k_scale, cp.v_scale)))
            ids = full[pos:pos + k + 1][None]
            p_t = torch.tensor([pos], dtype=torch.int32, device=dev)
            with shifted_mask(shift):
                ls, _ = gpt.forward_spec_batched(
                    p, ids, cs, p_t, cfg, ctx.dtype, rope=rope,
                    attn_len=engine._attn_bucket(pos + k + 2, ctx.max_seq_len,
                                                 minimum=256),
                    first_row_kernel=first)
            for j in range(k + 1):
                lp, _ = gpt.forward_decode_batched(p, ids[:, j], cp, p_t + j,
                                                   cfg, ctx.dtype, rope)
                worst = max(worst, ((ls[0, j] - lp[0]).abs().max()
                                    / lp[0].abs().max()).item())
                same0 += j == 0 and torch.equal(ls[0, 0], lp[0])
            pos += k + 1
        return worst, same0

    failures = []
    for model, p, expect_for in h.models:
        per_round = {n: 0 for n in h.names}
        per_round.update(spec_round_counts(model, cfg.n_layer))
        plain_step = {n: expect_for(1)[n] - expect_for(0)[n] for n in h.names}
        ctxs = {"spec": ctx_of(p, SPEC_K), "plain": ctx_of(p, 0)}
        tag = f"[spec {model}]"

        # ---- the single stream: generate_on_device, in turns
        plain_streams = {}
        for pname, pr in prompts.items():
            for c in ctxs.values():             # warm-up: the captures
                engine.generate_on_device(c, pr, SPEC_TOKENS)
            ttft = min(h.timed_ms(lambda: engine.generate_on_device(
                ctxs["plain"], pr, 1)) for _ in range(3))
            res = {"spec": [], "plain": []}
            for which in ("spec", "plain", "plain", "spec"):
                got = []
                h.reset()
                ms = h.timed_ms(lambda: got.append(engine.generate_on_device(
                    ctxs[which], pr, SPEC_TOKENS).tolist()))
                res[which].append((ms, got[0], h.read(),
                                   dict(speculative.LAST_STATS)))
            spec, plain = res["spec"][0][1], res["plain"][0][1]
            plain_streams[pname] = plain
            stats = res["spec"][0][3]
            if not (len(spec) == len(plain) == SPEC_TOKENS
                    and max(spec) < cfg.vocab_size
                    and all(r[1] == spec for r in res["spec"])
                    and all(r[1] == plain for r in res["plain"])
                    and stats["tokens"] >= SPEC_TOKENS - 1):
                raise AssertionError(f"{model} {pname}: spec or plain streams "
                                     f"malformed or not repeatable")
            prefill = expect_for(0)
            for ms, _, counts, st in res["spec"]:
                m = ((counts["q80_act_quant"] - prefill["q80_act_quant"])
                     // per_round["q80_act_quant"])
                want = {n: prefill[n] + m * per_round[n] for n in h.names}
                if (counts != want or m % engine.SPEC_READ_EVERY
                        or m < st["rounds"]):
                    raise AssertionError(f"{model} {pname}: spec launches "
                                         f"{counts}, not the prefill's and "
                                         f"{m} rounds' {per_round}")
            for _, _, counts, _ in res["plain"]:
                if counts != expect_for(SPEC_TOKENS - 1):
                    raise AssertionError(f"{model} {pname}: plain launches "
                                         f"differ")
            tps = {w: (SPEC_TOKENS - 1) / ((min(r[0] for r in res[w]) - ttft)
                                         / 1e3) for w in res}
            log(f"{tag} generate_on_device, {pname} prompt of {PROMPT_LEN}, "
                f"{SPEC_TOKENS} tokens ({card}), better of two in turns: spec_k "
                f"{SPEC_K} {tps['spec']:.1f} tok/s ({stats['tokens']} tokens "
                f"in {stats['rounds']} rounds, "
                f"{stats['tokens'] / stats['rounds']:.2f} tokens a round, "
                f"{m} rounds replayed), plain {tps['plain']:.1f} tok/s, "
                f"spec / plain {tps['spec'] / tps['plain']:.2f}; the streams "
                f"agree for {agreeing(spec, plain)} of {SPEC_TOKENS} tokens; "
                f"launches a round {spec_round_counts(model, cfg.n_layer)} (0 "
                f"decode_attention, 0 q80_matvec_fq)")

        # ---- one replay's cost, a verify round at k = 1, 3, 7 beside the
        # plain step: the card's ms between CUDA events on the context's
        # stream, and a round's busy ms by the profiler, its launches held
        # to spec_round_counts (the plain step's busy ms: phase 5's profile)
        cost = {}
        for which, ks in (("spec", (1, 3, 7)), ("plain", (0,))):
            ctx = ctxs[which]
            dec = ctx.decoder()
            for k in ks:
                with ctx.on_stream():
                    dec.claim()
                    dec.prefill(h.prompt)
                    g = (dec._round_graph(k, engine._attn_bucket(
                        PROMPT_LEN + 16 * (k + 1) + 2, ctx.max_seq_len,
                        minimum=256)) if k else dec._graph())
                    g.run()
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    for _ in range(8):
                        g.run()
                    ev[1].record()
                    torch.cuda.synchronize()
                    ms = ev[0].elapsed_time(ev[1]) / 8
                    prof = None
                    if k:
                        dec.prefill(h.prompt)
                        prof = h.profile_line(f"spec {model}",
                                              f"verify round k={k}", g.run,
                                              8, 1, ms, per_round)
                cost[k] = (ms, None if prof is None else prof["busy"])
        fmt = lambda k: f"{cost[k][0]:.3f} ms" + (
            "" if not k else " (busy not measured)" if cost[k][1] is None
            else f" (busy {cost[k][1]:.3f} ms)")
        log(f"{tag} one replay from position {PROMPT_LEN} ({card}), the "
            f"card's ms between CUDA events: verify round k=1 {fmt(1)}, k=3 "
            f"{fmt(3)}, k=7 {fmt(7)}; the plain step {fmt(0)}; round / step "
            + ", ".join(f"k={k} {cost[k][0] / cost[0][0]:.2f}"
                        for k in (1, 3, 7)))

        # ---- each round's logits row by row against the plain step's,
        # from a 4-token prompt (few rows attended: the control bites)
        ctx = ctxs["plain"]
        short_prompt = h.prompt[:4]
        cont = engine.generate_on_device(
            ctx, short_prompt, 8 * SPEC_LOGIT_ROUNDS).tolist()
        rel, _ = round_rows(p, ctx, short_prompt, cont)
        ctl, _ = round_rows(p, ctx, short_prompt, cont, shift=True)
        _, same0 = round_rows(p, ctx, short_prompt, cont, first=True)
        log(f"{tag} {SPEC_LOGIT_ROUNDS} verify rounds of 8 rows from a "
            f"4-token prompt fed the plain stream, each row's logits against "
            f"the plain step's at the same prefix ({ctx.dtype}): worst "
            f"max|d|/max|logit| {rel:.3e} (limit "
            f"{SPEC_LOGITS_TOL[model]:.1e}); control, the mask shifted by one "
            f"position, {ctl:.3e} (must exceed the limit); with row 0 through "
            f"the decode kernel (first_row_kernel), row 0 torch.equal to the "
            f"plain step's in {same0} of {SPEC_LOGIT_ROUNDS} rounds"
            + (" (must be all: K1 rows have the same bits at every B)"
               if model == "Q80" else " (K3's one-row kernel sums in "
               "another order than the W4A4 kernel of k + 1 rows)"))
        if not rel <= SPEC_LOGITS_TOL[model] < ctl:
            failures.append(f"{model}: verify-round logits off the plain "
                            f"step's, or the control passes")
        if model == "Q80" and same0 != SPEC_LOGIT_ROUNDS:
            failures.append(f"{model}: row 0 through the decode kernel is "
                            f"not the plain step's")

        # ---- a Session: its k trajectory
        s = engine.Session(ctx_of(p, SPEC_SESSION_K), "", max_new_tokens=128,
                           prompt_ids=prompts["repetitive"])
        ks = []
        while s.step() is not None:
            ks.append(s._spec_k_cur)
        log(f"{tag} Session spec_k {SPEC_SESSION_K}, repetitive prompt: "
            f"{len(s.output_ids)} tokens, {s.tps:.1f} tok/s, decode calls by "
            f"kind {dict(s.steps_by)}, agreeing with generate_on_device's "
            f"plain stream for {agreeing(s.output_ids, plain_streams['repetitive'])} "
            f"tokens; k after each token: {runs_of(ks)}")
        if not s.steps_by["round"]:
            raise AssertionError(f"{model}: the Session ran no verify round")

        # ---- BatchedEngine at 8 and 64 slots, spec and plain in turns
        bctxs = {"spec": ctx_of(p, SPEC_BATCH_K), "plain": ctx_of(p, 0)}
        for n_slots in (8, 64):
            # 8 slots: slot 0 samples, so every step has row 0 attend
            # through the decode kernel (first_row_kernel); 64: all greedy
            mixed = n_slots == 8
            bprompts = [srng.integers(100, 30000, 32).tolist() if i % 2 else
                        srng.integers(100, 30000, 8).tolist() * 4
                        for i in range(n_slots)]
            runs = {"spec": [], "plain": []}
            for which in ("plain", "spec", "spec", "plain"):
                be = BatchedEngine(bctxs[which], n_slots=n_slots)
                got = {}
                for i, bp in enumerate(bprompts):
                    slot, first = be.add(
                        bp, max_new_tokens=10 ** 6,
                        temperature=0.8 if mixed and i == 0 else 0.0,
                        repetition_penalty=1.0)
                    got[slot] = [] if first is None else [first]
                be._ensure_capacity(512)

                def burst(n):
                    for sl, ts in be.step_burst(n).items():
                        got[sl].extend(ts)

                for _ in range(3):                 # warm-up: the captures
                    burst(8)
                before = {sl: len(v) for sl, v in got.items()}
                kinds0 = dict(be.bursts_by)
                h.reset()
                sync()
                t0 = time.time()
                for _ in range(3):
                    burst(16)
                sync()
                secs = time.time() - t0
                counts = h.read()
                kinds = {k: v - kinds0.get(k, 0)
                         for k, v in be.bursts_by.items()}
                # a plain step: a round's launches and the decode kernel
                # per layer; a spec step: a round's, and the decode kernel
                # for row 0 where a slot samples
                n_spec = 0 if mixed else 16 * kinds.get("spec", 0)
                want = {n: 48 * per_round[n] + (48 - n_spec) * (
                    cfg.n_layer if n == "decode_attention" else 0)
                    for n in h.names}
                if counts != want:
                    raise AssertionError(f"{model} {n_slots} slots {which}: "
                                         f"launches {counts}, expected {want}")
                n_tok = sum(len(v) - before[sl] for sl, v in got.items())
                runs[which].append((secs, n_tok, got, kinds))
                if which == "spec" and not mixed and len(runs["spec"]) == 2:
                    # where a speculative step's time goes: one burst of
                    # 16, every slot verifying (the parks cleared before
                    # each profiled burst: a burst parks the slots whose
                    # drafts were rejected, and the witness may profile
                    # again)
                    def spec_burst():
                        be._spec_park[:] = 0
                        be.step_burst(16)
                    h.profile_line(f"spec {model}", f"{n_slots} slots, a "
                                   f"speculative burst (k = "
                                   f"{be._spec_k_cur}, parks cleared)",
                                   spec_burst, 1, 16, secs * 1e3 / 48,
                                   per_round)
                del be
                torch.cuda.empty_cache()
            sp, pl = runs["spec"][0][2], runs["plain"][0][2]
            if not (all(r[2] == sp for r in runs["spec"])
                    and all(r[2] == pl for r in runs["plain"])):
                raise AssertionError(f"{model} {n_slots} slots: two runs of "
                                     f"one engine differ")
            stoch_ok = sp[0] == pl[0] if mixed else None
            greedy_slots = range(1 if mixed else 0, n_slots)
            agree = [agreeing(sp[sl], pl[sl]) for sl in greedy_slots]
            best = {w: min(runs[w], key=lambda r: r[0]) for w in runs}
            ms = {w: best[w][0] * 1e3 / 48 for w in runs}
            tps = {w: best[w][1] / best[w][0] for w in runs}
            log(f"{tag} BatchedEngine {n_slots} slots"
                + (" (slot 0 at temperature 0.8)" if mixed else " (greedy)")
                + f", spec_k {SPEC_BATCH_K} against plain ({card}), 48 steps "
                f"timed at capacity 512, "
                f"better of two in turns: spec {ms['spec']:.3f} ms a step, "
                f"{tps['spec']:.1f} tok/s, "
                f"{best['spec'][1] / (48 * n_slots):.2f} tokens a slot-step "
                f"(bursts by kind {best['spec'][3]}); plain "
                f"{ms['plain']:.3f} ms a step, {tps['plain']:.1f} tok/s; "
                f"spec / plain tok/s {tps['spec'] / tps['plain']:.2f}; "
                + (f"the temperature-0.8 slot's stream equal to the plain "
                   f"engine's: {stoch_ok} ({len(sp[0])} tokens); "
                   if mixed else "")
                + f"greedy slots agree with their plain streams for min "
                f"{min(agree)}, mean {sum(agree) / len(agree):.1f} tokens (of "
                f"{min(len(pl[sl]) for sl in greedy_slots)}+)")
            if stoch_ok is False:
                failures.append(f"{model} {n_slots} slots: the stochastic "
                                f"slot's stream differs from the plain "
                                f"engine's")
        del ctxs, bctxs
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


def bench_profile(torch, reps=10):
    """How often torch.profiler's trace of the Q80 model's decode graphs
    (phase 5's, 1 step and GRAPH_STEPS steps a replay, 32 steps a window)
    loses kernel records, behind guard spins of 1000 and of
    PROFILE_EDGE_CYCLES cycles at the window's ends: each profile's
    records lost by kernel, then each guard's tally."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.ops import _build, sampling
    from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    _build.build_all()
    dev, cfg = torch.device("cuda"), ModelConfig(**QWEN3_06B)
    tok = TrieTokenizer()
    tok.build_preset(32768)
    ctx = engine.LLMContext(
        cfg=cfg, params=random_q80_params(torch, np, cfg, dev),
        tokenizer=tok, max_seq_len=cfg.block_size, device=dev,
        dtype=torch.bfloat16, sampler=sampling.SamplerConfig(
            temperature=0.0, repetition_penalty=1.0),
        stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")
    names = list(COUNTER_OF)
    counts = lambda s: decode_counts("Q80", s, names)
    per_step = {n: counts(1)[n] - counts(0)[n] for n in names}
    prompt = np.random.default_rng(SEED + 1).integers(
        100, 30000, PROMPT_LEN).tolist()
    dec = ctx.decoder()
    tally = {}
    with ctx.on_stream():
        dec.claim()
        for rep in range(reps):
            for guard in (1000, PROFILE_EDGE_CYCLES):
                for k in (GRAPH_STEPS, 1):
                    dec.prefill(prompt)
                    _, seen, _, wall_ms, _ = profile_steps(
                        torch, dec._graph(k).run, 32 // k, PROFILE_KEYS,
                        per_step, guard)
                    lost = {m: per_step.get(m, 0) * 32 - seen[m]
                            for m in seen if seen[m] != per_step.get(m, 0) * 32}
                    tally.setdefault((guard, k), []).append(
                        sum(lost.values()))
                    log(f"[bench profile] rep {rep}, guard {guard} cycles, "
                        f"graph of {k} x {32 // k}: {wall_ms:.2f} ms a "
                        f"replay; records lost {lost}")
    for (guard, k), lost in tally.items():
        log(f"[bench profile] {card_line()}: guard {guard} cycles, graph of "
            f"{k}: short in {sum(1 for x in lost if x)} of {len(lost)} "
            f"profiles, records lost {lost}")


def bench_spec(torch):
    """Phase 5c alone (spec_phase), on the full-width models of phase 5
    made as main makes them, with the kernels built first."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.ops import _build, sampling
    from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    _build.build_all()
    dev, cfg = torch.device("cuda"), ModelConfig(**QWEN3_06B)
    params = random_q80_params(torch, np, cfg, dev)
    params4 = random_q4k_params(torch, np, cfg, dev)
    tok = TrieTokenizer()
    tok.build_preset(32768)
    prng = np.random.default_rng(SEED + 1)
    for n in (17, 40, 100):            # phase 5's requests, then its prompt
        prng.integers(100, 30000, n)
    names = list(COUNTER_OF)

    def timed_ms(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        return (time.time() - t0) * 1e3

    card = card_line()
    greedy = sampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    spec_phase(torch, np, SimpleNamespace(
        dev=dev, cfg=cfg, card=card,
        prompt=prng.integers(100, 30000, PROMPT_LEN).tolist(), names=names,
        reset=lambda: zero_launches(torch),
        read=lambda: read_launches(torch, names), timed_ms=timed_ms,
        profile_line=lambda *a: profile_witness(torch, card, *a),
        models=[("Q80", params, lambda s: decode_counts("Q80", s, names)),
                ("Q4K", params4, lambda s: decode_counts("Q4K", s, names))],
        ctx_kw=dict(cfg=cfg, tokenizer=tok, max_seq_len=cfg.block_size,
                    device=dev, dtype=torch.bfloat16, sampler=greedy,
                    stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")))


def dense_counts(steps, names, L):
    """Launches of an L-layer model served dense (bf16 matrices through
    torch.matmul): its 64-row prefill and `steps` decode steps."""
    e = {n: 0 for n in names}
    e.update(decode_attention=L * steps, rms_norm_q80=(2 * L + 1) * (1 + steps),
             swiglu_q80=L * (1 + steps))
    return e


def gguf_rows_counts(steps, names, L=28):
    """Launches of an L-layer Qwen3 model from a Q8_0 GGUF (group size 32:
    the rows form) as from_gguf serves it, wq / wk / wv and w1 / w3 fused:
    its 64-row prefill (4 L products at 64 rows through q80_matmul_rows,
    the head at the last position through q80_matvec_rows) and `steps`
    decode steps (4 L + 1 q80_matvec_rows each)."""
    e = dense_counts(steps, names, L)
    e.update(q80_matmul_rows=4 * L, q80_matvec_rows=(4 * L + 1) * steps + 1)
    return e


def gguf_warp_counts(steps, names, L=28):
    """The same model with the seven products of a layer unfused (as the
    JAX package loads the file) through the warp-a-row kernel (warp_rows)."""
    e = dense_counts(steps, names, L)
    e.update(q80_matmul_rows_warp=(7 * L + 1) * (1 + steps))
    return e


@contextlib.contextmanager
def warp_rows(qmatmul):
    """Every rows-form product through the warp-a-row q80_matmul_rows_warp, the
    kernel before q80_matvec_rows and q80_matmul_rows (a decode graph
    captured meanwhile keeps it)."""
    saved = qmatmul.q80_rows
    qmatmul.q80_rows = qmatmul.q80_matmul_rows_warp
    try:
        yield
    finally:
        qmatmul.q80_rows = saved


def toy_ppl_counts(quant, windows, L):
    """Launches of model_ppl on phase 5c's toy_{quant}.bin over `windows`
    windows: each one f32 forward at block_size rows, K4 once a layer and
    4 products a layer and the head.  The toy's group size 128 puts its
    Q80 products in the rows form (q80_matmul_rows); a Q4K file's layer
    products are the W4A4 pair and its head is Q80, its activation
    fake-quantized first."""
    e = dict(flash_attn_fwd=windows * L)
    if quant == "q80":
        e.update(q80_matmul_rows=windows * (4 * L + 1))
    elif quant == "q4k":
        e.update(q4k_act_quant=windows * 4 * L,
                 q4k_matmul_w4a4=windows * 4 * L, q4k_fake_quant=windows,
                 q80_matmul_rows=windows)
    return e


# the control runs of phase 9c, by file: (fault, whether the card-to-CPU
# tolerance must catch it); a fault the PPL cannot tell from the sound
# run's divergence is read and printed only
PPL_CONTROLS = {
    "f32": (("k4_out_bf16", False), ("k4_bf16", True)),
    "q80": (("rows_bf16", True),),
    "q4k": (("q4k_1_of_32", False), ("q4k_8_of_32", True)),
}
PPL_FAULTS = {
    "k4_out_bf16": "K4's output rounded to bf16",
    "k4_bf16": "K4 run in bf16 (its inputs and output rounded)",
    "rows_bf16": "the rows form's products rounded to bf16",
    "q4k_1_of_32": "1 of every 32 activation values a step off",
    "q4k_8_of_32": "8 of every 32 activation values a step off",
}


@contextlib.contextmanager
def planted_ppl_fault(torch, fault):
    """A control of phase 9c's card-against-CPU PPL tolerance: while the
    block runs, a kernel's wrapper gives what a faulty kernel would
    (PPL_FAULTS): "k4_out_bf16" K4 writing its output in bf16; "k4_bf16"
    K4 launched at the bf16 type on bf16 copies of q, k, v; "rows_bf16"
    the Q80 rows form's product in bf16; "q4k_<n>_of_32" the Q4K
    activation's integer form with n values of every group of 32 (every
    32/n-th) one step off (up, or down from 15) and its correction term
    c = sa * A - n_g * ba moved to match: the 4-bit roundings that the
    sound run flips now and then, flipped in every group.  A wrapper that
    counts its launches lends the stand-in its counter, so the control's
    launches count nowhere."""
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.ops import q4k, qmatmul
    bf16 = torch.bfloat16
    if fault in ("k4_out_bf16", "k4_bf16"):
        mod, name = gpt, "flash_attention"
        orig = mod.flash_attention

        def planted(q, k, v, offset=0):
            if fault == "k4_bf16":
                return orig(q.to(bf16), k.to(bf16), v.to(bf16),
                            offset).to(q.dtype)
            return orig(q, k, v, offset).to(bf16).to(q.dtype)
    elif fault == "rows_bf16":
        mod, name = qmatmul, "q80_rows"
        orig = mod.q80_rows

        def planted(x, w, dtype=bf16):
            return orig(x, w, dtype).to(bf16).to(dtype)
    else:
        mod, name = q4k, "act_quant_q4k_packed"
        orig = mod.act_quant_q4k_packed
        GL = q4k.GROUP_LEN
        every = GL // int(fault.split("_")[1])

        def planted(x2d):
            vp, sa, ba, c = orig(x2d)
            B = vp.shape[0]
            halves = vp.reshape(B, -1, GL // 2)
            v = torch.cat([halves & 15, halves >> 4], -1).to(torch.int32)
            live = torch.arange(v.shape[1], device=v.device) * GL < x2d.shape[1]
            pick = (torch.arange(GL, device=v.device) % every == 0)
            pick = live[:, None] & pick[None, :]
            moved = torch.where(pick, torch.where(v < 15, v + 1, v - 1), v)
            c = c + (moved - v).sum(-1).float() * sa
            packed = moved[..., :GL // 2] | (moved[..., GL // 2:] << 4)
            return packed.to(torch.uint8).reshape(B, -1), sa, ba, c
    planted.launches = getattr(orig, "launches", 0)
    setattr(mod, name, planted)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def gguf_batched(torch, np, h, ctx, L):
    """A GGUF model in BatchedEngine at 8 and 64 slots: every slot joins
    with a 32-token prompt (launches exact: 4 L q80_matmul_rows at 32 rows
    and one q80_matvec_rows head a prefill), one batched step's logits
    against each slot's single stream (B = slots through q80_matmul_rows,
    B = 1 through q80_matvec_rows: the same f32 dequant, f32 sums in other
    orders, bf16 activations) within GGUF_BATCH_TOL of max|logit|, beside a
    control (each slot's batched logits against the next slot's single
    stream), then a burst of 8 steps (the capture) and 3 bursts of 16
    timed, launches exact (4 L + 1 q80_matmul_rows, L decode attentions a
    step).  -> {slots: dict(ms, tok_s, rel, control)}."""
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.serve.batching import BatchedEngine
    cfg, bf16 = ctx.cfg, torch.bfloat16
    sync = torch.cuda.synchronize if ctx.device.type == "cuda" else (lambda: 0)
    out = {}
    for n_slots in (8, 64):
        be = BatchedEngine(ctx, n_slots=n_slots)
        prng = np.random.default_rng(SEED + 14 + n_slots)
        prompts = [prng.integers(100, min(30000, cfg.vocab_size), 32).tolist()
                   for _ in range(n_slots)]
        h.reset()
        for pr in prompts:
            be.add(pr, max_new_tokens=10 ** 6, temperature=0.0,
                   repetition_penalty=1.0)
        got = h.read()
        want = {n: 0 for n in h.names}
        want.update(q80_matmul_rows=4 * L * n_slots, q80_matvec_rows=n_slots,
                    rms_norm_q80=(2 * L + 1) * n_slots,
                    swiglu_q80=L * n_slots)
        if got != want:
            raise AssertionError(f"GGUF joins at {n_slots} slots: launches "
                                 f"{got}, expected {want}")
        c_b = gpt.KVCache(*(None if t is None else t.clone() for t in (
            be.cache.k, be.cache.v, be.cache.k_scale, be.cache.v_scale)))
        lb, _ = gpt.forward_decode_batched(ctx.params, be.tok.clone(), c_b,
                                           be.pos.clone(), cfg, bf16,
                                           ctx.rope_tables())
        del c_b
        singles = []
        for i, pr in enumerate(prompts):
            c1 = ctx.new_cache(1, seq_len=be._cache_len())
            t1, _ = engine._prefill_first_token(ctx, pr, c1, ctx.generator())
            if int(t1[0]) != int(be.tok[i]):
                raise AssertionError(f"GGUF slot {i}: the first token differs")
            l1, _ = gpt.forward_with_cache(ctx.params, t1[:, None], c1,
                                           len(pr), cfg, bf16,
                                           rope=ctx.rope_tables())
            singles.append(l1[0, 0].float())
            del c1
        rel = max(((lb[i].float() - l1).abs().max() / l1.abs().max()).item()
                  for i, l1 in enumerate(singles))
        control = min(((lb[i].float() - singles[(i + 1) % n_slots]).abs().max()
                       / singles[(i + 1) % n_slots].abs().max()).item()
                      for i in range(n_slots))
        del lb, singles
        log(f"[export] GGUF in BatchedEngine, {n_slots} slots: one batched "
            f"step's logits against each slot's single stream, worst "
            f"max|d|/max|logit| {rel:.3e} (limit {GGUF_BATCH_TOL:.1e}); the "
            f"control, each slot's batched logits against the next slot's "
            f"single stream, least {control:.3e}")
        if not (rel <= GGUF_BATCH_TOL < control):
            raise AssertionError(f"GGUF batched logits at {n_slots} slots: "
                                 f"{rel} (control {control}), limit "
                                 f"{GGUF_BATCH_TOL}")
        h.reset()
        be.step_burst(8)                       # warm-up step, capture
        sync()
        t0 = time.time()
        bursts = [be.step_burst(16) for _ in range(3)]
        sync()
        secs = time.time() - t0
        got = h.read()
        steps = 8 + 48
        want = {n: 0 for n in h.names}
        want.update(q80_matmul_rows=(4 * L + 1) * steps,
                    decode_attention=L * steps,
                    rms_norm_q80=(2 * L + 1) * steps, swiglu_q80=L * steps)
        toks = sum(len(v) for b in bursts for v in b.values())
        if got != want or toks != 48 * n_slots:
            raise AssertionError(f"GGUF batched steps at {n_slots} slots: "
                                 f"launches {got}, expected {want}; "
                                 f"{toks} tokens")
        out[n_slots] = dict(ms=secs * 1e3 / 48, tok_s=toks / secs, rel=rel,
                            control=control)
        log(f"[export] GGUF in BatchedEngine, {n_slots} slots, positions "
            f"32-88 ({h.card}): {secs * 1e3 / 48:.3f} ms per batched step, "
            f"{toks / secs:.1f} tok/s aggregate; launches exact ({got})")
        del be
        torch.cuda.empty_cache()
    return out


def train_toy(torch, np, dev):
    """tools/make_trained_fixture.py's recipe through the port's loss_fn and
    AdamW on `dev`: its corpus (dataset/pretrain_sample.txt around a cyclic
    chorus), its char-level trie tokenizer, its 4-layer width-128 config,
    900 steps of batch 16 x 256 drawn by its seed, lr 1.5e-3, b2 0.95,
    weight decay 0.01, f32.  -> (params, cfg, tokenizer, losses every 100
    steps and the last, seconds)."""
    from nano_tpu_torch.config import ModelConfig, TrainConfig
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    from nano_tpu_torch.train.trainer import AdamW
    with open(os.path.join(ROOT, "dataset", "pretrain_sample.txt"),
              encoding="utf-8") as f:
        text = f.read()
    corpus = text + "\n" + TOY_CHORUS * TOY_N_CHORUS + "\n" + text
    tok = TrieTokenizer()
    tok.build_from_text(corpus)
    cfg = ModelConfig(block_size=256, vocab_size=tok.vocab_size, n_layer=4,
                      n_embd=128, n_head=4, n_kv_head=2, n_hidden=384)
    ids = np.asarray(tok.encode(corpus), np.int64)
    params = gpt.init_params(torch.Generator().manual_seed(TOY_SEED), cfg,
                             device=dev)
    opt = AdamW(TrainConfig(learning_rate=TOY_LR, beta1=0.9, beta2=0.95,
                            weight_decay=0.01, decay_lr=False, grad_clip=0.0),
                params)
    S = cfg.block_size
    rng = np.random.RandomState(TOY_SEED)
    offs = np.arange(S)
    losses = []
    t0 = time.time()
    for it in range(TOY_STEPS):
        starts = rng.randint(0, len(ids) - S - 1, TOY_BATCH)[:, None] + offs
        xb = torch.from_numpy(ids[starts]).to(dev)
        yb = torch.from_numpy(ids[starts + 1]).to(dev)
        loss = gpt.loss_fn(params, xb, yb, None, cfg, dtype=torch.float32)
        opt.update(list(torch.autograd.grad(loss, opt.params)))
        if it % 100 == 0 or it == TOY_STEPS - 1:
            losses.append((it, loss.item()))
    return params, cfg, tok, losses, time.time() - t0


def trained_toy_phase(torch, np, h):
    """Phase 5c on a trained model: train_toy on the card (its K4 launches
    asserted, the final loss under the tool's TOY_TARGET_LOSS), the model
    written as toy_{f32,q80,q4k}.bin under h.work by the port's writer,
    each file served from the card: greedy on the chorus prompt must
    continue the chorus, and generate_on_device with spec_k = SPEC_K must
    give the plain stream token for token, with more than one token a
    verify round (printed, with both streams' tok/s in turns)."""
    from dataclasses import replace
    from nano_tpu_torch.infer import engine, speculative
    from nano_tpu_torch.io import binfmt
    from nano_tpu_torch.ops import sampling
    dev = h.dev
    os.makedirs(h.work, exist_ok=True)
    h.reset()
    params, cfg, tok, losses, secs = train_toy(torch, np, dev)
    counts = h.read()
    L = cfg.n_layer
    log(f"[toy] {TOY_STEPS} steps of batch {TOY_BATCH} x {cfg.block_size}, "
        f"f32, {L} layers, width {cfg.n_embd}, vocab {cfg.vocab_size}, on "
        f"{h.card}: {secs:.1f} s; losses (step, loss) {losses}; launches "
        f"flash_attn_fwd {counts['flash_attn_fwd']}, flash_attn_bwd "
        f"{counts['flash_attn_bwd']}")
    if dev.type == "cuda" and not (
            counts["flash_attn_fwd"] == counts["flash_attn_bwd"]
            == L * TOY_STEPS):
        raise AssertionError("the toy's training did not run K4 once a layer "
                             "and step, forward and backward")
    if not losses[-1][1] < TOY_TARGET_LOSS:
        raise AssertionError(f"the toy is under-trained: final loss "
                             f"{losses[-1][1]} >= {TOY_TARGET_LOSS}")
    greedy = sampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    chorus_ids = None
    for quant in ("f32", "q80", "q4k"):
        path = os.path.join(h.work, f"toy_{quant}.bin")
        binfmt.write_model(path, params, cfg, tok.config, quant=quant,
                           group_size=128)
        ctx = engine.LLMContext.from_bin(path, device=dev, sampler=greedy)
        if chorus_ids is None:
            chorus_ids = ctx.encode(TOY_CHORUS)
        ids = ctx.encode(TOY_CHORUS * 2)
        out = engine.generate_on_device(ctx, ids, 3 * len(chorus_ids))
        text = ctx.decode(out.tolist())
        log(f"[toy] toy_{quant}.bin ({os.path.getsize(path)} bytes): greedy "
            f"on the chorus x 2 -> {text!r}")
        if not (TOY_CHORUS * 2 in text or text.count(TOY_CHORUS[:8]) >= 2):
            raise AssertionError(f"toy_{quant}.bin does not continue the "
                                 f"chorus")
        sctx = replace(ctx, spec_k=SPEC_K)
        runs = {}
        for label, c in (("spec", sctx), ("plain", ctx), ("plain", ctx),
                         ("spec", sctx)):
            t0 = time.time()
            o = engine.generate_on_device(c, ids, TOY_SPEC_TOKENS).tolist()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            runs.setdefault(label, []).append((o, time.time() - t0))
            if label == "spec":
                stats = dict(speculative.LAST_STATS)
        (sp, ts), (pl, tp) = runs["spec"][-1], runs["plain"][-1]
        per_round = stats["tokens"] / max(stats["rounds"], 1)
        log(f"[toy] toy_{quant}.bin generate_on_device {TOY_SPEC_TOKENS} "
            f"tokens on {h.card}: spec_k {SPEC_K} {TOY_SPEC_TOKENS / ts:.1f} "
            f"tok/s, {stats['tokens']} tokens in {stats['rounds']} rounds = "
            f"{per_round:.2f} a round; plain {TOY_SPEC_TOKENS / tp:.1f} tok/s; "
            f"streams token-identical {sp == pl}")
        if not (sp == pl and runs["spec"][0][0] == pl
                and runs["plain"][0][0] == pl):
            raise AssertionError(f"toy_{quant}.bin: the speculative stream "
                                 f"differs from the plain one")
        if not per_round > 1.0:
            raise AssertionError(f"toy_{quant}.bin: no draft accepted on "
                                 f"the chorus")
        del ctx, sctx
    del params


def qwen_gguf(torch, g, qcfg, work):
    """Phase 7b's file: a Qwen3-0.6B-shaped model (qcfg) of dense random
    weights drawn from the generator `g` (seeded SEED + 13; its state
    advances) with a byte-level BPE of the model's vocabulary size,
    written by the port's write_gguf as Q8_0 under `work`.  -> its path."""
    from nano_tpu_torch.io import gguf
    from nano_tpu_torch.tokenizer.bpe import BpeTokenizer
    dev = g.device
    QL, E, V, F = qcfg.n_layer, qcfg.n_embd, qcfg.vocab_size, qcfg.n_hidden
    HD, KVD, D = (qcfg.n_head * qcfg.head_dim, qcfg.n_kv_head * qcfg.head_dim,
                  qcfg.head_dim)

    def rnd(*shape, std=0.02, mean=0.0):
        return torch.randn(*shape, device=dev, generator=g) * std + mean

    qparams = {"tok_embeddings": rnd(V, E), "norm": rnd(E, mean=1.0),
               "blocks": {"attn_norm": rnd(QL, E, mean=1.0),
                          "ffn_norm": rnd(QL, E, mean=1.0),
                          "q_norm": rnd(QL, D, mean=1.0),
                          "k_norm": rnd(QL, D, mean=1.0),
                          "wq": rnd(QL, E, HD), "wk": rnd(QL, E, KVD),
                          "wv": rnd(QL, E, KVD), "wo": rnd(QL, HD, E),
                          "w1": rnd(QL, E, F), "w2": rnd(QL, F, E),
                          "w3": rnd(QL, E, F)}}
    # a byte-level BPE vocabulary of the model's size: the 256 bytes, then
    # tokens no merge builds
    vocab = [bytes([i]) for i in range(256)] + [
        b"<t%d>" % i for i in range(V - 256)]
    btok = BpeTokenizer(vocab, [0.0] * V)
    gpath = os.path.join(work, "qwen3_0.6b_q8_0.gguf")
    t0 = time.time()
    gguf.write_gguf(gpath, qparams, qcfg, btok, arch="qwen3", quant="q8_0")
    log(f"[export] write_gguf Qwen3-0.6B shape ({QL} layers, width {E}, "
        f"vocab {V}), dense f32 weights from seed {SEED + 13}, Q8_0: "
        f"{os.path.getsize(gpath)} bytes in {time.time() - t0:.1f} s")
    del qparams
    return gpath


def export_phase(torch, np, h):
    """Phase 7, export and import.  7a: the Nano-168M checkpoint that phase
    6 trained (h.ckpt, 24 layers, width 768) served by from_checkpoint and
    exported through nano_tpu_torch.export's main to f32, Q80 (group size
    256) and Q4K .bin files, each served by from_bin: the f32 file's stream
    token-identical to the checkpoint's, the Q80 and Q4K files' launches
    exact (decode_counts at L = 24), their first-step logits within
    EXPORT_LOGITS_TOL of the f32 file's, repack f32 -> f32 byte-identical.
    7b: Qwen3-0.6B at full width and depth, dense f32 random weights from
    a seed written by write_gguf as Q8_0 and served by from_gguf: every
    product through q80_matmul_rows at group size 32 (launches exact),
    timed over a decode step's launches beside the bound, its plain
    version and bf16 torch.matmul; convert_gguf to Q80 at group size 256
    served by from_bin through K1's W8A8 pair.  -> {"rows": the rows
    form's launches, ms, plain_ms, library_ms, bound (ms, by) over a decode
    step, "rows_err", "gctx": the GGUF model's context, which phase 8
    serves again}."""
    from dataclasses import replace
    from nano_tpu_torch import export as export_cli
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.io import binfmt, gguf
    from nano_tpu_torch.io.checkpoint import Checkpoint
    from nano_tpu_torch.ops import qmatmul, sampling
    from nano_tpu_torch.ops.q4k import Q4KTensor
    dev, names, card = h.dev, h.names, h.card
    greedy = sampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    os.makedirs(h.work, exist_ok=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def serve(ctx, label, ids, n, expect_for):
        """generate_on_device(ids, n) after a warm-up: TTFT (one token),
        then twice (the first captures the decode graph where it is not
        yet, the second replays it), the launches of both held to
        expect_for(n - 1).  -> (ids, tok/s of the second, TTFT ms, its
        launches)."""
        engine.generate_on_device(ctx, ids[:8], 4)
        sync()
        t0 = time.time()
        engine.generate_on_device(ctx, ids, 1)
        sync()
        ttft = time.time() - t0
        h.reset()
        first = engine.generate_on_device(ctx, ids, n).tolist()
        c1 = h.read()
        h.reset()
        sync()
        t0 = time.time()
        out = engine.generate_on_device(ctx, ids, n).tolist()
        sync()
        secs = time.time() - t0
        c2 = h.read()
        want = expect_for(n - 1)
        tok_s = (n - 1) / max(secs - ttft, 1e-9)
        log(f"[export] {label}: {n} greedy tokens from a {len(ids)}-token "
            f"prompt on {card}: decode {tok_s:.2f} tok/s (graph replays), "
            f"TTFT {ttft * 1e3:.2f} ms; first ids {out[:8]}; launches "
            f"{ {k: v for k, v in c2.items() if v} }")
        if first != out or len(out) != n or max(out) >= ctx.cfg.vocab_size:
            raise AssertionError(f"{label}: the stream is malformed or not "
                                 f"reproducible")
        if not (c1 == want and c2 == want):
            raise AssertionError(f"{label}: launches {c2} (first call {c1}) "
                                 f"differ from {want}")
        return out, tok_s, ttft * 1e3, c2

    def first_logits(ctx, ids):
        logits, _ = engine._prefill(ctx, ids, ctx.new_cache(1))
        return logits[0].float().cpu()

    def file_bytes(path):
        with open(path, "rb") as f:
            return f.read()

    # ---------------- 7a ----------------
    t7 = time.time()
    ck = Checkpoint(h.ckpt)
    ncfg = ModelConfig.from_dict(ck.model_config)
    L = ncfg.n_layer
    ids = h.nano_prompt
    n_new = EXPORT_NEW
    ctx_ck = engine.LLMContext.from_checkpoint(h.ckpt, device=dev,
                                               sampler=greedy)
    want_ck, tps_ck, ttft_ck, _ = serve(
        ctx_ck, f"Nano-168M step {ck.step} checkpoint (from_checkpoint, bf16)",
        ids, n_new, lambda s: dense_counts(s, names, L))
    del ctx_ck
    files, secs = {}, {}
    for flag, quant in (("--checkpoint", "f32"), ("--quant", "q80"),
                        ("--q4k", "q4k")):
        files[quant] = os.path.join(h.work, f"nano168m_{quant}.bin")
        t0 = time.time()
        export_cli.main([files[quant], flag, h.ckpt])
        secs[quant] = time.time() - t0
    log(f"[export] nano_tpu_torch.export of the checkpoint: "
        + ", ".join(f"{q} {os.path.getsize(p)} bytes in {secs[q]:.1f} s"
                    for q, p in files.items()))
    same = os.path.join(h.work, "nano168m_f32_repacked.bin")
    binfmt.repack(files["f32"], same, quant="f32")
    identical = file_bytes(same) == file_bytes(files["f32"])
    log(f"[export] repack f32 -> f32 byte-identical: {identical}")
    if not identical:
        raise AssertionError("repack f32 -> f32 changed the file")
    os.remove(same)

    ctx32 = engine.LLMContext.from_bin(files["f32"], quantized=False,
                                       device=dev, sampler=greedy)
    out32, tps32, ttft32, _ = serve(ctx32, "Nano-168M f32 .bin (bf16)", ids,
                                 n_new, lambda s: dense_counts(s, names, L))
    log(f"[export] the f32 export's stream token-identical to "
        f"from_checkpoint's: {out32 == want_ck}")
    if out32 != want_ck:
        raise AssertionError("the f32 export serves another stream than its "
                             "checkpoint")
    l32 = first_logits(ctx32, ids)
    other = first_logits(ctx32, h.nano_control_prompt)
    del ctx32
    scale = l32.abs().max().item()
    rows = [("checkpoint", tps_ck, ttft_ck, n_new), ("f32", tps32, ttft32,
                                                     n_new)]
    for quant, model in (("q80", "Q80"), ("q4k", "Q4K")):
        ctx = engine.LLMContext.from_bin(files[quant], device=dev,
                                         sampler=greedy)
        if quant == "q80":
            w = ctx.params["blocks"]["wqkv"]
            assert isinstance(w, qmatmul.Q80Tensor) and w.w8a8
        else:
            assert isinstance(ctx.params["blocks"]["wqkv"], Q4KTensor)
        out, tps, ttft, _ = serve(ctx, f"Nano-168M {model} .bin", ids, n_new,
                               lambda s, m=model: decode_counts(m, s, names,
                                                                L=L))
        err = (first_logits(ctx, ids) - l32).abs().max().item() / scale
        control = (other - l32).abs().max().item() / scale
        log(f"[export] Nano-168M {model}: first-step logits against the f32 "
            f"file's, of max|logit| {scale:.4f}: {err:.4e} (limit "
            f"{EXPORT_LOGITS_TOL[model]}; the f32 file's own logits at "
            f"another prompt read {control:.4e}); greedy stream agrees with "
            f"the f32 file's for {agreeing(out, out32)} of {n_new} tokens")
        if not err <= EXPORT_LOGITS_TOL[model]:
            raise AssertionError(f"the {model} export's logits are off by "
                                 f"{err}")
        rows.append((model, tps, ttft, agreeing(out, out32)))
        del ctx
    for p in files.values():
        os.remove(p)
    log(f"[export] 7a on {card}: " + "; ".join(
        f"{k} {t:.2f} tok/s, TTFT {f:.2f} ms" for k, t, f, _ in rows)
        + f" ({time.time() - t7:.1f} s)")

    # ---------------- 7b ----------------
    t7 = time.time()
    qcfg = h.qcfg
    QL, E, V, F = qcfg.n_layer, qcfg.n_embd, qcfg.vocab_size, qcfg.n_hidden
    HD, KVD, D = (qcfg.n_head * qcfg.head_dim, qcfg.n_kv_head * qcfg.head_dim,
                  qcfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    gpath = qwen_gguf(torch, g, qcfg, h.work)
    t0 = time.time()
    gctx = engine.LLMContext.from_gguf(gpath, device=dev, sampler=greedy)
    gb = gctx.params["blocks"]
    wqkv = gb.get("wqkv")
    if not (isinstance(wqkv, qmatmul.Q80Tensor) and wqkv.group_size == 32
            and not wqkv.w8a8 and "w13" in gb and "wq" not in gb
            and "w1" not in gb and gctx.params["output_q"]
            is gctx.params["tok_embeddings"]):
        raise AssertionError("the Q8_0 GGUF did not load as fused group-32 "
                             "rows")
    log(f"[export] from_gguf (quantized, wq/wk/wv and w1/w3 fused) in "
        f"{time.time() - t0:.1f} s")
    qids = h.qwen_prompt
    # the same weights as the JAX package serves the file, 7 products a
    # layer (views of the fused tensors), through the warp-a-row kernel: the
    # "before", served in turns with the fused model in one call
    F_ = qcfg.n_hidden
    cuts = {"wqkv": (("wq", 0, HD), ("wk", HD, HD + KVD),
                     ("wv", HD + KVD, HD + 2 * KVD)),
            "w13": (("w1", 0, F_), ("w3", F_, 2 * F_))}
    ub = {k: v for k, v in gb.items() if k not in cuts}
    for fused, parts in cuts.items():
        for name, lo, hi in parts:
            ub[name] = replace(gb[fused], q=gb[fused].q[:, lo:hi],
                               scales=gb[fused].scales[:, lo:hi])
    octx = engine.LLMContext(
        cfg=gctx.cfg, params={**gctx.params, "blocks": ub},
        tokenizer=gctx.tokenizer, max_seq_len=gctx.max_seq_len, device=dev,
        dtype=gctx.dtype, sampler=greedy, stop_tokens=gctx.stop_tokens,
        arch=gctx.arch)
    qbin = os.path.join(h.work, "qwen3_0.6b_q80.bin")
    t0 = time.time()
    gguf.convert_gguf(gpath, qbin, quant="q80", group_size=256)
    log(f"[export] convert_gguf -> Q80 gs 256 .bin "
        f"({os.path.getsize(qbin)} bytes) in {time.time() - t0:.1f} s")
    bctx = engine.LLMContext.from_bin(qbin, device=dev, sampler=greedy)
    if not bctx.params["blocks"]["wqkv"].w8a8:
        raise AssertionError("the converted .bin did not take the W8A8 form")
    # in turns: the GGUF model (new), its "before" and the converted .bin
    runs = {"new": [], "old": [], "bin": []}
    for route in ("new", "old", "bin", "bin", "old", "new"):
        if route == "new":
            runs[route].append(serve(
                gctx, "Qwen3-0.6B Q8_0 GGUF (from_gguf: 4 products a layer, "
                "q80_matvec_rows at one row, q80_matmul_rows above)", qids,
                n_new, lambda s: gguf_rows_counts(s, names, QL)))
        elif route == "old":
            with warp_rows(qmatmul):
                runs[route].append(serve(
                    octx, "Qwen3-0.6B Q8_0 GGUF, before (7 products a layer, "
                    "the warp-a-row q80_matmul_rows_warp)", qids, n_new,
                    lambda s: gguf_warp_counts(s, names, QL)))
        else:
            runs[route].append(serve(
                bctx, "Qwen3-0.6B Q80 .bin from convert_gguf (from_bin, "
                "W8A8)", qids, n_new,
                lambda s: decode_counts("Q80", s, names, L=QL)))
    del octx
    best = {k: (max(r[1] for r in v), min(r[2] for r in v))
            for k, v in runs.items()}
    gout, bout, oout = (runs[k][0][0] for k in ("new", "bin", "old"))
    gcounts = runs["new"][0][3]
    log(f"[export] Qwen3-0.6B on {card}, in turns new, old, .bin, .bin, old, "
        f"new, the better of two: the GGUF Q8_0 file {best['new'][0]:.2f} "
        f"tok/s, TTFT {best['new'][1]:.2f} ms (113 rows-form launches a "
        f"step) against {best['old'][0]:.2f} tok/s, TTFT {best['old'][1]:.2f} "
        f"ms before (197); the converted gs-256 .bin {best['bin'][0]:.2f} "
        f"tok/s, TTFT {best['bin'][1]:.2f} ms; the GGUF stream agrees with "
        f"the one before for {agreeing(gout, oout)} and with the .bin's for "
        f"{agreeing(gout, bout)} of {n_new} tokens")
    del bctx
    res = dict(launches=dict(q80_matvec_rows=gcounts["q80_matvec_rows"],
                             q80_matmul_rows=gcounts["q80_matmul_rows"]),
               tok_s={k: v[0] for k, v in best.items()},
               ttft={k: v[1] for k, v in best.items()})
    res["batched"] = gguf_batched(torch, np, h, gctx, QL)
    res["times"] = rows_form_times(torch, h.timer, gb, gctx.params["output_q"],
                                   QL, card, g, "export")
    res["gctx"] = gctx                # phase 8 serves it with an adapter
    res["gguf"], res["qbin"] = gpath, qbin      # phase 11 serves both files
    del gctx, gb, wqkv
    log(f"[export] 7b in {time.time() - t7:.1f} s")
    return res


def bench_toy(torch):
    """Phase 5c on the trained toy alone (trained_toy_phase)."""
    import numpy as np
    from nano_tpu_torch.ops import _build
    _build.build_all()
    names = list(COUNTER_OF)
    trained_toy_phase(torch, np, SimpleNamespace(
        dev=torch.device("cuda"), card=card_line(),
        reset=lambda: zero_launches(torch),
        read=lambda: read_launches(torch, names),
        work=os.path.join(ROOT, "build", "smoke_toy")))


def bench_export(torch):
    """Phase 7 alone (export_phase), on a Nano-168M checkpoint of its
    initial weights (config/model_168m.json's seed; phase 6 trains it 12
    steps first) and phase 5's Qwen3-0.6B prompt."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.io.checkpoint import save_checkpoint
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.ops import _build
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    _build.build_all()
    dev = torch.device("cuda")
    work = os.path.join(ROOT, "build", "smoke_export")
    os.makedirs(work, exist_ok=True)
    ncfg = ModelConfig.from_json(os.path.join(ROOT, "config",
                                              "model_168m.json"))
    ttok = TrieTokenizer.from_file(os.path.join(ROOT, "tokenizer",
                                                "nano_16384.json"))
    ckpt = os.path.join(work, "nano168m_init.npz")
    save_checkpoint(ckpt, params=gpt.init_params(
        torch.Generator().manual_seed(SEED), ncfg, device="cpu"),
        model_config=ncfg.to_dict(), tokenizer_config=ttok.config)
    with open(os.path.join(ROOT, "dataset", "pretrain_sample.txt"),
              encoding="utf-8") as f:
        nano_ids = ttok.encode(f.read())
    prng = np.random.default_rng(SEED + 1)
    for n in (17, 40, 100):            # phase 5's requests, then its prompt
        prng.integers(100, 30000, n)
    names = list(COUNTER_OF)
    res = export_phase(torch, np, SimpleNamespace(
        dev=dev, card=card_line(), names=names, timer=Timer(torch),
        reset=lambda: zero_launches(torch),
        read=lambda: read_launches(torch, names), ckpt=ckpt, qcfg=ModelConfig(**QWEN3_06B), work=work,
        qwen_prompt=prng.integers(100, 30000, PROMPT_LEN).tolist(),
        nano_prompt=nano_ids[:EXPORT_PROMPT],
        nano_control_prompt=nano_ids[1000:1000 + EXPORT_PROMPT]))
    os.remove(ckpt)
    del res["gctx"]
    os.remove(res.pop("gguf"))
    os.remove(res.pop("qbin"))
    log(f"[bench export] {res}")


def lora_phase(torch, np, h):
    """Phase 8, LoRA.  h: dev, card, names, reset, read, cfg (Qwen3-0.6B),
    tok, prompt (phase 5's), base80 (phase 5's Q80 stream, or None), q80 /
    q4k (the two full-width models' params, on the host), gctx (phase 7b's
    GGUF context, or None), tcfg / ckpt (the Nano-168M checkpoint to
    fine-tune, and its config), train_cfg / full_ms (phase 6's training
    config and ms/step, or None), nano_prompt, work.

    8a: the Q80 model with a rank-16 adapter written by write_lora: the
    graph stream (capture, then replays) torch.equal to the eager step
    loop, launches exact (the same kernels as without an adapter: the
    branch is torch.matmul); a swap to a second rank-16 adapter (copied
    into the decoder's buffers, no capture) giving a fresh context's
    stream; an unload giving the base stream; decode tok/s with and
    without the adapter in turns and a profile of each (busy ms and
    kernels a step: the branch's cost); speculative decode with the
    adapter.  The Q4K model and the GGUF model with the adapter, one
    stream each (launches exact).  8b: BatchedEngine at 8 and 64 slots,
    adapters of ranks 16 and 8 and base slots mixed: one batched step's
    logits within BATCH_TOL of each slot's single stream with its adapter,
    beside a control with two slots' adapters swapped that must read
    above it; ms a batched step and tok/s beside the engine without
    adapters, in turns.  8c: --merge-lora's f32 export of the Nano-168M
    checkpoint served against the checkpoint with the adapter attached,
    both f32: logits within MERGE_LOGITS_TOL (the control, the base
    alone, above it), greedy tokens equal wherever the margin exceeds
    twice the logits' difference.  8d: a LoRA fine-tune of the checkpoint
    (LORA_STEPS steps, phase 6's batch): the loss of a held batch falls,
    the base stays bit-unchanged, K4 launches exact, ms/step beside phase
    6's full fine-tune, and its LoRA-only checkpoint served by
    load_lora_checkpoint.  -> {kernel: launches on the LoRA paths}."""
    from nano_tpu_torch import export as export_cli
    from nano_tpu_torch.infer import engine, speculative
    from nano_tpu_torch.io import binfmt
    from nano_tpu_torch.io.checkpoint import Checkpoint
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.ops import sampling
    from nano_tpu_torch.serve.batching import BatchedEngine
    from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
    from nano_tpu_torch.train.trainer import Trainer
    dev, card, names, cfg = h.dev, h.card, h.names, h.cfg
    L = cfg.n_layer
    bf16, f32 = torch.bfloat16, torch.float32
    greedy = sampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    os.makedirs(h.work, exist_ok=True)
    path_counts = {n: 0 for n in names}

    def counted(c):
        for n in names:
            path_counts[n] += c[n]
        return c

    def adapter(name, c, rank, seed, std_b):
        path = os.path.join(h.work, f"{name}.bin")
        binfmt.write_lora(path, random_lora(np, c, rank, seed, std_b), c,
                          rank=rank, alpha=2 * rank)
        return path

    a16 = adapter("qwen_a16", cfg, LORA_RANK, SEED + 40, 0.1)
    b16 = adapter("qwen_b16", cfg, LORA_RANK, SEED + 41, 0.1)
    c8 = adapter("qwen_c8", cfg, LORA_RANK // 2, SEED + 42, 0.1)

    def qwen_ctx(params):
        return engine.LLMContext(
            cfg=cfg, params=params, tokenizer=h.tok,
            max_seq_len=cfg.block_size, device=dev, dtype=bf16,
            sampler=greedy, stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")

    def god(ctx, n=LORA_NEW, ids=None):
        """generate_on_device -> (ids, seconds, launches)."""
        h.reset()
        t0 = time.time()
        out = engine.generate_on_device(ctx, h.prompt if ids is None
                                        else ids, n)
        torch.cuda.synchronize()
        return out, time.time() - t0, h.read()

    def eager(ctx, n=LORA_NEW):
        """The decode step called from Python with the context's adapter,
        step by step (what the graph captures)."""
        cache, gen = ctx.new_cache(1), ctx.generator()
        tok_, seen = engine._prefill_first_token(
            ctx, h.prompt, cache, gen, ctx.lora, ctx.lora_scale)
        pos = torch.tensor([len(h.prompt)], dtype=torch.int32, device=dev)
        out = [tok_]
        for _ in range(1, n):
            tok_ = engine._decode_step(ctx, tok_, pos, cache, seen, gen,
                                       ctx.lora, ctx.lora_scale)
            pos += 1
            out.append(tok_)
        return torch.cat(out).cpu().numpy()

    def exact(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")

    # ---------------- 8a: one adapter on a context ----------------
    t8 = time.time()
    steps = LORA_NEW - 1
    params = params_to(h.q80, dev)
    ctx = qwen_ctx(params)
    expect = decode_counts("Q80", steps, names, L)
    base, _, c0 = god(ctx)
    exact("Q80 base", c0, expect)
    if h.base80 is not None and not np.array_equal(base,
                                                   h.base80[:LORA_NEW]):
        raise AssertionError("the Q80 base stream differs from phase 5's")
    ctx.load_lora(a16)
    out1, s1, c1 = god(ctx)
    outa, sa, ca = god(ctx)
    exact("Q80 + adapter, capture", c1, expect)
    exact("Q80 + adapter, replays", counted(ca), expect)
    ea = eager(ctx)
    dec = ctx.decoder()
    n_graphs = len(dec.graphs)
    log(f"[lora] Qwen3-0.6B Q80 + a rank-{LORA_RANK} adapter (alpha "
        f"{LORA_ALPHA}, write_lora), {LORA_NEW} greedy tokens: first call "
        f"(capture) {s1:.3f} s, replays {sa:.3f} s; graph stream torch.equal "
        f"to the eager step loop: {np.array_equal(outa, ea)}; agrees with "
        f"the base stream for {agreeing(outa.tolist(), base.tolist())} "
        f"tokens; launches exact with and without the adapter ({ca}); "
        f"decoder graphs {sorted(str(k[-1]) for k in dec.graphs)}")
    if not (np.array_equal(out1, outa) and np.array_equal(outa, ea)):
        raise AssertionError("Q80 + adapter: the graph stream differs from "
                             "the eager step loop")
    if np.array_equal(outa, base):
        raise AssertionError("the adapter did not change the stream")
    ctx.load_lora(b16)                        # same rank: copied in
    outb, _, cb = god(ctx)
    exact("Q80 + swapped adapter", counted(cb), expect)
    fresh = qwen_ctx(params)
    fresh.load_lora(b16)
    outf, _, _ = god(fresh)
    del fresh
    if len(dec.graphs) != n_graphs or not np.array_equal(outb, outf):
        raise AssertionError(f"the swap: {len(dec.graphs)} graphs (before "
                             f"{n_graphs}), stream equal to a fresh "
                             f"context's: {np.array_equal(outb, outf)}")
    ctx.unload_lora()
    outu, _, cu = god(ctx)
    exact("Q80 after unload", cu, expect)
    if not np.array_equal(outu, base):
        raise AssertionError("the unload did not give the base stream")
    log(f"[lora] swap to a second rank-{LORA_RANK} adapter under the "
        f"captured graph (no capture: {n_graphs} graphs before and after): "
        f"stream torch.equal to a fresh context's; unload: the base stream "
        f"torch.equal (phase 5's: {h.base80 is not None})")

    marks = [("streams, swap, unload", time.time() - t8)]
    # decode rate with and without the adapter, in turns, and a profile
    per_step = {n: expect[n] - decode_counts("Q80", steps - 1, names, L)[n]
                for n in names}
    rates = {"base": [], "lora": []}
    for kind in ("lora", "base", "base", "lora"):
        if kind == "lora":
            ctx.load_lora(a16)
        else:
            ctx.unload_lora()
        _, ttft, _ = god(ctx, 1)
        _, secs, _ = god(ctx, N_TOKENS)
        rates[kind].append(((N_TOKENS - 1) / max(secs - ttft, 1e-9), ttft))
    prof = {}
    for kind in ("base", "lora"):
        if kind == "lora":
            ctx.load_lora(a16)
        else:
            ctx.unload_lora()
        with ctx.on_stream():
            dec.claim()
            dec.prefill(h.prompt)
            # the sums only: phase 5 holds the profiler's launches to the
            # per-step counts (a record lost at the window's edge shows as
            # a kernel less a step here)
            got = (profile_steps(torch, dec._graph().run, 16, PROFILE_KEYS,
                                 per_step) if dev.type == "cuda" else None)
        prof[kind] = (None if got is None or sum(got[0].values()) <= 0 else
                      dict(busy=sum(got[0].values()) / 16,
                           kernels=got[2] / 16))
    (rb, tb), (rl, tl) = max(rates["base"]), max(rates["lora"])
    extra = ("not measured" if None in prof.values() else
             f"card busy {prof['lora']['busy']:.3f} ms a step against "
             f"{prof['base']['busy']:.3f} (the branch: "
             f"{prof['lora']['busy'] - prof['base']['busy']:.3f} ms), "
             f"{prof['lora']['kernels']:.0f} kernels a step against "
             f"{prof['base']['kernels']:.0f} (+"
             f"{prof['lora']['kernels'] - prof['base']['kernels']:.0f})")
    log(f"[decode LoRA Q80] {card}: {N_TOKENS} greedy tokens, better of two "
        f"in turns: {rl:.2f} tok/s with the rank-{LORA_RANK} adapter (TTFT "
        f"{tl * 1e3:.2f} ms) against {rb:.2f} tok/s without (TTFT "
        f"{tb * 1e3:.2f} ms); {extra}")

    marks.append(("rates and profiles", time.time() - t8))
    # speculative decode with the adapter: the plain adapter stream's
    # prefix where the verify forward rounds alike
    pattern = h.prompt[:8] * 8
    plain_s, _, _ = god(ctx, LORA_NEW, pattern)
    ctx.spec_k = SPEC_K
    spec_s, secs, csp = god(ctx, LORA_NEW, pattern)
    spec_s, secs, csp = god(ctx, LORA_NEW, pattern)
    counted(csp)
    st = speculative.LAST_STATS
    ctx.spec_k = 0
    if csp["decode_attention"] or not st["rounds"]:
        raise AssertionError(f"spec with an adapter: launches {csp}, stats "
                             f"{st}")
    log(f"[lora] spec_k {SPEC_K} with the adapter on a repeated 8-token "
        f"pattern: {st['tokens'] / st['rounds']:.2f} tokens a verify round, "
        f"{(LORA_NEW - 1) / secs:.1f} tok/s; agrees with the plain stream "
        f"for {agreeing(spec_s.tolist(), plain_s.tolist())} of {LORA_NEW}")
    del dec
    marks.append(("spec", time.time() - t8))

    # the Q4K model and the GGUF model with the adapter: a stream each
    for label, c_, want_for in (
            ("Q4K", None, lambda st_: decode_counts("Q4K", st_, names, L)),
            ("GGUF Q8_0", h.gctx,
             lambda st_: gguf_rows_counts(st_, names, L))):
        if label == "Q4K":
            p4 = params_to(h.q4k, dev)
            c_ = qwen_ctx(p4)
        elif c_ is None:
            log("[lora] GGUF: no model given (bench): not run")
            continue
        want = want_for(steps)
        b_, _, cb_ = god(c_)
        c_.load_lora(a16)
        o1, _, _ = god(c_)
        o2, secs, c2 = god(c_)
        exact(f"{label} + adapter", counted(c2), want)
        # the prefill's logits with the adapter against without: the
        # branch reached the model (a random model may keep its argmax)
        first = [engine._prefill(c_, h.prompt, c_.new_cache(1), *lo)[0]
                 for lo in ((c_.lora, c_.lora_scale), (None, 0.0))]
        moved = ((first[0] - first[1]).abs().max()
                 / first[1].abs().max()).item()
        c_.unload_lora()
        ou, _, _ = god(c_)
        ok = (np.array_equal(o1, o2) and np.array_equal(ou, b_)
              and moved > 0 and o2.max() < cfg.vocab_size)
        log(f"[lora] {label} + the adapter: {LORA_NEW} tokens, "
            f"{(LORA_NEW - 1) / secs:.1f} tok/s (replays), agrees with its "
            f"base stream for {agreeing(o2.tolist(), b_.tolist())}; the "
            f"prefill's logits moved by {moved:.3e} of max|logit|; launches "
            f"exact ({c2}); unload gives the base stream: "
            f"{np.array_equal(ou, b_)}")
        if not ok:
            raise AssertionError(f"{label} + adapter streams")
        if label == "Q4K":
            del c_, p4
    marks.append(("Q4K and GGUF", time.time() - t8))
    log(f"[lora] 8a in {time.time() - t8:.1f} s (at the end of each part: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in marks) + ")")

    # ---------------- 8b: per-slot adapters in BatchedEngine ----------
    t8 = time.time()
    ctx.unload_lora()
    kinds = ["a", "c", None]
    res, failures = {}, []
    for n_slots in (8, 64):
        be = BatchedEngine(ctx, n_slots=n_slots, adapters={"a": a16,
                                                           "c": c8})
        plain = BatchedEngine(ctx, n_slots=n_slots)
        prng = np.random.default_rng(SEED + 50 + n_slots)
        prompts = [prng.integers(100, 30000, 32).tolist()
                   for _ in range(n_slots)]
        which = [kinds[i % 3] for i in range(n_slots)]
        h.reset()
        for pr, name in zip(prompts, which):
            be.add(pr, max_new_tokens=10 ** 6, temperature=0.0,
                   repetition_penalty=1.0, adapter=name)
        want = {n: 0 for n in names}
        want.update(q80_act_quant=L * n_slots,
                    q80_matmul_w8a8=4 * L * n_slots, q80_matvec_fq=n_slots,
                    rms_norm_q80=(2 * L + 1) * n_slots,
                    swiglu_q80=L * n_slots)
        exact(f"{n_slots} slots' joins", counted(h.read()), want)
        for pr in prompts:
            plain.add(pr, max_new_tokens=10 ** 6, temperature=0.0,
                      repetition_penalty=1.0)

        def batched_logits(idx):
            c_b = gpt.KVCache(*(None if t is None else t.clone() for t in (
                be.cache.k, be.cache.v, be.cache.k_scale, be.cache.v_scale)))
            lb, _ = gpt.forward_decode_batched(
                ctx.params, be.tok.clone(), c_b, be.pos.clone(), cfg, bf16,
                ctx.rope_tables(), lora=be.lora_stack,
                lora_scale=be.lora_scales, lora_idx=idx)
            return lb.float()

        lb = batched_logits(be._adapter_idx_t)
        swapped = be._adapter_idx_t.clone()
        swapped[0], swapped[1] = be._adapter_idx_t[1], be._adapter_idx_t[0]
        lc = batched_logits(swapped)
        rel = {None: 0.0, "a": 0.0, "c": 0.0}
        ctrl = []
        for i, (pr, name) in enumerate(zip(prompts, which)):
            # the adapter as the engine's prefill takes it (padded to the
            # stack's rank: zero columns)
            lora, sc = be._adapter_prefill[be.adapter_ids[name]]
            c1 = ctx.new_cache(1, seq_len=be._cache_len())
            t1, _ = engine._prefill_first_token(ctx, pr, c1,
                                                ctx.generator(), lora, sc)
            if int(t1[0]) != int(be.tok[i]):
                raise AssertionError(f"slot {i}: the first token differs")
            l1, _ = gpt.forward_with_cache(ctx.params, t1[:, None], c1,
                                           len(pr), cfg, bf16,
                                           rope=ctx.rope_tables(), lora=lora,
                                           lora_scale=sc)
            l1 = l1[0, 0].float()
            rel[name] = max(rel[name], ((lb[i] - l1).abs().max()
                                        / l1.abs().max()).item())
            if i < 2:
                ctrl.append(((lc[i] - l1).abs().max()
                             / l1.abs().max()).item())
            del c1
        log(f"[lora] BatchedEngine, {n_slots} slots, adapters of ranks "
            f"{LORA_RANK} and {LORA_RANK // 2} and base slots in turn: one "
            f"batched step's logits against each slot's single stream with "
            f"its adapter, worst max|d|/max|logit|: base slots "
            f"{rel[None]:.3e}, rank {LORA_RANK} {rel['a']:.3e}, rank "
            f"{LORA_RANK // 2} {rel['c']:.3e} (limit {BATCH_TOL:.1e}); the "
            f"control, slots 0 and 1 with their adapters swapped, "
            f"{ctrl[0]:.3e} and {ctrl[1]:.3e}")
        if not max(rel.values()) <= BATCH_TOL < min(ctrl):
            failures.append(f"batched LoRA logits at {n_slots} slots")
        del lb, lc
        times = {"lora": [], "plain": []}
        for kind in ("lora", "plain", "plain", "lora"):
            eng_ = be if kind == "lora" else plain
            h.reset()
            eng_.step_burst(8)                    # the capture, then bursts
            torch.cuda.synchronize()
            t0 = time.time()
            got = sum(len(v) for _ in range(2)
                      for v in eng_.step_burst(16).values())
            torch.cuda.synchronize()
            secs = time.time() - t0
            c_ = h.read()
            want = {n: 0 for n in names}
            want.update(q80_act_quant=L * 40,
                        q80_matmul_w8a8=(4 * L + 1) * 40,
                        decode_attention=L * 40,
                        rms_norm_q80=(2 * L + 1) * 40, swiglu_q80=L * 40)
            exact(f"{n_slots} slots {kind}", c_, want)
            if kind == "lora":
                counted(c_)
            times[kind].append((secs * 1e3 / 32, got / secs))
        (ml, tl_), (mp, tp_) = min(times["lora"]), min(times["plain"])
        res[n_slots] = dict(ms=ml, tok_s=tl_, plain_ms=mp, rel=rel,
                            control=min(ctrl))
        log(f"[batch LoRA] {n_slots} slots ({card}), better of two in turns: "
            f"{ml:.3f} ms per batched step with per-slot adapters "
            f"({tl_:.1f} tok/s aggregate) against {mp:.3f} ms without "
            f"({tp_:.1f} tok/s); launches exact")
        del be, plain
        torch.cuda.empty_cache()
    del ctx, params
    torch.cuda.empty_cache()
    log(f"[lora] 8b in {time.time() - t8:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))

    # ---------------- 8c: --merge-lora ----------------
    t8 = time.time()
    tcfg = h.tcfg
    nano16 = adapter("nano_a16", tcfg, LORA_RANK, SEED + 43, 0.05)
    merged = os.path.join(h.work, "nano_merged_f32.bin")
    export_cli.main([merged, "--checkpoint", h.ckpt, "--merge-lora", nano16])
    mctx = engine.LLMContext.from_bin(merged, dtype=f32, device=dev,
                                      sampler=greedy)
    bctx = engine.LLMContext.from_checkpoint(h.ckpt, dtype=f32, device=dev,
                                             sampler=greedy)
    bctx.load_lora(nano16)
    ids = h.nano_prompt
    h.reset()
    mout = engine.generate_on_device(mctx, ids, LORA_NEW)
    bout = engine.generate_on_device(bctx, ids, LORA_NEW)
    counted(h.read())
    # teacher-forced on the merged stream: every position's logits of both
    full = torch.tensor([ids + mout[:-1].tolist()], device=dev)

    def all_logits(c, lora, sc):
        cache = c.new_cache(1)
        lg, _ = gpt.forward_with_cache(c.params, full, cache, 0, c.cfg, f32,
                                       rope=c.rope_tables(), lora=lora,
                                       lora_scale=sc)
        return lg[0, len(ids) - 1:]

    lm = all_logits(mctx, None, 0.0)
    lb_ = all_logits(bctx, bctx.lora, bctx.lora_scale)
    l0 = all_logits(bctx, None, 0.0)
    scale_ = lb_.abs().max()
    rel = ((lm - lb_).abs().max() / scale_).item()
    ctrl = ((l0 - lb_).abs().max() / scale_).item()
    d = (lm - lb_).abs().max(dim=-1).values
    top2 = lb_.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * d
    agree = lm.argmax(-1) == lb_.argmax(-1)
    log(f"[lora] --merge-lora: Nano-168M's checkpoint + a rank-{LORA_RANK} "
        f"adapter folded into an f32 .bin ({os.path.getsize(merged)} bytes), "
        f"served in f32 against the checkpoint with the adapter attached: "
        f"logits over {LORA_NEW} positions, max|d|/max|logit| {rel:.3e} "
        f"(limit {MERGE_LOGITS_TOL:.0e}; the control, the base alone, "
        f"{ctrl:.3e}); greedy argmax equal at {int(agree.sum())} of "
        f"{LORA_NEW} positions, at all {int(sure.sum())} whose margin "
        f"exceeds twice the difference; the two generated streams agree for "
        f"{agreeing(mout.tolist(), bout.tolist())} tokens")
    if not (rel <= MERGE_LOGITS_TOL < ctrl and bool(agree[sure].all())):
        raise AssertionError("the merged export disagrees with base + "
                             "adapter")
    del mctx, bctx, lm, lb_, l0
    os.remove(merged)
    torch.cuda.empty_cache()
    log(f"[lora] 8c in {time.time() - t8:.1f} s")

    # ---------------- 8d: LoRA fine-tune ----------------
    t8 = time.time()
    save_to = os.path.join(h.work, "finetune")
    lcfg = dict(h.train_cfg, from_checkpoint=h.ckpt, use_lora=True,
                lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA,
                learning_rate=LORA_LR, min_lr=LORA_LR / 10, warmup_iters=1,
                lr_decay_iters=LORA_STEPS, eval_interval=10 ** 6,
                save_checkpoint_to=save_to)
    trainer = Trainer(tcfg, lcfg, max_steps=LORA_STEPS, device=dev)
    trainer.init()
    trainer.load_data()
    A = lcfg["gradient_accumulation_steps"]
    TL = tcfg.n_layer
    frozen = {k: v.detach().clone() for k, v in
              gpt.param_leaves(trainer.params)}
    xs, ys, ms_ = trainer._get_accum_batch()            # the held batch
    before = trainer._eval_step(xs[0], ys[0], ms_[0])
    step_ms = []
    plain_step = trainer._train_step

    def timed_step(xs_, ys_, ms2):
        torch.cuda.synchronize()
        t0 = time.time()
        loss = plain_step(xs_, ys_, ms2)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        return loss

    trainer._train_step = timed_step
    h.reset()
    trainer.start()
    c_ = counted(h.read())
    after = trainer._eval_step(xs[0], ys[0], ms_[0])
    want = {n: 0 for n in names}
    want.update(flash_attn_fwd=TL * A * LORA_STEPS,
                flash_attn_bwd=TL * A * LORA_STEPS)
    exact("LoRA fine-tune", c_, want)
    unchanged = all(torch.equal(v, frozen[k]) and v.grad is None
                    for k, v in gpt.param_leaves(trainer.params))
    steady = sorted(step_ms[2:])
    ms_step = steady[len(steady) // 2]
    n_train = sum(v.numel() for v in trainer.lora.values())
    log(f"[train LoRA] the Nano-168M checkpoint, a fresh rank-"
        f"{LORA_RANK} adapter ({n_train:,} parameters) on the frozen base, "
        f"{LORA_STEPS} steps at lr {LORA_LR:g}, batch "
        f"{lcfg['batch_size']} x {tcfg.block_size}, {lcfg['dtype']}, remat "
        f"{lcfg['remat_policy']!r}, on {card}: median {ms_step:.1f} ms/step "
        f"over steps 3-{LORA_STEPS} (first {step_ms[0]:.1f}) against "
        + (f"{h.full_ms:.1f}" if h.full_ms else "not measured")
        + f" for the full fine-tune (phase 6); losses "
        f"{[round(l, 4) for _, l in trainer.loss_history]}; the held batch's "
        f"loss {before:.4f} -> {after:.4f}; base bit-unchanged: {unchanged}; "
        f"K4 launches exact ({c_['flash_attn_fwd']} forward, "
        f"{c_['flash_attn_bwd']} backward)")
    if not (after < before and unchanged):
        raise AssertionError("the LoRA fine-tune did not lower the held "
                             "batch's loss or moved the base")
    path = os.path.join(save_to, "checkpoint.npz")
    ck = Checkpoint(path)
    if not (ck.is_lora and not ck.has("model")):
        raise AssertionError("the LoRA fine-tune's checkpoint is not "
                             "LoRA-only")
    sctx = engine.LLMContext.from_checkpoint(h.ckpt, device=dev,
                                             sampler=greedy)
    sctx.load_lora_checkpoint(path)
    same = all(torch.equal(sctx.lora[k], v.detach().to(bf16))
               for k, v in trainer.lora.items())
    del trainer, frozen
    torch.cuda.empty_cache()
    out, secs, c_ = god(sctx, LORA_NEW, h.nano_prompt)
    exact("the fine-tuned adapter served", counted(c_),
          dense_counts(LORA_NEW - 1, names, TL))
    log(f"[lora] the LoRA-only checkpoint served by load_lora_checkpoint on "
        f"the base: adapter equal to the trainer's (bf16): {same}, scale "
        f"{sctx.lora_scale}; {LORA_NEW} tokens at "
        f"{(LORA_NEW - 1) / secs:.1f} tok/s, launches exact")
    if not (same and sctx.lora_scale == LORA_ALPHA / LORA_RANK
            and out.max() < tcfg.vocab_size):
        raise AssertionError("the LoRA-only checkpoint served wrong")
    del sctx
    shutil.rmtree(save_to)
    torch.cuda.empty_cache()
    log(f"[lora] 8d in {time.time() - t8:.1f} s")
    return dict(launches=path_counts, batched=res, decode=(rl, rb),
                train_ms=ms_step)


def bench_lora(torch):
    """Phase 8 alone (lora_phase) on phase 5's models built again, a
    Nano-168M checkpoint of its initial weights (phase 6 trains it 12 steps
    first) and phase 6's training config on its corpus; no GGUF model."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.io.checkpoint import save_checkpoint
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.ops import _build
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    _build.build_all()
    dev = torch.device("cuda")
    cfg = ModelConfig(**QWEN3_06B)
    work = os.path.join(ROOT, "build", "smoke_lora")
    os.makedirs(work, exist_ok=True)
    tcfg = ModelConfig.from_json(os.path.join(ROOT, "config",
                                              "model_168m.json"))
    tok_path = os.path.join(ROOT, "tokenizer", "nano_16384.json")
    ttok = TrieTokenizer.from_file(tok_path)
    ckpt = os.path.join(work, "nano168m_init.npz")
    save_checkpoint(ckpt, params=gpt.init_params(
        torch.Generator().manual_seed(SEED), tcfg, device="cpu"),
        model_config=tcfg.to_dict(), tokenizer_config=ttok.config)
    train_p, val_p, _, _ = pretrain_corpus(ttok, tcfg, work)
    with open(os.path.join(ROOT, "config", "pretrain.json")) as f:
        train_cfg = json.load(f)
    train_cfg.update(dataset_path=[[train_p, val_p]], tokenizer_path=tok_path)
    with open(os.path.join(ROOT, "dataset", "pretrain_sample.txt"),
              encoding="utf-8") as f:
        nano_ids = ttok.encode(f.read())
    tok = TrieTokenizer()
    tok.build_preset(32768)
    prng = np.random.default_rng(SEED + 1)
    for n in (17, 40, 100):            # phase 5's requests, then its prompt
        prng.integers(100, 30000, n)
    names = list(COUNTER_OF)
    card = card_line()
    res = lora_phase(torch, np, SimpleNamespace(
        dev=dev, card=card, names=names, reset=lambda: zero_launches(torch),
        read=lambda: read_launches(torch, names), cfg=cfg, tok=tok, prompt=prng.integers(100, 30000, PROMPT_LEN).tolist(),
        base80=None, q80=random_q80_params(torch, np, cfg, "cpu"),
        q4k=random_q4k_params(torch, np, cfg, "cpu"), gctx=None, tcfg=tcfg,
        ckpt=ckpt, train_cfg=train_cfg, full_ms=None,
        nano_prompt=nano_ids[:EXPORT_PROMPT], work=work))
    shutil.rmtree(work)
    log(f"[bench lora] {res}")


def lifecycle_phase(torch, np, h):
    """Phase 9, the training lifecycle on one card.

    9a: `python -m nano_tpu_torch.data sft` (its main) turns
    dataset/sft_sample.jsonl and dataset/sft_self_id.jsonl into shards
    with tokenizer/nano_16384.json at block size 512; a Trainer under
    config/sft.json (full SFT from h.ckpt, a Nano-168M checkpoint: masked
    loss, batch 32 x 512, accumulation 2, full remat; warmup cut to 1
    step) takes SFT_STEPS steps: the masked loss finite and falling on a
    held batch, K4's launches exact, ms/step, tokens/s, peak memory.
    9b: the remat policies at the pretrain shape (config/pretrain.json:
    batch 64 x 512, bf16) on the same weights and batches, REMAT_STEPS
    steps each: step 1's loss torch.equal across the policies, the first
    step's gradient norm within REMAT_NORM_TOL of "full"'s, K4's launches
    per microbatch exact (forward 2L under "full" and "dots", which run
    the attention again in backward; L under "ffn" and "heads"; backward
    L), ms/step and peak memory of each.
    9c: model_ppl on the toy's f32 / Q80 / Q4K files (h.toy_dir) over the
    first PPL_CHARS characters of its corpus and the next PPL_CHARS, on
    the card (launches exact, toy_ppl_counts) and on the CPU (plain
    versions): the bars of tests/test_trained_fixture.py on the first,
    the card within PPL_CARD_CPU_TOL of the CPU on both, and a control
    run on the first with a fault planted (planted_ppl_fault) off the CPU
    by more than that tolerance; then one PPL_WINDOW-token
    window of the full-width Qwen3-0.6B-shaped Q80 model (h.q80 on the
    host): K1's W8A8 pair (4 products a layer and the head) and K4's
    forward launches exact, tokens scored per second.
    9d: run_problem("sort") (the JAX soak test's run: exact match >=
    SORT_MIN_ACC, no K4 launch: global attention) and
    run_problem("calculator") (K4 at D = 16, launches exact), each
    exported and served: seq2seq on the sort model (its exact match) and
    denoise_generate at top_k = 1 (two runs the same tokens)."""
    import contextlib
    import gc
    import io as _io
    import random
    from dataclasses import replace
    from nano_tpu_torch import eval as teval
    from nano_tpu_torch import problems
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.data import __main__ as data_main
    from nano_tpu_torch.data import preprocess
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.io.checkpoint import Checkpoint
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.train.trainer import Trainer
    dev, card, names = h.dev, h.card, h.names
    os.makedirs(h.work, exist_ok=True)
    tcfg = ModelConfig.from_dict(Checkpoint(h.ckpt).model_config)
    TL = tcfg.n_layer

    def exact(label, got, **want):
        w = {n: 0 for n in names}
        w.update(want)
        if got != w:
            raise AssertionError(f"{label}: launches {got}, expected {w}")

    def profiled_busy_ms(fn):
        """fn() once under torch.profiler -> the card's busy ms (the sum
        of the kernels' device time), None where it recorded none."""
        if dev.type != "cuda":
            return None
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        return us / 1e3 if us > 0 else None

    def timed(trainer, step_ms):
        plain = trainer._train_step

        def step(xs, ys, ms):
            torch.cuda.synchronize()
            t0 = time.time()
            loss = plain(xs, ys, ms)
            torch.cuda.synchronize()
            step_ms.append((time.time() - t0) * 1e3)
            return loss
        trainer._train_step = step

    # ---------------- 9a: SFT ----------------
    t9 = time.time()
    gc.collect()            # the trainers of earlier phases hold cycles
    torch.cuda.empty_cache()
    prefix = os.path.join(h.work, "sft")
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        data_main.main(["sft", "-i",
                        os.path.join(ROOT, "dataset", "sft_sample.jsonl"),
                        os.path.join(ROOT, "dataset", "sft_self_id.jsonl"),
                        "-k", os.path.join(ROOT, "tokenizer",
                                           "nano_16384.json"),
                        "-b", str(tcfg.block_size), "-o", prefix])
    train_p, val_p = prefix + "_train.npz", prefix + "_val.npz"
    ids, mask = preprocess.load_shard(train_p)
    log(f"[sft] {out.getvalue().strip()}: {ids.shape[0]} train samples of "
        f"{ids.shape[1]} tokens, {int(mask.sum())} answer tokens in the "
        f"loss mask")
    if mask is None or ids.shape[1] != tcfg.block_size + 1:
        raise AssertionError("the SFT shards have no mask or a wrong width")
    with open(os.path.join(ROOT, "config", "sft.json")) as f:
        sft_cfg = json.load(f)
    sft_cfg.update(from_checkpoint=h.ckpt, dataset_path=[[train_p, val_p]],
                   save_checkpoint_to=os.path.join(h.work, "sft_ckpt"),
                   warmup_iters=1)
    trainer = Trainer(tcfg, sft_cfg, max_steps=10 ** 9, device=dev)
    trainer.init()
    trainer.load_data()
    trainer.max_steps = trainer.step_count + SFT_STEPS
    A = sft_cfg["gradient_accumulation_steps"]
    full = gpt._remat_mode(trainer._remat()) == "full"
    xs, ys, ms_ = trainer._get_accum_batch()            # the held batch
    before = trainer._eval_step(xs[0], ys[0], ms_[0])
    step_ms = []
    timed(trainer, step_ms)
    torch.cuda.reset_peak_memory_stats()
    h.reset()
    trainer.start()
    got = h.read()
    peak = torch.cuda.max_memory_allocated() / 1e9
    after = trainer._eval_step(xs[0], ys[0], ms_[0])
    exact("SFT", got, flash_attn_fwd=TL * A * SFT_STEPS * (2 if full else 1),
          flash_attn_bwd=TL * A * SFT_STEPS)
    losses = [l for _, l in trainer.loss_history]
    tokens = sft_cfg["batch_size"] * A * tcfg.block_size
    ms_step = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"[sft] the {TL}-layer width-{tcfg.n_embd} step-"
        f"{trainer.step_count - SFT_STEPS} checkpoint, "
        f"config/sft.json (batch {sft_cfg['batch_size']} x "
        f"{tcfg.block_size}, accumulation {A}, {sft_cfg['dtype']}, remat "
        f"{trainer._remat()!r}, masked loss), {SFT_STEPS} steps on {card}: "
        f"median {ms_step:.1f} ms/step over steps 2-{SFT_STEPS} (first "
        f"{step_ms[0]:.1f}), {tokens / ms_step * 1e3:.0f} tokens/s, peak "
        f"memory {peak:.2f} GB; losses {[round(l, 4) for l in losses]}; the "
        f"held batch's masked loss {before:.4f} -> {after:.4f}; K4 launches "
        f"exact ({got['flash_attn_fwd']} forward, {got['flash_attn_bwd']} "
        f"backward)")
    if not (len(losses) == SFT_STEPS and all(np.isfinite(losses))
            and np.isfinite(before) and after < before):
        raise AssertionError("the SFT loss is not finite or did not fall on "
                             "the held batch")
    del trainer
    gc.collect()
    shutil.rmtree(os.path.join(h.work, "sft_ckpt"))
    torch.cuda.empty_cache()
    log(f"[sft] 9a in {time.time() - t9:.1f} s")

    # ---------------- 9b: remat policies ----------------
    t9 = time.time()
    with open(os.path.join(ROOT, "config", "pretrain.json")) as f:
        pt_cfg = json.load(f)
    pt_cfg.update(from_checkpoint=h.ckpt, dataset_path=h.pretrain_data,
                  remat=True, eval_interval=10 ** 6)
    trainer = Trainer(tcfg, pt_cfg, max_steps=10 ** 9, device=dev)
    trainer.init()
    trainer.load_data()
    A = pt_cfg["gradient_accumulation_steps"]
    start = [p.detach().clone() for p in trainer.opt.params]
    opt0 = ([m.clone() for m in trainer.opt.mu],
            [v.clone() for v in trainer.opt.nu], trainer.opt.count)
    data0 = trainer.train_data.state()
    norms = []
    update = trainer.opt.update

    def update_with_norm(grads):
        if len(norms) == 0:
            norms.append(torch.sqrt(sum((g.float() * g.float()).sum()
                                        for g in grads)).item())
        update(grads)
    trainer.opt.update = update_with_norm
    rows = {}
    for policy in REMAT_POLICIES:
        with torch.no_grad():
            for p, s0 in zip(trainer.opt.params, start):
                p.copy_(s0)
            for dst, src in zip(trainer.opt.mu + trainer.opt.nu,
                                opt0[0] + opt0[1]):
                dst.copy_(src)
        trainer.opt.count = opt0[2]
        trainer.train_data.set_state(data0)
        trainer.train_config.remat_policy = policy
        norms.clear()
        step_ms, losses = [], []
        gc.collect()            # the trainers before this one hold cycles
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        h.reset()
        for _ in range(REMAT_STEPS):
            xs, ys, ms_ = trainer._get_accum_batch()
            torch.cuda.synchronize()
            t0 = time.time()
            loss = trainer._train_step(xs, ys, ms_)
            torch.cuda.synchronize()
            step_ms.append((time.time() - t0) * 1e3)
            losses.append(loss.detach().clone())
        got = h.read()
        peak = torch.cuda.max_memory_allocated() / 1e9
        fwd = TL * (2 if policy in ("full", "dots") else 1)
        exact(f"remat {policy}", got, flash_attn_fwd=fwd * A * REMAT_STEPS,
              flash_attn_bwd=TL * A * REMAT_STEPS)
        # one more step (the same batch as the last) under the profiler:
        # the card's busy time, against the last step's wall time
        busy = profiled_busy_ms(lambda: trainer._train_step(xs, ys, ms_))
        rows[policy] = dict(loss=losses[0], norm=norms[0], ms=step_ms,
                            peak=peak, fwd=fwd, busy=busy)
        idle = ("not measured" if busy is None
                else f"{1 - busy / step_ms[-1]:.3f}")
        log(f"[remat] {policy!r} at {TL} layers, width {tcfg.n_embd}, batch "
            f"{pt_cfg['batch_size']} x {tcfg.block_size}, bf16, on {card}: "
            f"{REMAT_STEPS} steps {[round(t, 1) for t in step_ms]} ms "
            f"(last {step_ms[-1]:.1f} ms/step), card busy (profiled) "
            f"{'not measured' if busy is None else f'{busy:.1f}'} ms, idle "
            f"share {idle}, peak memory {peak:.2f} GB, step-1 loss "
            f"{losses[0].item():.6f}, gradient norm {norms[0]:.6f}; K4 per "
            f"microbatch {fwd} forward, {TL} backward (exact)")
    ref = rows["full"]
    for policy, r in rows.items():
        rel = abs(r["norm"] - ref["norm"]) / ref["norm"]
        if not (torch.equal(r["loss"], ref["loss"])
                and torch.isfinite(r["loss"]) and rel <= REMAT_NORM_TOL):
            raise AssertionError(f"remat {policy!r}: step-1 loss or gradient "
                                 f"norm differs from 'full' ({rel:.2e})")
    log("[remat] table (" + card + "): " + "; ".join(
        f"{p} {r['ms'][-1]:.1f} ms/step (busy "
        f"{'not measured' if r['busy'] is None else round(r['busy'], 1)}), "
        f"{r['peak']:.2f} GB, K4 {r['fwd']}/{TL} a microbatch"
        for p, r in rows.items())
        + f"; step-1 loss torch.equal across the policies, gradient norms "
        f"within {REMAT_NORM_TOL:g} of 'full'")
    del trainer, start, opt0
    torch.cuda.empty_cache()
    log(f"[remat] 9b in {time.time() - t9:.1f} s")

    # ---------------- 9c: PPL ----------------
    t9 = time.time()
    with open(os.path.join(ROOT, "dataset", "pretrain_sample.txt"),
              encoding="utf-8") as f:
        text = f.read()
    corpus = text + "\n" + TOY_CHORUS * TOY_N_CHORUS + "\n" + text
    spans = (corpus[:PPL_CHARS], corpus[PPL_CHARS:2 * PPL_CHARS])
    ppl, fails = {}, []
    for quant in ("f32", "q80", "q4k"):
        path = os.path.join(h.toy_dir, f"toy_{quant}.bin")
        cpu_ctx = teval.load_context(path, "cpu")
        S, L = cpu_ctx.cfg.block_size, cpu_ctx.cfg.n_layer
        tol = PPL_CARD_CPU_TOL[quant]
        rels, cpus = [], []
        for i, text in enumerate(spans):
            ids = cpu_ctx.encode(text)
            n_win = len(list(teval.windows(len(ids), S, S)))
            h.reset()
            card_ppl = teval.model_ppl(path, text, device=dev)
            got = h.read()
            exact(f"toy_{quant}.bin's PPL over characters {i * PPL_CHARS}"
                  f"-{(i + 1) * PPL_CHARS}", got,
                  **toy_ppl_counts(quant, n_win, L))
            cpus.append(teval.ids_ppl(cpu_ctx, ids))
            rels.append(abs(card_ppl - cpus[-1]) / cpus[-1])
            if i == 0:
                ppl[quant] = card_ppl
            log(f"[ppl] toy_{quant}.bin, characters {i * PPL_CHARS}-"
                f"{(i + 1) * PPL_CHARS} of its corpus ({len(ids)} tokens, "
                f"{n_win} windows): card {card_ppl:.6f}, CPU plain "
                f"{cpus[-1]:.6f} (relative {rels[-1]:.2e}, tol {tol:g}); "
                f"launches exact {({k: v for k, v in got.items() if v})}")
        caught = True
        for fault, must in PPL_CONTROLS[quant]:
            with planted_ppl_fault(torch, fault):
                bad = teval.model_ppl(path, spans[0], device=dev)
            control = abs(bad - cpus[0]) / cpus[0]
            caught &= control > tol or not must
            log(f"[ppl] toy_{quant}.bin control, {PPL_FAULTS[fault]}: card "
                f"{bad:.6f} (relative {control:.2e}, "
                f"{'must exceed' if must else 'read against'} tol {tol:g})")
        if not (np.isfinite(rels).all() and max(rels) <= tol and caught):
            fails.append(f"toy_{quant}.bin: the card's PPL is off the "
                         f"CPU's by {max(rels):.2e}, or a planted fault "
                         f"passes the tolerance {tol:g}")
    if fails:
        raise AssertionError("; ".join(fails))
    d80, d4k = ppl["q80"] - ppl["f32"], ppl["q4k"] - ppl["f32"]
    log(f"[ppl] toy f32 {ppl['f32']:.4f} (bar < {PPL_F32_MAX}), Q80 delta "
        f"{d80:+.4f} (|.| < {PPL_DQ80_MAX}), Q4K delta {d4k:+.4f} (|.| < "
        f"{PPL_DQ4K_MAX})")
    if not (ppl["f32"] < PPL_F32_MAX and abs(d80) < PPL_DQ80_MAX
            and abs(d4k) < PPL_DQ4K_MAX):
        raise AssertionError("the toy's PPL misses the fixture's bars")
    qctx = engine.LLMContext(cfg=h.qcfg, params=params_to(h.q80, dev),
                             tokenizer=None, max_seq_len=PPL_WINDOW,
                             device=dev, dtype=torch.float32)
    window = np.random.default_rng(SEED + 9).integers(
        100, 30000, PPL_WINDOW + 1)
    teval.window_nll(qctx, window)                       # warm-up
    h.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    nll = teval.window_nll(qctx, window)
    torch.cuda.synchronize()
    secs = time.time() - t0
    got = h.read()
    QL = h.qcfg.n_layer
    exact("a PPL window of the Q80 model", got, q80_act_quant=4 * QL + 1,
          q80_matmul_w8a8=4 * QL + 1, flash_attn_fwd=QL)
    log(f"[ppl] full-width Qwen3-0.6B-shaped Q80 model, one {PPL_WINDOW}-"
        f"token window in f32 on {card}: {secs * 1e3:.1f} ms, "
        f"{PPL_WINDOW / secs:.0f} tokens scored/s, mean NLL "
        f"{nll.mean().item():.4f} (random weights); launches exact "
        f"({got['q80_act_quant']} q80_act_quant, {got['q80_matmul_w8a8']} "
        f"q80_matmul_w8a8, {got['flash_attn_fwd']} flash_attn_fwd)")
    if not bool(torch.isfinite(nll).all()):
        raise AssertionError("the Q80 window's NLL is not finite")
    del qctx
    torch.cuda.empty_cache()
    log(f"[ppl] 9c in {time.time() - t9:.1f} s")

    # ---------------- 9d: problems ----------------
    t9 = time.time()
    acc = {}
    for task, kw in (("sort", SORT_RUN), ("calculator", CALC_RUN)):
        work = os.path.join(h.work, task)
        binp = os.path.join(work, f"{task}.bin")
        prob = problems.make_problem(task, kw.get("seq_length", 8))
        pcfg = ModelConfig.from_dict(prob.model_config)
        out = _io.StringIO()
        h.reset()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            acc[task] = problems.run_problem(task, work, export_bin=binp,
                                             device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.time() - t0
        got = h.read()
        S = kw["max_steps"]
        n_eval = (S - 1) // max(100, S // 10)
        fwd = pcfg.n_layer * (S + 2 * 5 * n_eval + 1) if pcfg.is_causal else 0
        exact(f"run_problem({task!r})", got, flash_attn_fwd=fwd,
              flash_attn_bwd=pcfg.n_layer * S if pcfg.is_causal else 0)
        losses = [ln for ln in out.getvalue().splitlines() if "Loss:" in ln]
        log(f"[problems] {task}: {S} steps of batch {kw['batch_size']}, "
            f"{kw['dtype']}, {pcfg.n_layer} layers, width {pcfg.n_embd}, "
            f"heads of {pcfg.head_dim}, "
            f"{'causal' if pcfg.is_causal else 'global attention'}, on "
            f"{card}: {secs:.1f} s with data and evals, exact match "
            f"{acc[task]:.3f} over {kw['n_eval']} fresh samples; last log "
            f"{losses[-1].strip() if losses else None!r}; K4 launches exact "
            f"({got['flash_attn_fwd']} forward, {got['flash_attn_bwd']} "
            f"backward)")
        # a .bin header carries no is_causal (the reference's format)
        ctx = engine.LLMContext.from_bin(binp, device=dev,
                                         dtype=torch.float32)
        ctx.cfg = replace(ctx.cfg, is_causal=pcfg.is_causal)
        if task == "sort":
            rng = random.Random(SEED)
            n_ok, n = 0, 100
            for _ in range(n):
                s_ = "".join(str(rng.randint(0, 9)) for _ in range(4))
                got_ids = engine.seq2seq(ctx, ctx.encode(s_))
                n_ok += ctx.decode(got_ids) == "".join(sorted(s_))
            log(f"[problems] sort model served by from_bin: seq2seq exact "
                f"match {n_ok}/{n}")
            if not (acc[task] >= SORT_MIN_ACC and n_ok >= SORT_MIN_ACC * n):
                raise AssertionError("the sort model misses the soak test's "
                                     "bar")
        prompt = ctx.encode("(+1(*01))=" if task == "calculator" else "31")
        outs = [engine.denoise_generate(ctx, prompt, 2 * pcfg.block_size,
                                        top_k=1) for _ in range(2)]
        log(f"[problems] {task}: denoise_generate top_k=1, "
            f"{2 * pcfg.block_size} new tokens -> "
            f"{ctx.decode(outs[0])[:60]!r}...; "
            f"two runs equal: {outs[0] == outs[1]}")
        if not (outs[0] == outs[1]
                and len(outs[0]) == len(prompt) + 2 * pcfg.block_size
                and max(outs[0]) < pcfg.vocab_size):
            raise AssertionError(f"{task}: denoise_generate at top_k=1 is "
                                 f"not deterministic or left its vocab")
        del ctx
        shutil.rmtree(work)
    log(f"[problems] 9d in {time.time() - t9:.1f} s")
    return dict(sort=acc["sort"], calculator=acc["calculator"],
                remat={p: (r["ms"][-1], r["peak"]) for p, r in rows.items()},
                sft_ms=ms_step, ppl=ppl)


def bench_lifecycle(torch):
    """Phase 9 alone (lifecycle_phase) on a Nano-168M checkpoint of its
    initial weights (phase 6 trains it 12 steps first), a freshly trained
    toy (phase 5c's) and phase 5's Q80 model built again."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.io.checkpoint import save_checkpoint
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.ops import _build
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    _build.build_all()
    dev = torch.device("cuda")
    work = os.path.join(ROOT, "build", "smoke_lifecycle")
    os.makedirs(work, exist_ok=True)
    tcfg = ModelConfig.from_json(os.path.join(ROOT, "config",
                                              "model_168m.json"))
    ttok = TrieTokenizer.from_file(os.path.join(ROOT, "tokenizer",
                                                "nano_16384.json"))
    ckpt = os.path.join(work, "nano168m_init.npz")
    save_checkpoint(ckpt, params=gpt.init_params(
        torch.Generator().manual_seed(SEED), tcfg, device="cpu"),
        model_config=tcfg.to_dict(), tokenizer_config=ttok.config)
    train_p, val_p, _, _ = pretrain_corpus(ttok, tcfg, work)
    names = list(COUNTER_OF)
    card = card_line()
    reset = lambda: zero_launches(torch)
    read = lambda: read_launches(torch, names)
    toy_dir = os.path.join(ROOT, "build", "smoke_toy")
    trained_toy_phase(torch, np, SimpleNamespace(
        dev=dev, card=card, reset=reset, read=read, work=toy_dir))
    qcfg = ModelConfig(**QWEN3_06B)
    res = lifecycle_phase(torch, np, SimpleNamespace(
        dev=dev, card=card, names=names, reset=reset, read=read, ckpt=ckpt,
        pretrain_data=[[train_p, val_p]], toy_dir=toy_dir, qcfg=qcfg,
        q80=random_q80_params(torch, np, qcfg, "cpu"), work=work))
    shutil.rmtree(work)
    log(f"[bench lifecycle] {res}")


# the rows form's timed cases: (label, rows B, with the head); a decode
# step and a batched step run the 112 layer products and the head, a
# prefill the 112 (its head is one row)
ROWS_TIME_CASES = (("decode step", 1, True), ("8 slots", 8, True),
                   ("64-token prefill", 64, False), ("64 slots", 64, True))


def rows_form_times(torch, timer, blocks, head, L, card, gen, tag):
    """The rows form of a GGUF model's served weights (`blocks`, stacked
    over L layers, and the head), over each case of ROWS_TIME_CASES, bf16
    activations into bf16 (the head into f32), replayed from a CUDA graph:
    the new kernels as q80_rows picks them (q80_matvec_rows at one row,
    q80_matmul_rows above) and the warp-a-row q80_matmul_rows_warp in the order old,
    new, new, old; the plain version; bf16 torch.matmul and f32
    torch.matmul (TF32 off: the one PyTorch call that computes the same
    function) on weights dequantized ahead; the bound (bytes: each weight,
    scale, input and output once; operations: 2 B N K at the f32 rate).
    Layer 0's products and the head are held to the plain version first (f32
    out, 1e-5 of max|y|).  -> {label: dict(launches, new, old (two times
    each), plain, bf16, f32, bound (ms, by), err)}."""
    from nano_tpu_torch.ops import qmatmul
    bf16, f32 = torch.bfloat16, torch.float32
    names = [n for n in ("wqkv", "wq", "wk", "wv", "wo", "w13", "w1", "w3",
                         "w2") if n in blocks]
    layer = [blocks[n].layer(i) for i in range(L) for n in names]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    deq16 = [w.dequantize(bf16) for w in layer + [head]]
    deq32 = [w.dequantize(f32) for w in layer + [head]]
    out = {}
    for label, B, with_head in ROWS_TIME_CASES:
        idx = list(range(len(layer))) + ([len(layer)] if with_head else [])
        ws = [(layer + [head])[j] for j in idx]
        odt = [bf16] * len(layer) + [f32] * with_head
        xs = [torch.randn(B, w.in_dim, device=head.q.device,
                          generator=gen).to(bf16) for w in ws]
        err = 0.0
        for j in list(range(len(names))) + ([len(ws) - 1] if with_head else []):
            y = qmatmul.q80_rows(xs[j], ws[j], f32)
            ref = qmatmul.q80_matmul_rows_plain(xs[j], ws[j], f32)
            err = max(err, ((y - ref).abs().max() / ref.abs().max()).item())
        if not err <= 1e-5:
            raise AssertionError(f"the rows form {label}: max|d|/max|y| {err}")
        run_new = lambda: [qmatmul.q80_rows(x, w, o)
                           for x, w, o in zip(xs, ws, odt)]
        run_old = lambda: [qmatmul.q80_matmul_rows_warp(x, w, o)
                           for x, w, o in zip(xs, ws, odt)]
        run_plain = lambda: [qmatmul.q80_matmul_rows_plain(x, w, o)
                             for x, w, o in zip(xs, ws, odt)]
        run_bf16 = lambda: [torch.matmul(x, deq16[j].t())
                            for x, j in zip(xs, idx)]
        run_f32 = lambda: [torch.matmul(x.float(), deq32[j].t())
                           for x, j in zip(xs, idx)]
        t_old = [timer(run_old)]
        t_new = [timer(run_new), timer(run_new)]
        t_old.append(timer(run_old))
        t_plain = timer(run_plain, reps=3)
        t_bf16, t_f32 = timer(run_bf16), timer(run_f32)
        nb = sum(w.q.numel() + 4 * w.scales.numel() + 2 * B * w.in_dim
                 + (4 if o == f32 else 2) * B * w.out_dim
                 for w, o in zip(ws, odt))
        b = bound(nb, sum(2 * B * w.q.numel() for w in ws), F32_OPS_PER_S)
        kern = "q80_matvec_rows" if B == 1 else "q80_matmul_rows"
        log(f"[{tag}] rows form, {label} (B = {B}, {len(ws)} launches, gs "
            f"{head.group_size}, {nb / 1e6:.1f} MB, "
            f"{2 * B * sum(w.q.numel() for w in ws) / 1e9:.2f} GFLOP) on "
            f"{card}: {kern} {t_new[0]:.4f} / {t_new[1]:.4f} ms, the warp-a-row "
            f"q80_matmul_rows_warp {t_old[0]:.4f} / {t_old[1]:.4f} ms (in the "
            f"order old, new, new, old), plain {t_plain:.4f} ms, bf16 "
            f"torch.matmul {t_bf16:.4f} ms, f32 torch.matmul (TF32 off) "
            f"{t_f32:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); new / old "
            f"{min(t_new) / min(t_old):.3f}, new / f32 library "
            f"{min(t_new) / t_f32:.3f}, new / bf16 library "
            f"{min(t_new) / t_bf16:.3f}, new / bound {min(t_new) / b[0]:.2f}; "
            f"largest error against the plain version {err:.3e} of max|y|")
        out[label] = dict(launches=len(ws), new=t_new, old=t_old,
                          plain=t_plain, bf16=t_bf16, f32=t_f32, bound=b,
                          err=err)
        del xs
    torch.backends.cuda.matmul.allow_tf32 = tf32
    del deq16, deq32
    torch.cuda.empty_cache()
    return out


def rows_plan_sweep(torch, timer, blocks, head, L, B, tag):
    """Every work split of the rows-form kernel for B rows at each distinct
    product of a GGUF model's served weights (its L layers launched in
    turn, bf16 rows): q80_matvec_rows's (T, R, S) at B = 1,
    q80_matmul_rows's (MB, BN, CS, S) above, the C function called
    directly; the fastest three and the plan's."""
    from nano_tpu_torch.ops import _build, int8_mma, qmatmul
    bf16 = torch.bfloat16
    lib = _build.lib("q80_matmul")
    int8_mma.init(torch.device("cuda"), "q80_matmul_init")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    st = lambda: torch.cuda.current_stream().cuda_stream
    for name in [n for n in ("wqkv", "wo", "w13", "w2") if n in blocks] + ["head"]:
        ws = [head] if name == "head" else [blocks[name].layer(i)
                                            for i in range(L)]
        w0 = ws[0]
        K, N, gs = w0.in_dim, w0.out_dim, w0.group_size
        x = torch.randn(B, K, device="cuda").to(bf16)
        y = torch.empty(B, N, device="cuda", dtype=bf16)
        res = []
        if B == 1:
            plan = qmatmul.matvec_rows_plan(N, K, gs, sms)
            for T in (8, 32):
                for R in (2, 4, 8, 16, 32):
                    for S in (1, 2, 3, 4):
                        if qmatmul.matvec_rows_smem(K, K // gs, R, S) > 113 * 1024:
                            continue
                        for blocks_ in sorted({plan[0], min(sms, plan[0])}):
                            args = (blocks_, R, S, T)
                            run = lambda a=args: [lib.q80_matvec_rows(
                                x.data_ptr(), 1, w.q.data_ptr(),
                                w.scales.data_ptr(), y.data_ptr(), 1, K, N, gs,
                                *a, st()) for w in ws]
                            if any(run()):
                                continue
                            res.append((timer(run), args))
        else:
            plan = qmatmul.rows_plan(B, N, K, sms)
            for BN in (8, 16, 32, 64):
                if BN < min(B, 64) // 2 or (BN > 8 and BN // 2 >= B):
                    continue
                for MB in (64, 128):
                    for CS in (1, 2, 4, 8):
                        for S in (1, 2, 3, 4):
                            if (CS > -(-K // qmatmul.ROWS_KC)
                                    or qmatmul.rows_smem(MB, BN, CS, S)
                                    > qmatmul.MAX_SMEM):
                                continue
                            args = (MB, BN, CS, S)
                            run = lambda a=args: [lib.q80_matmul_rows(
                                x.data_ptr(), 1, w.q.data_ptr(),
                                w.scales.data_ptr(), y.data_ptr(), 1, B, K, N,
                                gs, *a, st()) for w in ws]
                            if any(run()):
                                continue
                            res.append((timer(run), args))
        res.sort()
        mine = next((t for t, a in res if a == tuple(plan)), None)
        log(f"[{tag}] sweep B = {B}, {name} ({len(ws)} x {K}->{N}, gs {gs}): "
            f"fastest " + ", ".join(f"{a} {t:.4f} ms" for t, a in res[:3])
            + f"; the plan {tuple(plan)} "
            + ("not run" if mine is None else f"{mine:.4f} ms"))


def gguf_rows_params(torch, cfg, gs, seed):
    """Random Qwen3-0.6B weights in the rows form as from_gguf serves a
    GGUF file at group size gs (Q8_0: 32, Q6_K: 16): stacked fused wqkv,
    wo, w13, w2 and the tied head, int8 values and f32 scales from a
    seed, on the card."""
    from nano_tpu_torch.ops import qmatmul
    g = torch.Generator(device="cuda").manual_seed(seed)
    L, E, F, V, HD, KVD, _ = _shapes(cfg)

    def w(*shape):
        q = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda",
                          generator=g)
        s = torch.rand(*shape[:-1], shape[-1] // gs, device="cuda",
                       generator=g) * 2e-3 + 1e-4
        return qmatmul.Q80Tensor(q=q, scales=s, group_size=gs)
    blocks = {"wqkv": w(L, HD + 2 * KVD, E), "wo": w(L, E, HD),
              "w13": w(L, 2 * F, E), "w2": w(L, E, F)}
    return blocks, w(V, E)


def rows_lib_variant(defines, name):
    """q80_matmul.cu built once more with `defines` (-D flags) into
    build/rows_variants/<name>/, loaded, its rows entry points typed and its
    shared-memory limits raised: a build for measurement beside the real
    library."""
    import ctypes
    from nano_tpu_torch.ops import _build
    work = os.path.join(ROOT, "build", "rows_variants", name)
    os.makedirs(work, exist_ok=True)
    so = os.path.join(work, "libq80_matmul.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, *defines, "-o", so,
                    os.path.join(_build.CSRC_DIR, "q80_matmul.cu")], check=True)
    lib = ctypes.CDLL(so)
    for fn in ("q80_matmul_rows", "q80_matvec_rows"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn][0]
    if lib.q80_matmul_init() != 0:
        raise RuntimeError(f"{name}: q80_matmul_init failed")
    return lib


def bench_rows_clocks(torch, blocks, head, B):
    """Layer 0 of each product at B rows through a build with
    -DNANO_ROWS_CLOCKS, rows_plan's split, the L2 cleared before it: per
    launch the span from the first block's entry to the last block's exit,
    the spread of the entries, and the median over blocks of each stamp
    (first chunk ready, products done, the cluster's tiles met, exit) after
    the block's entry, in ns of %globaltimer."""
    import ctypes
    import statistics
    from nano_tpu_torch.ops import qmatmul
    lib = rows_lib_variant(["-DNANO_ROWS_CLOCKS"], "clocks")
    lib.q80_matmul_rows_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 << 20, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    for name in ("wqkv", "wo", "w13", "w2", "head"):
        w = head if name == "head" else blocks[name].layer(0)
        K, N, gs = w.in_dim, w.out_dim, w.group_size
        plan = qmatmul.rows_plan(B, N, K, sms)
        x = torch.randn(B, K, device="cuda").to(torch.bfloat16)
        y = torch.empty(B, N, dtype=torch.bfloat16, device="cuda")
        for _ in range(2):    # the first launch warms up
            flush.zero_()
            assert lib.q80_matmul_rows(x.data_ptr(), 1, w.q.data_ptr(),
                                       w.scales.data_ptr(), y.data_ptr(), 1, B,
                                       K, N, gs, *plan, st) == 0
            torch.cuda.synchronize()
        MB, BN, CS, _ = plan
        nb = min(16384, -(-N // MB) * CS * -(-B // BN))
        buf = (ctypes.c_ulonglong * (5 * nb))()
        assert lib.q80_matmul_rows_clocks(buf, nb) == 0
        t = [list(buf)[5 * b:5 * b + 5] for b in range(nb)]
        t0 = min(r[0] for r in t)
        med = [statistics.median(r[k] - r[0] for r in t) for k in range(1, 5)]
        log(f"[bench rows clocks] B={B} {name} plan {plan}, {nb} blocks: span "
            f"{max(r[4] for r in t) - t0} ns, entries spread over "
            f"{max(r[0] for r in t) - t0} ns; median after entry: first "
            f"chunk ready {med[0]:.0f}, products done {med[1]:.0f}, tiles "
            f"met {med[2]:.0f}, exit {med[3]:.0f} ns")


def bench_rows(torch, sweep=False, clocks=False):
    """The rows form (K1 below group size 256) over a Qwen3-0.6B GGUF
    model's products at group sizes 32 and 16 (rows_form_times); with
    `sweep` every work split at 1, 8 and 64 rows (rows_plan_sweep), with
    `clocks` where a block's time goes at 8 and 64 rows
    (bench_rows_clocks)."""
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.ops import _build
    _build.build_all()
    cfg = ModelConfig(**QWEN3_06B)
    card, timer = card_line(), Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for gs in (32, 16):
        blocks, head = gguf_rows_params(torch, cfg, gs, SEED + gs)
        rows_form_times(torch, timer, blocks, head, cfg.n_layer, card, gen,
                        "bench rows")
        if sweep:
            for B in (1, 8, 64):
                rows_plan_sweep(torch, timer, blocks, head, cfg.n_layer, B,
                                "bench rows")
        if clocks and gs == 32:
            for B in (8, 64):
                bench_rows_clocks(torch, blocks, head, B)
        del blocks, head
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------
# phase 10: parallelism on torch.distributed (nano_tpu_torch/parallel)
# ---------------------------------------------------------------------

# 10a: tokens of each TP = 2 stream over gloo and of its one-device
# reference (two processes time-slice the card, and each eager TP step
# waits on 56 gloo all-reduces through the host: ~120-155 ms a step on an
# NVIDIA H100 80GB HBM3 at 700 W, so the phase takes 32; with the rest of
# the script the run took 1042.8 s of command on a slow host); 10b:
# tokens of the NCCL streams (captured graphs)
PAR_TOKENS, PAR_NCCL_TOKENS = 32, 256
# 10a: a TP = 2 context's first-step logits against the one-device
# context's on the same card, of max|logit|: the row-parallel products'
# f32 partial sums added across the two ranks, rounded to bf16 once, where
# one device sums the whole row in the kernel; an ulp here and there in
# the bf16 activations, which the next product's activation quantization
# can turn into a flipped int8 or 4-bit step, compounding over 28 random
# layers (phase 5c's verify rounds differ from the plain step in the same
# way).  The control, a planted fault (each rank's partial sums doubled in
# place of the sum over the ranks: a collective that adds nothing), must
# read above it; the one-device logits at another prompt are printed too.
# Read on an NVIDIA H100 80GB HBM3 at 700 W: Q80 4.82e-2 against the
# control's 1.38 (the limit near their geometric mean); Q4K 0.0 against
# 8.32e-3 (its random weights, positive on average, make the model nearly
# blind to its input, as in phase 5c: a weak control), the limit phase
# 5c's for the same model.
PAR_LOGITS_TOL = {"Q80": 0.25, "Q4K": 4e-3}
# 10c: Nano-168M at full width, depth cut to PAR_LAYERS (the time limit:
# 8 layers read the same losses to 4.7e-4), batch PAR_BATCH x 512, bf16,
# PAR_STEPS steps and one resumed step under each mesh; the
# losses beside one device's, relative: bf16 products of other shapes
# (half the rows under "data", half the heads and hidden units under
# "model") and the sums over ranks in another order.  The control: the
# one-device loss moves further than that over the steps.  Read on an
# NVIDIA H100 80GB HBM3 at 700 W, at 8 layers: 4.70e-4 ({"data": 2}) and
# 3.35e-4 ({"model": 2}) against the control's 0.106.
PAR_LAYERS, PAR_BATCH, PAR_STEPS = 4, 8, 3
PAR_LOSS_TOL = 5e-3
PAR_MESHES = ({"data": 2}, {"model": 2})
# 10d, 10e: sequence and pipeline parallelism on the same model, batch and
# steps (10d: each rank 256 of the 512 positions, K4's offset form; 10e:
# two layers a stage, PAR_MICRO microbatches), held to the same
# one-device losses.  10f: phase 8's rank-16 adapter on phase 5's Q80
# model at TP = 2 (PAR_LOGITS_TOL, PAR_TOKENS), a BatchedEngine of 4 slots
# with two adapters and the base (PAR_BATCH_TOKENS each), and a LoRA
# fine-tune of 10c's one-device checkpoint at {"model": 2} for
# PAR_LORA_STEPS steps (phase 8's learning rate), losses within
# PAR_LOSS_TOL of one device's
PAR_SEQ, PAR_PIPE = {"seq": 2}, {"pipe": 2}
PAR_MICRO = 4
PAR_BATCH_TOKENS, PAR_LORA_STEPS = 8, 2


def _par_qwen_ctx(torch, engine, cfg, params, dev):
    from nano_tpu_torch.ops import sampling
    from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
    return engine.LLMContext(
        cfg=cfg, params=params, tokenizer=None, max_seq_len=cfg.block_size,
        device=dev, dtype=torch.bfloat16,
        sampler=sampling.SamplerConfig(temperature=0.0,
                                       repetition_penalty=1.0),
        stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")


def _par_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def par_adapter(np, cfg, rank, seed):
    """Phase 8's adapter of `rank` from `seed` (B ~ N(0, 0.1^2)) -> (its
    factors, its scale alpha / rank = 2)."""
    return random_lora(np, cfg, rank, seed, 0.1), 2.0


def par_serve(torch, np, job, mesh, model, lora=None):
    """One Qwen3-0.6B-shaped model of phase 5 on this rank (with the
    adapter `lora`, (factors, scale), attached, where given): the
    one-device context's first logits at the prompt and at another one,
    and its greedy stream (decode graphs); then the context sharded over
    `mesh`: its first logits, the same with each rank's partial sums
    doubled in place of the all-reduce (the control), a warm-up, and a
    timed generate_on_device of job["tokens"] tokens, launches counted
    from 0.  -> a dict of numbers."""
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine
    dev = torch.device(job["device"])
    cfg = ModelConfig(**job["qwen"])
    names, prompt, n = job["names"], job["prompt"], job["tokens"]
    params = (random_q80_params if model == "Q80" else random_q4k_params)(
        torch, np, cfg, dev)

    def ctx_of():
        ctx = _par_qwen_ctx(torch, engine, cfg, params, dev)
        if lora is not None:
            ctx._attach(*lora)
        return ctx

    def first(ctx, ids):
        return engine._prefill(ctx, ids, ctx.new_cache(1), ctx.lora,
                               ctx.lora_scale)[0][0].float().cpu()

    one = ctx_of()
    ref = first(one, prompt)
    other = first(one, prompt[1:] + prompt[:1])
    ref_stream = engine.generate_on_device(one, prompt, n)
    del one
    tp = ctx_of().shard(mesh)
    got = first(tp, prompt)
    plan = tp.cfg.tp
    plan.all_reduce = lambda y: y.mul_(plan.size)           # the control
    fault = first(tp, prompt)
    del plan.all_reduce
    engine.generate_on_device(tp, prompt[:8], 4)           # warm-up
    _par_sync(torch, dev)
    t0 = time.time()
    engine.generate_on_device(tp, prompt, 1)
    _par_sync(torch, dev)
    ttft = time.time() - t0
    zero_launches(torch)
    t0 = time.time()
    out = engine.generate_on_device(tp, prompt, n)
    _par_sync(torch, dev)
    secs = time.time() - t0
    counts = read_launches(torch, names)
    scale = float(ref.abs().max())
    return dict(
        err=float((got - ref).abs().max()) / scale,
        control=float((fault - ref).abs().max()) / scale,
        other=float((other - ref).abs().max()) / scale,
        agree=agreeing(out.tolist(), ref_stream.tolist()),
        stream=out.tolist(), counts=counts,
        expect=decode_counts(model, n - 1, names, cfg.n_layer),
        tok_s=(n - 1) / max(secs - ttft, 1e-9), ttft_ms=ttft * 1e3,
        captures=tp.captures, backend=mesh.backend,
        plan=(plan.heads, plan.kv_heads, plan.attn, plan.ffn, plan.ffn_mode))


def par_train(torch, np, job, shape, over=None, steps=PAR_STEPS,
              resume=True):
    """Nano-168M (PAR_LAYERS layers) under mesh_shape `shape` (and the
    train config changes `over`) on this rank: steps - 1 steps (launches
    counted), a checkpoint, one more step; with `resume` a second Trainer
    resumed from the checkpoint takes that step too.  -> losses, the
    resumed step's loss and whether every local leaf (the adapter's in a
    LoRA fine-tune) equals the unbroken run's, launches and the count
    expected (every layer of a rank's forward once a microbatch: a
    pipeline stage's layers over its microbatches), ms a step."""
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.train.trainer import Trainer
    dev = torch.device(job["device"])
    # bf16 at D = 48: every forward and backward takes the wgmma kernels
    names = ["flash_attn_fwd", "flash_attn_bwd", "flash_attn_fwd_wgmma",
             "flash_attn_bwd_wgmma"]
    tag = "_".join(f"{k}{v}" for k, v in shape.items()) + (
        "_lora" if (over or {}).get("use_lora") else "")
    tc = dict(job["train_cfg"], mesh_shape=shape,
              save_checkpoint_to=os.path.join(job["work"], tag),
              **(over or {}))
    t = Trainer(job["tcfg"], tc, max_steps=steps - 1,
                ckpt_filename="first.npz", device=dev)
    t.init()
    t.load_data()
    step_ms = []
    plain_step = t._train_step

    def timed_step(xs, ys, ms):
        _par_sync(torch, dev)
        t0 = time.time()
        loss = plain_step(xs, ys, ms)
        _par_sync(torch, dev)
        step_ms.append((time.time() - t0) * 1e3)
        return loss

    t._train_step = timed_step
    zero_launches(torch)
    t.start()
    counts = read_launches(torch, names)
    ck = os.path.join(tc["save_checkpoint_to"], "first.npz")
    t.ckpt_filename = "second.npz"
    t.max_steps = steps
    t.start()
    out = dict(losses=[l for _, l in t.loss_history], resumed=None,
               same=True)
    if resume:
        resumed = Trainer(job["tcfg"], dict(tc, from_checkpoint=ck),
                          max_steps=steps, is_continued_pretrain=True,
                          ckpt_filename="resumed.npz", device=dev)
        resumed.init()
        resumed.load_data()
        resumed.start()
        out.update(resumed=resumed.loss_history[-1][1], same=all(
            torch.equal(a, b) for (_, a), (_, b) in zip(
                gpt.param_leaves(t.params),
                gpt.param_leaves(resumed.params))))
    A = tc["gradient_accumulation_steps"]
    P = shape.get("pipe", 1)
    per_step = job["tcfg"]["n_layer"] // P * (tc["pp_microbatches"] if P > 1
                                              else 1) * A
    return dict(out, counts=counts,
                expect={n: per_step * (steps - 1) for n in names},
                ms=sorted(step_ms[1:])[len(step_ms[1:]) // 2],
                mesh=dict(t.mesh.shape))


def par_batched_lora(torch, np, job, mesh):
    """10f, per-slot adapters at TP = 2: phase 5's Q80 model sharded over
    `mesh`, a BatchedEngine of 4 slots with two rank-16 adapters (phase
    8's) and the base, four joins at once, PAR_BATCH_TOKENS greedy tokens
    each (steps eager: gloo's all-reduces are not captured); then each
    join alone in the same engine.  -> the streams together and alone,
    launches of the batched run."""
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.io import binfmt
    from nano_tpu_torch.serve.batching import BatchedEngine
    dev = torch.device(job["device"])
    cfg = ModelConfig(**job["qwen"])
    paths = {}
    for name, seed in (("a", SEED + 40), ("b", SEED + 41)):
        paths[name] = os.path.join(job["work"], f"lora_{name}_"
                                   f"{torch.distributed.get_rank()}.bin")
        binfmt.write_lora(paths[name], random_lora(np, cfg, LORA_RANK, seed,
                                                   0.1), cfg, rank=LORA_RANK,
                          alpha=2 * LORA_RANK)
    ctx = _par_qwen_ctx(torch, engine, cfg, random_q80_params(
        torch, np, cfg, dev), dev).shard(mesh)
    be = BatchedEngine(ctx, n_slots=4, adapters=paths)
    prompt = job["prompt"]
    joins = [(prompt[:40], "a"), (prompt[5:45], None), (prompt[10:50], "b"),
             (prompt[15:55], "a")]

    def run(which):
        got, live = {}, {}
        for i in which:
            ids, name = joins[i]
            slot, first = be.add(ids, max_new_tokens=PAR_BATCH_TOKENS,
                                 temperature=0.0, repetition_penalty=1.0,
                                 adapter=name)
            got[i], live[slot] = [first], i
        while be.n_active:
            res = be.step_burst(2)
            for slot, toks in res.items():
                got[live[slot]].extend(toks)
            for slot in [x for x, e in res.ended.items() if e]:
                be.release(slot)
        return got

    zero_launches(torch)
    together = run(range(4))
    counts = read_launches(torch, job["names"])
    alone = {}
    for i in range(4):
        alone.update(run([i]))
    for p in paths.values():
        os.remove(p)
    return dict(together=together, alone=alone, counts=counts)


def parallel_rank(job):
    """A rank of phase 10's gloo group (``parallel.launch``): TP = 2
    serving of phase 5's two models, the two training meshes of 10c,
    sequence (10d) and pipeline (10e) parallelism, and LoRA at TP = 2
    (10f: serving, per-slot adapters, a fine-tune)."""
    import numpy as np
    import torch
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.parallel import mesh as meshlib
    mesh = meshlib.make_mesh(n_model=2)
    out, secs = {}, {}

    def timed(key, fn):
        t0 = time.time()
        result = fn()
        secs[key] = time.time() - t0
        return result

    for model in ("Q80", "Q4K"):
        out[model] = timed(model, lambda: par_serve(torch, np, job, mesh,
                                                    model))
    out["train"] = [timed(str(shape), lambda: par_train(torch, np, job,
                                                        shape))
                    for shape in PAR_MESHES]
    out["seq"] = timed("seq", lambda: par_train(torch, np, job, PAR_SEQ))
    out["pipe"] = timed("pipe", lambda: par_train(
        torch, np, job, PAR_PIPE, dict(pp_microbatches=PAR_MICRO)))
    lora = par_adapter(np, ModelConfig(**job["qwen"]), LORA_RANK, SEED + 40)
    out["lora"] = timed("lora", lambda: par_serve(torch, np, job, mesh,
                                                  "Q80", lora))
    out["lora_batched"] = timed("lora_batched", lambda: par_batched_lora(
        torch, np, job, mesh))
    out["lora_train"] = timed("lora_train", lambda: par_train(
        torch, np, job, {"model": 2}, job["lora_train"],
        steps=PAR_LORA_STEPS, resume=False))
    out["secs"] = secs
    return out


def nccl_rank(job):
    """A rank of a NCCL group: phase 5's Q80 model sharded over all of it
    (one rank: every cut whole, every all-reduce a sum of one), its decode
    steps captured in CUDA graphs with the all-reduces inside, beside the
    unsharded context's graphs.  -> streams, launches, tok/s."""
    import numpy as np
    import torch
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.parallel import mesh as meshlib
    dev = torch.device(job["device"])
    cfg = ModelConfig(**job["qwen"])
    names, prompt, n = job["names"], job["prompt"], job["nccl_tokens"]
    params = random_q80_params(torch, np, cfg, dev)
    one = _par_qwen_ctx(torch, engine, cfg, params, dev)
    ref = engine.generate_on_device(one, prompt, n)
    del one
    mesh = meshlib.make_mesh(n_model=torch.distributed.get_world_size())
    tp = _par_qwen_ctx(torch, engine, cfg, params, dev).shard(mesh)
    first = engine.generate_on_device(tp, prompt, n)       # captures
    _par_sync(torch, dev)
    t0 = time.time()
    engine.generate_on_device(tp, prompt, 1)
    _par_sync(torch, dev)
    ttft = time.time() - t0
    zero_launches(torch)
    t0 = time.time()
    out = engine.generate_on_device(tp, prompt, n)          # replays
    _par_sync(torch, dev)
    secs = time.time() - t0
    counts = read_launches(torch, names)
    return dict(equal=bool(np.array_equal(out, ref) and
                           np.array_equal(first, ref)),
                agree=agreeing(out.tolist(), ref.tolist()),
                stream=out.tolist(),
                captures=tp.captures, counts=counts,
                expect=decode_counts("Q80", n - 1, names, cfg.n_layer),
                tok_s=(n - 1) / max(secs - ttft, 1e-9),
                graphs=len(tp.decoder().graphs))


def nccl_train_rank(job):
    """A rank of a NCCL group of two cards: 10d's and 10e's meshes
    (par_train) over NCCL, a record beside the gloo ranks' (all-gather,
    reduce-scatter, send and recv on the cards)."""
    import numpy as np
    import torch
    return [par_train(torch, np, job, PAR_SEQ),
            par_train(torch, np, job, PAR_PIPE,
                      dict(pp_microbatches=PAR_MICRO))]


def nccl_phase(torch, h, job):
    """10b: one NCCL rank decodes phase 5's Q80 model from captured graphs
    with its all-reduces inside, its stream torch.equal to the unsharded
    graphs'; where the machine has two cards or more, two NCCL ranks at
    TP = 2 as well (the ranks' streams equal, launches exact), and, given
    10c's training job, {"seq": 2} and {"pipe": 2} over NCCL (a record:
    ms/step, losses, launches)."""
    from nano_tpu_torch.parallel import launch
    for n in ((1, 2) if torch.cuda.device_count() >= 2 else (1,)):
        t0 = time.time()
        ranks = launch.run("chip_smoke:nccl_rank", n, args=(job,),
                           backend="nccl", device="cuda")
        r = ranks[0]
        tok_s = " / ".join(f"{x['tok_s']:.2f}" for x in ranks)
        log(f"[parallel nccl] TP = {n} over NCCL ({n} card(s)): decode "
            f"graphs captured with the all-reduces inside: "
            f"{r['captures']} ({r['graphs']} graph(s)); the stream "
            f"torch.equal to the unsharded graphs': {r['equal']} "
            f"(agreeing {r['agree']} of {h.nccl_tokens}); "
            f"{tok_s} tok/s by rank; launches {r['counts']}; in "
            f"{time.time() - t0:.1f} s on {h.card}")
        for x in ranks:
            if not x["captures"] or x["counts"] != x["expect"]:
                raise AssertionError("the NCCL decode was not the captured "
                                     "graphs' or its launches differ")
            if x["stream"] != r["stream"]:
                raise AssertionError("the NCCL ranks took different tokens")
        if n == 1 and not r["equal"]:
            raise AssertionError("the one-rank NCCL stream differs from "
                                 "the unsharded graphs'")
    if torch.cuda.device_count() >= 2 and "tcfg" in job:
        t0 = time.time()
        ranks = launch.run("chip_smoke:nccl_train_rank", 2, args=(job,),
                           backend="nccl", device="cuda")
        for shape, r0, r1 in zip((PAR_SEQ, PAR_PIPE), *ranks):
            log(f"[parallel nccl] Nano-168M {job['tcfg']['n_layer']} "
                f"layers, batch {job['train_cfg']['batch_size']} x 512, "
                f"bf16, mesh {r0['mesh']} over NCCL (2 cards): losses "
                f"{r0['losses']}; {r0['ms']:.1f} / {r1['ms']:.1f} ms/step "
                f"by rank; resumed step {r0['resumed']!r}, leaves equal "
                f"{r0['same']} / {r1['same']}; launches per rank "
                f"{r0['counts']} (expected {r0['expect']}) on {h.card}")
        log(f"[parallel nccl] the two meshes over NCCL in "
            f"{time.time() - t0:.1f} s")


def parallel_phase(torch, np, h):
    """Phase 10 (``nano_tpu_torch/parallel``): two gloo ranks sharing the
    card serve phase 5's Q80 and Q4K models at TP = 2 and train Nano-168M
    at full width under {"data": 2} and {"model": 2} (10a, 10c), under
    {"seq": 2} (10d: K4's offset form) and {"pipe": 2} (10e), and serve
    and fine-tune with LoRA at TP = 2 (10f); one NCCL rank decodes from
    captured graphs with its all-reduces inside (and two, at TP = 2, where
    the machine has two cards).  h: dev, card, names, prompt, train_data,
    work, and `tokens`, `nccl_tokens`, `qwen`, `layers`, `batch` (the
    script's sizes, smaller for a rehearsal on the CPU).  -> the rank 0
    results of the gloo group."""
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.parallel import launch
    from nano_tpu_torch.train.trainer import Trainer
    os.makedirs(h.work, exist_ok=True)
    tcfg = dict(ModelConfig.from_json(os.path.join(
        ROOT, "config", "model_168m.json")).to_dict(), n_layer=h.layers)
    with open(os.path.join(ROOT, "config", "pretrain.json")) as f:
        train_cfg = json.load(f)
    train_cfg.update(dataset_path=h.train_data, batch_size=h.batch,
                     tokenizer_path=os.path.join(ROOT, "tokenizer",
                                                 "nano_16384.json"),
                     warmup_iters=1, eval_interval=1000, log_interval=1)
    # the one-device trajectory the meshes are held to, and a LoRA
    # fine-tune of its checkpoint (10f's reference)
    one = Trainer(tcfg, dict(train_cfg, save_checkpoint_to=os.path.join(
        h.work, "one")), max_steps=PAR_STEPS, device=h.dev)
    one.init()
    one.load_data()
    one.start()
    one_losses = [l for _, l in one.loss_history]
    lora_train = dict(use_lora=True, lora_rank=LORA_RANK,
                      lora_alpha=LORA_ALPHA, learning_rate=LORA_LR,
                      from_checkpoint=os.path.join(h.work, "one",
                                                   "checkpoint.npz"))
    one = Trainer(tcfg, dict(train_cfg, save_checkpoint_to=os.path.join(
        h.work, "one_lora"), **lora_train), max_steps=PAR_LORA_STEPS,
        device=h.dev)
    one.init()
    one.load_data()
    one.start()
    one_lora = [l for _, l in one.loss_history]
    del one
    job = dict(device=h.dev.type, qwen=h.qwen, names=h.names,
               prompt=h.prompt, tokens=h.tokens, nccl_tokens=h.nccl_tokens,
               tcfg=tcfg, train_cfg=train_cfg, work=h.work,
               lora_train=lora_train)

    t0 = time.time()
    ranks = launch.run("chip_smoke:parallel_rank", 2, args=(job,),
                       backend="gloo", device=h.dev.type)
    log(f"[parallel] two gloo ranks on one {h.dev.type} device in "
        f"{time.time() - t0:.1f} s; rank 0's parts: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in ranks[0]["secs"].items()))
    for model in ("Q80", "Q4K"):
        r0, r1 = ranks[0][model], ranks[1][model]
        log(f"[parallel {model}] TP = 2 over {r0['backend']} "
            f"(decode graphs captured: {r0['captures']}; steps eager), "
            f"plan heads/kv/attn/ffn {r0['plan']}; first-step logits "
            f"against one device {r0['err']:.3e} of max|logit| (limit "
            f"{PAR_LOGITS_TOL[model]}; control, each rank's partial sums "
            f"doubled in place of the all-reduce: {r0['control']:.3e}; "
            f"another prompt: {r0['other']:.3e}); {h.tokens} greedy "
            f"tokens agree with "
            f"one device's for {r0['agree']} (rank 1: {r1['agree']}); "
            f"decode {r0['tok_s']:.2f} / {r1['tok_s']:.2f} tok/s by rank, "
            f"TTFT {r0['ttft_ms']:.1f} ms, on {h.card}")
        log(f"[parallel {model}] launches per rank {r0['counts']}; "
            f"expected {r0['expect']}")
        for r in (r0, r1):
            if r["counts"] != r["expect"]:
                raise AssertionError(f"{model} TP launches differ from a "
                                     f"prefill and {h.tokens - 1} steps'")
        if r0["stream"] != r1["stream"]:
            raise AssertionError(f"the two ranks took different {model} "
                                 f"tokens")
        if not (r0["err"] <= PAR_LOGITS_TOL[model] < r0["control"]):
            raise AssertionError(f"{model} TP logits off one device's")
    meshes = [(shape, r0, r1, "parallel train") for shape, r0, r1 in zip(
        PAR_MESHES, ranks[0]["train"], ranks[1]["train"])]
    meshes += [(PAR_SEQ, ranks[0]["seq"], ranks[1]["seq"], "parallel seq"),
               (PAR_PIPE, ranks[0]["pipe"], ranks[1]["pipe"],
                "parallel pipe")]
    for shape, r0, r1, tag in meshes:
        rel = [abs(a - b) / b for a, b in zip(r0["losses"], one_losses)]
        moved = max(abs(l - one_losses[0]) for l in one_losses) / one_losses[0]
        how = (f", each rank {512 // shape['seq']} positions (K4's offset "
               f"form)" if "seq" in shape else
               f", {h.layers // shape['pipe']} layers a stage, {PAR_MICRO} "
               f"microbatches" if "pipe" in shape else "")
        log(f"[{tag}] Nano-168M {h.layers} layers, batch {h.batch} x 512, "
            f"bf16, mesh {r0['mesh']} (two gloo ranks{how}): "
            f"losses {r0['losses']} beside one device's {one_losses} "
            f"(relative {max(rel):.3e}, limit {PAR_LOSS_TOL}; the "
            f"one-device loss moved {moved:.3e}); step {PAR_STEPS} resumed "
            f"{r0['resumed']!r} / {r1['resumed']!r}, unbroken "
            f"{r0['losses'][-1]!r} / {r1['losses'][-1]!r}, leaves equal "
            f"{r0['same']} / {r1['same']}; {r0['ms']:.1f} / "
            f"{r1['ms']:.1f} ms/step by rank; launches per rank "
            f"{r0['counts']} / {r1['counts']} (expected {r0['expect']}) on "
            f"{h.card}")
        for r in (r0, r1):
            if r["counts"] != r["expect"]:
                raise AssertionError(f"mesh {shape}: K4 launches differ")
            if not (r["resumed"] == r["losses"][-1] and r["same"]):
                raise AssertionError(f"mesh {shape}: the resumed run left "
                                     f"the trajectory")
            if r["losses"] != r0["losses"]:
                raise AssertionError(f"mesh {shape}: the ranks logged "
                                     f"different losses")
        if not (max(rel) <= PAR_LOSS_TOL < moved):
            raise AssertionError(f"mesh {shape}: losses off one device's")
    par_lora_checks(h, ranks, one_lora)
    if h.dev.type == "cuda":
        nccl_phase(torch, h, job)
    return ranks[0]


def par_lora_checks(h, ranks, one_lora):
    """10f's checks on the gloo ranks' results: LoRA serving at TP = 2
    (logits, control, stream, launches), per-slot adapters (each slot's
    stream its stream alone), the LoRA fine-tune at {"model": 2} (losses
    beside one device's, launches)."""
    r0, r1 = ranks[0]["lora"], ranks[1]["lora"]
    log(f"[parallel lora] Q80 with a rank-{LORA_RANK} adapter at TP = 2 "
        f"over {r0['backend']} (adapter attached before the shard: B of q, "
        f"k, v and wo's A cut on the heads): first-step logits against the "
        f"one-device LoRA context {r0['err']:.3e} of max|logit| (limit "
        f"{PAR_LOGITS_TOL['Q80']}; control, each rank's partial sums "
        f"doubled in place of the all-reduce: {r0['control']:.3e}; another "
        f"prompt: {r0['other']:.3e}); {h.tokens} greedy tokens agree with "
        f"one device's for {r0['agree']} (rank 1: {r1['agree']}); decode "
        f"{r0['tok_s']:.2f} / {r1['tok_s']:.2f} tok/s by rank, TTFT "
        f"{r0['ttft_ms']:.1f} ms; launches per rank {r0['counts']} "
        f"(expected {r0['expect']}) on {h.card}")
    for r in (r0, r1):
        if r["counts"] != r["expect"]:
            raise AssertionError("LoRA TP launches differ from a prefill and "
                                 f"{h.tokens - 1} steps'")
    if r0["stream"] != r1["stream"]:
        raise AssertionError("the two ranks took different LoRA tokens")
    if not (r0["err"] <= PAR_LOGITS_TOL["Q80"] < r0["control"]):
        raise AssertionError("LoRA TP logits off one device's")
    b0, b1 = ranks[0]["lora_batched"], ranks[1]["lora_batched"]
    log(f"[parallel lora] BatchedEngine at TP = 2, 4 slots (adapters a, "
        f"base, b, a), {PAR_BATCH_TOKENS} greedy tokens each: every slot's "
        f"stream equal to its stream alone: "
        f"{b0['together'] == b0['alone']} ({b0['together']}); launches of "
        f"the batched run per rank {b0['counts']}")
    for b in (b0, b1):
        if b["together"] != b["alone"] or b["together"] != b0["together"]:
            raise AssertionError("a slot's stream with per-slot adapters at "
                                 "TP = 2 differs from its stream alone")
        if not (b["counts"]["q80_matmul_w8a8"] and
                b["counts"]["decode_attention"]):
            raise AssertionError("the batched LoRA run launched no K1 / K2")
    t0, t1 = ranks[0]["lora_train"], ranks[1]["lora_train"]
    rel = [abs(a - b) / b for a, b in zip(t0["losses"], one_lora)]
    log(f"[parallel lora] LoRA fine-tune (rank {LORA_RANK}) of the "
        f"{h.layers}-layer checkpoint at mesh {t0['mesh']}: losses "
        f"{t0['losses']} / {t1['losses']} beside one device's {one_lora} "
        f"(relative {max(rel):.3e}, limit {PAR_LOSS_TOL}); {t0['ms']:.1f} / "
        f"{t1['ms']:.1f} ms/step by rank; launches per rank {t0['counts']} "
        f"(expected {t0['expect']}) on {h.card}")
    for t in (t0, t1):
        if t["counts"] != t["expect"] or t["losses"] != t0["losses"]:
            raise AssertionError("the LoRA fine-tune at TP = 2: K4 launches "
                                 "differ or the ranks logged other losses")
    if not (len(rel) == PAR_LORA_STEPS and max(rel) <= PAR_LOSS_TOL):
        raise AssertionError("the LoRA fine-tune at TP = 2: losses off one "
                             "device's")


def bench_parallel(torch):
    """Phase 10 alone (parallel_phase): phase 5's prompt and models, phase
    6's corpus made again."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.ops import _build
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    t0 = time.time()
    _build.build_all()
    log(f"[bench parallel] build {time.time() - t0:.1f} s")
    work = os.path.join(ROOT, "build", "smoke_parallel")
    os.makedirs(work, exist_ok=True)
    tcfg = ModelConfig.from_json(os.path.join(ROOT, "config",
                                              "model_168m.json"))
    ttok = TrieTokenizer.from_file(os.path.join(ROOT, "tokenizer",
                                                "nano_16384.json"))
    train_p, val_p, _, _ = pretrain_corpus(ttok, tcfg, work)
    prng = np.random.default_rng(SEED + 1)
    for n in (17, 40, 100):            # phase 5's requests, then its prompt
        prng.integers(100, 30000, n)
    t0 = time.time()
    parallel_phase(torch, np, SimpleNamespace(
        dev=torch.device("cuda"), card=card_line(), names=list(COUNTER_OF),
        prompt=prng.integers(100, 30000, PROMPT_LEN).tolist(),
        qwen=QWEN3_06B, tokens=PAR_TOKENS, nccl_tokens=PAR_NCCL_TOKENS,
        layers=PAR_LAYERS, batch=PAR_BATCH, train_data=[[train_p, val_p]],
        work=work))
    shutil.rmtree(work)
    log(f"[bench parallel] phase 10 in {time.time() - t0:.1f} s")


def bench_nccl(torch):
    """Phase 10b alone (nccl_phase): phase 5's prompt and Q80 model; two
    NCCL ranks at TP = 2, and 10d's and 10e's meshes over NCCL, where the
    machine has two cards."""
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.ops import _build
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    import numpy as np
    t0 = time.time()
    _build.build_all()
    log(f"[bench nccl] build {time.time() - t0:.1f} s")
    prng = np.random.default_rng(SEED + 1)
    for n in (17, 40, 100):            # phase 5's requests, then its prompt
        prng.integers(100, 30000, n)
    work = os.path.join(ROOT, "build", "smoke_nccl")
    os.makedirs(work, exist_ok=True)
    tcfg = ModelConfig.from_json(os.path.join(ROOT, "config",
                                              "model_168m.json"))
    ttok = TrieTokenizer.from_file(os.path.join(ROOT, "tokenizer",
                                                "nano_16384.json"))
    train_p, val_p, _, _ = pretrain_corpus(ttok, tcfg, work)
    with open(os.path.join(ROOT, "config", "pretrain.json")) as f:
        train_cfg = json.load(f)
    train_cfg.update(dataset_path=[[train_p, val_p]], batch_size=PAR_BATCH,
                     tokenizer_path=os.path.join(ROOT, "tokenizer",
                                                 "nano_16384.json"),
                     warmup_iters=1, eval_interval=1000, log_interval=1)
    h = SimpleNamespace(card=card_line(), nccl_tokens=PAR_NCCL_TOKENS)
    nccl_phase(torch, h, dict(
        device="cuda", qwen=QWEN3_06B, names=list(COUNTER_OF),
        prompt=prng.integers(100, 30000, PROMPT_LEN).tolist(),
        nccl_tokens=PAR_NCCL_TOKENS, work=work, train_cfg=train_cfg,
        tcfg=dict(tcfg.to_dict(), n_layer=PAR_LAYERS)))
    shutil.rmtree(work)


GLOO_PROBES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "send_recv")


def gloo_probe_rank(name):
    """A rank of `bench gloo`: the collective `name` of torch.distributed
    once over gloo on a small CUDA tensor (the port never tries and
    catches: ``parallel.mesh`` routes by backend)."""
    import torch
    import torch.distributed as dist
    rank, world = dist.get_rank(), dist.get_world_size()
    t = torch.full((4,), float(rank + 1), device="cuda")
    out = torch.zeros(4 * world, device="cuda")
    parts = list(out.chunk(world))
    half = out[:4 // world]
    {"all_reduce": lambda: dist.all_reduce(t),
     "broadcast": lambda: dist.broadcast(t, 0),
     "all_gather": lambda: dist.all_gather(parts, t),
     "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(out, t),
     "reduce_scatter": lambda: dist.reduce_scatter(
         half, list(t.clone().chunk(world))),
     "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(half, t),
     "send_recv": lambda: (dist.send(t, 1) if rank == 0
                           else dist.recv(t, 0))}[name]()
    torch.cuda.synchronize()
    # what the collective wrote: t in place, or its output
    return (t if name in ("all_reduce", "broadcast", "send_recv")
            else out).cpu().tolist()


def bench_gloo(torch):
    """Which torch.distributed collectives gloo takes on CUDA tensors here
    (`python3 chip_smoke.py bench gloo`): each in a group of two gloo
    ranks on the card of its own, its failure reported by the error's last
    line."""
    from nano_tpu_torch.parallel import launch
    for name in GLOO_PROBES:
        try:
            res = launch.run("chip_smoke:gloo_probe_rank", 2, args=(name,),
                             backend="gloo", device="cuda")
            got = f"ran; the ranks' results {res}"
        except Exception as e:              # the probe's own report
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            got = f"fails: {lines[-1][:200] if lines else type(e).__name__}"
        log(f"[bench gloo] torch {torch.__version__}, {name} of CUDA "
            f"tensors over gloo: {got}")


# Phase 11, the frontends (frontend_phase).  11a: a Session on phase 5's
# Q80 model draws FRONT_TOKENS greedy tokens after its 64-token prompt in
# each observing mode; a summary row's mean|x| must lie within
# FRONT_MEAN_TOL (relative) of the mean of |the callback mode's data| for
# the same tap (the two modes see the same bf16 tensor; only the order of
# the f32 sums differs).
FRONT_TOKENS = 16
FRONT_MEAN_TOL = 1e-3
# 11b: WS_CLIENTS concurrent in-process clients of WSServer, half JSON
# asking WS_TOKENS greedy tokens, half the reference frame (which takes the
# server's 256); one JSON client sends STOP after WS_STOP_AFTER tokens
WS_CLIENTS = 8
WS_TOKENS = 64
WS_STOP_AFTER = 16
WS_BURSTS = (1, 4)
# 11c / 11d: tokens a completion, a gateway request and the CLI draw
OPENAI_TOKENS = 32
GATEWAY_TOKENS = 24
CLI_TOKENS = 32


class _Conn:
    """An in-process WebSocket connection of phase 11: the server's recv()
    takes the client's messages from a queue (CLOSE: the client went
    away), its send() appends to `frames`."""
    CLOSE = object()

    def __init__(self):
        import asyncio
        self.inbox = asyncio.Queue()
        self.frames = []
        self.changed = asyncio.Event()

    async def recv(self):
        m = await self.inbox.get()
        if m is _Conn.CLOSE:
            raise ConnectionError("closed")
        return m

    async def send(self, m):
        self.frames.append(m)
        self.changed.set()

    async def wait_for(self, pred, timeout=300.0):
        import asyncio
        deadline = time.monotonic() + timeout
        while not pred(self.frames):
            self.changed.clear()
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{len(self.frames)} frames so far")
            try:
                await asyncio.wait_for(self.changed.wait(), left)
            except asyncio.TimeoutError:
                pass


def _reply_ended(frame) -> bool:
    """The frame that ends a WSServer / gateway reply: the reference
    protocol's empty frame, or JSON that is no token frame."""
    if frame == "":
        return True
    try:
        obj = json.loads(frame)
    except (TypeError, ValueError):
        return False
    return isinstance(obj, dict) and not ("token" in obj or (
        "text" in obj and "done" not in obj))


async def _converse(handler, msg, stop_after=None):
    """One request `msg` on a fresh connection to `handler` (STOP after
    `stop_after` frames) -> its frames, up to the end of the reply."""
    import asyncio
    conn = _Conn()
    task = asyncio.create_task(handler(conn))
    conn.inbox.put_nowait(msg)
    if stop_after is not None:
        await conn.wait_for(lambda f: len(f) >= stop_after)
        conn.inbox.put_nowait("STOP")
    await conn.wait_for(lambda f: bool(f) and _reply_ended(f[-1]))
    conn.inbox.put_nowait(_Conn.CLOSE)
    await asyncio.wait_for(task, 120)
    return conn.frames


def _json_reply(frames):
    """(token ids, their texts, the done frame) of a JSON reply."""
    objs = [json.loads(f) for f in frames]
    toks = [o for o in objs if "token" in o]
    return ([o["token"] for o in toks], [o["text"] for o in toks],
            objs[-1])


def optional_packages() -> str:
    """Which of the frontends' optional packages import here: websockets
    (the WebSocket transports), aiohttp (the OpenAI HTTP transport),
    transformers (the gateway's HF backend)."""
    import importlib
    out = []
    for name in ("websockets", "aiohttp", "transformers"):
        try:
            mod = importlib.import_module(name)
            out.append(f"{name} {getattr(mod, '__version__', '?')}")
        except Exception as e:            # absent or broken: say which
            out.append(f"{name} no ({type(e).__name__})")
    return ", ".join(out)


def frontend_phase(torch, np, h):
    """Phase 11, the frontends, through the port's servers in-process.

    11a observe: phase 5's Q80 model (h.q80 on h.dev, h.cfg, h.tok, h.prompt)
    in a Session with no observer, a callback observer and a summary
    observer (NANO_TPU_OBSERVE=fallback), twice each (the second times the
    steps): every phase fires, layer phases at every layer; each phase's
    event count is the prefill's plus one a step (SAMPLE: one a step); the
    streams torch.equal; launches exact (decode_counts) in every mode; the
    summary step one graph replay; the summary RESIDUAL rows within
    FRONT_MEAN_TOL of the callback data's mean|x|; ms a step by mode.
    11b WebSocket: WSServer (8 slots) on the Q80 model at each of WS_BURSTS:
    WS_CLIENTS concurrent clients (half JSON, WS_TOKENS tokens, one of them
    STOPped after WS_STOP_AFTER; half the reference frame), each reply equal
    to the same request served alone by the same server (where one parts,
    the alone stream's top-2 margin there, of max|logit|, must be within
    BATCH_TOL), the stats verb, aggregate tok/s beside h.batch_tok_s (phase
    5b's 8 slots); on the trained toy (h.toy_dir) the replies' text equals
    generate_sync's.  11c OpenAI: completions on the Q80 model and chat
    completions on phase 7b's GGUF file (h.gguf, the Qwen chat template),
    one-shot and SSE through the transport-free methods: the SSE pieces
    equal the one-shot text, usage exact, a stop sequence ends with
    finish_reason "stop".  11d: NativeGGUFGateway on h.gguf (3 requests,
    3 samplers: pieces equal Session's stream, one decoder), and
    ``python -m nano_tpu_torch.infer`` on phase 7b's converted .bin (h.qbin)
    as a subprocess: its text equals generate_sync's; with -o a top-6 line
    a step and --trace a Chrome trace naming q80_matvec_fq's and decode
    attention's kernels.  -> {"launches": the counts of every driven run,
    "ms": 11a's ms a step by mode, "tok_s": 11b's by burst}."""
    import asyncio
    from nano_tpu_torch import observe
    from nano_tpu_torch.infer import engine
    from nano_tpu_torch.ops import sampling
    from nano_tpu_torch.serve import gateway, openai_http, wss
    from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
    dev, cfg, card, names = h.dev, h.cfg, h.card, h.names
    L = cfg.n_layer
    exact = dev.type == "cuda"             # the counters count on the card
    sync = torch.cuda.synchronize if exact else (lambda: None)
    greedy = sampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    launches = {n: 0 for n in names}

    def counted(fn):
        """fn() with the launch counters from 0 -> (its result, counts),
        the counts also added to the phase's."""
        h.reset()
        out = fn()
        got = h.read()
        for n in names:
            launches[n] += got[n]
        return out, got

    def q80_ctx(observation=None):
        return engine.LLMContext(
            cfg=cfg, params=h.q80, tokenizer=h.tok,
            max_seq_len=cfg.block_size, device=dev, dtype=torch.bfloat16,
            sampler=greedy, stop_tokens=QWEN_STOP_TOKENS, arch="qwen3",
            observation=observation)

    # ---------------- 11a ----------------
    t11 = time.time()
    events = {}

    def observer(mode):
        def fn(o):
            row = (o.mean_abs if o.summary
                   else float(np.abs(o.data.astype(np.float64)).mean()))
            events[mode].append((int(o.phase), o.layer, row))
        return fn

    def run_session(ctx):
        """Prefill, then the steps timed -> (ids, ms a step, steps)."""
        s = engine.Session(ctx, "", max_new_tokens=FRONT_TOKENS,
                           prompt_ids=h.prompt)
        s.step()
        sync()
        t0 = time.time()
        while s.step() is not None:
            pass
        sync()
        steps = sum(s.steps_by.values())
        return s.output_ids, (time.time() - t0) * 1e3 / max(steps, 1), steps

    streams, ms, steps_of = {}, {}, {}
    saved = observe._FORCE_FALLBACK
    try:
        for mode in ("none", "callback", "summary"):
            observe._FORCE_FALLBACK = mode == "summary"
            ctx = q80_ctx(None if mode == "none" else observer(mode))
            events[mode] = []
            run_session(ctx)                      # captures (graph modes)
            graph = None
            if mode == "summary" and exact:
                graph = ctx.decoder().graphs[(greedy, 1, "fallback", None)]
                if graph.graph is None:
                    raise AssertionError("the summary step was not captured")
                runs = []
                inner = graph.run
                graph.run = lambda: (runs.append(1), inner())
            events[mode] = []
            (ids, ms[mode], steps), counts = counted(lambda: run_session(ctx))
            streams[mode], steps_of[mode] = ids, steps
            if exact and counts != decode_counts("Q80", steps, names, L=L):
                raise AssertionError(f"11a {mode}: launches {counts}")
            if graph is not None and len(runs) != steps:
                raise AssertionError(f"11a summary: {len(runs)} replays for "
                                     f"{steps} steps")
            del ctx
    finally:
        observe._FORCE_FALLBACK = saved
    for mode in ("callback", "summary"):
        if not torch.equal(torch.tensor(streams[mode]),
                           torch.tensor(streams["none"])):
            raise AssertionError(f"11a: the {mode} stream differs")
        n = steps_of[mode]
        got = {}
        for ph, layer, _ in events[mode]:
            got[(ph, layer)] = got.get((ph, layer), 0) + 1
        want = {(ph, layer): 1 + n for ph in range(1, 9)
                for layer in range(L)}
        want.update({(0, -1): 1 + n, (9, -1): 1 + n, (10, -1): 1 + n,
                     (11, -1): n})
        if got != want:
            raise AssertionError(f"11a {mode}: events by (phase, layer) "
                                 f"{sorted(got.items())[:6]}... want "
                                 f"{1 + n} a layer phase")
    res_rows = lambda mode: [r for ph, _, r in events[mode] if ph == 8]
    cb, sm = np.asarray(res_rows("callback")), np.asarray(res_rows("summary"))
    worst = float((np.abs(sm - cb) / cb).max())
    log(f"[frontends] 11a observe, Qwen3-0.6B Q80 ({L} layers) on {card}: a "
        f"64-token prompt and {FRONT_TOKENS} greedy tokens; "
        f"{len(events['callback'])} callback events and "
        f"{len(events['summary'])} summary rows, every phase, layer phases "
        f"at layers 0-{L - 1}, counts exact; streams torch.equal; launches "
        f"exact in every mode; summary steps one graph replay each; "
        f"RESIDUAL summary mean|x| against the callback data's: worst "
        f"{worst:.3e} relative (tol {FRONT_MEAN_TOL}); ms a step: "
        f"unobserved {ms['none']:.3f} (graph replay), callback "
        f"{ms['callback']:.3f} (eager, host copies), summary "
        f"{ms['summary']:.3f} (graph replay + one read)")
    if not worst <= FRONT_MEAN_TOL:
        raise AssertionError("11a: summary rows disagree with the callback "
                             "data")

    # ---------------- 11b ----------------
    rng = np.random.default_rng(SEED + 11)
    texts = [h.tok.decode(rng.integers(100, 30000, 24).tolist())
             for _ in range(WS_CLIENTS)]
    n_json = WS_CLIENTS // 2
    msgs = [json.dumps({"prompt": t, "max_new_tokens": WS_TOKENS,
                        "temperature": 0.0, "repetition_penalty": 1.0,
                        "template": False}) for t in texts[:n_json]]
    msgs += [f"{len(t):05d}|{t}" for t in texts[n_json:]]
    # what each reference frame asks, in JSON (the alone runs): the
    # server's defaults
    alone_msgs = msgs[:n_json] + [json.dumps({
        "prompt": t, "max_new_tokens": 256, "temperature": 0.0,
        "repetition_penalty": 1.0, "template": False})
        for t in texts[n_json:]]
    sctx = q80_ctx()

    async def serve_all(server):
        tasks = [_converse(server.handle, m,
                           WS_STOP_AFTER if i == 0 else None)
                 for i, m in enumerate(msgs)]
        sync()
        t0 = time.time()
        got = await asyncio.gather(*tasks)
        secs = time.time() - t0
        stats = json.loads((await _converse(server.handle, json.dumps(
            {"stats": True})))[-1])
        return got, secs, stats

    async def alone(server):
        return [await _converse(server.handle, m) for m in alone_msgs]

    def margin_at(prompt_text, toks, p):
        """Top-2 margin of max|logit| where the alone stream `toks` drew
        token p (a prefill over the prompt and toks[:p])."""
        ids = sctx.build_prompt_ids(prompt_text, False) + toks[:p]
        with sctx.on_stream():
            lg, _ = engine._prefill(sctx, ids, sctx.new_cache(1))
        top2 = lg[0].topk(2).values
        return float((top2[0] - top2[1]) / lg[0].abs().max())

    async def runs(server, with_alone):
        got = await serve_all(server)
        return got, (await alone(server) if with_alone else None)

    tok_s = {}
    alone_frames = None
    for burst in WS_BURSTS[::-1]:
        server = wss.WSServer(sctx, n_slots=8, template=False, burst=burst)
        ((got, secs, stats), ref), counts = counted(lambda: asyncio.run(
            runs(server, alone_frames is None)))
        alone_frames = alone_frames or ref
        tok_s[burst] = stats["tokens_total"] / secs
        parts = []
        for i, (frames, ref) in enumerate(zip(got, alone_frames)):
            rt, rtexts, _ = _json_reply(ref)
            if i < n_json:
                toks, _, done = _json_reply(frames)
                want = "interrupted" if i == 0 else "length"
                if done != {"done": True, "reason": want}:
                    raise AssertionError(f"11b client {i}: ended {done}")
                p = next((j for j, (a, b) in enumerate(zip(toks, rt))
                          if a != b), None)
                if i == 0 and not len(toks) < len(rt):
                    raise AssertionError("11b: STOP did not cut the stream")
            else:
                if frames[-1] != "":
                    raise AssertionError(f"11b client {i}: no terminator")
                text = "".join(frames[:-1])
                full = "".join(rtexts)
                if text == full:
                    p = None
                else:
                    c = next((j for j, (a, b) in enumerate(zip(text, full))
                              if a != b), min(len(text), len(full)))
                    cum = np.cumsum([len(t) for t in rtexts])
                    p = int(np.searchsorted(cum, c, side="right"))
            if p is not None:
                m = margin_at(texts[i], rt, p)
                parts.append((i, p, m))
                if not m <= BATCH_TOL:
                    raise AssertionError(f"11b client {i} parts from its "
                                         f"alone stream at {p} where the "
                                         f"margin is {m:.3e}")
        if stats["requests_total"] != WS_CLIENTS:
            raise AssertionError(f"11b stats: {stats}")
        log(f"[frontends] 11b WSServer, 8 slots, burst {burst}, Qwen3-0.6B "
            f"Q80 on {card}: {WS_CLIENTS} concurrent clients ({n_json} JSON "
            f"x {WS_TOKENS} tokens, the first STOPped after "
            f"{WS_STOP_AFTER}: reason interrupted; {WS_CLIENTS - n_json} "
            f"reference frames x 256), {stats['tokens_total']} tokens in "
            f"{secs:.3f} s = {tok_s[burst]:.1f} tok/s aggregate (phase 5b's "
            f"batched step at 8 slots: "
            + ("not measured" if h.batch_tok_s is None else
               f"{h.batch_tok_s:.1f} tok/s") + "); each reply equal to the "
            f"request served alone " + (f"except {parts} (client, position, "
                                        f"top-2 margin)" if parts else
                                        "token for token")
            + f"; stats verb {stats['requests_total']} requests; launches "
            f"{ {n: c for n, c in counts.items() if c} }")
    del server

    # the trained toy: the replies' text equals generate_sync's
    tctx = engine.LLMContext.from_bin(
        os.path.join(h.toy_dir, "toy_q80.bin"), device=dev, sampler=greedy)
    tmsgs = [json.dumps({"prompt": TOY_CHORUS[:k], "max_new_tokens": 48,
                         "temperature": 0.0, "repetition_penalty": 1.0,
                         "template": False}) for k in (6, 12)]
    tserver = wss.WSServer(tctx, n_slots=8, template=False, burst=4)

    async def toy_all():
        return await asyncio.gather(*[_converse(tserver.handle, m)
                                      for m in tmsgs])
    treplies = asyncio.run(toy_all())
    for k, frames in zip((6, 12), treplies):
        objs = [json.loads(f) for f in frames]
        text = "".join(o.get("text", "") for o in objs if "done" not in o)
        parts_ = []
        engine.generate_sync(tctx, TOY_CHORUS[:k], max_new_tokens=48,
                             on_decoding=lambda s_, t_, x: parts_.append(x))
        want = "".join(parts_)
        if text != want:
            raise AssertionError(f"11b toy: {text!r} != {want!r}")
    log(f"[frontends] 11b the trained toy (toy_q80.bin) through WSServer: "
        f"2 concurrent replies' text equal to generate_sync's: "
        f"{text[:24]!r}...")
    del tserver, tctx

    # ---------------- 11c ----------------
    async def openai_checks(srv, req, kind):
        call = srv.chat if kind == "chat" else srv.completions
        one = await call(req)
        sse = await call({**req, "stream": True})
        events_ = [e async for e in sse.events]
        body = one.body
        field = ((lambda c: c["message"]["content"]) if kind == "chat"
                 else (lambda c: c["text"]))
        piece = ((lambda c: c["delta"].get("content", "")) if kind == "chat"
                 else (lambda c: c["text"]))
        text = field(body["choices"][0])
        streamed = "".join(piece(e["choices"][0]) for e in events_)
        if not (one.status == sse.status == 200 and streamed == text):
            raise AssertionError(f"11c {kind}: SSE {streamed!r} != one-shot "
                                 f"{text!r}")
        stop = text[len(text) // 2:len(text) // 2 + 3]
        cut = await call({**req, "stop": stop})
        ctext = field(cut.body["choices"][0])
        csse = await call({**req, "stop": [stop], "stream": True})
        cevents = [e async for e in csse.events]
        if not (ctext == text[:text.find(stop)] and cut.body["choices"][0][
                "finish_reason"] == "stop" and cevents[-1]["choices"][0][
                "finish_reason"] == "stop"):
            raise AssertionError(f"11c {kind}: the stop {stop!r} did not end "
                                 f"the stream")
        return body, ctext

    def openai_on(ctx, req, kind, name):
        pool = wss.WSServer(ctx, n_slots=8, template=True, model_name=name)
        return asyncio.run(openai_checks(openai_http.OpenAIServer(pool), req,
                                         kind))

    creq = {"prompt": texts[0], "max_tokens": OPENAI_TOKENS,
            "temperature": 0.0, "repetition_penalty": 1.0}
    (body, ctext), c_counts = counted(
        lambda: openai_on(sctx, creq, "completions", "qwen3-0.6b-q80"))
    n_prompt = len(sctx.build_prompt_ids(texts[0], False))
    if body["usage"] != {"prompt_tokens": n_prompt,
                         "completion_tokens": OPENAI_TOKENS,
                         "total_tokens": n_prompt + OPENAI_TOKENS}:
        raise AssertionError(f"11c completions usage {body['usage']}")
    gctx = engine.LLMContext.from_gguf(h.gguf, device=dev, sampler=greedy)
    msgs_chat = [{"role": "system", "content": "be brief"},
                 {"role": "user", "content": "hello"}]
    qreq = {"messages": msgs_chat, "max_tokens": OPENAI_TOKENS,
            "temperature": 0.0, "repetition_penalty": 1.0}
    (cbody, cctext), g_counts = counted(
        lambda: openai_on(gctx, qreq, "chat", "qwen3-0.6b-q8_0.gguf"))
    n_chat = len(gctx.build_chat_ids(msgs_chat))
    if cbody["usage"]["prompt_tokens"] != n_chat or cbody["usage"][
            "total_tokens"] != n_chat + cbody["usage"]["completion_tokens"]:
        raise AssertionError(f"11c chat usage {cbody['usage']}")
    log(f"[frontends] 11c OpenAIServer on {card}: /v1/completions on the Q80 "
        f"model and /v1/chat/completions on the Qwen3-0.6B Q8_0 GGUF "
        f"({n_chat} chat-template prompt tokens), one-shot and SSE equal, "
        f"usage {body['usage']} / {cbody['usage']}, a stop sequence ends "
        f"both with finish_reason stop; launches "
        f"{ {n: c for n, c in c_counts.items() if c} } and "
        f"{ {n: c for n, c in g_counts.items() if c} }")
    del gctx, sctx

    # ---------------- 11d ----------------
    gw = gateway.NativeGGUFGateway(h.gguf, device=dev)
    decoders, gw_texts = set(), []
    for rp in (1.0, 1.1, 1.3):
        req = json.dumps({"prompt": "hello", "template": False,
                          "max_new_tokens": GATEWAY_TOKENS,
                          "temperature": 0.0, "repetition_penalty": rp})
        frames, counts = counted(lambda: asyncio.run(_converse(
            gw.handle, req)))
        objs = [json.loads(f) for f in frames]
        text = "".join(o.get("text", "") for o in objs)
        decoders.add(id(gw.ctx._decoder))
        # the sampler the gateway set for the request
        gw.ctx.sampler = sampling.SamplerConfig(
            temperature=0.0, top_p=0.8, repetition_penalty=rp)
        s = engine.generate_sync(gw.ctx, "hello",
                                 max_new_tokens=GATEWAY_TOKENS)
        sdec = gw.ctx.stream_decoder()
        want = "".join(sdec.feed(t) for t in s.output_ids) + sdec.flush()
        if text != want or objs[-1] != {"done": True, "reason": "stop"}:
            raise AssertionError(f"11d gateway (rp {rp}): {text!r} != "
                                 f"{want!r}")
        gw_texts.append(text)
    if len(decoders) != 1 or len(gw.ctx._decoder.graphs) != 3:
        raise AssertionError(f"11d gateway: {len(decoders)} decoders, "
                             f"{len(gw.ctx._decoder.graphs)} graphs")
    log(f"[frontends] 11d NativeGGUFGateway on the Qwen3-0.6B Q8_0 GGUF "
        f"({card}): 3 requests at repetition penalty 1.0, 1.1, 1.3, pieces "
        f"equal to Session's streams, one SingleDecoder and 3 graphs (one "
        f"a sampler); launches of the last "
        f"{ {n: c for n, c in counts.items() if c} }")
    del gw

    dev_args = [] if exact else ["--device", "cpu"]
    cli = [sys.executable, "-m", "nano_tpu_torch.infer", "-m", h.qbin, "-q",
           "hello world", "-n", str(CLI_TOKENS), "-t", "0", "-r", "1.0"]
    bctx = engine.LLMContext.from_bin(h.qbin, device=dev, sampler=(
        sampling.SamplerConfig(temperature=0.0, top_p=0.8,
                               repetition_penalty=1.0)))
    parts_ = []
    engine.generate_sync(bctx, "hello world", max_new_tokens=CLI_TOKENS,
                         on_decoding=lambda s_, t_, x: parts_.append(x))
    want = "".join(parts_) + "\n"
    steps = len(parts_) - 1
    del bctx
    trace = os.path.join(h.work, "infer_trace")
    t0 = time.time()
    r1 = subprocess.run(cli + ["-p"] + dev_args, cwd=ROOT,
                        capture_output=True, text=True, timeout=300)
    r2 = subprocess.run(cli + ["-o", "--trace", trace] + dev_args, cwd=ROOT,
                        capture_output=True, text=True, timeout=300)
    cli_secs = time.time() - t0
    for r in (r1, r2):
        # -p prints a sliding " [x tok/s]" after each token from the 4th
        text = re.sub(r" \[[0-9.]+ tok/s\]", "", r.stdout)
        if r.returncode != 0 or text != want:
            raise AssertionError(f"11d infer CLI rc {r.returncode}: "
                                 f"{r.stdout[-300:]!r} {r.stderr[-600:]}")
    top6 = [ln for ln in r2.stderr.splitlines() if "top6:" in ln]
    with open(os.path.join(trace, "trace.json")) as f:
        kernel_names = {e.get("name", "") for e in json.load(f)[
            "traceEvents"] if e.get("cat") == "kernel"}
    shutil.rmtree(trace)
    found = {w: any(k in n for n in kernel_names) for k, w in (
        ("q80_matvec_fq_kernel", "q80_matvec_fq"),
        ("decode_attn_kernel", "decode_attention"))}
    tps = [ln for ln in r1.stderr.splitlines() if "tok/s]" in ln]
    log(f"[frontends] 11d python -m nano_tpu_torch.infer on the converted "
        f"Q80 .bin, {CLI_TOKENS} greedy tokens, as subprocesses ({card}): "
        f"text equal to generate_sync's; {tps[-1] if tps else ''}; -o "
        f"{len(top6)} top-6 lines for {steps} steps; --trace: kernels "
        f"named {found}; both runs {cli_secs:.1f} s")
    if len(top6) != steps or (exact and not all(found.values())):
        raise AssertionError("11d: -o or --trace output malformed")
    log(f"[frontends] phase 11 launches {launches}; {time.time() - t11:.1f} s")
    return {"launches": launches, "ms": ms, "tok_s": tok_s}


def bench_frontends(torch):
    """Phase 11 alone (frontend_phase): phase 5's Q80 model and prompt,
    the trained toy (trained again unless build/smoke_toy holds it) and
    phase 7b's GGUF file and its converted Q80 .bin, written again."""
    import numpy as np
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.io import gguf
    from nano_tpu_torch.ops import _build
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    _build.build_all()
    log(f"[bench frontends] optional packages: {optional_packages()}")
    dev = torch.device("cuda")
    names = list(COUNTER_OF)
    reset = lambda: zero_launches(torch)
    read = lambda: read_launches(torch, names)
    cfg = ModelConfig(**QWEN3_06B)
    tok = TrieTokenizer()
    tok.build_preset(32768)
    prng = np.random.default_rng(SEED + 1)
    for n in (17, 40, 100):            # phase 5's requests, then its prompt
        prng.integers(100, 30000, n)
    prompt = prng.integers(100, 30000, PROMPT_LEN).tolist()
    toy_dir = os.path.join(ROOT, "build", "smoke_toy")
    if not os.path.exists(os.path.join(toy_dir, "toy_q80.bin")):
        trained_toy_phase(torch, np, SimpleNamespace(
            dev=dev, card=card_line(), reset=reset, read=read, work=toy_dir))
    work = os.path.join(ROOT, "build", "smoke_frontends")
    os.makedirs(work, exist_ok=True)
    gpath = qwen_gguf(torch, torch.Generator(device=dev).manual_seed(
        SEED + 13), cfg, work)
    qbin = os.path.join(work, "qwen3_0.6b_q80.bin")
    gguf.convert_gguf(gpath, qbin, quant="q80", group_size=256)
    frontend_phase(torch, np, SimpleNamespace(
        dev=dev, card=card_line(), names=names, reset=reset, read=read,
        cfg=cfg, q80=random_q80_params(torch, np, cfg, dev), tok=tok,
        prompt=prompt, toy_dir=toy_dir, gguf=gpath, qbin=qbin,
        batch_tok_s=None, work=work))
    shutil.rmtree(work)


def bench(what) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    log(f"[bench] card: {card_line()}")
    flags = {"clocks": "clocks" in what}
    q80_flags = dict(flags, batched="batched" in what, sweep="sweep" in what)
    q4k_flags = dict(batched="batched" in what, sweep="sweep" in what,
                     clocks="clocks" in what, step="step" in what)
    for name, fn in (("flash", bench_flash), ("routes", bench_routes),
                     ("decode", bench_decode),
                     ("q4k", bench_q4k), ("q80", bench_q80),
                     ("pipes", bench_pipes), ("spec", bench_spec),
                     ("toy", bench_toy), ("export", bench_export),
                     ("rows", bench_rows), ("lora", bench_lora),
                     ("lifecycle", bench_lifecycle),
                     ("parallel", bench_parallel), ("nccl", bench_nccl),
                     ("gloo", bench_gloo), ("profile", bench_profile),
                     ("frontends", bench_frontends)):
        if not what or name in what:
            fn(torch, **{"flash": flags, "routes": flags, "q80": q80_flags,
                         "q4k": q4k_flags,
                         "rows": dict(sweep="sweep" in what,
                                      clocks="clocks" in what)}.get(name, {}))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from dataclasses import replace
    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.infer import engine, speculative
    from nano_tpu_torch.models import gpt
    from nano_tpu_torch.ops import (_build, decode_attn, flash_attn, int8_mma,
                                    norm_quant, q4k, qmatmul, sampling)
    from nano_tpu_torch.train.data import DataLoader
    from nano_tpu_torch.train.trainer import Trainer
    from nano_tpu_torch.tokenizer.bpe import QWEN_STOP_TOKENS
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    import torch.nn.functional as F

    t_start = time.time()
    timer = Timer(torch)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
    log(f"[env] the frontends' optional packages: {optional_packages()}")

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
    occ = _build.lib("flash_attn").flash_attn_fwd_blocks_per_sm
    log("[build] flash_fwd_mma_kernel blocks per SM by (D, query heads a "
        "block): " + ", ".join(f"({d}, {h}) {occ(d, h)}" for d, h in (
            (48, 2), (48, 4), (64, 2), (128, 2))))

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
    log(f"[time] phase 3 starts at {time.time() - t_start:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = {}

    def entry(name, replaces, source, main_path=True):
        kernels[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, launches=0, max_abs_err=0.0,
                             ms=0.0, plain_ms=0.0, bound_ms=0.0,
                             bound_by="bytes", library_ms=0.0,
                             main_path=main_path)

    entry("q80_act_quant", "nano_tpu/ops/qmatmul.py:250",
          "nano_tpu_torch/csrc/q80_matmul.cu")
    entry("q80_matmul_w8a8", "nano_tpu/ops/qmatmul.py:268",
          "nano_tpu_torch/csrc/q80_matmul.cu")
    # the rows form (gs < 256: a GGUF file's products): one row, more rows,
    # and the warp-a-row kernel, held and timed here as their "before"
    entry("q80_matvec_rows", "nano_tpu/ops/qmatmul.py:129",
          "nano_tpu_torch/csrc/q80_matmul.cu")
    entry("q80_matmul_rows", "nano_tpu/ops/qmatmul.py:129",
          "nano_tpu_torch/csrc/q80_matmul.cu")
    entry("q80_matmul_rows_warp", "nano_tpu/ops/qmatmul.py:129",
          "nano_tpu_torch/csrc/q80_matmul.cu", main_path=False)
    entry("q80_matvec_fq", "nano_tpu/ops/qmatmul.py:250 + :268",
          "nano_tpu_torch/csrc/q80_matmul.cu")
    # q80_act_quant redesigned as the epilogue of the kernels that make its
    # input: the residual add + RMSNorm and SwiGLU beside K1
    entry("rms_norm_q80", "nano_tpu/ops/qmatmul.py:250 + "
          "nano_tpu/models/gpt.py:96", "nano_tpu_torch/csrc/norm_quant.cu")
    entry("swiglu_q80", "nano_tpu/ops/qmatmul.py:250 + "
          "nano_tpu/models/gpt.py:454", "nano_tpu_torch/csrc/norm_quant.cu")
    # q4k_act_quant redesigned the same way: the Q4K epilogue of the two
    # kernels beside K3
    entry("rms_norm_q4k", "nano_tpu/ops/q4k.py:459 + "
          "nano_tpu/models/gpt.py:96", "nano_tpu_torch/csrc/norm_quant.cu")
    entry("swiglu_q4k", "nano_tpu/ops/q4k.py:459 + "
          "nano_tpu/models/gpt.py:454", "nano_tpu_torch/csrc/norm_quant.cu")
    # and q4k_fake_quant as the epilogue of the final norm that makes its
    # input, where the head is the Q80 table requantized from the Q4K one
    entry("rms_norm_q4k_fq", "nano_tpu/ops/q4k.py:644 + "
          "nano_tpu/models/gpt.py:96", "nano_tpu_torch/csrc/norm_quant.cu")
    entry("decode_attention", "nano_tpu/ops/decode_attn.py:45",
          "nano_tpu_torch/csrc/decode_attn.cu")
    # off the decode, batched and speculative paths since the final norm
    # writes the head's fake-quantized row (rms_norm_q4k_fq); the wide-row
    # route and the full-sequence forward's head (phase 9c's PPL) keep it
    entry("q4k_fake_quant", "nano_tpu/ops/q4k.py:644",
          "nano_tpu_torch/csrc/q4k.cu", main_path=False)
    # K3's f32 kernel: held against its plain version here and timed as
    # the "before" of q4k_matmul_w4a4, on no main path
    entry("q4k_matmul", "nano_tpu/ops/q4k.py:717",
          "nano_tpu_torch/csrc/q4k.cu", main_path=False)
    entry("q4k_matvec_fq", "nano_tpu/ops/q4k.py:717",
          "nano_tpu_torch/csrc/q4k.cu")
    entry("q4k_act_quant", "nano_tpu/ops/q4k.py:459",
          "nano_tpu_torch/csrc/q4k.cu")
    entry("q4k_matmul_w4a4", "nano_tpu/ops/q4k.py:717",
          "nano_tpu_torch/csrc/q4k.cu")
    # the forward: in bf16 at D <= 64 (every training path here) the wgmma
    # kernel of flash_fwd_wgmma.cu (ops/flash_attn.py:fwd_route); the
    # mma.sync kernel in flash_attn.cu at D = 128, f32 on the CUDA cores
    entry("flash_attn_fwd", "nano_tpu/models/gpt.py:239",
          "nano_tpu_torch/csrc/flash_fwd_wgmma.cu")
    # the backward: in bf16 at D <= 64 (every training path here) the two
    # wgmma passes of flash_bwd_wgmma.cu (ops/flash_attn.py:bwd_route);
    # the mma.sync passes in flash_attn.cu at D = 128, f32 on the CUDA cores
    entry("flash_attn_bwd", "nano_tpu/models/gpt.py:239",
          "nano_tpu_torch/csrc/flash_bwd_wgmma.cu")
    # K4's offset form: the same two kernels, a rank of sequence
    # parallelism's queries at their offset against the gathered K/V
    # (phase 10d's main path; the JAX package gets it from GSPMD's
    # partition of the attention that K4 replaces)
    entry("flash_attn_fwd_offset", "nano_tpu/models/gpt.py:239",
          "nano_tpu_torch/csrc/flash_fwd_wgmma.cu")
    entry("flash_attn_bwd_offset", "nano_tpu/models/gpt.py:239",
          "nano_tpu_torch/csrc/flash_bwd_wgmma.cu")

    def note_err(name, err):
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)

    def set_bound(name, n_bytes, n_ops, ops_per_s):
        kernels[name]["bound_ms"], kernels[name]["bound_by"] = bound(
            n_bytes, n_ops, ops_per_s)

    def layer_weights(w):
        lead = w.q if isinstance(w, qmatmul.Q80Tensor) else w.packed
        return ([w.layer(i) for i in range(lead.shape[0])] if lead.dim() == 3
                else [w])

    # K1 at B > 1 (the int8 tensor-core kernel) at one slot, 8 and 64 slots
    # (a batched step; 64: also a 64-token prefill) and 65 (two slot tiles),
    # f32 out; two runs the same bits; every row torch.equal to the same row
    # through q80_matvec_fq (the two kernels add a row's group terms in one
    # order, csrc/q80_matmul.cu:RangeSum: a batched step gives the single
    # stream's bits)
    n_rows_equal = 0
    k1_rows = sorted({1, 8, 64, 65, *SPEC_ROWS})
    for B in k1_rows:
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
            again = qmatmul.q80_w8a8(kq, ks, w0, torch.float32)
            ref = qmatmul.q80_w8a8_plain(pq, ps, w0, torch.float32)
            err = (y - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()
            log(f"[kernel] q80_matmul_w8a8 {name} {K}->{N} B={B} plan (MB, "
                f"BN, CS, S) {qmatmul.w8a8_plan(B, N, K, GS, sms)}: int8 equal, "
                f"max_abs_err {err:.3e} (tol {tol:.3e} = 1e-5 of max|y|), two "
                f"runs bit-equal {torch.equal(y, again)}")
            if not err <= tol:
                raise AssertionError(f"q80_matmul_w8a8 {name} B={B} off by {err}")
            if not torch.equal(y, again):
                raise AssertionError(f"q80_matmul_w8a8 {name} B={B}: two runs "
                                     f"differ")
            for i in range(B if B > 1 else 0):
                if not torch.equal(y[i], qmatmul.q80_matvec_fq(
                        x[i:i + 1], w0, torch.float32)[0]):
                    raise AssertionError(f"q80_matmul_w8a8 {name} B={B}: row "
                                         f"{i} differs from q80_matvec_fq's")
                n_rows_equal += 1
            note_err("q80_matmul_w8a8", err)

    log(f"[kernel] q80_matmul_w8a8 at B = {k1_rows[1:]}: all {n_rows_equal} "
        f"rows torch.equal to q80_matvec_fq's of the same row (one order of "
        f"summation at every batch size; cluster = w8a8_ranges(G))")

    # K1 at B = 1 with the activation quantization folded in: the five
    # products and two small shapes (one group, gs 512), f32 and bf16 rows
    # (group 1 all zero where there is one) into f32 and bf16.  The int8
    # row and scales it writes must equal act_quant_q80_plain's; y within
    # 1e-5 of max|y| of the plain version in f32 (the same integer
    # decisions, f32 sums in another order); two runs the same bits; a
    # bf16 y is the f32 y rounded.
    rng = np.random.default_rng(SEED)
    mv_cases = [(name, layer_weights(w)[0]) for name, w in shapes]
    for K, N, gs in ((256, 264, 256), (1024, 384, 512)):
        mv_cases.append((f"{K}->{N} gs={gs}", qmatmul.Q80Tensor(
            q=torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8)).to(dev),
            scales=torch.from_numpy(rng.random((N, K // gs), dtype=np.float32)
                                    * 0.02 + 1e-3).to(dev),
            group_size=gs, w8a8=True)))
    n_mv = 0
    for name, w0 in mv_cases:
        gs = w0.group_size
        x = torch.randn(1, w0.in_dim, device=dev, generator=gen)
        x[0, gs:2 * gs] = 0.0
        for xt in (x, x.to(torch.bfloat16)):
            pq, ps = qmatmul.act_quant_q80_plain(xt, gs)
            ref = qmatmul.q80_matvec_fq_plain(xt, w0, torch.float32)
            y32 = None
            for dt in (torch.float32, torch.bfloat16):
                y, kq, ks = qmatmul.q80_matvec_fq(xt, w0, dt, with_act=True)
                again = qmatmul.q80_matvec_fq(xt, w0, dt)
                if not (torch.equal(kq, pq) and torch.equal(ks, ps)):
                    raise AssertionError(f"q80_matvec_fq int8 decisions differ "
                                         f"at {name} {xt.dtype}")
                if not torch.equal(y, again):
                    raise AssertionError(f"q80_matvec_fq: two runs differ at "
                                         f"{name} {xt.dtype} -> {dt}")
                if dt == torch.float32:
                    y32 = y
                    err = (y - ref).abs().max().item()
                    if not err <= 1e-5 * ref.abs().max().item():
                        raise AssertionError(f"q80_matvec_fq {name} off by {err}")
                    note_err("q80_matvec_fq", err)
                elif not torch.equal(y, y32.to(dt)):
                    raise AssertionError(f"q80_matvec_fq {name}: bf16 y is not "
                                         f"the f32 y rounded")
                n_mv += 1
    log(f"[kernel] q80_matvec_fq: int8 row and scales torch.equal to "
        f"act_quant_q80_plain, two runs bit-equal, in {n_mv} cases (the five "
        f"Qwen3-0.6B products, 256->264 gs 256 and 1024->384 gs 512, f32/bf16 "
        f"row x f32/bf16 out); worst max_abs_err vs the plain version "
        f"{kernels['q80_matvec_fq']['max_abs_err']:.3e} (tol 1e-5 of max|y|); "
        f"plans (blocks, R, S, T): " + ", ".join(
            f"{name} {qmatmul.matvec_plan(w0.out_dim, w0.in_dim, w0.group_size, sms)}"
            for name, w0 in mv_cases[:5]))

    # the residual add + RMSNorm and SwiGLU kernels with the Q80
    # quantization as their epilogue (csrc/norm_quant.cu), against the eager
    # ops on the card at the Qwen3-0.6B widths (E = 1024, 2F = 6144), B = 1,
    # 8, 64 and 65, bf16 and f32, with and without the residual, group sizes
    # 0 (no quantization), 256 and 512: h and the SwiGLU output torch.equal
    # to the eager ops; hn torch.equal to the eager ops with the sum of
    # squares taken in the kernel's order (rms_norm_kernel_order), and
    # against eager rms_norm within one bf16 ulp, or 2 k + 2 f32 ulps where
    # the two f32 factors rsqrt(mean + eps) are k apart (an f32 value's ulp
    # may be half the factor's, relatively, and each of the two products'
    # roundings adds one); xq and sa
    # torch.equal to q80_act_quant of the kernel's own output, with and
    # without that output written; two runs bit-equal; an all-zero row
    # scale 0 and values 0; a row the same bits at B = 1 and inside B = 64
    E_, F2 = cfg.n_embd, 2 * cfg.n_hidden
    eps = cfg.norm_eps
    nw = torch.from_numpy(1 + 0.1 * rng.standard_normal(E_).astype(np.float32)
                          ).to(dev)
    worst_ulp = {torch.bfloat16: 0, torch.float32: 0}
    eager_ulp = {torch.bfloat16: 0, torch.float32: 0}
    factor_ulp = 0
    n_nq = 0

    def same_act(p, q):
        return torch.equal(p.xq, q.xq) and torch.equal(p.sa, q.sa)

    norm_rows = sorted({1, 8, 64, 65, *SPEC_ROWS})
    for B in norm_rows:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(B, E_, device=dev, generator=gen) * 2).to(dt)
            a = torch.randn(B, E_, device=dev, generator=gen).to(dt)
            h13 = (torch.randn(B, F2, device=dev, generator=gen) * 2).to(dt)
            if B > 2:
                x[2], a[2], h13[2] = 0, 0, 0
            for res in (None, a):
                want_h = x if res is None else x + res
                want_hn = norm_quant.rms_norm(want_h, nw, eps)
                ordered, r_k = rms_norm_kernel_order(torch, norm_quant, want_h,
                                                     nw, eps)
                hf = want_h.float()
                r_e = torch.rsqrt(torch.mean(hf * hf, dim=-1, keepdim=True)
                                  + eps)
                k_rows = ulps(r_k, r_e)
                factor_ulp = max(factor_ulp, int(k_rows.max()))
                limit = (torch.ones_like(k_rows) if dt == torch.bfloat16
                         else torch.where(k_rows > 0, 2 * k_rows + 2, 0))
                if B > 1:   # eager's own rows alone against inside B rows
                    eager_ulp[dt] = max(eager_ulp[dt], int(ulps(
                        norm_quant.rms_norm(want_h[-1:], nw, eps),
                        want_hn[-1:]).max()))
                for gs in (0, 256, 512):
                    h, hn, act = norm_quant.rms_norm_q80(x, nw, eps, res, gs)
                    h2, hn2, act2 = norm_quant.rms_norm_q80(x, nw, eps, res, gs)
                    _, none, act3 = norm_quant.rms_norm_q80(x, nw, eps, res, gs,
                                                            want_hn=False)
                    u_rows = ulps(hn, want_hn).amax(dim=-1, keepdim=True)
                    u = int(u_rows.max())
                    worst_ulp[dt] = max(worst_ulp[dt], u)
                    note_err("rms_norm_q80",
                             (hn.float() - want_hn.float()).abs().max().item())
                    ok = (torch.equal(hn, ordered)
                          and bool((u_rows <= limit).all())
                          and torch.equal(hn2, hn) and none is None
                          and (h is None if res is None else
                               torch.equal(h, want_h) and torch.equal(h2, h)))
                    if gs:
                        kq, ks = qmatmul.act_quant_q80(hn, gs)
                        ok = ok and (torch.equal(act.xq, kq)
                                     and torch.equal(act.sa, ks)
                                     and same_act(act2, act)
                                     and same_act(act3, act))
                        if B > 2:
                            ok = ok and not act.sa[2].any() and not act.xq[2].any()
                    if not ok:
                        raise AssertionError(f"rms_norm_q80 B={B} {dt} gs={gs} "
                                             f"residual {res is not None}: "
                                             f"differs from the eager ops "
                                             f"({u} ulp)")
                    n_nq += 1
            want_y = F.silu(h13[:, :F2 // 2]) * h13[:, F2 // 2:]
            for gs in (0, 256, 512):
                y, act = norm_quant.swiglu_q80(h13, gs)
                y2, act2 = norm_quant.swiglu_q80(h13, gs)
                none, act3 = norm_quant.swiglu_q80(h13, gs, want_hidden=False)
                ok = torch.equal(y, want_y) and torch.equal(y2, y) and none is None
                if gs:
                    kq, ks = qmatmul.act_quant_q80(y, gs)
                    ok = ok and (torch.equal(act.xq, kq)
                                 and torch.equal(act.sa, ks)
                                 and same_act(act2, act) and same_act(act3, act))
                    if B > 2:
                        ok = ok and not act.sa[2].any() and not act.xq[2].any()
                if not ok:
                    raise AssertionError(f"swiglu_q80 B={B} {dt} gs={gs}: "
                                         f"differs from the eager ops")
                note_err("swiglu_q80",
                         (y.float() - want_y.float()).abs().max().item())
                n_nq += 1
            if B == 64:
                h, hn, act = norm_quant.rms_norm_q80(x, nw, eps, a, GS)
                y, yact = norm_quant.swiglu_q80(h13, GS)
                for r in (0, 2, 37, 63):
                    h1, hn1, act1 = norm_quant.rms_norm_q80(
                        x[r:r + 1], nw, eps, a[r:r + 1], GS)
                    y1, yact1 = norm_quant.swiglu_q80(h13[r:r + 1], GS)
                    if not (torch.equal(h1[0], h[r]) and torch.equal(hn1[0], hn[r])
                            and torch.equal(act1.xq[0], act.xq[r])
                            and torch.equal(act1.sa[0], act.sa[r])
                            and torch.equal(y1[0], y[r])
                            and torch.equal(yact1.xq[0], yact.xq[r])
                            and torch.equal(yact1.sa[0], yact.sa[r])):
                        raise AssertionError(f"norm_quant {dt}: row {r} alone "
                                             f"differs from row {r} of 64")
    log(f"[kernel] rms_norm_q80 / swiglu_q80 at E={E_}, 2F={F2}, B = "
        f"{norm_rows}, bf16 and f32, gs 0/256/512, with and without the residual "
        f"({n_nq} cases): h and the SwiGLU output torch.equal to the eager "
        f"ops; hn torch.equal to the eager ops summed in the kernel's order, "
        f"and at most {worst_ulp[torch.bfloat16]} bf16 ulp and "
        f"{worst_ulp[torch.float32]} f32 ulp from eager rms_norm (limits 1 "
        f"and 2 k + 2, the f32 factors up to k = {factor_ulp} ulp apart; "
        f"eager rms_norm's own last row alone against inside B rows: "
        f"{eager_ulp[torch.bfloat16]} bf16 ulp, "
        f"{eager_ulp[torch.float32]} f32 ulp); xq and sa torch.equal to "
        f"q80_act_quant of the kernel's own output; two runs bit-equal; the "
        f"all-zero row scale 0 and values 0; rows 0, 2, 37, 63 the same bits "
        f"at B = 1 and inside B = 64")

    # the same kernels with the Q4K epilogue (rms_norm_q4k, swiglu_q4k):
    # h, hn and the SwiGLU output torch.equal to the Q80 instances'; vp,
    # sa, ba and c torch.equal to q4k_act_quant (and its plain version) of
    # the kernel's own rounded output, with and without that output
    # written; two runs bit-equal; the all-zero row all zero; rows 0, 2,
    # 37, 63 the same bits at B = 1 and inside B = 64
    def same4(p, q):
        return all(torch.equal(a, b) for a, b in zip(p.parts(), q.parts()))

    def act_quant_of(act, y):
        y2 = y.reshape(-1, y.shape[-1])
        k = q4k.act_quant_q4k_packed(y2)
        pl = q4k.act_quant_q4k_packed_plain(y2)
        return (all(torch.equal(a, b) for a, b in zip(act.parts(), k))
                and all(torch.equal(a, b) for a, b in zip(act.parts(), pl)))

    n_nq4 = 0
    for B in norm_rows:
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(B, E_, device=dev, generator=gen) * 2).to(dt)
            a = torch.randn(B, E_, device=dev, generator=gen).to(dt)
            h13 = (torch.randn(B, F2, device=dev, generator=gen) * 2).to(dt)
            if B > 2:
                x[2], a[2], h13[2] = 0, 0, 0
            for res in (None, a):
                h, hn, act = norm_quant.rms_norm_q4k(x, nw, eps, res)
                _, none, act2 = norm_quant.rms_norm_q4k(x, nw, eps, res,
                                                        want_hn=False)
                h8, hn8, _ = norm_quant.rms_norm_q80(x, nw, eps, res)
                ok = (torch.equal(hn, hn8) and none is None
                      and (h is None if res is None else torch.equal(h, h8))
                      and act_quant_of(act, hn) and same4(act2, act))
                if B > 2:
                    ok = ok and not act.vp[2].any() and not act.sa[2].any()
                if B == 64:
                    for r in (0, 2, 37, 63):
                        one = norm_quant.rms_norm_q4k(
                            x[r:r + 1], nw, eps,
                            None if res is None else res[r:r + 1])[2]
                        ok = ok and all(torch.equal(p_[0], q_[r]) for p_, q_
                                        in zip(one.parts(), act.parts()))
                if not ok:
                    raise AssertionError(f"rms_norm_q4k B={B} {dt} residual "
                                         f"{res is not None}: differs")
                n_nq4 += 1
            y, act = norm_quant.swiglu_q4k(h13)
            none, act2 = norm_quant.swiglu_q4k(h13, want_hidden=False)
            y8, _ = norm_quant.swiglu_q80(h13)
            ok = (torch.equal(y, y8) and none is None and act_quant_of(act, y)
                  and same4(act2, act))
            if B > 2:
                ok = ok and not act.vp[2].any() and not act.sa[2].any()
            if B == 64:
                for r in (0, 2, 37, 63):
                    one = norm_quant.swiglu_q4k(h13[r:r + 1])[1]
                    ok = ok and all(torch.equal(p_[0], q_[r]) for p_, q_
                                    in zip(one.parts(), act.parts()))
            if not ok:
                raise AssertionError(f"swiglu_q4k B={B} {dt}: differs")
            n_nq4 += 1
    for name in ("rms_norm_q4k", "swiglu_q4k"):
        note_err(name, 0.0)
    log(f"[kernel] rms_norm_q4k / swiglu_q4k at E={E_}, 2F={F2}, B = "
        f"{norm_rows}, bf16 and f32, with and without the residual "
        f"({n_nq4} cases): h, hn and the SwiGLU output torch.equal to "
        f"rms_norm_q80's / swiglu_q80's; vp, sa, ba and c torch.equal to "
        f"q4k_act_quant and its plain version of the kernel's own output, "
        f"with and without that output written; the all-zero row all zero; "
        f"rows 0, 2, 37, 63 the same bits at B = 1 and inside B = 64")

    # the Q4K model's final norm with the head's fake-quant as its epilogue
    # (rms_norm_q4k_fq), at the model's width and at two ragged ones: fq
    # torch.equal to q4k_fake_quant of rms_norm_q80's hn (the two launches
    # it replaces) and to the plain version, zeros past E; h and hn
    # torch.equal to rms_norm_q80's; fq the same without hn written; two
    # runs bit-equal
    n_fq = 0
    for E_fq in (E_, 320, 40):
        w_fq = (nw if E_fq == E_ else
                1 + 0.1 * torch.randn(E_fq, device=dev, generator=gen))
        for B in norm_rows:
            for dt in (torch.bfloat16, torch.float32):
                x = (torch.randn(B, E_fq, device=dev, generator=gen) * 2).to(dt)
                a = torch.randn(B, E_fq, device=dev, generator=gen).to(dt)
                for res in (None, a):
                    h, hn, fq = norm_quant.rms_norm_q4k_fq(x, w_fq, eps, res)
                    _, none, fq2 = norm_quant.rms_norm_q4k_fq(
                        x, w_fq, eps, res, want_hn=False)
                    h8, hn8, _ = norm_quant.rms_norm_q80(x, w_fq, eps, res)
                    ok = (torch.equal(fq, q4k.fake_quant_act(hn8))
                          and torch.equal(fq, q4k.fake_quant_act_plain(hn8))
                          and not fq[:, E_fq:].any() and torch.equal(fq2, fq)
                          and torch.equal(hn, hn8) and none is None
                          and (h is None if res is None
                               else torch.equal(h, h8)))
                    if not ok:
                        raise AssertionError(
                            f"rms_norm_q4k_fq E={E_fq} B={B} {dt} residual "
                            f"{res is not None}: differs from rms_norm_q80 + "
                            f"q4k_fake_quant")
                    n_fq += 1
    note_err("rms_norm_q4k_fq", 0.0)
    log(f"[kernel] rms_norm_q4k_fq at E = {E_}, 320, 40, B = {norm_rows}, "
        f"bf16 and f32, with and without the residual ({n_fq} cases): fq "
        f"torch.equal to q4k_fake_quant of rms_norm_q80's hn and to the "
        f"plain version, zeros past E, the same without hn written; h, hn "
        f"torch.equal to rms_norm_q80's")

    # its time: a decode step's one launch (B = 1) and a batched step's (8,
    # 64), 32 launches on distinct rows replayed from a graph and divided,
    # beside the two launches it replaces (rms_norm_q80, then
    # q4k_fake_quant), rms_norm_q80 alone (the final norm without the
    # fake-quant), the plain version and the bound (x and the weight read,
    # fq written)
    fq_rows = {}
    n_pad_fq = -(-E_ // 256) * 256
    for B in (1, 8, 64):
        xs = [torch.randn(B, E_, device=dev, generator=gen).to(torch.bfloat16)
              for _ in range(32)]
        t_fq = timer(lambda: [norm_quant.rms_norm_q4k_fq(
            x, nw, eps, None, False) for x in xs]) / 32
        t_pair = timer(lambda: [q4k.fake_quant_act(norm_quant.rms_norm_q80(
            x, nw, eps)[1]) for x in xs]) / 32
        t_norm = timer(lambda: [norm_quant.rms_norm_q80(x, nw, eps)
                                for x in xs]) / 32
        t_plain = timer(lambda: [norm_quant.rms_norm_q4k_fq_plain(
            x, nw, eps, None, False) for x in xs]) / 32
        b_fq = bound(2 * B * E_ + 4 * E_ + 4 * B * n_pad_fq,
                     (NORM_OPS_PER_VALUE + FQ_OPS_PER_VALUE) * B * E_,
                     F32_OPS_PER_S)
        fq_rows[B] = (t_fq, t_plain, b_fq)
        log(f"[time] the Q4K model's final norm at B={B} (E={E_}, bf16, a "
            f"launch): rms_norm_q4k_fq {t_fq:.5f} ms against the two it "
            f"replaces (rms_norm_q80, then q4k_fake_quant) {t_pair:.5f} ms and "
            f"rms_norm_q80 alone {t_norm:.5f} ms; plain {t_plain:.5f} ms; "
            f"bound {b_fq[0]:.6f} ms ({b_fq[1]}); {card}")
        del xs
    t_fq, t_plain, b_fq = fq_rows[1]
    kernels["rms_norm_q4k_fq"].update(ms=t_fq, plain_ms=t_plain,
                                      library_ms=None, bound_ms=b_fq[0],
                                      bound_by=b_fq[1])

    # one step's launches of the two kernels (28 layers: 57 norms, 28
    # SwiGLUs), replayed from a graph, at B = 1 (hn only: q80_matvec_fq
    # quantizes a single row itself), 8 and 64 (with the Q80 outputs at GS,
    # as a batched step or a 64-token prefill asks for them), beside the
    # eager chain they replace (the norm's ops, the residual add, F.silu *
    # h3, and q80_act_quant where the product takes int8), their plain
    # versions, F.rms_norm as the one library call for the norm, and the
    # bound (bytes: each input read once, each output written once)
    attn_w = [blocks["attn_norm"][i] for i in range(L)]
    ffn_w = [blocks["ffn_norm"][i] for i in range(L)]
    fin_w = params["norm"]
    nq_rows = {}
    for B in (1, 8, 64):
        gs = GS if B > 1 else 0
        xs = [torch.randn(B, E_, device=dev, generator=gen).to(torch.bfloat16)
              for _ in range(L + 1)]
        ats = [torch.randn(B, E_, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(L)]
        hs = [torch.randn(B, F2, device=dev, generator=gen).to(torch.bfloat16)
              for _ in range(L)]

        def run_norms(rms=norm_quant.rms_norm_q80):
            for i in range(L):
                rms(xs[i], attn_w[i], eps, None, gs, not gs)
                rms(xs[i], ffn_w[i], eps, ats[i], gs, not gs)
            rms(xs[L], fin_w, eps, None, gs, not gs)

        def run_swiglus(sw=norm_quant.swiglu_q80):
            for i in range(L):
                sw(hs[i], gs, not gs)

        def run_eager():
            quant = ((lambda t: qmatmul.act_quant_q80(t, gs)) if gs
                     else (lambda t: t))
            for i in range(L):
                quant(norm_quant.rms_norm(xs[i], attn_w[i], eps))
                quant(norm_quant.rms_norm(xs[i] + ats[i], ffn_w[i], eps))
                quant(F.silu(hs[i][:, :F2 // 2]) * hs[i][:, F2 // 2:])
            quant(norm_quant.rms_norm(xs[L], fin_w, eps))

        def run_library():
            for i in range(L):
                F.rms_norm(xs[i], (E_,), attn_w[i], eps)
                F.rms_norm(xs[i] + ats[i], (E_,), ffn_w[i], eps)
            F.rms_norm(xs[L], (E_,), fin_w, eps)

        out_b = (lambda n: B * n + B * (n // gs) * 4) if gs else (
            lambda n: 2 * B * n)
        norm_bytes = ((2 * L + 1) * (2 * B * E_ + 4 * E_ + out_b(E_))
                      + L * (2 * B * E_ + 2 * B * E_))    # the residual, h
        sw_bytes = L * (2 * B * F2 + out_b(F2 // 2))
        t_norm, t_sw = timer(run_norms), timer(run_swiglus)
        t_fused = timer(lambda: (run_norms(), run_swiglus()))
        t_eager = timer(run_eager)
        t_norm_plain = timer(lambda: run_norms(norm_quant.rms_norm_q80_plain))
        t_sw_plain = timer(lambda: run_swiglus(norm_quant.swiglu_q80_plain))
        t_lib = timer(run_library) if hasattr(F, "rms_norm") else None
        b_norm = bound(norm_bytes, NORM_OPS_PER_VALUE * (2 * L + 1) * B * E_,
                       F32_OPS_PER_S)
        b_sw = bound(sw_bytes, SWIGLU_OPS_PER_VALUE * L * B * F2 // 2,
                     F32_OPS_PER_S)
        nq_rows[B] = (t_norm, t_sw, t_norm_plain, t_sw_plain, t_lib, b_norm,
                      b_sw)
        log(f"[time] a step's {2 * L + 1} rms_norm_q80 + {L} swiglu_q80 "
            f"launches at B={B} ({'Q80 outputs at gs ' + str(gs) if gs else 'hn only'}"
            f"): {t_fused:.4f} ms ({t_norm:.4f} + {t_sw:.4f}) against the "
            f"eager chain they replace {t_eager:.4f} ms (norm ops, residual "
            f"add, F.silu * h3" + (", q80_act_quant" if gs else "") +
            f"); plain {t_norm_plain:.4f} + {t_sw_plain:.4f} ms; "
            f"F.rms_norm x {2 * L + 1} "
            + ("not in this PyTorch" if t_lib is None else f"{t_lib:.4f} ms")
            + f"; bound {b_norm[0]:.4f} + {b_sw[0]:.4f} ms (bytes, "
            f"{norm_bytes / 1e6:.2f} + {sw_bytes / 1e6:.2f} MB); {card}")
        del xs, ats, hs
    # the JSON rows: the 64-row step (a 64-slot batched step or a 64-token
    # prefill, both with the Q80 outputs)
    t_norm, t_sw, t_norm_plain, t_sw_plain, t_lib, b_norm, b_sw = nq_rows[64]
    for name, ms_, plain_, lib_, b_ in (
            ("rms_norm_q80", t_norm, t_norm_plain, t_lib, b_norm),
            ("swiglu_q80", t_sw, t_sw_plain, None, b_sw)):
        kernels[name].update(ms=ms_, plain_ms=plain_, library_ms=lib_,
                             bound_ms=b_[0], bound_by=b_[1])

    # the Q4K model's step: 56 rms_norm_q4k + 28 swiglu_q4k launches (the
    # final norm feeds the Q80 head and writes hn alone), at B = 1, 8 and
    # 64, beside the path before the fold (the norms writing hn and the
    # SwiGLU output, then q4k_act_quant on each: 84 launches more), the
    # eager ops with q4k_act_quant, the plain versions, F.rms_norm x 56 and
    # the bound (each input read once, each output written once)
    nq4_rows = {}
    for B in (1, 8, 64):
        xs = [torch.randn(B, E_, device=dev, generator=gen).to(torch.bfloat16)
              for _ in range(L)]
        ats = [torch.randn(B, E_, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(L)]
        hs = [torch.randn(B, F2, device=dev, generator=gen).to(torch.bfloat16)
              for _ in range(L)]

        def run_norms4(rms=norm_quant.rms_norm_q4k):
            for i in range(L):
                rms(xs[i], attn_w[i], eps, None, False)
                rms(xs[i], ffn_w[i], eps, ats[i], False)

        def run_swiglus4(sw=norm_quant.swiglu_q4k):
            for i in range(L):
                sw(hs[i], False)

        def run_before4():
            aq = lambda t: q4k.act_quant_q4k_packed(t.reshape(-1, t.shape[-1]))
            for i in range(L):
                aq(norm_quant.rms_norm_q80(xs[i], attn_w[i], eps)[1])
                aq(norm_quant.rms_norm_q80(xs[i], ffn_w[i], eps, ats[i])[1])
                aq(norm_quant.swiglu_q80(hs[i])[0])

        def run_eager4():
            aq = lambda t: q4k.act_quant_q4k_packed(t.reshape(-1, t.shape[-1]))
            for i in range(L):
                aq(norm_quant.rms_norm(xs[i], attn_w[i], eps))
                aq(norm_quant.rms_norm(xs[i] + ats[i], ffn_w[i], eps))
                aq(F.silu(hs[i][:, :F2 // 2]) * hs[i][:, F2 // 2:])

        def run_library4():
            for i in range(L):
                F.rms_norm(xs[i], (E_,), attn_w[i], eps)
                F.rms_norm(xs[i] + ats[i], (E_,), ffn_w[i], eps)

        out4 = lambda n: B * (n // 2 + 12 * (n // 32))    # vp, sa, ba, c
        norm4_bytes = 2 * L * (2 * B * E_ + 4 * E_ + out4(E_)) + L * (
            2 * B * E_ + 2 * B * E_)                      # the residual, h
        sw4_bytes = L * (2 * B * F2 + out4(F2 // 2))
        t_norm4, t_sw4 = timer(run_norms4), timer(run_swiglus4)
        t_fused4 = timer(lambda: (run_norms4(), run_swiglus4()))
        t_before4, t_eager4 = timer(run_before4), timer(run_eager4)
        t_norm4_plain = timer(lambda: run_norms4(norm_quant.rms_norm_q4k_plain))
        t_sw4_plain = timer(lambda: run_swiglus4(norm_quant.swiglu_q4k_plain))
        t_lib4 = timer(run_library4) if hasattr(F, "rms_norm") else None
        b_norm4 = bound(norm4_bytes, (NORM_OPS_PER_VALUE + AQ_OPS_PER_VALUE)
                        * 2 * L * B * E_, F32_OPS_PER_S)
        b_sw4 = bound(sw4_bytes, (SWIGLU_OPS_PER_VALUE + AQ_OPS_PER_VALUE)
                      * L * B * F2 // 2, F32_OPS_PER_S)
        nq4_rows[B] = (t_norm4, t_sw4, t_norm4_plain, t_sw4_plain, t_lib4,
                       b_norm4, b_sw4)
        log(f"[time] the Q4K step's {2 * L} rms_norm_q4k + {L} swiglu_q4k "
            f"launches at B={B} (the Q4K form): {t_fused4:.4f} ms ({t_norm4:.4f}"
            f" + {t_sw4:.4f}) against {t_before4:.4f} ms for the path before "
            f"them (rms_norm_q80 and swiglu_q80 writing hn, then "
            f"{3 * L} q4k_act_quant) and {t_eager4:.4f} ms for the eager ops "
            f"with q4k_act_quant; plain {t_norm4_plain:.4f} + "
            f"{t_sw4_plain:.4f} ms; F.rms_norm x {2 * L} "
            + ("not in this PyTorch" if t_lib4 is None else f"{t_lib4:.4f} ms")
            + f"; bound {b_norm4[0]:.4f} + {b_sw4[0]:.4f} ms ({b_norm4[1]}, "
            f"{norm4_bytes / 1e6:.2f} + {sw4_bytes / 1e6:.2f} MB); {card}")
        del xs, ats, hs
    # the JSON rows: the 64-row step, as for the Q80 epilogue
    t_norm4, t_sw4, t_norm4_plain, t_sw4_plain, t_lib4, b_norm4, b_sw4 = \
        nq4_rows[64]
    for name, ms_, plain_, lib_, b_ in (
            ("rms_norm_q4k", t_norm4, t_norm4_plain, t_lib4, b_norm4),
            ("swiglu_q4k", t_sw4, t_sw4_plain, None, b_sw4)):
        kernels[name].update(ms=ms_, plain_ms=plain_, library_ms=lib_,
                             bound_ms=b_[0], bound_by=b_[1])

    # The rows form (gs < 256) at the tiny fixtures' shapes, K = 80 at gs
    # 16 (scale rows off every 16-byte boundary), and at a Qwen3-0.6B GGUF
    # file's fused products and head at group sizes 32 (Q8_0, phase 7b's
    # path) and 16 (Q6_K), one row (q80_matvec_rows: a decode step) and 8
    # and 64 (q80_matmul_rows: batched steps, a prompt), bf16 rows in as the
    # model feeds them (f32 to the head's f32 out); the warp-a-row
    # q80_matmul_rows_warp the same way; two runs bit-equal
    rng = np.random.default_rng(SEED)

    def hold_rows(name, fn, x, w, label):
        y = fn(x, w, torch.float32)
        again = fn(x, w, torch.float32)
        ref = qmatmul.q80_matmul_rows_plain(x, w, torch.float32)
        err = (y - ref).abs().max().item() / ref.abs().max().item()
        log(f"[kernel] {name} {label}: max|d|/max|y| {err:.3e} (tol 1e-5), "
            f"two runs bit-equal {torch.equal(y, again)}")
        if not (err <= 1e-5 and torch.equal(y, again)):
            raise AssertionError(f"{name} {label} off by {err}")
        note_err(name, err * ref.abs().max().item())

    for K, N, gs, B in ((64, 128, 32, 1), (64, 256, 32, 16), (128, 64, 32, 1),
                        (64, 64, 64, 1), (80, 40, 16, 1), (80, 40, 16, 9)):
        w = qmatmul.Q80Tensor(
            q=torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8)).to(dev),
            scales=torch.from_numpy(rng.random((N, K // gs), dtype=np.float32)
                                    * 0.02 + np.float32(1e-3)).to(dev),
            group_size=gs)
        x = torch.randn(B, K, device=dev, generator=gen)
        label = f"{K}->{N} gs={gs} B={B}"
        hold_rows("q80_matmul_rows", qmatmul.q80_matmul_rows, x, w, label)
        hold_rows("q80_matmul_rows_warp", qmatmul.q80_matmul_rows_warp, x, w,
                  label)
        if B == 1:
            hold_rows("q80_matvec_rows", qmatmul.q80_matvec_rows, x, w, label)
    for gs in (32, 16):
        gblocks, ghead = gguf_rows_params(torch, cfg, gs, SEED + gs)
        for name, w in [(n, gblocks[n].layer(1)) for n in gblocks] + [
                ("head", ghead)]:
            K, N = w.in_dim, w.out_dim
            for B in (1, 8, 64):
                x = torch.randn(B, K, device=dev, generator=gen).to(torch.bfloat16)
                label = f"{name} {K}->{N} gs={gs} B={B}"
                if B == 1:
                    hold_rows("q80_matvec_rows", qmatmul.q80_matvec_rows, x,
                              w, label)
                hold_rows("q80_matmul_rows", qmatmul.q80_matmul_rows, x, w,
                          label)
                if name != "head" or B == 1:
                    hold_rows("q80_matmul_rows_warp",
                              qmatmul.q80_matmul_rows_warp, x, w, label)
        del gblocks, ghead

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

    # what the kernel special-cases: every D and every instance of the heads
    # per KV head it is built for (rep 3 runs in the instance for 4, rep 7
    # in the one for 8), f32 and bf16 q, the three cache types; at batch 1 (positions split
    # over the grid) pos 0, T - 1, a pos inside a split and two that leave
    # whole splits empty; at batch 64 a pos per row.
    # Two calls in a row on one workspace must give the same bits: the
    # ticket counters are back at zero after each call.
    def decode_case(B, T, n_kv, rep, Dh, cdt, qdt):
        q = torch.randn(B, n_kv * rep, Dh, device=dev, generator=gen).to(qdt)
        if cdt == torch.int8:
            kc, vc = (torch.randint(-127, 128, (B, T, n_kv, Dh), dtype=torch.int8,
                                    device=dev, generator=gen) for _ in range(2))
            ksc, vsc = (torch.rand(B, T, n_kv, device=dev, generator=gen) * 0.02
                        for _ in range(2))
        else:
            kc, vc = (torch.randn(B, T, n_kv, Dh, device=dev, generator=gen).to(cdt)
                      for _ in range(2))
            ksc = vsc = None
        return q, kc, vc, ksc, vsc

    n_dec, worst_dec = 0, 0.0
    for Dh in (16, 32, 48, 64, 128):
        for rep in (1, 2, 3, 4, 7):
            for qdt in (torch.float32, torch.bfloat16):
                for cdt in (torch.bfloat16, torch.int8, torch.float32):
                    T = 512
                    chunk, n_split = decode_attn.choose_splits(2, T)
                    assert n_split >= 4
                    cases = [(decode_case(1, T, 2, rep, Dh, cdt, qdt),
                              torch.tensor([p], dtype=torch.int32, device=dev))
                             for p in (0, T - 1, chunk + chunk // 2,
                                       2 * chunk - 1, 2 * chunk)]
                    pos64 = torch.randint(0, 128, (64,), dtype=torch.int32,
                                          device=dev, generator=gen)
                    pos64[0], pos64[1] = 0, 127
                    cases.append((decode_case(64, 128, 2, rep, Dh, cdt, qdt), pos64))
                    for args, pos in cases:
                        out = decode_attn.decode_attention(*args, pos, 2, rep)
                        again = decode_attn.decode_attention(*args, pos, 2, rep)
                        ref = decode_attn.decode_attention_plain(*args, pos, 2, rep)
                        err = (out - ref).abs().max().item()
                        if not (torch.allclose(out, ref, rtol=2e-5, atol=2e-5)
                                and torch.equal(out, again)
                                and out.dtype == torch.float32):
                            raise AssertionError(
                                f"decode_attention D={Dh} rep={rep} q {qdt} cache "
                                f"{cdt} B={args[0].shape[0]} pos={pos[:4].tolist()}: "
                                f"off by {err}, or two calls differ")
                        worst_dec = max(worst_dec, err)
                        n_dec += 1
    note_err("decode_attention", worst_dec)
    log(f"[kernel] decode_attention: {n_dec} more cases (D 16/32/48/64/128 x "
        f"rep 1/2/3/4/7 x f32/bf16 q x bf16/int8/f32 cache; B=1 T=512 at pos 0, T-1, "
        f"inside a split, whole splits empty; B=64 T=128 a pos per row): "
        f"worst max_abs_err {worst_dec:.3e} (tol 2e-5 + 2e-5*|ref|), two "
        f"calls on one workspace bit-equal in all")

    # the split comes from (KV, T) alone: at the Qwen3-0.6B heads, every row
    # of a batch of 8 or 64 torch.equal to the same row alone (a batched
    # step gives the single stream's bits)
    n_same = 0
    for T in (128, 1024):
        for B in (8, 64):
            args = decode_case(B, T, KV, H // KV, D, torch.bfloat16,
                               torch.bfloat16)
            pos_b = torch.randint(0, T, (B,), dtype=torch.int32, device=dev,
                                  generator=gen)
            out = decode_attn.decode_attention(*args, pos_b, KV, H // KV)
            for i in range(B):
                one = decode_attn.decode_attention(
                    *(a[i:i + 1] if a is not None else None for a in args),
                    pos_b[i:i + 1], KV, H // KV)
                if not torch.equal(out[i], one[0]):
                    raise AssertionError(f"decode_attention T={T} B={B}: row "
                                         f"{i} differs from the row alone")
                n_same += 1
    log(f"[kernel] decode_attention at KV={KV}, rep={H // KV}, D={D}, T = 128 "
        f"and 1024, B = 8 and 64: all {n_same} rows torch.equal to the same "
        f"row alone (splits {[decode_attn.choose_splits(KV, T) for T in (128, 1024)]} "
        f"at every B)")

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

    # K3 at B = 1 (q4k_matvec_fq, redesigned: the weights by bulk copy on
    # matvec_plan, the fake-quantized row rebuilt from the integer form a
    # norm, SwiGLU or q4k_act_quant wrote), at the four products of a
    # layer, the tiny widths and a ragged one (in = 40, 0xE in every nibble
    # past it), from f32 and bf16 rows: the row it rebuilt torch.equal to
    # q4k_fake_quant's; y within 1e-5 of max|y| of the plain version (f32
    # sums in another order); bf16 y the f32 y rounded; two runs bit-equal
    n_fused = 0
    for name, w in q4_cases + [("ragged 40->200, pad nibbles 0xE",
                                q4k_padded_weight(torch, rng, 40, 200, dev))]:
        x = act_rows(1, w.in_dim)
        for xt in (x, x.to(torch.bfloat16)):
            act = q4k.Q4KAct(*q4k.act_quant_q4k_packed(xt), xt.shape)
            got, xf = q4k.q4k_matvec_fq(act, w, torch.float32, with_act=True)
            again = q4k.q4k_matvec_fq(act, w, torch.float32)
            got16 = q4k.q4k_matvec_fq(act, w, torch.bfloat16)
            ref = q4k.q4k_matvec_fq_plain(xt, w, torch.float32)
            err = (got - ref).abs().max().item()
            if not (torch.equal(xf, q4k.fake_quant_act(xt))
                    and err <= 1e-5 * ref.abs().max().item()
                    and torch.equal(got16, got.to(torch.bfloat16))
                    and torch.equal(again, got)):
                raise AssertionError(f"q4k_matvec_fq {name} {xt.dtype}: "
                                     f"rebuilt row, y (off by {err}) or a "
                                     f"second run differs")
            note_err("q4k_matvec_fq", err)
            n_fused += 1
        if not name.startswith("tiny"):
            log(f"[kernel] q4k_matvec_fq {name} {w.in_dim}->{w.out_dim}: plan "
                f"(blocks, R, S, T) {q4k.matvec_plan(w.out_dim, w.n_pad, sms)}")
    log(f"[kernel] q4k_matvec_fq: the rebuilt row torch.equal to "
        f"q4k_fake_quant's, two runs bit-equal, bf16 y the f32 y rounded, "
        f"in {n_fused} cases (the four Q4K matmuls of a layer, the tiny "
        f"widths and in = 40 with 0xE pad nibbles x f32/bf16 row); worst "
        f"max_abs_err vs the plain version "
        f"{kernels['q4k_matvec_fq']['max_abs_err']:.3e} (tol 1e-5 of max|y|)")

    # K3 at B > 1 in integer form.  q4k_act_quant: torch.equal to its plain
    # version (the same IEEE operations), rows with an all-zero group and
    # constant groups.  q4k_matmul_w4a4: within 1e-5 of max|y| of its plain
    # version on the same integer form (the same integers, f32 sums in
    # another order; 8-9e-7 between the two plain forms on the CPU) at the
    # four products of a layer, the tiny widths and a ragged one (in = 40,
    # 0xE in every nibble past it), into f32 and bf16 (the f32 y rounded);
    # two runs the same bits
    n_aq = 0
    k3_rows = sorted({2, 8, 64, 65, *SPEC_ROWS})
    for n in (1024, 2048, 3072, 40, 64, 128):
        for B in k3_rows:
            x = act_rows(B, n)
            for xt in (x, x.to(torch.bfloat16)):
                got = q4k.act_quant_q4k_packed(xt)
                want = q4k.act_quant_q4k_packed_plain(xt)
                note_err("q4k_act_quant", max(
                    (a.float() - b.float()).abs().max().item()
                    for a, b in zip(got, want)))
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"q4k_act_quant differs at n={n} "
                                         f"B={B} {xt.dtype}")
                n_aq += 1
    log(f"[kernel] q4k_act_quant: values, sa, ba and c torch.equal with the "
        f"plain version in {n_aq} cases (n = 1024, 2048, 3072, 40, 64, 128; "
        f"B = {k3_rows}; f32 and bf16 input; all-zero and constant groups)")
    w4_cases = q4_cases + [("ragged 40->200, pad nibbles 0xE", q4k_padded_weight(
        torch, rng, 40, 200, dev))]
    n_w4 = 0
    for B in k3_rows:
        for name, w in w4_cases:
            act = q4k.act_quant_q4k_packed(act_rows(B, w.in_dim))
            y = q4k.q4k_matmul_w4a4(*act, w, torch.float32)
            again = q4k.q4k_matmul_w4a4(*act, w, torch.float32)
            y16 = q4k.q4k_matmul_w4a4(*act, w, torch.bfloat16)
            ref = q4k.q4k_matmul_w4a4_plain(*act, w, torch.float32)
            err = (y - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()
            if B in (8, 64) and not name.startswith("tiny"):
                log(f"[kernel] q4k_matmul_w4a4 {name} {w.in_dim}->{w.out_dim} "
                    f"B={B} plan (MB, BN, CS, S) "
                    f"{q4k.w4a4_plan(B, w.out_dim, w.n_pad, sms)}: max_abs_err "
                    f"{err:.3e} (tol {tol:.3e} = 1e-5 of max|y|), two runs "
                    f"bit-equal {torch.equal(y, again)}")
            if not err <= tol:
                raise AssertionError(f"q4k_matmul_w4a4 {name} B={B} off by "
                                     f"{err}")
            if not (torch.equal(y, again) and torch.equal(y16, y.to(torch.bfloat16))):
                raise AssertionError(f"q4k_matmul_w4a4 {name} B={B}: two runs "
                                     f"differ, or bf16 y is not the f32 y "
                                     f"rounded")
            note_err("q4k_matmul_w4a4", err)
            n_w4 += 1
    log(f"[kernel] q4k_matmul_w4a4: within 1e-5 of max|y| of the plain "
        f"version, two runs bit-equal, in {n_w4} cases (the four Q4K products "
        f"of a layer, the tiny widths and in = 40 with 0xE pad nibbles; B = "
        f"{k3_rows}); worst max_abs_err "
        f"{kernels['q4k_matmul_w4a4']['max_abs_err']:.3e}")

    # K4, causal GQA flash attention: forward and backward against the
    # plain version differentiated by autograd, at the Nano-168M and
    # Qwen3-0.6B head shapes, every head width (D = 32 at Nano-56M's
    # training shape, batch 64 x 512), ragged lengths and rep = 1.  f32: the same
    # arithmetic in another order (1e-5 of max|ref| forward, 1e-4
    # backward); bf16: the kernel keeps the probabilities in f32 where the
    # plain version rounds them to bf16, and both round the results (2e-2).
    def flash_case(B, S, Hh, KVh, Dh, dt):
        mk = lambda *shape: torch.randn(*shape, device=dev, generator=gen).to(dt)
        return mk(B, S, Hh, Dh), mk(B, S, KVh, Dh), mk(B, S, KVh, Dh), mk(B, S, Hh * Dh)

    def fwd_bwd(fn, q, k, v, g):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        return out, torch.autograd.grad(out, leaves, g)

    for B, S, Hh, KVh, Dh in ((4, 512, 16, 8, 48), (2, 1024, 16, 8, 128),
                              (2, 200, 4, 2, 64), (2, 96, 4, 4, 48),
                              (2, 130, 8, 2, 48), (2, 65, 4, 1, 16),
                              (64, 512, 16, 8, 32)):
        for dt in (torch.bfloat16, torch.float32):
            case = flash_case(B, S, Hh, KVh, Dh, dt)
            out, grads = fwd_bwd(flash_attn.flash_attention, *case)
            _, grads2 = fwd_bwd(flash_attn.flash_attention, *case)
            ref, rgrads = fwd_bwd(flash_attn.flash_attention_plain, *case)
            torch.cuda.synchronize()
            tol_f, tol_b = ((1e-5, 1e-4) if dt == torch.float32
                            else (2e-2, 2e-2))
            err_f = (out.float() - ref.float()).abs().max().item()
            lim_f = tol_f * ref.float().abs().max().item()
            errs = [(a.float() - b.float()).abs().max().item()
                    for a, b in zip(grads, rgrads)]
            lims = [tol_b * b.float().abs().max().item() for b in rgrads]
            same = all(torch.equal(a, b) for a, b in zip(grads, grads2))
            log(f"[kernel] flash_attn {str(dt)[6:]} B={B} S={S} H={Hh} "
                f"KV={KVh} D={Dh}: fwd max_abs_err {err_f:.3e} (tol "
                f"{lim_f:.3e} = {tol_f:g} of max|ref|); bwd dq/dk/dv "
                + "/".join(f"{e:.3e}" for e in errs) + " (tol "
                + "/".join(f"{x:.3e}" for x in lims) + f" = {tol_b:g} of "
                f"max|ref|); two backward runs bit-equal: {same}")
            if not (err_f <= lim_f and all(e <= x for e, x in zip(errs, lims))
                    and same and out.shape == ref.shape):
                raise AssertionError(f"flash attention B={B} S={S} D={Dh} "
                                     f"{dt} disagrees with the plain version")
            note_err("flash_attn_fwd", err_f)
            note_err("flash_attn_bwd", max(errs))
            del case, out, grads, grads2, ref, rgrads

    # the forward alone, at what its design special-cases: rep 4 (four
    # heads a block at D <= 64, two at D = 128), rep 3 and 1, S below one
    # tile, one row, and S = 64 k +- 1.  out against the plain version (as
    # above) and lse, the backward's input, against the log-sum-exp of the
    # plain scaled scores: 1e-5 absolute in f32, 1e-3 in bf16 (bf16 inputs,
    # f32 sums on both sides).  Two runs must give the same bits.
    n_fwd, worst_lse = 0, 0.0
    for B, S, Hh, KVh, Dh in ((2, 1, 4, 2, 48), (2, 63, 8, 2, 48), (2, 64, 8, 2, 64),
                              (2, 65, 4, 1, 48), (1, 127, 8, 2, 128),
                              (1, 129, 8, 1, 128), (2, 256, 12, 4, 48),
                              (2, 33, 4, 1, 16), (1, 191, 6, 1, 64)):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, _ = flash_case(B, S, Hh, KVh, Dh, dt)
            out, lse = flash_attn.flash_attn_fwd(q, k, v)
            out2, lse2 = flash_attn.flash_attn_fwd(q, k, v)
            ref, ref_lse = flash_attn.flash_attn_fwd_plain(q, k, v)
            f32c = dt == torch.float32
            err_f = (out.float() - ref.float()).abs().max().item()
            lim_f = (1e-5 if f32c else 2e-2) * ref.float().abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            if not (err_f <= lim_f and err_l <= (1e-5 if f32c else 1e-3)
                    and lse.shape == (B, Hh, S) and torch.equal(out, out2)
                    and torch.equal(lse, lse2)):
                raise AssertionError(
                    f"flash_attn_fwd B={B} S={S} H={Hh} KV={KVh} D={Dh} {dt}: "
                    f"out off by {err_f:.3e} (tol {lim_f:.3e}), lse by "
                    f"{err_l:.3e}, or two runs differ")
            note_err("flash_attn_fwd", err_f)
            if not f32c:
                worst_lse = max(worst_lse, err_l)
            n_fwd += 1
    log(f"[kernel] flash_attn_fwd: {n_fwd} forward-only cases (rep 1/2/3/4, "
        f"S = 1, 33, 63, 64, 65, 127, 129, 191, 256; bf16 and f32): out "
        f"within tolerance, lse vs logsumexp of the plain scores within "
        f"1e-5 (f32) / 1e-3 (bf16; worst {worst_lse:.3e}), two runs bit-equal")

    # K4 timing: one training step's launches at the Nano-168M shape (24
    # layers, batch 64 x 512, bf16), each layer on its own tensors; device
    # time between CUDA events around each layer's forward and backward,
    # summed over the layers, the better of two passes after a warm-up.
    # The same way for the kernels, the plain version and SDPA.
    tcfg = ModelConfig.from_json(os.path.join(ROOT, "config", "model_168m.json"))
    TB, TS, TL = 64, tcfg.block_size, tcfg.n_layer
    TH, TKV, TD = tcfg.n_head, tcfg.n_kv_head, tcfg.head_dim
    step_layers = []
    for _ in range(TL):
        q, k, v, g = flash_case(TB, TS, TH, TKV, TD, torch.bfloat16)
        step_layers.append((q.requires_grad_(True), k.requires_grad_(True),
                            v.requires_grad_(True), g))

    # the training shape itself against the plain version, layer by layer
    # (the plain version's (B, H, S, S) scores fit at batch 64): the same
    # 2e-2 of max|ref| as the smaller bf16 cases above
    worst_f = worst_b = 0.0
    for q, k, v, g in step_layers:
        out, grads = fwd_bwd(flash_attn.flash_attention, q, k, v, g)
        ref, rgrads = fwd_bwd(flash_attn.flash_attention_plain, q, k, v, g)
        err_f = (out.float() - ref.float()).abs().max().item()
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(grads, rgrads)]
        ok = (out.shape == ref.shape
              and err_f <= 2e-2 * ref.float().abs().max().item()
              and all(e <= 2e-2 * b.float().abs().max().item()
                      for e, b in zip(errs, rgrads)))
        if not ok:
            raise AssertionError(
                f"flash attention at the training shape B={TB} S={TS} "
                f"D={TD} bf16 disagrees with the plain version: fwd "
                f"{err_f:.3e}, dq/dk/dv {errs}")
        worst_f, worst_b = max(worst_f, err_f), max(worst_b, *errs)
        del out, grads, ref, rgrads
    note_err("flash_attn_fwd", worst_f)
    note_err("flash_attn_bwd", worst_b)
    log(f"[kernel] flash_attn bf16 at the training shape B={TB} S={TS} "
        f"H={TH} KV={TKV} D={TD}, {TL} layers' tensors: fwd max_abs_err "
        f"{worst_f:.3e}, bwd {worst_b:.3e} (tol 2e-2 of max|ref| for out "
        f"and each of dq, dk, dv)")

    def step_times(fn, grad_out=lambda g: g, layers=None):
        best = None
        for _ in range(3):
            marks = []
            for q, k, v, g in (step_layers if layers is None else layers):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                out = fn(q, k, v)
                ev[1].record()
                grads = torch.autograd.grad(out, (q, k, v), grad_out(g))
                ev[2].record()
                marks.append(ev)
                del out, grads
            torch.cuda.synchronize()
            t = (sum(e[0].elapsed_time(e[1]) for e in marks),
                 sum(e[1].elapsed_time(e[2]) for e in marks))
            best = t if best is None else (min(best[0], t[0]),
                                           min(best[1], t[1]))
        return best

    def sdpa(q, k, v):      # (B, H, S, D) out, as the library gives it
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    k_ms = step_times(flash_attn.flash_attention)
    p_ms = step_times(flash_attn.flash_attention_plain)
    l_ms = step_times(sdpa, lambda g: g.reshape(TB, TS, TH, TD).transpose(1, 2))
    el = 2                                       # bytes of a bf16
    qo_bytes, kv_bytes = TB * TS * TH * TD * el, TB * TS * TKV * TD * el
    lse_bytes = TB * TH * TS * 4
    pair_flops = 2 * TB * TH * TD * TS * (TS + 1) // 2   # one causal product
    for name, i, n_bytes, n_prod in (
            ("flash_attn_fwd", 0, 2 * qo_bytes + 2 * kv_bytes + lse_bytes, 2),
            # reads q, k, v, out, dout, lse; writes dq, dk, dv; S, dP, dV,
            # dK, dQ are the five products it cannot do without
            ("flash_attn_bwd", 1, 4 * qo_bytes + 4 * kv_bytes + lse_bytes, 5)):
        kk = kernels[name]
        kk["ms"], kk["plain_ms"], kk["library_ms"] = k_ms[i], p_ms[i], l_ms[i]
        set_bound(name, TL * n_bytes, TL * n_prod * pair_flops, BF16_OPS_PER_S)
        log(f"[time] one training step of attention, {name} ({TL} layers, "
            f"B={TB} S={TS} H={TH} KV={TKV} D={TD}, bf16): kernel "
            f"{kk['ms']:.3f} ms, plain {kk['plain_ms']:.3f} ms, SDPA(is_causal, "
            f"enable_gqa) {kk['library_ms']:.3f} ms, bound {kk['bound_ms']:.4f} "
            f"ms ({kk['bound_by']}: {TL * n_bytes / 1e6:.1f} MB, "
            f"{TL * n_prod * pair_flops / 1e12:.3f} TFLOP)")
    # the step's 24 backward launches by route on the forward's out and
    # lse: the wgmma passes (the route's choice) and the mma.sync passes, in turns,
    # CUDA events around each layer's call summed, the best of three
    with torch.no_grad():
        step_fwd = [flash_attn.flash_attn_fwd(q, k, v)
                    for q, k, v, _ in step_layers]

    def bwd_by_route(rt):
        best = float("inf")
        for _ in range(3):
            marks = []
            for (q, k, v, g), (o, l) in zip(step_layers, step_fwd):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                flash_attn.flash_attn_bwd(q.detach(), k.detach(), v.detach(),
                                          o, l, g.reshape(o.shape), route=rt)
                ev[1].record()
                marks.append(ev)
            torch.cuda.synchronize()
            best = min(best, sum(a.elapsed_time(b) for a, b in marks))
        return best

    rt_step = flash_attn.bwd_route(TB, TS, TS, 0, TH, TKV, TD, torch.bfloat16)
    t_rt = [bwd_by_route(r_) for r_ in (flash_attn.BwdRoute("mma"), rt_step,
                                        rt_step, flash_attn.BwdRoute("mma"))]

    # the step's 24 forward launches by route, the same way
    def fwd_by_route(rt):
        best = float("inf")
        for _ in range(3):
            marks = []
            for q, k, v, _ in step_layers:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                flash_attn.flash_attn_fwd(q.detach(), k.detach(), v.detach(),
                                          route=rt)
                ev[1].record()
                marks.append(ev)
            torch.cuda.synchronize()
            best = min(best, sum(a.elapsed_time(b) for a, b in marks))
        return best

    rt_fstep = flash_attn.fwd_route(TB, TS, TS, 0, TH, TKV, TD, torch.bfloat16)
    t_frt = [fwd_by_route(r_) for r_ in (flash_attn.FwdRoute("mma"), rt_fstep,
                                         rt_fstep, flash_attn.FwdRoute("mma"))]
    log(f"[time] one training step's {TL} flash_attn_fwd launches (B={TB} "
        f"S={TS} H={TH} KV={TKV} D={TD}, bf16, no autograd), in turns: the "
        f"route's {tuple(rt_fstep)} {t_frt[1]:.4f} / {t_frt[2]:.4f} ms, the "
        f"mma.sync kernel {t_frt[0]:.4f} / {t_frt[3]:.4f} ms; SDPA "
        f"{kernels['flash_attn_fwd']['library_ms']:.4f} ms, bound "
        f"{kernels['flash_attn_fwd']['bound_ms']:.4f} ms; on {card}")
    log(f"[time] one training step's {TL} flash_attn_bwd launches (B={TB} "
        f"S={TS} H={TH} KV={TKV} D={TD}, bf16, no autograd), in turns: the "
        f"route's {tuple(rt_step)} {t_rt[1]:.3f} / {t_rt[2]:.3f} ms, the mma.sync "
        f"passes {t_rt[0]:.3f} / {t_rt[3]:.3f} ms; on {card}")
    del step_layers, step_fwd

    # K4's offset form (a rank of sequence parallelism, phase 10d: Sq
    # queries at an offset against Skv >= offset + Sq gathered keys), at
    # Nano-168M's head shape and at D = 128, bf16 and f32, offsets 0, S/2
    # and inside a tile, keys past the last query: out and lse against the
    # plain version, dq / dk / dv against it differentiated by autograd
    # (the tolerances above), dk and dv zero past the last query, two
    # backward runs bit-equal, and the offset call's out and lse rows
    # against the same rows of the call on the whole sequence within the
    # plain tolerance.
    n_off = 0
    for B, Sq, Skv, off, Hh, KVh, Dh in OFFSET_CASES:
        for dt in (torch.bfloat16, torch.float32):
            f32c = dt == torch.float32
            mk = lambda *shape: torch.randn(*shape, device=dev,
                                            generator=gen).to(dt)
            qf, k, v = mk(B, Skv, Hh, Dh), mk(B, Skv, KVh, Dh), mk(
                B, Skv, KVh, Dh)
            q, g = qf[:, off:off + Sq].contiguous(), mk(B, Sq, Hh * Dh)
            out, lse = flash_attn.flash_attn_fwd(q, k, v, off)
            ref, ref_lse = flash_attn.flash_attn_fwd_plain(q, k, v, off)
            full, full_lse = flash_attn.flash_attn_fwd(qf, k, v)
            kern = lambda a, b, c: flash_attn.flash_attention(a, b, c, off)
            plain = lambda a, b, c: flash_attn.flash_attention_plain(
                a, b, c, off)
            _, grads = fwd_bwd(kern, q, k, v, g)
            _, grads2 = fwd_bwd(kern, q, k, v, g)
            _, rgrads = fwd_bwd(plain, q, k, v, g)
            torch.cuda.synchronize()
            tol_f, tol_b = ((1e-5, 1e-4) if f32c else (2e-2, 2e-2))
            lim_f = tol_f * ref.float().abs().max().item()
            tol_l = 1e-5 if f32c else 1e-3
            err_f = (out.float() - ref.float()).abs().max().item()
            err_l = (lse - ref_lse).abs().max().item()
            err_rows = max(
                (full[:, off:off + Sq].float() - out.float()).abs().max()
                .item() / max(lim_f, 1e-30),
                (full_lse[..., off:off + Sq] - lse).abs().max().item()
                / tol_l)
            errs = [(a.float() - b.float()).abs().max().item()
                    for a, b in zip(grads, rgrads)]
            lims = [tol_b * b.float().abs().max().item() + 1e-5
                    for b in rgrads]
            same = all(torch.equal(a, b) for a, b in zip(grads, grads2))
            past = off + Sq == Skv or not (grads[1][:, off + Sq:].any()
                                           or grads[2][:, off + Sq:].any())
            log(f"[kernel] flash_attn offset form {str(dt)[6:]} B={B} "
                f"Sq={Sq} Skv={Skv} offset={off} H={Hh} KV={KVh} D={Dh}: "
                f"out {err_f:.3e} (tol {lim_f:.3e}), lse {err_l:.3e} (tol "
                f"{tol_l:g}); dq/dk/dv " + "/".join(f"{e:.3e}" for e in errs)
                + " (tol " + "/".join(f"{x:.3e}" for x in lims) + "); rows "
                f"of the whole call at {err_rows:.3f} of the tolerance; two "
                f"backward runs bit-equal: {same}; dk, dv zero past the "
                f"last query: {past}")
            if not (err_f <= lim_f and err_l <= tol_l and err_rows <= 1.0
                    and all(e <= x for e, x in zip(errs, lims)) and same
                    and past and out.shape == (B, Sq, Hh, Dh)):
                raise AssertionError(
                    f"flash attention's offset form B={B} Sq={Sq} Skv={Skv} "
                    f"offset={off} D={Dh} {dt} disagrees with the plain "
                    f"version or with the whole sequence's rows")
            note_err("flash_attn_fwd_offset", err_f)
            note_err("flash_attn_bwd_offset", max(errs))
            n_off += 1
            if not f32c and Dh in flash_attn.WGMMA_HEAD_DIMS:
                # each forward route alone: the wgmma kernel (one and, where
                # rep is even, two heads a block) and the mma.sync kernel,
                # each against the plain version (the tolerances above), two
                # runs bit-equal; the wgmma kernel against the mma.sync one
                # within the same 2e-2 of max|ref|
                fwd_by = {}
                for rt in [flash_attn.FwdRoute("wgmma", h_) for h_ in (1, 2)
                           if (Hh // KVh) % h_ == 0] + [
                               flash_attn.FwdRoute("mma")]:
                    o1, l1 = flash_attn.flash_attn_fwd(q, k, v, off, route=rt)
                    o2, l2 = flash_attn.flash_attn_fwd(q, k, v, off, route=rt)
                    torch.cuda.synchronize()
                    e_o = (o1.float() - ref.float()).abs().max().item()
                    e_l = (l1 - ref_lse).abs().max().item()
                    if not (e_o <= lim_f and e_l <= tol_l
                            and torch.equal(o1, o2) and torch.equal(l1, l2)):
                        raise AssertionError(
                            f"flash_attn_fwd route {tuple(rt)} B={B} Sq={Sq} "
                            f"Skv={Skv} offset={off} D={Dh}: out off the plain "
                            f"version by {e_o:.3e} (tol {lim_f:.3e}), lse by "
                            f"{e_l:.3e} (tol {tol_l:g}), or two runs differ")
                    if rt.kernel == "wgmma":
                        note_err("flash_attn_fwd_offset", e_o)
                    fwd_by[rt] = o1
                mma_o = fwd_by.pop(flash_attn.FwdRoute("mma"))
                d_fwd = max((o_.float() - mma_o.float()).abs().max().item()
                            for o_ in fwd_by.values()) / max(
                                ref.float().abs().max().item(), 1e-30)
                log(f"[kernel] flash_attn_fwd offset form B={B} Sq={Sq} "
                    f"Skv={Skv} offset={off} H={Hh} KV={KVh} D={Dh} bf16, "
                    f"routes {[tuple(r_) for r_ in fwd_by]} and the mma.sync "
                    f"kernel: each within tolerance of the plain version, two "
                    f"runs bit-equal; wgmma vs mma.sync {d_fwd:.3e} of max|ref| "
                    f"(tol 2e-2)")
                if d_fwd > 2e-2:
                    raise AssertionError("the wgmma forward disagrees with "
                                         "the mma.sync kernel")
                del fwd_by, mma_o
                # each route's passes alone on the forward's out and lse:
                # the wgmma passes (one and, where rep is even, two heads a
                # dq block) and the mma.sync passes, each against the plain gradients
                # (the tolerances above), two runs bit-equal, dk and dv zero
                # past the last query; the wgmma passes against the mma.sync
                # within the same 2e-2 of max|ref|
                go = g.reshape(B, Sq, Hh, Dh)
                routes = [flash_attn.BwdRoute("wgmma", h_)
                          for h_ in (1, 2) if (Hh // KVh) % h_ == 0]
                by_route = {}
                for rt in routes + [flash_attn.BwdRoute("mma")]:
                    a = flash_attn.flash_attn_bwd(q, k, v, out, lse, go, off,
                                                  route=rt)
                    a2 = flash_attn.flash_attn_bwd(q, k, v, out, lse, go, off,
                                                   route=rt)
                    torch.cuda.synchronize()
                    e_ = [(x.float() - y.float()).abs().max().item()
                          for x, y in zip(a, rgrads)]
                    zero_past = off + Sq == Skv or not (
                        a[1][:, off + Sq:].any() or a[2][:, off + Sq:].any())
                    if not (all(e <= x for e, x in zip(e_, lims))
                            and all(torch.equal(x, y) for x, y in zip(a, a2))
                            and zero_past):
                        raise AssertionError(
                            f"flash_attn_bwd route {tuple(rt)} B={B} Sq={Sq} "
                            f"Skv={Skv} offset={off} D={Dh}: dq/dk/dv off the "
                            f"plain version by {e_} (tol {lims}), or two runs "
                            f"differ, or dk, dv are not zero past the last "
                            f"query")
                    if rt.passes == "wgmma":
                        note_err("flash_attn_bwd_offset", max(e_))
                    by_route[rt] = a
                mma_ = by_route.pop(flash_attn.BwdRoute("mma"))
                d_old = max((x.float() - y.float()).abs().max().item()
                            / max(r_.float().abs().max().item(), 1e-30)
                            for a in by_route.values()
                            for x, y, r_ in zip(a, mma_, rgrads))
                log(f"[kernel] flash_attn_bwd offset form B={B} Sq={Sq} "
                    f"Skv={Skv} offset={off} H={Hh} KV={KVh} D={Dh} bf16, "
                    f"routes {[tuple(r_) for r_ in by_route]} and the mma.sync "
                    f"passes: each within tolerance of the plain version, "
                    f"two runs bit-equal, dk, dv zero past the last query; "
                    f"wgmma vs the mma.sync passes {d_old:.3e} of max|ref| (tol "
                    f"2e-2)")
                if d_old > 2e-2:
                    raise AssertionError("the wgmma passes disagree with "
                                         "the mma.sync passes")
                del by_route, mma_
            del qf, k, v, q, g, out, lse, ref, ref_lse, full, full_lse
            del grads, grads2, rgrads
    log(f"[kernel] flash_attn offset form: {n_off} cases within tolerance")

    # a rank's launches in one step of phase 10d: PAR_LAYERS layers of
    # Nano-168M at batch PAR_BATCH, rank 1's 256 queries at offset 256 (the
    # rank with the most work) against the 512 gathered keys, bf16: the
    # kernels, the plain versions of both and SDPA with the same boolean
    # mask (its backward: forward and backward less the forward), each the
    # device time of the 4 layers' calls replayed from a CUDA graph (at
    # these small shapes the host's dispatch would otherwise be timed)
    SQ, SOFF = TS // 2, TS // 2
    sp_layers = []
    for _ in range(PAR_LAYERS):
        q, k, v, g = flash_case(PAR_BATCH, TS, TH, TKV, TD, torch.bfloat16)
        q, g = q[:, SOFF:].contiguous(), g[:, SOFF:].reshape(
            PAR_BATCH, SQ, TH, TD).contiguous()
        out, lse = flash_attn.flash_attn_fwd(q, k, v, SOFF)
        sp_layers.append((q, k, v, g, out, lse))
    sp_mask = flash_attn.causal_mask(SQ, dev, SOFF, TS) == 0
    sdpa_leaves = [[t.transpose(1, 2).detach().requires_grad_(True)
                    for t in (q, k, v)] + [g.transpose(1, 2)]
                   for q, k, v, g, _, _ in sp_layers]

    def sdpa_offset(backward):
        for q, k, v, g in sdpa_leaves:
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=sp_mask,
                                               enable_gqa=True)
            if backward:
                torch.autograd.grad(o, (q, k, v), g)

    def layers_of(fn):
        return lambda: [fn(*x) for x in sp_layers]

    k_ms = (timer(layers_of(lambda q, k, v, g, o, l:
                            flash_attn.flash_attn_fwd(q, k, v, SOFF))),
            timer(layers_of(lambda q, k, v, g, o, l:
                            flash_attn.flash_attn_bwd(q, k, v, o, l, g,
                                                      SOFF))))
    p_ms = (timer(layers_of(lambda q, k, v, g, o, l:
                            flash_attn.flash_attn_fwd_plain(q, k, v, SOFF))),
            timer(layers_of(lambda q, k, v, g, o, l:
                            flash_attn.flash_attn_bwd_plain(q, k, v, o, l, g,
                                                            SOFF))))
    l_fwd = timer(lambda: sdpa_offset(False))
    l_ms = (l_fwd, timer(lambda: sdpa_offset(True)) - l_fwd)
    # the same launches through the mma.sync passes, and the wgmma passes
    # split: the dq pass, the dk/dv pass alone on the statistics of a dq
    # pass run before, the two (the one-off reading without PDL is in
    # PERF.md)
    mma_rt = flash_attn.BwdRoute("mma")
    mma_ms = timer(layers_of(lambda q, k, v, g, o, l: flash_attn.flash_attn_bwd(
        q, k, v, o, l, g, SOFF, route=mma_rt)))
    # the forward through the mma.sync kernel, in turns with the route's
    fwd10 = flash_attn.fwd_route(PAR_BATCH, SQ, TS, SOFF, TH, TKV, TD,
                                 torch.bfloat16)
    if fwd10.kernel != "wgmma":
        raise AssertionError(f"phase 10d's rank takes {fwd10}, not the wgmma "
                             f"forward")
    fwd_turns = [timer(layers_of(lambda q, k, v, g, o, l, r_=r_:
                                 flash_attn.flash_attn_fwd(q, k, v, SOFF,
                                                           route=r_)))
                 for r_ in (flash_attn.FwdRoute("mma"), fwd10, fwd10,
                            flash_attn.FwdRoute("mma"))]
    rt10 = flash_attn.bwd_route(PAR_BATCH, SQ, TS, SOFF, TH, TKV, TD,
                                torch.bfloat16)
    if rt10.passes != "wgmma":
        raise AssertionError(f"phase 10d's rank takes {rt10}, not the wgmma "
                             f"passes")
    splits = [BwdSplit(torch, q, k, v, o, l, g, SOFF, rt10.hpb)
              for q, k, v, g, o, l in sp_layers]
    for sp in splits:
        sp.run(1)
    split_ms = [timer(lambda: [sp.run(p_) for sp in splits])
                for p_ in (1, 2, 3)]
    del splits
    # what a call costs the host (the training step is eager): 100 calls
    # of each route back to back, the card left to catch up after the clock
    # stops; the wgmma route encodes four tensor maps a call
    host_us = {}
    for tag, rt in (("mma", mma_rt), ("wgmma", rt10), ("mma", mma_rt),
                    ("wgmma", rt10)):
        q, k, v, g, o, l = sp_layers[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            flash_attn.flash_attn_bwd(q, k, v, o, l, g, SOFF, route=rt)
        host_us[tag] = min(host_us.get(tag, 1e9),
                           (time.perf_counter() - t0) * 1e4)
        torch.cuda.synchronize()
    log(f"[time] one rank's step of attention under sequence parallelism, "
        f"flash_attn_fwd ({PAR_LAYERS} layers, B={PAR_BATCH} Sq={SQ} at "
        f"offset {SOFF}, Skv={TS}, D={TD}, graph replays), in turns: the "
        f"route {tuple(fwd10)} {fwd_turns[1]:.4f} / {fwd_turns[2]:.4f} ms, the "
        f"mma.sync kernel {fwd_turns[0]:.4f} / {fwd_turns[3]:.4f} ms; on "
        f"{card}")
    log(f"[time] one rank's step of attention under sequence parallelism, "
        f"flash_attn_bwd ({PAR_LAYERS} layers, B={PAR_BATCH} Sq={SQ} at "
        f"offset {SOFF}, Skv={TS}, D={TD}, graph replays): the route "
        f"{tuple(rt10)} {k_ms[1]:.4f} ms, the mma.sync passes {mma_ms:.4f} ms; by "
        f"pass: wgmma dq {split_ms[0]:.4f}, wgmma dk/dv alone "
        f"{split_ms[1]:.4f}, the two {split_ms[2]:.4f}; host "
        f"{host_us['wgmma']:.1f} us a call (the mma.sync passes' "
        f"{host_us['mma']:.1f}); on {card}")
    qo_bytes = PAR_BATCH * SQ * TH * TD * el
    kv_bytes = PAR_BATCH * TS * TKV * TD * el
    lse_bytes = PAR_BATCH * TH * SQ * 4
    # the (query, key) pairs the mask leaves: query i sees SOFF + i + 1
    pairs = SQ * SOFF + SQ * (SQ + 1) // 2
    pair_flops = 2 * PAR_BATCH * TH * TD * pairs
    for name, i, n_bytes, n_prod in (
            ("flash_attn_fwd_offset", 0,
             2 * qo_bytes + 2 * kv_bytes + lse_bytes, 2),
            ("flash_attn_bwd_offset", 1,
             4 * qo_bytes + 4 * kv_bytes + lse_bytes, 5)):
        kk = kernels[name]
        kk["ms"], kk["plain_ms"], kk["library_ms"] = k_ms[i], p_ms[i], l_ms[i]
        set_bound(name, PAR_LAYERS * n_bytes,
                  PAR_LAYERS * n_prod * pair_flops, BF16_OPS_PER_S)
        log(f"[time] one rank's step of attention under sequence "
            f"parallelism, {name} ({PAR_LAYERS} layers, B={PAR_BATCH} "
            f"Sq={SQ} at offset {SOFF}, Skv={TS}, H={TH} KV={TKV} D={TD}, "
            f"bf16, graph replays): kernel {kk['ms']:.4f} ms, plain "
            f"{kk['plain_ms']:.4f} ms, SDPA(boolean mask, enable_gqa) "
            f"{kk['library_ms']:.4f} ms, bound {kk['bound_ms']:.4f} ms "
            f"({kk['bound_by']}: "
            f"{PAR_LAYERS * n_bytes / 1e6:.1f} MB, "
            f"{PAR_LAYERS * n_prod * pair_flops / 1e12:.3f} TFLOP)")
    del sp_layers, sdpa_leaves

    # ---- timing: one decode step's launches of each kernel, B=1 ----
    # (real per-layer weights, so nothing stays in L2), by product and in
    # total: the pair, which runs only at B > 1 (q80_act_quant +
    # q80_matmul_w8a8), and q80_matvec_fq, which a decode step runs
    lib = _build.lib("q80_matmul")
    int8_mma.init(dev, "q80_matmul_init")
    step_calls = []      # (product, weight, x bf16, xq, sa, y, plan, bf16 weight)
    for name, w in shapes:
        for wl in layer_weights(w):
            x = torch.randn(1, wl.in_dim, device=dev, generator=gen).to(torch.bfloat16)
            xq, sa = qmatmul.act_quant_q80_plain(x, GS)
            step_calls.append((name, wl, x, xq, sa,
                               torch.empty(1, wl.out_dim, device=dev,
                                           dtype=torch.bfloat16),
                               qmatmul.matvec_plan(wl.out_dim, wl.in_dim, GS, sms),
                               wl.dequantize(torch.bfloat16)))
    assert len(step_calls) == 4 * L + 1

    def run_act_quant(calls=step_calls):
        for _, wl, x, xq, sa, *_ in calls:
            lib.q80_act_quant(x.data_ptr(), 1, xq.data_ptr(), sa.data_ptr(),
                              1, wl.in_dim, GS, stream())

    def run_w8a8(calls=step_calls):
        for _, wl, x, xq, sa, y, *_ in calls:
            _build.check(lib.q80_matmul_w8a8(
                xq.data_ptr(), sa.data_ptr(), wl.q.data_ptr(),
                wl.scales.data_ptr(), y.data_ptr(), 1, 1, wl.in_dim,
                wl.out_dim, GS, *qmatmul.w8a8_plan(1, wl.out_dim, wl.in_dim,
                                                   GS, sms), stream()),
                "q80_matmul_w8a8")

    def run_pair(calls=step_calls):
        run_act_quant(calls)
        run_w8a8(calls)

    def run_matvec(calls=step_calls):
        for _, wl, x, _, _, y, plan, _ in calls:
            _build.check(lib.q80_matvec_fq(
                x.data_ptr(), 1, wl.q.data_ptr(), wl.scales.data_ptr(),
                y.data_ptr(), 1, None, None, wl.in_dim, wl.out_dim, GS, *plan,
                qmatmul.w8a8_ranges(wl.out_dim, wl.in_dim, GS, sms), stream()),
                "q80_matvec_fq")

    def run_matvec_plain():
        for _, wl, x, *_ in step_calls:
            qmatmul.q80_matvec_fq_plain(x, wl, torch.bfloat16)

    def run_w8a8_library():
        for _, wl, x, *_, wd in step_calls:
            torch.matmul(x, wd.t())

    def mv_bytes(calls):
        """q80_matvec_fq's bytes: the weights and scales once, the bf16 row
        in, the bf16 result out."""
        return sum(wl.q.numel() + wl.scales.numel() * 4 + 2 * wl.in_dim
                   + 2 * wl.out_dim for _, wl, *_ in calls)

    mm_ops = sum(2 * wl.q.numel() for _, wl, *_ in step_calls)
    k = kernels["q80_matvec_fq"]
    t_pair = [timer(run_pair)]
    t_mv = [timer(run_matvec), timer(run_matvec)]
    t_pair.append(timer(run_pair))
    k["ms"] = t_mv[0]
    k["plain_ms"] = timer(run_matvec_plain)
    k["library_ms"] = timer(run_w8a8_library)
    set_bound("q80_matvec_fq", mv_bytes(step_calls), mm_ops, INT8_OPS_PER_S)
    log(f"[time] the same step through q80_matvec_fq ({len(step_calls)} "
        f"launches, act quant folded in; in turns pair, fused, fused, pair): "
        f"{t_mv[0]:.4f} / {t_mv[1]:.4f} ms against {t_pair[0]:.4f} / "
        f"{t_pair[1]:.4f} ms for q80_act_quant + q80_matmul_w8a8 (plain "
        f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms for "
        f"{mv_bytes(step_calls) / 1e6:.1f} MB, library {k['library_ms']:.4f} "
        f"ms)")
    for name, _ in shapes:
        calls = [c for c in step_calls if c[0] == name]
        aq_ms = timer(lambda c=calls: run_act_quant(c))
        mm_ms = timer(lambda c=calls: run_w8a8(c))
        mv_ms = timer(lambda c=calls: run_matvec(c))
        wl = calls[0][1]
        b_ms, _ = bound(mv_bytes(calls), sum(2 * c[1].q.numel() for c in calls),
                        INT8_OPS_PER_S)
        log(f"[time] K1 by product, {name} ({len(calls)} x {wl.in_dim}->"
            f"{wl.out_dim}, plan {calls[0][6]}): act_quant {aq_ms:.4f} + w8a8 "
            f"{mm_ms:.4f} = {aq_ms + mm_ms:.4f} ms; q80_matvec_fq "
            f"{mv_ms:.4f} ms; bound {b_ms:.4f} ms "
            f"({mv_bytes(calls) / 1e6:.2f} MB); {card}")
    del step_calls

    # ---- timing: the pair on its main path, a 64-token prefill's 112
    # layer products (B = PROMPT_LEN; its head is one q80_matvec_fq) ----
    pre_calls = []       # (weight, x bf16, xq, sa)
    for name, w in shapes[:4]:
        for wl in layer_weights(w):
            x = torch.randn(PROMPT_LEN, wl.in_dim, device=dev, generator=gen
                            ).to(torch.bfloat16)
            pre_calls.append((wl, x, *qmatmul.act_quant_q80_plain(x, GS)))
    assert len(pre_calls) == 4 * L
    B = PROMPT_LEN

    def run_pre_act_quant(calls=pre_calls):
        for wl, x, *_ in calls:
            qmatmul.act_quant_q80(x, GS)

    def run_pre_act_quant_plain(calls=pre_calls):
        for wl, x, *_ in calls:
            qmatmul.act_quant_q80_plain(x, GS)

    def run_pre_w8a8():
        for wl, _, xq, sa in pre_calls:
            qmatmul.q80_w8a8(xq, sa, wl, torch.bfloat16)

    def run_pre_w8a8_plain():
        for wl, _, xq, sa in pre_calls:
            qmatmul.q80_w8a8_plain(xq, sa, wl, torch.bfloat16)

    # q80_act_quant's main path since the norms and SwiGLU quantize their
    # output: wo's 28 inputs (the attention output); all 112, the path
    # before, beside it
    wo_calls = pre_calls[L:2 * L]
    assert all(wl.in_dim == H * D for wl, *_ in wo_calls)
    k = kernels["q80_act_quant"]
    aq112_ms = timer(run_pre_act_quant)
    k["ms"] = timer(lambda: run_pre_act_quant(wo_calls))
    k["plain_ms"] = timer(lambda: run_pre_act_quant_plain(wo_calls))
    k["library_ms"] = None
    set_bound("q80_act_quant",
              sum(B * (wl.in_dim * 2 + wl.in_dim + wl.in_dim // GS * 4)
                  for wl, *_ in wo_calls),
              sum(3 * B * wl.in_dim for wl, *_ in wo_calls), F32_OPS_PER_S)
    k = kernels["q80_matmul_w8a8"]
    k["ms"] = timer(run_pre_w8a8)
    k["plain_ms"] = timer(run_pre_w8a8_plain)
    wds = [wl.dequantize(torch.bfloat16) for wl, *_ in pre_calls]
    k["library_ms"] = timer(lambda: [torch.matmul(c[1], wd.t())
                                     for c, wd in zip(pre_calls, wds)])
    del wds
    pre_bytes = sum(wl.q.numel() + wl.scales.numel() * 4 + B * wl.in_dim
                    + B * wl.in_dim // GS * 4 + B * wl.out_dim * 2
                    for wl, *_ in pre_calls)
    set_bound("q80_matmul_w8a8", pre_bytes,
              sum(2 * B * wl.q.numel() for wl, *_ in pre_calls), INT8_OPS_PER_S)
    log(f"[time] a {B}-token Q80 prefill's {len(pre_calls)} layer products "
        f"(B={B}): q80_act_quant on wo's {len(wo_calls)} inputs "
        f"{kernels['q80_act_quant']['ms']:.4f} ms (plain "
        f"{kernels['q80_act_quant']['plain_ms']:.4f}, bound "
        f"{kernels['q80_act_quant']['bound_ms']:.4f}; on all "
        f"{len(pre_calls)}, the path before the norms and SwiGLU quantized "
        f"their output, {aq112_ms:.4f} ms), "
        f"q80_matmul_w8a8 {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}; bound "
        f"{k['bound_ms']:.4f} ms, {k['bound_by']}, {pre_bytes / 1e6:.1f} MB), "
        f"bf16 torch.matmul on weights dequantized ahead "
        f"{k['library_ms']:.4f} ms; {card}")
    del pre_calls

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

    # K3 at B = 1 over the same 112 rows as a decode step gives them, in
    # their integer form (the norms and SwiGLU write it; wo's after
    # q4k_act_quant): the kernel alone, and with wo's 28 q4k_act_quant (a
    # step's K3 work)
    acts4 = [q4k.Q4KAct(*q4k.act_quant_q4k_packed_plain(x), x.shape)
             for _, x, *_ in mm4]

    def run_fused():
        for (wl, *_), act in zip(mm4, acts4):
            q4k.q4k_matvec_fq(act, wl, torch.bfloat16)

    def run_fused_plain():
        for (wl, *_), act in zip(mm4, acts4):
            q4k.q4k_matvec_fq_plain(act, wl, torch.bfloat16)

    def run_step_k3():
        for (wl, x, *_), act in zip(mm4, acts4):
            q4k.q4k_matvec_fq(x if wl.in_dim == cfg.n_head * cfg.head_dim
                              else act, wl, torch.bfloat16)

    k = kernels["q4k_matvec_fq"]
    k["ms"] = timer(run_fused)
    k["plain_ms"] = timer(run_fused_plain)
    k["library_ms"] = timer(run_mm4_library)
    t_step_k3 = timer(run_step_k3)
    # the weights once, the integer form in, the bf16 result out; the dot
    fused_bytes = sum(wl.packed.numel() + 8 * wl.scales.numel()
                      + wl.n_pad // 2 + 8 * (wl.n_pad // 32) + 2 * wl.out_dim
                      for wl, *_ in mm4)
    set_bound("q4k_matvec_fq", fused_bytes, mm4_ops, F32_OPS_PER_S)
    plans = {n: q4k.matvec_plan(b4[n].out_dim, b4[n].n_pad, sms)
             for n in ("wqkv", "wo", "w13", "w2")}
    log(f"[time] a Q4K decode step's {len(mm4)} products through "
        f"q4k_matvec_fq on their integer form (plans (blocks, R, S, T) "
        f"{plans}): {k['ms']:.4f} ms; with wo's "
        f"{L} q4k_act_quant (a step's K3 work) {t_step_k3:.4f} ms; the two "
        f"kernels it replaced at B = 1 (q4k_fake_quant + q4k_matmul) "
        f"{kernels['q4k_fake_quant']['ms'] + kernels['q4k_matmul']['ms']:.4f}"
        f" ms; plain {k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
        f"for {fused_bytes / 1e6:.1f} MB, library {k['library_ms']:.4f} ms; "
        f"{card}")
    del mm4, fq4, acts4

    # ---- timing: K3 at B > 1 on its main path, a 64-token prefill's 112
    # layer products (B = PROMPT_LEN) as the model calls them:
    # q4k_act_quant, then q4k_matmul_w4a4 ----
    B = PROMPT_LEN
    pre4 = []     # (weight, x bf16, its integer form)
    for name in ("wqkv", "wo", "w13", "w2"):
        for wl in layer_weights(b4[name]):
            x = torch.randn(B, wl.in_dim, device=dev, generator=gen
                            ).to(torch.bfloat16)
            pre4.append((wl, x, q4k.act_quant_q4k_packed_plain(x)))
    assert len(pre4) == 4 * L

    def run_pre4_aq(calls=pre4):
        for wl, x, _ in calls:
            q4k.act_quant_q4k_packed(x)

    def run_pre4_aq_plain(calls=pre4):
        for wl, x, _ in calls:
            q4k.act_quant_q4k_packed_plain(x)

    def run_pre4_w4():
        for wl, _, act in pre4:
            q4k.q4k_matmul_w4a4(*act, wl, torch.bfloat16)

    def run_pre4_w4_plain():
        for wl, _, act in pre4:
            q4k.q4k_matmul_w4a4_plain(*act, wl, torch.bfloat16)

    # q4k_act_quant's main path since the norms and SwiGLU write the Q4K
    # form: wo's 28 inputs (the attention output); all 112, the path
    # before, beside it
    wo4 = pre4[L:2 * L]
    assert all(wl.in_dim == H * D for wl, *_ in wo4)
    k = kernels["q4k_act_quant"]
    aq4_112_ms = timer(run_pre4_aq)
    k["ms"] = timer(lambda: run_pre4_aq(wo4))
    k["plain_ms"] = timer(lambda: run_pre4_aq_plain(wo4))
    k["library_ms"] = None
    set_bound("q4k_act_quant",
              sum(B * (2 * wl.in_dim + wl.n_pad // 2 + 12 * (wl.n_pad // 32))
                  for wl, *_ in wo4),
              AQ_OPS_PER_VALUE * B * sum(wl.in_dim for wl, *_ in wo4),
              F32_OPS_PER_S)
    k = kernels["q4k_matmul_w4a4"]
    k["ms"] = timer(run_pre4_w4)
    k["plain_ms"] = timer(run_pre4_w4_plain)
    wds4 = [wl.dequantize(torch.bfloat16) for wl, *_ in pre4]
    k["library_ms"] = timer(lambda: [torch.matmul(c[1], wd.t())
                                     for c, wd in zip(pre4, wds4)])
    del wds4
    k["bound_ms"], k["bound_by"], pre4_bytes = w4a4_bound(
        [wl for wl, *_ in pre4], B)
    log(f"[time] a {B}-token Q4K prefill's {len(pre4)} layer products "
        f"(B={B}): q4k_act_quant on wo's {len(wo4)} inputs "
        f"{kernels['q4k_act_quant']['ms']:.4f} ms (plain "
        f"{kernels['q4k_act_quant']['plain_ms']:.4f}, bound "
        f"{kernels['q4k_act_quant']['bound_ms']:.4f}; on all {len(pre4)} "
        f"{aq4_112_ms:.4f}), q4k_matmul_w4a4 "
        f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}; bound "
        f"{k['bound_ms']:.4f} ms, {k['bound_by']}, {pre4_bytes / 1e6:.1f} MB), "
        f"bf16 torch.matmul on weights dequantized ahead "
        f"{k['library_ms']:.4f} ms; {card}")
    del pre4

    # attention: the last step of the main path's decode (the decoder's
    # cache of max_seq_len = 1024 rows, position PROMPT_LEN + N_TOKENS - 2),
    # one call per layer on its own layer cache
    T_main = QWEN3_06B["block_size"]
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

    # the same step fed as the model feeds it (gpt.attention: bf16 q, the
    # f32 result cast to bf16), so that everything a call puts on the stream
    # is counted; SDPA the same way (bf16 in, bf16 out)
    def run_attn_fed():
        for i in range(L):
            decode_attn.decode_attention(q16[i][:, :, 0], cache.k[i], cache.v[i],
                                         None, None, pos, KV, H // KV
                                         ).to(torch.bfloat16)

    fed_ms = timer(run_attn_fed)
    fed_lib_ms = timer(run_attn_library)
    chunk, n_split = decode_attn.choose_splits(KV, T_main)
    log(f"[time] the same step as the model feeds it (bf16 q, result cast to "
        f"bf16; grid {KV} x {n_split} blocks of {chunk} rows): kernel + cast "
        f"{fed_ms:.4f} ms, SDPA(enable_gqa) {fed_lib_ms:.4f} ms, ratio "
        f"{fed_ms / fed_lib_ms:.2f}")
    del cache, kvs

    # ---------------- 4. tiny fixtures ----------------
    log(f"[time] phase 4 starts at {time.time() - t_start:.1f} s")
    fix = os.path.join(ROOT, "tests", "js", "fixtures")
    with open(os.path.join(fix, "expected.json")) as f:
        expected = json.load(f)
    greedy = sampling.SamplerConfig(temperature=0.0, repetition_penalty=1.0)
    tiny = engine.LLMContext.from_bin(
        os.path.join(fix, "tiny_q80.bin"), max_seq_len=64,
        dtype=torch.float32, sampler=greedy)
    assert tiny.device.type == "cuda"
    # one counter a wrapper: the offset form counts with flash_attn_fwd /
    # flash_attn_bwd, the wgmma routes' calls also with flash_attn_fwd_wgmma
    # / flash_attn_bwd_wgmma, read where a main path trains
    names = [n for n in kernels if not n.endswith("_offset")]
    assert sorted(COUNTER_OF) == sorted(names + WGMMA_COUNTERS)

    def reset():
        zero_launches(torch)

    def read():
        return read_launches(torch, names)

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
        # the same stream by generate_on_device: graph replays, one read
        ids = ctx.encode(expected["prompt"])
        god = engine.generate_on_device(ctx, ids, len(want)).tolist()
        log(f"[tiny] {file} generate_on_device (decode graph): {god}")
        if god != want:
            raise AssertionError(f"{file}: the graphed stream differs from "
                                 f"expected.json")
        # speculative decode, spec_k = 7: verify rounds replayed from their
        # graphs must give the same streams
        sctx = replace(ctx, spec_k=SPEC_K)
        s = engine.generate_sync(sctx, expected["prompt"], max_new_tokens=16)
        god = engine.generate_on_device(sctx, ids, len(want)).tolist()
        stats = speculative.LAST_STATS
        log(f"[tiny] {file} spec_k {SPEC_K}: generate_sync {s.output_ids} "
            f"(decode calls {dict(s.steps_by)}), generate_on_device {god} "
            f"({stats})")
        if s.output_ids != want or god != want or not s.steps_by["round"]:
            raise AssertionError(f"{file}: a speculative stream differs from "
                                 f"expected.json")

    def tiny_batched(ctx, file, want):
        """Through BatchedEngine: the expected prompt joins while two other
        streams decode; it must give the solo greedy stream."""
        from nano_tpu_torch.serve.batching import BatchedEngine
        be = BatchedEngine(ctx, n_slots=4)
        others = [ctx.encode(t) for t in ("abcabc", "xyz" * 5)]
        for ids in others:
            be.add(ids, max_new_tokens=40, temperature=0.0,
                   repetition_penalty=1.0)
            be.step_burst(3)
        slot, first = be.add(ctx.encode(expected["prompt"]),
                             max_new_tokens=len(want), temperature=0.0,
                             repetition_penalty=1.0)
        got = [first]
        while be.slots[slot].active:
            got.extend(be.step_burst(4).get(slot, []))
        log(f"[tiny] {file} through BatchedEngine (4 slots, joined after two "
            f"others): {got}")
        if got != want:
            raise AssertionError(f"{file}: the batched stream differs from "
                                 f"the solo greedy stream")

    tiny_stream(tiny, "tiny_q80.bin", expected["greedy"]["q80"],
                ("q80_matvec_rows", "q80_matmul_rows", "decode_attention"))
    tiny_batched(tiny, "tiny_q80.bin", expected["greedy"]["q80"])
    tiny4 = engine.LLMContext.from_bin(
        os.path.join(fix, "tiny_q4k.bin"), max_seq_len=64,
        dtype=torch.float32, sampler=greedy)
    head4 = tiny4.params["output_q"]
    assert (isinstance(tiny4.params["blocks"]["w13"], q4k.Q4KTensor)
            and isinstance(head4, qmatmul.Q80Tensor)
            and head4.group_size == 64 and not head4.w8a8)
    tiny_stream(tiny4, "tiny_q4k.bin", expected["greedy"]["q4k"],
                ("q4k_act_quant", "q4k_matmul_w4a4", "rms_norm_q4k_fq",
                 "q4k_matvec_fq", "rms_norm_q4k", "swiglu_q4k",
                 "q80_matvec_rows", "decode_attention"))
    del tiny, tiny4

    # ---------------- 5. full width ----------------
    log(f"[time] phase 5 starts at {time.time() - t_start:.1f} s")
    tok = TrieTokenizer()
    tok.build_preset(32768)
    prng = np.random.default_rng(SEED + 1)
    prompts = [prng.integers(100, 30000, n).tolist() for n in (17, 40, 100)]
    budgets = (64, 128, 64)
    prompt = prng.integers(100, 30000, PROMPT_LEN).tolist()

    def profile_line(*a):
        return profile_witness(torch, card, *a)

    def eager_stream(ctx, ids, n):
        """The engine's decode step called from Python step by step (what
        the graph captures), on a cache of the decoder's length.
        -> (ids (n,), seconds with the prefill)."""
        cache = ctx.new_cache(1)
        gen = ctx.generator()
        torch.cuda.synchronize()
        t0 = time.time()
        tok_, seen = engine._prefill_first_token(ctx, ids, cache, gen)
        pos = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
        out = torch.empty((n,), dtype=torch.int64, device=dev)
        out[0] = tok_[0]
        for i in range(1, n):
            tok_ = engine._decode_step(ctx, tok_, pos, cache, seen, gen)
            pos += 1
            out[i] = tok_[0]
        out = out.cpu()
        return out.numpy(), time.time() - t0

    def timed_god(ctx, ids, n):
        """-> (generate_on_device's ids, seconds, launch counts)."""
        reset()
        torch.cuda.synchronize()
        t0 = time.time()
        out = engine.generate_on_device(ctx, ids, n)
        torch.cuda.synchronize()
        secs = time.time() - t0
        return out, secs, read()

    def timed_k_graph(ctx, ids, n_replays):
        """The context's decoder run through its graph of GRAPH_STEPS steps
        (a graph the engine does not replay; measured beside it): prefill,
        n_replays replays, one read.  -> (ids, seconds, launch counts)."""
        dec = ctx.decoder()
        reset()
        t0 = time.time()
        with ctx.on_stream():
            dec.claim()
            dec.prefill(ids)
            graph = dec._graph(GRAPH_STEPS)
            for _ in range(n_replays):
                graph.run()
            out = dec.out[:1 + GRAPH_STEPS * n_replays].cpu().numpy()
        torch.cuda.synchronize()
        return out, time.time() - t0, read()


    def drive(label, p, expect_for):
        """3 requests; generate_on_device(prompt, N_TOKENS) twice (the
        first captures the decode graph, the second only replays it), each
        with its launch counts held to expect_for(N_TOKENS - 1) (the counts
        of a prefill and that many decode steps); the same stream from the
        eager step loop, torch.equal; the graph of GRAPH_STEPS steps; and a
        profile of the eager loop and of the graph in the same call.
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
                f"{sess.output_ids[:8]}, {sess.tps:.1f} tok/s (Session: one "
                f"graph replay and one token read a step)")
            if not sess.output_ids or max(sess.output_ids) >= cfg.vocab_size:
                raise AssertionError("request produced no or out-of-range "
                                     "tokens")
        req_counts = read()
        log(f"[full {label}] 3 requests in {time.time() - t0:.2f} s; "
            f"launches {req_counts}")

        expect = expect_for(N_TOKENS - 1)
        per_step = {n: expect_for(1)[n] - expect_for(0)[n] for n in names}
        torch.cuda.synchronize()
        t0 = time.time()
        first = engine.generate_on_device(ctx, prompt, 1)
        ttft_ms = (time.time() - t0) * 1e3
        out1, secs1, counts1 = timed_god(ctx, prompt, N_TOKENS)
        out, t_all, god_counts = timed_god(ctx, prompt, N_TOKENS)
        graph_tok_s = (N_TOKENS - 1) / max(t_all - ttft_ms / 1e3, 1e-9)
        log(f"[full {label}] generate_on_device prompt {PROMPT_LEN}, "
            f"{N_TOKENS} greedy tokens on {card}, decode graph of 1 step: "
            f"TTFT {ttft_ms:.2f} ms, first call (warm-up step + capture) "
            f"{secs1:.3f} s, second (replays) {t_all:.3f} s, decode "
            f"{graph_tok_s:.2f} tok/s; first ids {out[:8].tolist()}")
        if (out.shape != (N_TOKENS,) or out[0] != first[0]
                or not np.array_equal(out, out1)):
            raise AssertionError("generate_on_device output malformed")
        log(f"[full {label}] launches {god_counts}; first call {counts1}; "
            f"expected {expect}")
        if god_counts != expect or counts1 != expect:
            raise AssertionError("launch counts differ from the per-step "
                                 "counts")

        eager, eager_s = eager_stream(ctx, prompt, EAGER_TOKENS)
        eager_tok_s = (EAGER_TOKENS - 1) / max(eager_s - ttft_ms / 1e3, 1e-9)
        log(f"[full {label}] the eager step loop, {EAGER_TOKENS} tokens: "
            f"{eager_tok_s:.2f} tok/s ({eager_s:.3f} s); the graphed stream's "
            f"first {EAGER_TOKENS} torch.equal to it: "
            f"{np.array_equal(eager, out[:EAGER_TOKENS])}")
        if not torch.equal(torch.from_numpy(eager), torch.from_numpy(
                out[:EAGER_TOKENS].astype(np.int64))):
            raise AssertionError(f"{label}: the graphed stream differs from "
                                 f"the eager step loop")

        n_rep = (N_TOKENS - 1) // GRAPH_STEPS
        k_steps = GRAPH_STEPS * n_rep
        outk, _, countsk = timed_k_graph(ctx, prompt, n_rep)
        outk2, tk, _ = timed_k_graph(ctx, prompt, n_rep)
        k_tok_s = k_steps / max(tk - ttft_ms / 1e3, 1e-9)
        log(f"[full {label}] decode graph of {GRAPH_STEPS} steps: "
            f"{k_tok_s:.2f} tok/s ({tk:.3f} s for {k_steps} steps), stream "
            f"torch.equal: {np.array_equal(outk2, out[:k_steps + 1])}; "
            f"launches {countsk}")
        if not (np.array_equal(outk, out[:k_steps + 1])
                and np.array_equal(outk2, outk)
                and countsk == expect_for(k_steps)):
            raise AssertionError(f"{label}: the {GRAPH_STEPS}-step graph "
                                 f"differs")

        # where a decode step's time goes, the eager loop and the graph in
        # the same call: 32 steps each from position PROMPT_LEN
        n_prof = 32
        pcache = ctx.new_cache(1)
        pgen = ctx.generator()
        ptok, pseen = engine._prefill_first_token(ctx, prompt, pcache, pgen)
        ppos = torch.tensor([PROMPT_LEN], dtype=torch.int32, device=dev)

        def eager_step():
            nonlocal ptok
            ptok = engine._decode_step(ctx, ptok, ppos, pcache, pseen, pgen)
            ppos.add_(1)

        eager_ms = (eager_s - ttft_ms / 1e3) * 1e3 / (EAGER_TOKENS - 1)
        graph_ms = (t_all - ttft_ms / 1e3) * 1e3 / (N_TOKENS - 1)
        k_ms = (tk - ttft_ms / 1e3) * 1e3 / k_steps
        profile_line(label, "eager step loop", eager_step, n_prof, 1,
                     eager_ms, per_step)
        del pcache
        dec = ctx.decoder()
        with ctx.on_stream():
            dec.claim()
            dec.prefill(prompt)
            profile_line(label, "decode graph, 1 step a replay",
                         dec._graph().run, n_prof, 1, graph_ms, per_step)
            dec.prefill(prompt)
            profile_line(label, f"decode graph, {GRAPH_STEPS} steps a "
                         f"replay", dec._graph(GRAPH_STEPS).run,
                         n_prof // GRAPH_STEPS, GRAPH_STEPS, k_ms, per_step)
        log(f"[decode {label}] {card}: eager {eager_tok_s:.2f} tok/s "
            f"({eager_ms:.3f} ms/step), graph {graph_tok_s:.2f} tok/s "
            f"({graph_ms:.3f} ms/step), graph of {GRAPH_STEPS} steps "
            f"{k_tok_s:.2f} tok/s ({k_ms:.3f} ms/step), TTFT {ttft_ms:.2f} ms")
        return ctx, out, {n: req_counts[n] + god_counts[n] for n in names}

    def expect80(steps):
        """Launches of a Q80 prefill (64 rows) and `steps` decode steps."""
        return decode_counts("Q80", steps, names)

    log("[full Q80] expected launches: 113 Q80 matmuls = 4 x 28 + head per "
        "forward; the prefill's 112 layer products (64 rows) through "
        "q80_matmul_w8a8, 84 of them on int8 rows that rms_norm_q80 (wqkv, "
        "w13) and swiglu_q80 (w2) wrote, wo's 28 after q80_act_quant; its "
        "head (the last row only) and every decode step's 113 as "
        "q80_matvec_fq (act quant folded in); 57 rms_norm_q80 (2 a layer + "
        "the final norm) and 28 swiglu_q80 per forward; 28 attentions per "
        "decode step")
    _, out80, counts80 = drive("Q80", params, expect80)
    for name in ("q80_act_quant", "q80_matmul_w8a8", "q80_matvec_fq",
                 "decode_attention", "rms_norm_q80", "swiglu_q80"):
        kernels[name]["launches"] = counts80[name]
        if counts80[name] == 0:
            raise AssertionError(f"main path launched no {name}")

    def expect4(steps):
        """Launches of a Q4K prefill and `steps` decode steps."""
        return decode_counts("Q4K", steps, names)

    log("[full Q4K] expected launches: 112 Q4K matmuls = 4 x 28 per forward, "
        "as q4k_matvec_fq in a decode step and as q4k_matmul_w4a4 (int8 "
        "tensor cores) in the prefill, 84 of them on the Q4K integer form "
        "that rms_norm_q4k (wqkv, w13) and swiglu_q4k (w2) wrote, wo's 28 "
        "after q4k_act_quant; one q80_matvec_fq head (one row) per forward; "
        "56 rms_norm_q4k, 28 swiglu_q4k and the final rms_norm_q4k_fq, which "
        "writes the fake-quantized row the requantized Q80 head reads, per "
        "forward (no q4k_fake_quant); 28 attentions per decode step")
    _, out4, counts4 = drive("Q4K", params4, expect4)
    for name in ("q4k_act_quant", "q4k_matmul_w4a4", "rms_norm_q4k_fq",
                 "q4k_matvec_fq", "rms_norm_q4k", "swiglu_q4k"):
        kernels[name]["launches"] = counts4[name]
        if counts4[name] == 0:
            raise AssertionError(f"Q4K path launched no {name}")
    # drive() held every count to expect4, q4k_matmul's and
    # q4k_fake_quant's to 0: reported as the main path's count, with the
    # entry's main_path false
    for name in ("q4k_matmul", "q4k_fake_quant"):
        kernels[name]["launches"] = counts4[name]
        if counts4[name]:
            raise AssertionError(f"the Q4K path launched {name}")

    def pad_only(x2d):
        """The activation as K3 takes it, without the fake-quant."""
        n = x2d.shape[1]
        xp = torch.zeros(x2d.shape[0], -(-n // 256) * 256,
                         dtype=torch.float32, device=x2d.device)
        xp[:, :n] = x2d
        return xp

    def pair_final_norm(x, weight, eps_, residual=None, want_hn=True):
        """rms_norm_q4k_fq as the two launches it replaced: rms_norm_q80,
        then the head's fake-quant (gpt.fake_quant_act: q4k_fake_quant, or
        what a route rebinds it to)."""
        h, hn, _ = norm_quant.rms_norm_q80(x, weight, eps_, residual)
        fq = gpt.fake_quant_act(hn.reshape(-1, hn.shape[-1]))
        return h, hn, fq.reshape(*hn.shape[:-1], fq.shape[-1])

    @contextlib.contextmanager
    def k3_route(route):
        """The model's Q4K product (gpt.q4k_matmul) and the head's
        fake-quant (gpt.fake_quant_act, and the final norm that folds it in,
        gpt.rms_norm_q4k_fq, as the pair it was before: rms_norm_q80, then
        q4k_fake_quant) rebound here for a measurement, not a switch of the
        package: "pair", more than one row through the pair
        K3 at B > 1 was before (q4k_fake_quant + q4k_matmul);
        "unquantized", no activation quantization at all (K3's f32 kernel
        on the padded activation at every row count, the head's fake-quant
        a pad).  Two
        faulty B > 1 paths, the controls of the Q4K logits check:
        "unquantized_rows", more than one row without the activation's
        quantization (one row as the package has it); "shifted_scales",
        more than one row through the new pair with each row's sa, ba and
        c taken from the row before it.  Every route takes the activation
        as a tensor: the norms and SwiGLU write no Q4K form meanwhile."""
        saved, q4k_out = (gpt.q4k_matmul, gpt.fake_quant_act,
                          gpt.rms_norm_q4k_fq), gpt._q4k_out

        def product(x, w, dtype):
            x2d = x.reshape(-1, w.in_dim)
            if route == "unquantized":
                y = q4k.q4k_matmul_f32(pad_only(x2d), w, dtype)
            elif x2d.shape[0] == 1:
                y = q4k.q4k_matvec_fq(x2d, w, dtype)
            elif route == "unquantized_rows":
                y = q4k.q4k_matmul_f32(pad_only(x2d), w, dtype)
            elif route == "shifted_scales":
                vp, *per_group = q4k.act_quant_q4k_packed(x2d)
                y = q4k.q4k_matmul_w4a4(
                    vp, *(t.roll(1, 0).contiguous() for t in per_group), w,
                    dtype)
            else:
                y = q4k.q4k_matmul_f32(q4k.fake_quant_act(x2d), w, dtype)
            return y.reshape(*x.shape[:-1], w.out_dim)

        gpt.q4k_matmul, gpt._q4k_out = product, lambda ws: False
        gpt.rms_norm_q4k_fq = pair_final_norm
        if route == "unquantized":
            gpt.fake_quant_act = pad_only
        try:
            yield
        finally:
            gpt.q4k_matmul, gpt.fake_quant_act, gpt.rms_norm_q4k_fq = saved
            gpt._q4k_out = q4k_out

    # The Q4K stream with the final norm as the two launches it replaced
    # (rms_norm_q80, then q4k_fake_quant: the path before the fold), on a
    # fresh context whose decode graph is captured so: token-identical
    saved_fq = gpt.rms_norm_q4k_fq
    gpt.rms_norm_q4k_fq = pair_final_norm
    try:
        ctx_pair = engine.LLMContext(
            cfg=cfg, params=params4, tokenizer=tok,
            max_seq_len=cfg.block_size, device=dev, dtype=torch.bfloat16,
            sampler=greedy, stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")
        engine.generate_on_device(ctx_pair, prompts[0][:8], 4)   # capture
        out_pair, _, pair_counts = timed_god(ctx_pair, prompt, N_TOKENS)
    finally:
        gpt.rms_norm_q4k_fq = saved_fq
    del ctx_pair
    want_pair = dict(expect4(N_TOKENS - 1), rms_norm_q4k_fq=0,
                     q4k_fake_quant=N_TOKENS, rms_norm_q80=N_TOKENS)
    log(f"[full Q4K] {N_TOKENS} greedy tokens with the final norm as "
        f"rms_norm_q80 + q4k_fake_quant (the path before the fold): "
        f"token-identical to the fused norm's {np.array_equal(out_pair, out4)}"
        f"; launches {pair_counts} (expected {want_pair})")
    if not np.array_equal(out_pair, out4) or pair_counts != want_pair:
        raise AssertionError("the Q4K stream through the fused final norm "
                             "differs from the two launches it replaced")

    # The eager ops that rms_norm_q80 / rms_norm_q4k / rms_norm_q4k_fq and
    # swiglu_q80 / swiglu_q4k replaced, rebound into the model here for a
    # measurement, not a switch of the package: the norm's ops (and the
    # residual add), F.silu * h3, and q80_act_quant where the product takes
    # int8 rows, q4k_act_quant where it takes the Q4K form, q4k_fake_quant
    # before the requantized head (the path before them)
    def eager_act(y, gs):
        if not gs:
            return None
        xq, sa = qmatmul.act_quant_q80(y.reshape(-1, y.shape[-1]), gs)
        return qmatmul.Q80Act(xq, sa, y.shape)

    def eager_act4(y):
        return q4k.Q4KAct(*q4k.act_quant_q4k_packed(y.reshape(
            -1, y.shape[-1])), y.shape)

    def eager_rms_norm_q4k(x, weight, eps_, residual=None, want_hn=True):
        h, hn, _ = eager_rms_norm_q80(x, weight, eps_, residual)
        return h, hn, eager_act4(hn)

    def eager_swiglu_q4k(h13_, want_hidden=True):
        y, _ = eager_swiglu_q80(h13_)
        return y, eager_act4(y)

    def eager_rms_norm_q4k_fq(x, weight, eps_, residual=None, want_hn=True):
        h, hn, _ = eager_rms_norm_q80(x, weight, eps_, residual)
        fq = q4k.fake_quant_act(hn.reshape(-1, hn.shape[-1]))
        return h, hn, fq.reshape(*hn.shape[:-1], fq.shape[-1])

    def eager_rms_norm_q80(x, weight, eps_, residual=None, group_size=0,
                           want_hn=True):
        h = x if residual is None else x + residual
        hn = norm_quant.rms_norm(h, weight, eps_)
        return None if residual is None else h, hn, eager_act(hn, group_size)

    def eager_swiglu_q80(h13_, group_size=0, want_hidden=True):
        Fh = h13_.shape[-1] // 2
        y = F.silu(h13_[..., :Fh]) * h13_[..., Fh:]
        return y, eager_act(y, group_size)

    @contextlib.contextmanager
    def norm_route(route):
        """route "eager": gpt's fused norm and SwiGLU rebound to the eager
        ops; "fused": as the package has them."""
        saved = (gpt.rms_norm_q80, gpt.swiglu_q80, gpt.rms_norm_q4k,
                 gpt.swiglu_q4k, gpt.rms_norm_q4k_fq)
        if route == "eager":
            (gpt.rms_norm_q80, gpt.swiglu_q80, gpt.rms_norm_q4k,
             gpt.swiglu_q4k, gpt.rms_norm_q4k_fq) = (
                 eager_rms_norm_q80, eager_swiglu_q80, eager_rms_norm_q4k,
                 eager_swiglu_q4k, eager_rms_norm_q4k_fq)
        try:
            yield
        finally:
            (gpt.rms_norm_q80, gpt.swiglu_q80, gpt.rms_norm_q4k,
             gpt.swiglu_q4k, gpt.rms_norm_q4k_fq) = saved

    def eager_counts(step):
        """A step's launch counts with the eager route: no norm or SwiGLU
        kernel, and q80_act_quant before each product they fed int8 rows
        (85 a step where any was), q4k_act_quant before each they fed the
        Q4K form (84 a step, at every row count), q4k_fake_quant before the
        requantized head."""
        e = dict(step, rms_norm_q80=0, swiglu_q80=0, rms_norm_q4k=0,
                 swiglu_q4k=0, rms_norm_q4k_fq=0)
        if step.get("q80_act_quant", 0) >= 28:
            e["q80_act_quant"] = step["q80_act_quant"] + 85
        if step.get("rms_norm_q4k", 0):
            e["q4k_act_quant"] = step["q4k_act_quant"] + 84
        if step.get("rms_norm_q4k_fq", 0):
            e["q4k_fake_quant"] = (step.get("q4k_fake_quant", 0)
                                   + step["rms_norm_q4k_fq"])
        return e

    def timed_ms(fn):
        torch.cuda.synchronize()
        t0_ = time.time()
        fn()
        torch.cuda.synchronize()
        return (time.time() - t0_) * 1e3

    def decode_routes(label, p, expect_for):
        """The B = 1 decode step (the engine's graph of one step) and TTFT
        with the fused norms and SwiGLU and with the eager ops, in turns
        eager, fused, fused, eager, each on a fresh context (its decode
        graph captured under its route); the better of two each, the
        profile of the first of each route."""
        fused_step = {n: expect_for(1)[n] - expect_for(0)[n] for n in names}
        res = {"eager": [], "fused": []}
        for route in ("eager", "fused", "fused", "eager"):
            with norm_route(route):
                ctx = engine.LLMContext(
                    cfg=cfg, params=p, tokenizer=tok,
                    max_seq_len=cfg.block_size, device=dev,
                    dtype=torch.bfloat16, sampler=greedy,
                    stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")
                engine.generate_on_device(ctx, prompts[0][:8], 4)  # capture
                ttft = min(timed_ms(lambda: engine.generate_on_device(
                    ctx, prompt, 1)) for _ in range(3))
                outr = []
                t_all = timed_ms(lambda: outr.append(
                    engine.generate_on_device(ctx, prompt, N_TOKENS)))
                step_ms = (t_all - ttft) / (N_TOKENS - 1)
                dec = ctx.decoder()
                prof = None
                with ctx.on_stream():
                    dec.claim()
                    dec.prefill(prompt)
                    if not res[route]:
                        prof = profile_line(
                            f"{label} {route}",
                            "decode graph, 1 step a replay",
                            dec._graph().run, 32, 1, step_ms,
                            fused_step if route == "fused" else
                            eager_counts(fused_step))
                res[route].append((ttft, step_ms, prof, outr[0]))
                del ctx, dec
        best = {r: (min(v[0] for v in res[r]), min(v[1] for v in res[r]),
                    res[r][0][2]) for r in res}
        same = all(np.array_equal(v[3], res["fused"][0][3])
                   for r in res for v in res[r])
        pr = lambda b: ("not measured" if b[2] is None else
                        f"busy {b[2]['busy']:.3f} ms, {b[2]['kernels']:.0f} "
                        f"kernels, other {b[2]['other']:.3f} ms a step")
        log(f"[norms {label}] B = 1 decode ({card}), one call, better of two "
            f"in turns: fused norms and SwiGLU TTFT {best['fused'][0]:.2f} ms, "
            f"{best['fused'][1]:.3f} ms a step ({pr(best['fused'])}); eager "
            f"ops TTFT {best['eager'][0]:.2f} ms, {best['eager'][1]:.3f} ms a "
            f"step ({pr(best['eager'])}); the four streams equal: {same}")
        return same

    decode_routes("Q80", params, expect80)
    decode_routes("Q4K", params4, expect4)

    # ---------------- 5b. continuous batching ----------------
    log(f"[time] phase 5b starts at {time.time() - t_start:.1f} s")
    # Qwen3-0.6B Q80, BATCH_SLOTS slots: a prompt of 16-64 tokens joins
    # every BATCH_JOIN_EVERY steps, each stream BATCH_NEW greedy tokens, the
    # cache growing 128 -> 256; bursts of graph replays.
    from nano_tpu_torch.serve.batching import BatchedEngine
    bctx = engine.LLMContext(
        cfg=cfg, params=params, tokenizer=tok, max_seq_len=cfg.block_size,
        device=dev, dtype=torch.bfloat16, sampler=greedy,
        stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")
    brng = np.random.default_rng(SEED + 3)
    joins = [brng.integers(100, 30000, int(m)).tolist()
             for m in brng.integers(16, 65, BATCH_SLOTS)]
    def join_drive(ctx_, n_new):
        """The joins, one every BATCH_JOIN_EVERY steps into a BatchedEngine
        of BATCH_SLOTS slots on ctx_, n_new greedy tokens each, in bursts of
        graph replays until every stream ends.  -> (engine, {slot: tokens},
        slots in join order, batched steps, cache capacities, launch
        counts, seconds)."""
        be_ = BatchedEngine(ctx_, n_slots=BATCH_SLOTS)
        streams_, order_, caps_ = {}, [], [be_._cache_len()]
        n_steps = 0

        def burst():
            nonlocal n_steps
            for sl, ts in be_.step_burst(BATCH_JOIN_EVERY).items():
                streams_[sl].extend(ts)
            n_steps += BATCH_JOIN_EVERY
            caps_.append(be_._cache_len())

        reset()
        t0_ = time.time()
        for pr in joins:
            slot, first = be_.add(pr, max_new_tokens=n_new, temperature=0.0,
                                   repetition_penalty=1.0)
            streams_[slot] = [] if first is None else [first]
            order_.append(slot)
            burst()
        while be_.n_active:
            burst()
        torch.cuda.synchronize()
        secs = time.time() - t0_
        return be_, streams_, order_, n_steps, caps_, read(), secs

    def first_logits_rel(be_, ctx_, p_):
        """One batched step's logits (B = BATCH_SLOTS, every join's prompt
        in its slot again) against each slot's single stream (B = 1), both
        after the same prefill: -> the worst max|d| / max|logit|."""
        for i, pr in enumerate(joins):
            if be_.add(pr, max_new_tokens=2, temperature=0.0,
                       repetition_penalty=1.0)[0] != i:
                raise AssertionError("a released slot was not free")
        c_b = gpt.KVCache(*(None if t_ is None else t_.clone() for t_ in (
            be_.cache.k, be_.cache.v, be_.cache.k_scale, be_.cache.v_scale)))
        lb, _ = gpt.forward_decode_batched(p_, be_.tok.clone(), c_b,
                                           be_.pos.clone(), cfg, torch.bfloat16,
                                           ctx_.rope_tables())
        worst_rel = 0.0
        for i, pr in enumerate(joins):
            c1 = ctx_.new_cache(1, seq_len=be_._cache_len())
            t1, _ = engine._prefill_first_token(ctx_, pr, c1, ctx_.generator())
            l1, _ = gpt.forward_with_cache(p_, t1[:, None], c1, len(pr), cfg,
                                           torch.bfloat16,
                                           rope=ctx_.rope_tables())
            l1 = l1[0, 0]
            if int(t1[0]) != int(be_.tok[i]):
                raise AssertionError(f"slot {i}: the first token differs")
            worst_rel = max(worst_rel, ((lb[i] - l1).abs().max()
                                        / l1.abs().max()).item())
        for i in range(BATCH_SLOTS):
            be_.release(i)
        del c_b
        return worst_rel

    def first_logits_check(be_, ctx_, p_, tol, why):
        """first_logits_rel within tol (why: the reason for tol)."""
        worst_rel = first_logits_rel(be_, ctx_, p_)
        log(f"[batch] one batched step's logits vs each slot's single stream "
            f"({why}): worst max|d|/max|ref| {worst_rel:.3e} (tol {tol:.3e})")
        if not worst_rel <= tol:
            raise AssertionError("batched logits disagree with the single "
                                 "stream")

    be, streams, order, n_bsteps, caps, b_counts, b_secs = join_drive(
        bctx, BATCH_NEW)
    n_j = len(joins)
    expect_b = {n: 0 for n in names}
    expect_b.update(q80_act_quant=28 * n_j + 28 * n_bsteps,
                    q80_matmul_w8a8=112 * n_j + 113 * n_bsteps,
                    q80_matvec_fq=n_j, decode_attention=28 * n_bsteps,
                    rms_norm_q80=57 * (n_j + n_bsteps),
                    swiglu_q80=28 * (n_j + n_bsteps))
    full_len = all(len(streams[sl]) == BATCH_NEW for sl in order)
    log(f"[batch] Qwen3-0.6B Q80, {BATCH_SLOTS} slots, {n_j} prompts of "
        f"{[len(p_) for p_ in joins]} tokens joining every "
        f"{BATCH_JOIN_EVERY} steps, {BATCH_NEW} tokens each: {n_bsteps} "
        f"batched steps in {b_secs:.2f} s ({card}), capacities "
        f"{sorted(set(caps))}; launches {b_counts}; expected {expect_b} "
        f"(112 W8A8 products, 28 of them after q80_act_quant, + a one-row "
        f"head per join's prefill; 113 W8A8 products, 28 act quants (wo), 57 "
        f"rms_norm_q80 and 28 swiglu_q80 writing the other 85's int8 rows, "
        f"and 28 attentions per batched step)")
    if b_counts != expect_b:
        raise AssertionError("batched launch counts differ from the per-step "
                             "counts")
    for name in ("q80_act_quant", "q80_matmul_w8a8", "decode_attention",
                 "rms_norm_q80", "swiglu_q80"):
        if b_counts[name] == 0:
            raise AssertionError(f"the batching path launched no {name}")
    if full_len and sorted(set(caps)) != [128, 256]:
        raise AssertionError("the cache did not grow 128 -> 256")
    for sl in order:
        be.release(sl)
    if be._cache_len() != 128:
        raise AssertionError("the cache did not reset when the engine went "
                             "idle")
    # B = 1: q80_matvec_fq; B = 8: the W8A8 pair
    first_logits_check(be, bctx, params, BATCH_TOL, "the same int8 decisions, "
                       "f32 sums in another order")

    # every slot's stream against its single stream.  They are equal up to
    # the first step d where they part, if they part; after d their
    # histories differ, so the two paths are compared on one history: each
    # slot's batched stream fed back a token a step through B = 8 (row s
    # stream s; the W8A8 pair) and through B = 1 (q80_matvec_fq), logits of
    # every step kept.  Checks: B = 1 reproduces the single stream up to d
    # (the same arithmetic); the drift max|l8 - l1|/max|l1| of each slot
    # stays below the single stream's own rounding error, its distance
    # from the same B = 1 path in f32 with no activation rounding (the
    # rows form); tokens agree wherever the B = 1 top-2 margin exceeds that
    # bound.  Two f32 witnesses fed the same history: the W8A8 path with
    # f32 activations and cache (only the int8 activation rounding left)
    # and the rows form (no activation rounding: only f32 sums in another
    # order), whose drift must stay below ROWS_DRIFT_TOL.
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

    def forced(fctx, fparams, B, feed, lens_prompts):
        """Logits (n, S, V) f32 of every step when the streams' tokens feed
        (n, S) are fed a step at a time after their prompts: in one forward
        of B = S rows (row s stream s) or, B = 1, each stream alone.  The
        step is a DecodeGraph (warm-up, capture, replays)."""
        n, S = feed.shape
        V = cfg.vocab_size
        rec = torch.empty((n, S, V), device=dev)
        c = fctx.new_cache(B)
        tok_ = torch.zeros((B,), dtype=torch.int64, device=dev)
        pos_ = torch.zeros((B,), dtype=torch.int32, device=dev)
        i_ = torch.zeros((1,), dtype=torch.int64, device=dev)
        col = torch.zeros((n, B), dtype=torch.int64, device=dev)
        out_ = torch.empty((n, B, V), device=dev)

        def step():
            tok_.copy_(col.index_select(0, i_)[0])
            lg, _ = gpt.forward_decode_batched(fparams, tok_, c, pos_, cfg,
                                               fctx.dtype, fctx.rope_tables())
            out_.index_copy_(0, i_, lg.float()[None])
            pos_.add_(1)
            i_.add_(1)

        graph = engine.DecodeGraph(step, dev, 1, None, fctx.graph_pool())
        groups = ([list(range(S))] if B == S else [[s_] for s_ in range(S)])
        with fctx.on_stream():
            for g in groups:
                for r, s_ in enumerate(g):
                    c1 = fctx.new_cache(1)
                    engine._prefill(fctx, lens_prompts[s_], c1)
                    for dst, src in zip(BatchedEngine._tensors(c),
                                        BatchedEngine._tensors(c1)):
                        dst[:, r] = src[:, 0]
                    pos_[r] = len(lens_prompts[s_])
                    col[:, r] = feed[:, s_]
                i_.zero_()
                for _ in range(n):
                    graph.run()
                rec[:, g] = out_
        torch.cuda.synchronize()
        del graph
        return rec

    def rel(a, b):
        return ((a - b).abs().amax(-1) / b.abs().amax(-1))     # (n, S)

    solos, parts = [], []
    for slot, pr in zip(order, joins):
        got = streams[slot]
        solo = engine.generate_on_device(bctx, pr, len(got)).tolist()
        solos.append(solo)
        parts.append(next((j for j, (a_, b_) in enumerate(zip(got, solo))
                           if a_ != b_), len(got)))
    n_f = min(len(streams[sl]) for sl in order) - 1
    feed = torch.tensor([streams[sl][:n_f] for sl in order], device=dev).t()
    f32ctx = engine.LLMContext(
        cfg=cfg, params=params, tokenizer=tok, max_seq_len=cfg.block_size,
        device=dev, dtype=torch.float32, sampler=greedy,
        stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")
    t0 = time.time()
    fed = {}
    for kind, fp in (("bf16", params), ("f32 W8A8", params),
                     ("f32 rows", rows_form(params))):
        fctx = bctx if kind == "bf16" else f32ctx
        l8 = forced(fctx, fp, BATCH_SLOTS, feed, joins)
        l1 = forced(fctx, fp, 1, feed, joins)
        top2 = l1.topk(2, dim=-1).values
        fed[kind] = dict(drift=rel(l8, l1), a8=l8.argmax(-1),
                         a1=l1.argmax(-1),
                         margin=(top2[..., 0] - top2[..., 1])
                         / l1.abs().amax(-1))
        del l8, top2
        if kind == "bf16":
            l1_bf16 = l1
        elif kind == "f32 rows":
            fed["bf16"]["noise"] = rel(l1_bf16, l1)
        del l1
        torch.cuda.empty_cache()
    del l1_bf16, f32ctx
    f_secs = time.time() - t0
    fb, fw, fr = fed["bf16"], fed["f32 W8A8"], fed["f32 rows"]
    want_next = feed[1:].t().cpu()          # (S, n_f - 1): what each fed
    drift_b, noise_b = fb["drift"].cpu(), fb["noise"].cpu()
    drift_w, drift_r = fw["drift"].cpu(), fr["drift"].cpu()
    a1_b, a8_b, margin_b = fb["a1"].cpu(), fb["a8"].cpu(), fb["margin"].cpu()
    failures = []
    for s_, (slot, d) in enumerate(zip(order, parts)):
        J = min(d, n_f)
        single_ok = a1_b[:J, s_].tolist() == solos[s_][1:J + 1]
        bound_ = noise_b[:, s_].max().item()
        sure = margin_b[:, s_] > bound_
        tok_ok = torch.equal(a8_b[sure, s_], a1_b[sure, s_])
        own = int((a8_b[:n_f - 1, s_] == want_next[s_]).sum())
        log(f"[batch] slot {slot}: parts from its single stream at step {d} "
            f"of {len(streams[slot])}; fed its batched stream for {n_f} "
            f"steps: B = 1 reproduces the single stream up to the parting "
            f"{single_ok}; drift max|l8 - l1|/max|l1| bf16 "
            f"{drift_b[:, s_].max().item():.3e} (bound: the B = 1 bf16 path "
            f"against its f32 rows form {bound_:.3e}), f32 W8A8 "
            f"{drift_w[:, s_].max().item():.3e}, f32 rows "
            f"{drift_r[:, s_].max().item():.3e} (tol {ROWS_DRIFT_TOL}); "
            f"tokens equal at the {int(sure.sum())} steps whose top-2 margin "
            f"exceeds the bound {tok_ok}; B = 8 gives the batched stream's "
            f"own next token at {own} of {n_f - 1} steps")
        if not single_ok:
            failures.append(f"slot {slot}: B = 1 fed the stream does not "
                            f"reproduce the single stream")
        if not drift_b[:, s_].max().item() <= bound_:
            failures.append(f"slot {slot}: the bf16 drift exceeds the single "
                            f"stream's rounding error")
        if not tok_ok:
            failures.append(f"slot {slot}: tokens differ where the margin "
                            f"exceeds the bound")
        if not drift_r[:, s_].max().item() <= ROWS_DRIFT_TOL:
            failures.append(f"slot {slot}: the rows-form drift exceeds "
                            f"ROWS_DRIFT_TOL")
    at = [j for j in (0, 15, 31, 63, 95, n_f - 1) if j < n_f]
    for kind, dr in (("bf16", drift_b), ("f32 W8A8", drift_w),
                     ("f32 rows", drift_r), ("bf16 vs f32 rows (B = 1)",
                                             noise_b)):
        log(f"[batch] drift {kind}, max over the slots after "
            + ", ".join(f"{j + 1}: {dr[j].max().item():.3e}" for j in at)
            + " steps fed")
    log(f"[batch] streams equal to their single streams for {parts} of "
        f"{[len(streams[sl]) for sl in order]} tokens; the fed comparison "
        f"took {f_secs:.1f} s ({card})")
    if failures:
        raise AssertionError("; ".join(failures))
    del fed, fb, fw, fr

    def throughput(ctx_, n_slots, model, per_step, profile=True):
        """Every slot decoding from a 32-token prompt: bursts of 16 replays
        timed, then (with `profile`) one profiled.  -> (ms per batched
        step, aggregate tok/s, idle share or None, profile_line's result
        or None)."""
        eng_ = BatchedEngine(ctx_, n_slots=n_slots)
        trng = np.random.default_rng(SEED + n_slots)
        for _ in range(n_slots):
            eng_.add(trng.integers(100, 30000, 32).tolist(),
                     max_new_tokens=10 ** 6, temperature=0.0,
                     repetition_penalty=1.0)
        eng_.step_burst(8)                      # warm-up step + capture
        torch.cuda.synchronize()
        t0_ = time.time()
        res = [eng_.step_burst(16) for _ in range(3)]
        secs = time.time() - t0_
        got = sum(len(v) for r in res for v in r.values())
        ms_step = secs * 1e3 / 48
        prof = None if not profile else profile_line(
            f"batch {n_slots}" if model == "Q80" else
            f"batch {model} {n_slots}", f"{n_slots} slots, bursts of 16 "
            f"graph replays", lambda: eng_.step_burst(16), 1, 16, ms_step,
            per_step)
        idle = None if prof is None else 1 - prof["busy"] / ms_step
        log(f"[batch] {n_slots} slots, Qwen3-0.6B {model}, positions 40-88 "
            f"({card}): {ms_step:.3f} ms per batched step, {got / secs:.1f} "
            f"tok/s aggregate ({got} tokens in {secs:.3f} s), idle share "
            + ("not measured" if idle is None else f"{idle:.3f}"))
        del eng_
        torch.cuda.empty_cache()
        return ms_step, got / secs, idle, prof

    def route_summary(label, n_slots, runs, new, old, what_new, what_old):
        """One line of a batched step through two routes in turns, the
        best of each route's runs, the busy time of its profiled run."""
        best = lambda rs: min(r[0] for r in rs)
        prof = lambda rs: next((r[3] for r in rs if r[3] is not None), None)
        pr = lambda p: ("not measured" if p is None else
                        f"busy {p['busy']:.3f} ms, {p['kernels']:.0f} "
                        f"kernels, other {p['other']:.3f} ms a step")
        log(f"[batch] {label}, {n_slots} slots ({card}), one call, the best "
            f"of {len(runs[new])} and {len(runs[old])} runs in turns: "
            f"{best(runs[new]):.3f} ms per batched step {what_new} "
            f"({pr(prof(runs[new]))}); {best(runs[old]):.3f} ms {what_old} "
            f"({pr(prof(runs[old]))})")

    q80_step = dict(q80_act_quant=28, q80_matmul_w8a8=113,
                    decode_attention=28, rms_norm_q80=57, swiglu_q80=28)
    for n_slots in (8, 64):
        runs = {"eager": [], "fused": []}
        for route in ("eager", "fused", "fused", "eager"):
            with norm_route(route):
                runs[route].append(throughput(
                    bctx, n_slots, "Q80" if route == "fused" else
                    "Q80, eager norms, SwiGLU and q80_act_quant",
                    q80_step if route == "fused" else eager_counts(q80_step),
                    profile=not runs[route]))
        route_summary("Q80", n_slots, runs, "fused", "eager",
                      "through rms_norm_q80 + swiglu_q80",
                      "through the eager ops and q80_act_quant")
        if n_slots == 8:                # beside phase 11's server
            batch_tok_s8 = max(r[1] for r in runs["fused"])
    del be, bctx

    # The Q4K model in BatchedEngine: the same joins, BATCH_NEW4 greedy
    # tokens each (the Q80 drive holds the cache growth); a batched step
    # runs its 112 Q4K products as q4k_act_quant + q4k_matmul_w4a4 and its
    # head (the Q4K fake-quant, then the Q80 head at B = slots) as
    # rms_norm_q4k_fq + the W8A8 pair
    bctx4 = engine.LLMContext(
        cfg=cfg, params=params4, tokenizer=tok, max_seq_len=cfg.block_size,
        device=dev, dtype=torch.bfloat16, sampler=greedy,
        stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")
    be4, streams4, order4, n_b4, _, b4_counts, b4_secs = join_drive(
        bctx4, BATCH_NEW4)
    expect_b4 = {n: 0 for n in names}
    expect_b4.update(q4k_act_quant=28 * (n_j + n_b4),
                     q4k_matmul_w4a4=112 * n_j + 112 * n_b4,
                     q80_matvec_fq=n_j,
                     q80_act_quant=n_b4, q80_matmul_w8a8=n_b4,
                     decode_attention=28 * n_b4,
                     rms_norm_q4k_fq=n_j + n_b4,
                     rms_norm_q4k=56 * (n_j + n_b4),
                     swiglu_q4k=28 * (n_j + n_b4))
    log(f"[batch] Qwen3-0.6B Q4K, {BATCH_SLOTS} slots, the same {n_j} joins, "
        f"{BATCH_NEW4} tokens each: {n_b4} batched steps in {b4_secs:.2f} s "
        f"({card}), streams of {[len(streams4[sl]) for sl in order4]} "
        f"tokens; launches {b4_counts}; expected {expect_b4} (112 "
        f"q4k_matmul_w4a4, wo's 28 after q4k_act_quant and a one-row head "
        f"per join's prefill; the same, a W8A8 pair head and 28 attentions "
        f"per batched step; 56 rms_norm_q4k, 28 swiglu_q4k and the final "
        f"rms_norm_q4k_fq, which fake-quantizes the head's row, per forward; "
        f"no q4k_fake_quant)")
    if b4_counts != expect_b4:
        raise AssertionError("Q4K batched launch counts differ from the "
                             "per-step counts")
    if b4_counts["q4k_fake_quant"] or not b4_counts["rms_norm_q4k_fq"]:
        raise AssertionError("the Q4K batching path ran q4k_fake_quant, or "
                             "no fused final norm")
    for name in ("q4k_act_quant", "q4k_matmul_w4a4", "decode_attention"):
        if b4_counts[name] == 0:
            raise AssertionError(f"the Q4K batching path launched no {name}")
    if not all(len(streams4[sl]) == BATCH_NEW4 for sl in order4):
        raise AssertionError("a Q4K batched stream ended early")
    for sl in order4:
        be4.release(sl)
    # B = 1: q4k_matvec_fq (f32 dequant dot); B = 8: the integer expansion
    first_logits_check(be4, bctx4, params4, Q4K_BATCH_TOL, "the same 4-bit "
                       "decisions, f32 sums in another order")
    # the same check on two faulty B > 1 paths: each must read above the
    # limit, or the check could not see such a fault
    controls = {}
    for route in ("unquantized_rows", "shifted_scales"):
        with k3_route(route):
            controls[route] = first_logits_rel(be4, bctx4, params4)
    log(f"[batch] the Q4K logits check's controls, worst max|d|/max|ref| "
        f"(limit {Q4K_BATCH_TOL:.3e}): B > 1 products without the "
        f"activation's quantization {controls['unquantized_rows']:.3e}, "
        f"with each row's sa, ba, c from the row before "
        f"{controls['shifted_scales']:.3e}")
    if not min(controls.values()) > Q4K_BATCH_TOL:
        raise AssertionError("the Q4K logits check passes a faulty B > 1 "
                             "path")
    del be4, streams4
    q4_step = dict(q4k_act_quant=28, q4k_matmul_w4a4=112, q80_act_quant=1,
                   q80_matmul_w8a8=1, decode_attention=28, rms_norm_q4k_fq=1,
                   rms_norm_q4k=56, swiglu_q4k=28)
    old_step = dict(q4k_fake_quant=113, q4k_matmul=112, q80_act_quant=1,
                    q80_matmul_w8a8=1, decode_attention=28, rms_norm_q80=57,
                    swiglu_q80=28)
    for n_slots in (8, 64):
        # in turns: the package's path, the pair K3 at B > 1 replaced, the
        # eager norms and SwiGLU (then q4k_act_quant on their output), the
        # package's path again
        runs = {"pair": [], "eager": [], None: []}
        for route in (None, "pair", "eager", None):
            with (k3_route(route) if route == "pair" else
                  norm_route(route or "fused")):
                runs[route].append(throughput(
                    bctx4, n_slots, {None: "Q4K", "pair": "Q4K, K3 at B > 1 "
                                     "as q4k_fake_quant + q4k_matmul",
                                     "eager": "Q4K, eager norms and SwiGLU"
                                     }[route],
                    old_step if route == "pair" else
                    eager_counts(q4_step) if route == "eager" else q4_step,
                    profile=not runs[route]))
        route_summary("Q4K", n_slots, runs, None, "pair",
                      "through the Q4K form and q4k_matmul_w4a4",
                      "through the pair it replaced")
        route_summary("Q4K", n_slots, runs, None, "eager",
                      "through rms_norm_q4k + swiglu_q4k (the Q4K form)",
                      "through the eager norm ops, SwiGLU and q4k_act_quant")
    del bctx4

    # §6 rows: the kernels of one batched step at 8 and 64 slots beside one
    # library call and the bound
    prods = [wl for _, w in shapes for wl in layer_weights(w)]
    wds = [wl.dequantize(torch.bfloat16) for wl in prods]
    for B in (8, 64):
        xs = [torch.randn(B, wl.in_dim, device=dev, generator=gen
                          ).to(torch.bfloat16) for wl in prods]

        qs = [qmatmul.act_quant_q80_plain(x, GS) for x in xs]

        def run_pair_b():
            for x, wl in zip(xs, prods):
                qmatmul.q80_w8a8(*qmatmul.act_quant_q80(x, GS), wl,
                                 torch.bfloat16)

        def run_w8a8_b():
            for (xq, sa), wl in zip(qs, prods):
                qmatmul.q80_w8a8(xq, sa, wl, torch.bfloat16)

        def run_lib_b():
            for x, wd in zip(xs, wds):
                torch.matmul(x, wd.t())

        k_ms, m_ms, l_ms = timer(run_pair_b), timer(run_w8a8_b), timer(run_lib_b)
        nb = sum(wl.q.numel() + 4 * wl.scales.numel()
                 + 2 * B * (wl.in_dim + wl.out_dim) for wl in prods)
        b_ms, b_by = bound(nb, sum(2 * B * wl.q.numel() for wl in prods),
                           INT8_OPS_PER_S)
        log(f"[batched kernels] B={B}: W8A8 pair (q80_act_quant + "
            f"q80_matmul_w8a8 on the int8 tensor cores, {len(prods)} launches "
            f"each, a step's products and the head): {k_ms:.4f} ms, "
            f"q80_matmul_w8a8 alone {m_ms:.4f} ms; bf16 torch.matmul on "
            f"weights dequantized ahead {l_ms:.4f} ms (pair / library "
            f"{k_ms / l_ms:.2f}); bound {b_ms:.4f} ms ({b_by}, "
            f"{nb / 1e6:.1f} MB); {card}")
        del xs, qs
    del wds

    T_b = 256
    for B in (8, 64):
        caches = [(torch.randn(B, T_b, KV, D, device=dev, generator=gen
                               ).to(torch.bfloat16),
                   torch.randn(B, T_b, KV, D, device=dev, generator=gen
                               ).to(torch.bfloat16)) for _ in range(L)]
        qs = [torch.randn(B, H, D, device=dev, generator=gen
                          ).to(torch.bfloat16) for _ in range(L)]
        pos_b = torch.randint(T_b // 4, T_b, (B,), dtype=torch.int32,
                              device=dev, generator=gen)
        tr = [(k_.transpose(1, 2).contiguous(), v_.transpose(1, 2).contiguous())
              for k_, v_ in caches]
        amask = (torch.arange(T_b, device=dev)[None, :]
                 <= pos_b[:, None].long())[:, None, None, :]
        for i in range(2):
            out = decode_attn.decode_attention(qs[i], *caches[i], None, None,
                                               pos_b, KV, H // KV)
            ref = decode_attn.decode_attention_plain(qs[i], *caches[i], None,
                                                     None, pos_b, KV, H // KV)
            if not torch.allclose(out, ref, rtol=2e-5, atol=2e-5):
                raise AssertionError(f"decode_attention B={B} off")

        def run_k2_b():
            for q_, (k_, v_) in zip(qs, caches):
                decode_attn.decode_attention(q_, k_, v_, None, None, pos_b,
                                             KV, H // KV).to(torch.bfloat16)

        def run_sdpa_b():
            for q_, (k_, v_) in zip(qs, tr):
                F.scaled_dot_product_attention(q_[:, :, None, :], k_, v_,
                                               attn_mask=amask,
                                               enable_gqa=True)

        k_ms, l_ms = timer(run_k2_b), timer(run_sdpa_b)
        rows_read = int((pos_b.long() + 1).sum())
        b_ms, b_by = bound(L * (rows_read * KV * D * 2 * 2 + B * H * D * 4),
                           L * 4 * rows_read * H * D, F32_OPS_PER_S)
        log(f"[batched kernels] B={B}: decode_attention ({L} launches, bf16 "
            f"cache T={T_b}, positions {T_b // 4}-{T_b - 1} a row, bf16 q, "
            f"result cast) {k_ms:.4f} ms; SDPA(enable_gqa, a mask a row) "
            f"{l_ms:.4f} ms; ratio {k_ms / l_ms:.2f}; bound {b_ms:.4f} ms "
            f"({b_by}); {card}")
        del caches, tr, qs

    # K3 at B > 1 over a batched step's 112 layer products at 8 and 64
    # slots (at 64 also a 64-token prefill's)
    prods4 = [(name, wl) for name in ("wqkv", "wo", "w13", "w2")
              for wl in layer_weights(params4["blocks"][name])]
    for B in (8, 64):
        k3_batched_times(torch, prods4, B, "batched kernels", f"B={B}, Q4K "
                         f"(a step's layer products)")
    del prods4, prods
    torch.cuda.empty_cache()

    # ---------------- 5c. speculative decode ----------------
    log(f"[time] phase 5c starts at {time.time() - t_start:.1f} s")
    t0 = time.time()
    spec_phase(torch, np, SimpleNamespace(
        dev=dev, cfg=cfg, card=card, prompt=prompt, names=names, reset=reset,
        read=read, profile_line=profile_line, timed_ms=timed_ms,
        models=[("Q80", params, expect80), ("Q4K", params4, expect4)],
        ctx_kw=dict(cfg=cfg, tokenizer=tok, max_seq_len=cfg.block_size,
                    device=dev, dtype=torch.bfloat16, sampler=greedy,
                    stop_tokens=QWEN_STOP_TOKENS, arch="qwen3")))
    log(f"[spec] phase 5c in {time.time() - t0:.1f} s")
    t0 = time.time()
    trained_toy_phase(torch, np, SimpleNamespace(
        dev=dev, card=card, reset=reset, read=read,
        work=os.path.join(ROOT, "build", "smoke_toy")))
    log(f"[toy] phase 5c on the trained toy in {time.time() - t0:.1f} s")

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
            row = start
            if S > 1:
                j = torch.arange(start + S, device=d)[None, :]
                seen = j <= start + torch.arange(S, device=d)[:, None]
                mask = torch.where(seen, 0.0, -float("inf"))
            else:
                # decode: the position on the device, and the cache row
                # (batch row 0) it writes
                pos_t = torch.full((1,), start, dtype=torch.int32, device=d)
                row = pos_t.long()
            per_dev.append((p, cos, sin, mask, pos_t, row))
        attn_len = start + S if S > 1 else None
        for i in range(L):
            outs = []
            for (p, cos, sin, mask, pos_t, row), c, x in zip(
                    per_dev, caches, (h, h.cpu())):
                outs.append(gpt.block(
                    x, gpt.layer_params(p["blocks"], i), cfg, cos, sin, mask,
                    f32, c.layer(i), row, pos_t, attn_len))
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
            with contextlib.nullcontext() if fq_on else k3_route("unquantized"):
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
    # phase 8 serves the two models again: kept on the host meanwhile
    q80_host = params_to(params, "cpu")
    del params
    logits_checks("Q4K", params4,
                  [("Q4K with activation fake-quant", same, True, 1 / 15),
                   ("Q4K without activation fake-quant, rows-form head",
                    rows_form, False, 1e-4)], out4)

    q4k_host = params_to(params4, "cpu")
    del params4
    torch.cuda.empty_cache()

    # ---------------- 6. training ----------------
    log(f"[time] phase 6 starts at {time.time() - t_start:.1f} s")
    work = os.path.join(ROOT, "build", "smoke_train")
    os.makedirs(work, exist_ok=True)
    tok_path = os.path.join(ROOT, "tokenizer", "nano_16384.json")
    ttok = TrieTokenizer.from_file(tok_path)
    with open(os.path.join(ROOT, "dataset", "pretrain_sample.txt"),
              encoding="utf-8") as f:
        sample = f.read()
    t0 = time.time()
    train_p, val_p, n_copies, n_blocks = pretrain_corpus(ttok, tcfg, work)
    log(f"[train] corpus: dataset/pretrain_sample.txt x {n_copies} -> "
        f"{n_blocks} blocks of {tcfg.block_size + 1} tokens in "
        f"{time.time() - t0:.1f} s")
    if n_blocks < 1024:
        raise AssertionError("corpus gave fewer than 1024 blocks")

    with open(os.path.join(ROOT, "config", "pretrain.json")) as f:
        train_cfg = json.load(f)
    train_cfg.update(dataset_path=[[train_p, val_p]], tokenizer_path=tok_path,
                     save_checkpoint_to=work, warmup_iters=4,
                     eval_interval=TRAIN_EVAL_AT, eval_iters=1)
    A = train_cfg["gradient_accumulation_steps"]
    tokens_per_step = train_cfg["batch_size"] * A * tcfg.block_size
    trainer = Trainer(tcfg, train_cfg, max_steps=TRAIN_STEPS)
    trainer.init()
    trainer.load_data()
    if trainer.device.type != "cuda":
        raise AssertionError("the trainer did not take the card")
    step_ms = []
    plain_step = trainer._train_step

    def timed_step(xs, ys, ms):
        torch.cuda.synchronize()
        t_step = time.time()
        loss = plain_step(xs, ys, ms)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t_step) * 1e3)
        return loss

    trainer._train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    reset()
    trainer.start()
    counts = read()
    wg_calls = read_launches(torch, WGMMA_COUNTERS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [l for _, l in trainer.loss_history]
    n_eval_fwd = 2 * train_cfg["eval_iters"] * TL * (
        (TRAIN_STEPS - 1) // TRAIN_EVAL_AT)
    expect_t = {n: 0 for n in names}
    expect_t.update(flash_attn_fwd=TL * A * TRAIN_STEPS + n_eval_fwd,
                    flash_attn_bwd=TL * A * TRAIN_STEPS)
    log(f"[train] launches {counts}; expected {expect_t} ({TL} forward and "
        f"{TL} backward per microbatch, {n_eval_fwd} eval forwards)")
    if counts != expect_t:
        raise AssertionError("training launch counts differ from 24 per "
                             "microbatch, forward and backward")
    log(f"[train] calls through the wgmma kernels: forward "
        f"{wg_calls['flash_attn_fwd_wgmma']} of {counts['flash_attn_fwd']}, "
        f"backward {wg_calls['flash_attn_bwd_wgmma']} of "
        f"{counts['flash_attn_bwd']}")
    if (wg_calls["flash_attn_fwd_wgmma"] != counts["flash_attn_fwd"]
            or wg_calls["flash_attn_bwd_wgmma"] != counts["flash_attn_bwd"]):
        raise AssertionError("the training step's attention did not take the "
                             "wgmma kernels")
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        kernels[name]["launches"] = counts[name]
    steady = sorted(step_ms[2:])
    ms_step = steady[len(steady) // 2]
    fell = losses[0] - sum(losses[-3:]) / 3
    log(f"[train] Nano-168M, {TL} layers, batch {train_cfg['batch_size']} x "
        f"{tcfg.block_size}, bf16, remat {train_cfg['remat_policy']!r}, on "
        f"{card}: median {ms_step:.1f} ms/step over steps 3-{TRAIN_STEPS} "
        f"(first {step_ms[0]:.1f}), {tokens_per_step / ms_step * 1e3:.0f} "
        f"tokens/s, {trainer.flop_per_token * tokens_per_step / ms_step / 1e6:.1f} "
        f"GFLOP/s by the trainer's formula, peak memory {peak_gb:.2f} GB")
    log(f"[train] losses {[round(l, 4) for l in losses]}; first - mean of "
        f"last three = {fell:.3f} (must be >= 1.0; first within 0.3 of "
        f"ln {tcfg.vocab_size} = {np.log(tcfg.vocab_size):.3f})")
    if not (len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
            and abs(losses[0] - np.log(tcfg.vocab_size)) <= 0.3
            and fell >= 1.0):
        raise AssertionError("the training losses are not what a model that "
                             "learns gives")
    ckpt = os.path.join(work, "checkpoint.npz")
    ckpt12 = os.path.join(work, "step12.npz")
    if not os.path.exists(ckpt):
        raise AssertionError("no checkpoint written")
    os.replace(ckpt, ckpt12)

    # the run that did not stop takes step 13; a second Trainer resumed
    # from the step-12 checkpoint (data stream replayed) takes it too
    trainer.max_steps = TRAIN_STEPS + 1
    trainer.start()
    resumed = Trainer(tcfg, dict(train_cfg, from_checkpoint=ckpt12),
                      max_steps=TRAIN_STEPS + 1, is_continued_pretrain=True,
                      ckpt_filename="resumed.npz")
    resumed.init()
    resumed.load_data()
    resumed.start()
    os.remove(os.path.join(work, "resumed.npz"))
    os.remove(ckpt)
    a, b = trainer.loss_history[-1], resumed.loss_history[-1]
    log(f"[train] step {a[0]} loss: the run that did not stop {a[1]!r}, "
        f"resumed from the checkpoint {b[1]!r} (must be equal)")
    if not (a[0] == b[0] == TRAIN_STEPS + 1 and a[1] == b[1]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(
                gpt.param_leaves(trainer.params),
                gpt.param_leaves(resumed.params)))):
        raise AssertionError("the resumed run left the trajectory")
    del resumed
    torch.cuda.empty_cache()

    # where a training step's time goes
    from torch.profiler import ProfilerActivity, profile
    xs, ys, ms = trainer._get_accum_batch()
    plain_step(xs, ys, ms)      # refills the allocator's cache emptied above
    torch.cuda.synchronize()
    t0 = time.time()
    plain_step(xs, ys, ms)      # the same batch with the profiler off
    torch.cuda.synchronize()
    bare_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        plain_step(xs, ys, ms)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    groups = {"K4 forward": 0.0, "K4 backward": 0.0, "matmuls": 0.0,
              "other": 0.0}
    others, n_kernels = {}, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us_ = getattr(e, "self_device_time_total", 0.0)
        n_kernels += e.count
        if "flash_fwd" in e.key:
            key = "K4 forward"
        elif "flash_bwd" in e.key or "flash_delta" in e.key:
            key = "K4 backward"
        elif any(x in e.key for x in ("gemm", "cutlass", "nvjet", "xmma",
                                      "cublas")):
            key = "matmuls"
        else:
            key = "other"
            others[e.key] = others.get(e.key, 0.0) + us_ / 1e3
        groups[key] += us_ / 1e3
    busy_ms = sum(groups.values())
    if busy_ms > 0:
        top = sorted(others.items(), key=lambda kv: -kv[1])[:5]
        # the profiler itself slows the host, so the idle share is taken
        # against the same batch's step timed just before with it off; not
        # clamped, so a busy time above that step shows as a negative share
        log(f"[profile train] one step ({card}): card busy (profiled) "
            f"{busy_ms:.1f} ms of the same batch's {bare_ms:.1f} ms step "
            f"with the profiler off, idle share {1 - busy_ms / bare_ms:.3f} "
            f"(wall with the profiler on {wall_ms:.1f} ms, median step "
            f"{ms_step:.1f} ms), {n_kernels} kernels; busy ms: "
            + ", ".join(f"{k} {v:.1f}" for k, v in groups.items())
            + "; largest of other: "
            + ", ".join(f"{k[:48]} {v:.1f}" for k, v in top))
    else:
        log("[profile train] the profiler recorded no device time: not "
            "measured")
    del trainer, prof
    torch.cuda.empty_cache()

    # Nano-56M (config/model_56m.json: 16 layers, width 512, 16/8 heads of
    # 32) under config/pretrain_56m.json (batch 64 x 512, bf16, remat true)
    # on the same corpus, warmup cut to 1 step so that 3 steps show the
    # loss falling: every attention through K4 at D = 32, forward again for
    # each layer in the backward (full remat recomputes the block)
    cfg56 = ModelConfig.from_json(os.path.join(ROOT, "config", "model_56m.json"))
    with open(os.path.join(ROOT, "config", "pretrain_56m.json")) as f:
        train56 = json.load(f)
    work56 = os.path.join(work, "56m")
    train56.update(dataset_path=[[train_p, val_p]], tokenizer_path=tok_path,
                   save_checkpoint_to=work56, warmup_iters=1, log_interval=1)
    steps56 = 3
    t56 = Trainer(cfg56, train56, max_steps=steps56)
    t56.init()
    t56.load_data()
    full56 = gpt._remat_mode(t56._remat()) == "full"
    reset()
    t0 = time.time()
    t56.start()
    torch.cuda.synchronize()
    secs56 = time.time() - t0
    counts = read()
    wg56 = read_launches(torch, WGMMA_COUNTERS)
    L56, A56 = cfg56.n_layer, train56["gradient_accumulation_steps"]
    expect56 = {n: 0 for n in names}
    expect56.update(flash_attn_fwd=L56 * A56 * steps56 * (2 if full56 else 1),
                    flash_attn_bwd=L56 * A56 * steps56)
    losses56 = [l for _, l in t56.loss_history]
    log(f"[train] Nano-56M, {L56} layers, width {cfg56.n_embd}, heads of "
        f"{cfg56.head_dim}, batch {train56['batch_size']} x {cfg56.block_size}, "
        f"bf16, remat {t56._remat()!r}, on {card}: {steps56} steps in "
        f"{secs56:.2f} s with a checkpoint, losses "
        f"{[round(l, 4) for l in losses56]} (first within 0.3 of ln "
        f"{cfg56.vocab_size} = {np.log(cfg56.vocab_size):.3f}, last below "
        f"first); launches {counts}; expected {expect56}")
    if (counts != expect56
            or wg56["flash_attn_fwd_wgmma"] != counts["flash_attn_fwd"]
            or wg56["flash_attn_bwd_wgmma"] != counts["flash_attn_bwd"]):
        raise AssertionError("Nano-56M launch counts differ from one forward "
                             "(two under full remat) and one backward per "
                             "layer and microbatch, or its attention did not "
                             "take the wgmma kernels")
    if not (len(losses56) == steps56 and all(np.isfinite(losses56))
            and abs(losses56[0] - np.log(cfg56.vocab_size)) <= 0.3
            and losses56[-1] < losses56[0]):
        raise AssertionError("the Nano-56M losses are not what a model that "
                             "learns gives")
    shutil.rmtree(work56)
    del t56
    torch.cuda.empty_cache()

    # one f32 step at full width (4 layers, batch 2 x 512) on the card
    # against the same step on the CPU through the plain versions.  Same
    # f32 arithmetic, sums in other orders (a 16384-way softmax, width-768
    # dots, K4's tiles): loss within 1e-4 relative, every parameter's
    # gradient within 1e-3 of its max|grad|.
    cfg4 = replace(tcfg, n_layer=4)
    cpu_params = gpt.init_params(torch.Generator().manual_seed(SEED), cfg4,
                                 device="cpu")
    gpu_params = gpt.map_leaves(
        lambda t_: t_.detach().to(dev).requires_grad_(True), cpu_params)
    x, y, m = DataLoader([train_p], seed=SEED).get_batch(2, tcfg.block_size)
    step_loss = {}
    for tag, d, p in (("cpu", "cpu", cpu_params), ("card", dev, gpu_params)):
        to = lambda arr: torch.from_numpy(np.ascontiguousarray(arr)).to(
            d, torch.int64)
        n0 = flash_attn.flash_attention.launches
        loss = gpt.loss_fn(p, to(x), to(y), to(m), cfg4, dtype=torch.float32,
                           remat="ffn")
        loss.backward()
        step_loss[tag] = loss.item()
        if (flash_attn.flash_attention.launches - n0
                != (cfg4.n_layer if tag == "card" else 0)):
            raise AssertionError("K4 ran where it should not, or did not "
                                 "where it should")
    rel = abs(step_loss["card"] - step_loss["cpu"]) / abs(step_loss["cpu"])
    worst, worst_name = 0.0, ""
    for (name, c), (_, g) in zip(gpt.param_leaves(cpu_params),
                                 gpt.param_leaves(gpu_params)):
        r = ((g.grad.cpu() - c.grad).abs().max() / c.grad.abs().max()).item()
        if r > worst:
            worst, worst_name = r, name
    log(f"[train] one f32 step, 4 layers, batch 2 x {tcfg.block_size}, card "
        f"(kernels) vs CPU (plain): loss {step_loss['card']:.6f} vs "
        f"{step_loss['cpu']:.6f}, relative {rel:.2e} (tol 1e-4); largest "
        f"gradient difference over max|grad| {worst:.2e} at {worst_name} "
        f"(tol 1e-3)")
    if not (rel <= 1e-4 and worst <= 1e-3):
        raise AssertionError("the f32 step on the card disagrees with the "
                             "plain versions on the CPU")
    del cpu_params, gpu_params

    # ---------------- 7. export and import ----------------
    log(f"[time] phase 7 starts at {time.time() - t_start:.1f} s")
    t0 = time.time()
    nano_ids = ttok.encode(sample)
    res7 = export_phase(torch, np, SimpleNamespace(
        dev=dev, card=card, names=names, reset=reset, read=read, timer=timer,
        ckpt=ckpt12, qcfg=cfg, qwen_prompt=prompt,
        work=os.path.join(ROOT, "build", "smoke_export"),
        nano_prompt=nano_ids[:EXPORT_PROMPT],
        nano_control_prompt=nano_ids[1000:1000 + EXPORT_PROMPT]))
    # the rows form's JSON rows (phase 7b's GGUF model): q80_matvec_rows
    # over a decode step's 113 launches, q80_matmul_rows over a 64-token
    # prefill's 112 products, the warp-a-row kernel (their "before") over the
    # decode step; library: f32 torch.matmul (TF32 off) on weights
    # dequantized ahead, the one PyTorch call of the same function
    for name, case, key in (("q80_matvec_rows", "decode step", "new"),
                            ("q80_matmul_rows", "64-token prefill", "new"),
                            ("q80_matmul_rows_warp", "decode step", "old")):
        t = res7["times"][case]
        kernels[name].update(
            launches=res7["launches"].get(name, 0), ms=min(t[key]),
            plain_ms=t["plain"], library_ms=t["f32"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1])
    log(f"[export] phase 7 in {time.time() - t0:.1f} s")

    # ---------------- 8. LoRA ----------------
    log(f"[time] phase 8 starts at {time.time() - t_start:.1f} s")
    t0 = time.time()
    res8 = lora_phase(torch, np, SimpleNamespace(
        dev=dev, card=card, names=names, reset=reset, read=read, cfg=cfg,
        tok=tok, prompt=prompt,
        base80=out80, q80=q80_host, q4k=q4k_host, gctx=res7.pop("gctx"),
        tcfg=tcfg, ckpt=ckpt12, train_cfg=train_cfg, full_ms=ms_step,
        nano_prompt=nano_ids[:EXPORT_PROMPT],
        work=os.path.join(ROOT, "build", "smoke_lora")))
    del q4k_host
    lora_path = res8["launches"]
    log(f"[lora] launches on the LoRA paths (phase 8's driven runs, each "
        f"counted from 0): {lora_path}")
    for name in ("q80_act_quant", "q80_matmul_w8a8", "q80_matvec_fq",
                 "decode_attention", "rms_norm_q80", "swiglu_q80",
                 "q4k_act_quant", "q4k_matmul_w4a4", "rms_norm_q4k_fq",
                 "q4k_matvec_fq", "q80_matvec_rows", "q80_matmul_rows",
                 "flash_attn_fwd", "flash_attn_bwd"):
        if lora_path[name] == 0:
            raise AssertionError(f"the LoRA paths launched no {name}")
    if lora_path["q4k_fake_quant"]:
        raise AssertionError("the LoRA paths launched q4k_fake_quant")
    log(f"[lora] phase 8 in {time.time() - t0:.1f} s")

    # ---------------- 9. training lifecycle ----------------
    log(f"[time] phase 9 starts at {time.time() - t_start:.1f} s")
    t0 = time.time()
    lifecycle_phase(torch, np, SimpleNamespace(
        dev=dev, card=card, names=names, reset=reset, read=read, ckpt=ckpt12,
        pretrain_data=[[train_p, val_p]],
        toy_dir=os.path.join(ROOT, "build", "smoke_toy"), qcfg=cfg,
        q80=q80_host, work=os.path.join(ROOT, "build", "smoke_lifecycle")))
    os.remove(ckpt12)
    log(f"[lifecycle] phase 9 in {time.time() - t0:.1f} s")

    # ---------------- 10. parallel ----------------
    log(f"[time] phase 10 starts at {time.time() - t_start:.1f} s")
    t0 = time.time()
    torch.cuda.empty_cache()
    work10 = os.path.join(ROOT, "build", "smoke_parallel")
    res10 = parallel_phase(torch, np, SimpleNamespace(
        dev=dev, card=card, names=names, prompt=prompt, qwen=QWEN3_06B,
        tokens=PAR_TOKENS, nccl_tokens=PAR_NCCL_TOKENS, layers=PAR_LAYERS,
        batch=PAR_BATCH,
        train_data=[[train_p, val_p]], work=work10))
    shutil.rmtree(work10)
    # K4's offset form on its main path: rank 0's launches in 10d's
    # counted steps (rank 1's are the same, asserted)
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        kernels[name + "_offset"]["launches"] = res10["seq"]["counts"][name]
        if not res10["seq"]["counts"][name]:
            raise AssertionError(f"sequence parallelism launched no {name}")
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        if (res10["seq"]["counts"][name + "_wgmma"]
                != res10["seq"]["counts"][name]):
            raise AssertionError(f"sequence parallelism's {name} did not "
                                 f"take the wgmma kernel")
    log(f"[parallel] 10d's rank through the wgmma kernels: forward "
        f"{res10['seq']['counts']['flash_attn_fwd_wgmma']} of "
        f"{res10['seq']['counts']['flash_attn_fwd']}, backward "
        f"{res10['seq']['counts']['flash_attn_bwd_wgmma']} of "
        f"{res10['seq']['counts']['flash_attn_bwd']}")
    log(f"[parallel] phase 10 in {time.time() - t0:.1f} s")

    # ---------------- 11. frontends ----------------
    log(f"[time] phase 11 starts at {time.time() - t_start:.1f} s")
    t0 = time.time()
    torch.cuda.empty_cache()
    work11 = os.path.join(ROOT, "build", "smoke_frontends")
    os.makedirs(work11, exist_ok=True)
    res11 = frontend_phase(torch, np, SimpleNamespace(
        dev=dev, card=card, names=names, reset=reset, read=read, cfg=cfg,
        q80=params_to(q80_host, dev), tok=tok, prompt=prompt,
        toy_dir=os.path.join(ROOT, "build", "smoke_toy"),
        gguf=res7["gguf"], qbin=res7["qbin"], batch_tok_s=batch_tok_s8,
        work=work11))
    del q80_host
    shutil.rmtree(work11)
    for path in (res7["gguf"], res7["qbin"]):
        os.remove(path)
    for name in ("q80_act_quant", "q80_matmul_w8a8", "q80_matvec_fq",
                 "decode_attention", "rms_norm_q80", "swiglu_q80",
                 "q80_matvec_rows", "q80_matmul_rows"):
        if res11["launches"][name] == 0:
            raise AssertionError(f"the frontends launched no {name}")
    log(f"[frontends] phase 11 in {time.time() - t0:.1f} s")

    # ---------------- result ----------------
    for k in kernels.values():
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"):
            if k[key] is not None:
                k[key] = float(k[key])
        lib_ms = ("none" if k["library_ms"] is None
                  else f"{k['library_ms']:.4f} ms")
        per = ("training" if k["name"].startswith("flash_attn") else
               "prefill" if k["name"] in ("q80_act_quant", "q80_matmul_w8a8",
                                          "q4k_act_quant", "q4k_matmul_w4a4")
               else "64-row step" if k["name"] in ("rms_norm_q80",
                                                   "swiglu_q80", "rms_norm_q4k",
                                                   "swiglu_q4k")
               else "GGUF prefill" if k["name"] == "q80_matmul_rows"
               else "decode")
        off = "" if k["main_path"] else " (on no main path)"
        log(f"[summary] {k['name']}: {k['launches']} launches{off}, max_abs_err "
            f"{k['max_abs_err']:.3e}; per {per} {k['ms']:.4f} ms, plain "
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
    sys.exit(bench(sys.argv[2:]) if sys.argv[1:2] == ["bench"] else main())
