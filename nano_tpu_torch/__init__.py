"""nano_tpu_torch — the PyTorch/CUDA port of nano_tpu for NVIDIA Hopper.

The package mirrors ``nano_tpu``'s subpackages and module names so each
piece has an obvious counterpart, but it imports neither ``jax`` nor any
module of ``nano_tpu``: what it needs from there it keeps as its own copy.

  config     — ModelConfig and TrainConfig dataclasses (JSON-compatible)
  tokenizer  — trie tokenizer (Nano) and byte-level BPE (Qwen)
  data       — corpus preprocessing: raw text -> packed token shards
  io         — .bin model reader and writer (F32 / Q80 / Q4K), GGUF
               (io.gguf), HF safetensors (io.qwen) and reference .pt
               (io.pt_import) import, io.checkpoint (.npz training
               checkpoints, params interchangeable with the JAX
               package's), JAX-params bridge for tests
  export     — ``python -m nano_tpu_torch.export``: the root export.py's
               conversions
  ops        — hand-written CUDA kernels (Q80 matmul, decode attention,
               Q4K activation fake-quant and fused-dequant matmul,
               ops.flash_attn: causal GQA flash attention, forward and
               backward) with their plain PyTorch versions, samplers
  models     — GPT forward with a KV cache (prefill + decode) and the
               full-sequence training forward, loss and init
  infer      — LLMContext (from_bin / from_checkpoint / from_gguf) /
               Session / generate_sync / generate_on_device;
               the decode step captured as a CUDA graph and replayed;
               ``python -m nano_tpu_torch.infer``, the REPL
  observe    — per-phase taps of the forward (callback or summary rows)
               and a torch.profiler trace
  serve      — continuous batching (BatchedEngine) and the frontends:
               WebSocket, OpenAI HTTP, the model gateway, the voice
               bridge and the ASR FIFO server
  train      — DataLoader, AdamW, Trainer; ``python -m nano_tpu_torch.train``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
A CUDA tensor always goes through the hand-written kernel; only tensors
on the CPU take the plain PyTorch versions.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# The f32 mode is the value oracle: its matmuls must run true f32.  TF32
# keeps ~10 mantissa bits and flips near-tie argmaxes on small models
# (the JAX package needed Precision.HIGHEST for the same reason).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from nano_tpu_torch.config import ModelConfig  # noqa: E402

__version__ = "0.1.0"
__all__ = ["ModelConfig", "resolve_device", "__version__"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  Without a GPU and without an explicit request this
    raises — the port never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nano_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
