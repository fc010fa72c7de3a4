"""The launch counters of the hand-written kernels, read and set together.

Every kernel wrapper adds one to its own counter (``<wrapper>.launches``,
and ``flash_attention.backward_launches``) where it launches its kernel.
A CUDA graph replays launches without running that Python, so whoever
replays one (``infer.engine.DecodeGraph``) adds what its capture counted,
and takes back what the capture itself added: capturing records launches
but runs none.
"""

from __future__ import annotations

from typing import Dict, Tuple

from nano_tpu_torch.ops import decode_attn, flash_attn, norm_quant, q4k, qmatmul

# (module, wrapper, counter attribute)
COUNTERS: Tuple[Tuple[object, str, str], ...] = (
    (qmatmul, "act_quant_q80", "launches"),
    (qmatmul, "q80_w8a8", "launches"),
    (qmatmul, "q80_matmul_rows", "launches"),
    (qmatmul, "q80_matvec_rows", "launches"),
    (qmatmul, "q80_matmul_rows_warp", "launches"),
    (qmatmul, "q80_matvec_fq", "launches"),
    (norm_quant, "rms_norm_q80", "launches"),
    (norm_quant, "swiglu_q80", "launches"),
    (norm_quant, "rms_norm_q4k", "launches"),
    (norm_quant, "rms_norm_q4k_fq", "launches"),
    (norm_quant, "swiglu_q4k", "launches"),
    (decode_attn, "decode_attention", "launches"),
    (q4k, "fake_quant_act", "launches"),
    (q4k, "q4k_matmul_f32", "launches"),
    (q4k, "q4k_matvec_fq", "launches"),
    (q4k, "act_quant_q4k_packed", "launches"),
    (q4k, "q4k_matmul_w4a4", "launches"),
    (flash_attn, "flash_attention", "launches"),
    (flash_attn, "flash_attention", "forward_wgmma_launches"),
    (flash_attn, "flash_attention", "backward_launches"),
    (flash_attn, "flash_attention", "wgmma_launches"),
)


def counts() -> Dict[Tuple[str, str], int]:
    """{(wrapper, attribute): count} of every kernel wrapper."""
    return {(fn, attr): getattr(getattr(mod, fn), attr)
            for mod, fn, attr in COUNTERS}


def add(delta: Dict[Tuple[str, str], int], times: int = 1) -> None:
    """Add `times` x `delta` to the counters."""
    for mod, fn, attr in COUNTERS:
        n = delta.get((fn, attr), 0)
        if n:
            w = getattr(mod, fn)
            setattr(w, attr, getattr(w, attr) + times * n)


def restore(saved: Dict[Tuple[str, str], int]) -> None:
    """Set every counter back to `saved`."""
    for mod, fn, attr in COUNTERS:
        setattr(getattr(mod, fn), attr, saved[(fn, attr)])
