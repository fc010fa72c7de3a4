"""Export checkpoints to the self-contained .bin format, and convert
between .bin, GGUF and reference .pt files.

The counterpart of the repository's root ``export.py``, with the same
arguments, output bytes and messages:

    python -m nano_tpu_torch.export out.bin --checkpoint ckpt.npz   # F32
    python -m nano_tpu_torch.export out.bin --quant ckpt.npz        # Q80
    python -m nano_tpu_torch.export out.bin --q4k ckpt.npz          # Q4K
    python -m nano_tpu_torch.export out.bin --lora lora_ckpt.npz    # LoRA sidecar
    python -m nano_tpu_torch.export out.bin --checkpoint ref.pt     # reference .pt
    python -m nano_tpu_torch.export out.bin --repack model.bin [--to q4k|q80|f32]
    python -m nano_tpu_torch.export out.bin --from-gguf model.gguf [--to q80]
    python -m nano_tpu_torch.export out.gguf --to-gguf qwen.bin [--to q8_0]

``--merge-lora adapter`` (a LoRA .npz checkpoint or .bin sidecar) folds
the adapter into the base weights of a --checkpoint / --quant / --q4k
.npz export first.  The .bin embeds the checkpoint's tokenizer.
Everything here runs on the host; no device is needed.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Nano .bin exporter")
    ap.add_argument("output", help="output .bin path")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--checkpoint", help="FP32 export from .npz checkpoint")
    g.add_argument("--quant", help="Q80 export from .npz checkpoint")
    g.add_argument("--q4k", help="Q4K export from .npz checkpoint")
    g.add_argument("--lora", help="LoRA export from .npz checkpoint")
    g.add_argument("--repack", help="re-quantize an existing .bin")
    g.add_argument("--from-gguf", dest="from_gguf",
                   help="convert a llama.cpp GGUF (dense Qwen2/Qwen3) "
                        "to .bin; quant via --to")
    g.add_argument("--to-gguf", dest="to_gguf",
                   help="export a Qwen-arch .bin to GGUF (f32/f16/q8_0 "
                        "via --to) for the llama.cpp ecosystem")
    ap.add_argument("--to", default="q4k",
                    choices=["f32", "q80", "q4k", "f16", "q8_0"],
                    help="target quant for --repack / --from-gguf "
                         "(f32|q80|q4k) and --to-gguf (f32|f16|q8_0)")
    ap.add_argument("--merge-lora", dest="merge_lora",
                    help="fold a LoRA adapter (.npz checkpoint or .bin "
                         "sidecar) into the base weights before export "
                         "(composes with --checkpoint/--quant/--q4k)")
    ap.add_argument("--group_size", type=int, default=256,
                    help="Q80 quantization group (halved until it divides "
                         "the dims; >= 256 takes the W8A8 kernels)")
    args = ap.parse_args(argv)

    from nano_tpu_torch.io import binfmt

    if args.from_gguf:
        from nano_tpu_torch.io import gguf
        to = args.to if args.to in ("f32", "q80", "q4k") else "q80"
        cfg = gguf.convert_gguf(args.from_gguf, args.output, quant=to,
                                group_size=args.group_size)
        print(f"converted GGUF -> {args.output} ({to}, "
              f"{cfg.n_layer}L/{cfg.n_embd}E)")
        return

    if args.to_gguf:
        from nano_tpu_torch.io import gguf
        to = args.to if args.to in ("f32", "f16", "q8_0") else "q8_0"
        bm = binfmt.read_model(args.to_gguf, dense=True)
        if bm.header.model_type not in (binfmt.MODEL_TYPE_QWEN2,
                                        binfmt.MODEL_TYPE_QWEN3):
            raise SystemExit("--to-gguf maps Qwen-arch .bin files only "
                             "(llama.cpp has no Nano architecture)")
        arch = ("qwen2" if bm.header.model_type == binfmt.MODEL_TYPE_QWEN2
                else "qwen3")
        gguf.write_gguf(args.output, bm.params, bm.config,
                        bm.tokenizer_config["tokenizer"], arch=arch,
                        quant=to)
        print(f"exported GGUF ({arch}, {to}) -> {args.output}")
        return

    if args.repack:
        binfmt.repack(args.repack, args.output, quant=args.to,
                      group_size=args.group_size)
        print(f"repacked {args.repack} -> {args.output} ({args.to})")
        return

    src = args.checkpoint or args.quant or args.q4k or args.lora
    quant = "f32" if args.checkpoint else ("q80" if args.quant else "q4k")
    if src.endswith((".pt", ".pth")):
        from nano_tpu_torch.io import pt_import
        if args.lora:
            raise SystemExit("LoRA .pt export needs the base config: "
                             "convert with pt_import.import_lora() + "
                             "binfmt.write_lora() instead")
        cfg = pt_import.pt_to_bin(src, args.output, quant=quant,
                                  group_size=args.group_size)
        print(f"exported {quant} from reference .pt -> {args.output} "
              f"({cfg.n_layer}L/{cfg.n_embd}E)")
        return

    from nano_tpu_torch.config import ModelConfig
    from nano_tpu_torch.io.checkpoint import Checkpoint
    ck = Checkpoint(src)
    cfg = ModelConfig.from_dict(ck.model_config)

    if args.lora:
        rank, alpha = ck.lora_rank_alpha()
        binfmt.write_lora(args.output, ck.load_lora(), cfg, rank=rank,
                          alpha=alpha)
        print(f"exported LoRA (rank={rank}, alpha={alpha}) -> {args.output}")
        return

    params = ck.load_params()
    if args.merge_lora:
        from nano_tpu_torch.models import gpt
        if args.merge_lora.endswith(".bin"):
            bl = binfmt.read_lora(args.merge_lora, cfg)
            lora, scale = bl.lora, bl.alpha / bl.rank
        else:
            lck = Checkpoint(args.merge_lora)
            rank, alpha = lck.lora_rank_alpha()
            lora, scale = lck.load_lora(), alpha / rank
        params = gpt.merge_lora(params, lora, scale)
        print(f"merged LoRA {args.merge_lora} (scale {scale:g})")
    binfmt.write_model(args.output, params, cfg, ck.tokenizer_config,
                       quant=quant, group_size=args.group_size)
    print(f"exported {quant} -> {args.output}")


if __name__ == "__main__":
    main()
