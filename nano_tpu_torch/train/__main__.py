"""Train a Nano model on one CUDA device, or over the ranks of a torchrun
launch (``mesh_shape`` in the train JSON: {"data": D, "seq": Q, "pipe": P,
"model": M}; "pipe" takes ``pp_microbatches``).

    python -m nano_tpu_torch.train -m config/model_168m.json -t config/pretrain.json
    torchrun --nproc_per_node 4 -m nano_tpu_torch.train -m ... -t ...
                                               # one card a rank (NCCL)
    python -m nano_tpu_torch.train ... -c      # continued pretrain: replay
                                               # the data stream to the
                                               # checkpoint's step
    python -m nano_tpu_torch.train ... --device cpu   # plain PyTorch versions

The model JSON holds ModelConfig fields; the train JSON holds TrainConfig
fields plus `max_steps` (alias `max_iters`).  Unknown keys are ignored, so
the reference's and the JAX package's config files work as they are.
"""

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m nano_tpu_torch.train",
                                 description="Nano trainer (PyTorch/CUDA)")
    ap.add_argument("-m", "--model_config", required=True)
    ap.add_argument("-t", "--train_config", required=True)
    ap.add_argument("-c", "--continue_pretrain", action="store_true",
                    help="resume the data stream position as well as the "
                         "model (reference: train.py:374-377)")
    ap.add_argument("--max_steps", type=int, default=None,
                    help="override max training steps")
    ap.add_argument("--device", default=None,
                    help="cuda unless given; 'cpu' runs the plain versions")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend under torchrun: nccl on "
                         "cuda and gloo on the cpu unless given ('gloo' "
                         "for ranks that share a card)")
    args = ap.parse_args(argv)

    with open(args.model_config, "r", encoding="utf-8") as f:
        mc = json.load(f)
    with open(args.train_config, "r", encoding="utf-8") as f:
        tc = json.load(f)
    mc = mc.get("model_config", mc)  # accept both flat and nested schemas
    tc = tc.get("train_config", tc)

    max_steps = (args.max_steps or tc.get("max_steps") or
                 tc.get("max_iters") or 10 ** 10)

    import torch.distributed as dist
    from nano_tpu_torch.parallel.mesh import maybe_distributed_init
    from nano_tpu_torch.train.trainer import Trainer
    # under torchrun (its RANK / WORLD_SIZE), as train.py does
    maybe_distributed_init(args.backend, args.device)
    try:
        t = Trainer(mc, tc, max_steps=int(max_steps),
                    is_continued_pretrain=args.continue_pretrain,
                    device=args.device)
        t.init()
        t.load_data()
        t.start(denoise=bool(tc.get("denoise", False)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
