"""Dataset preprocessing CLI: the root data.py's subcommands on the port.

    python -m nano_tpu_torch.data pretrain -i corpus.txt [corpus2.txt ...] \\
        -k tokenizer/nano_16384.json -b 512 -o dataset/pt [--part_blocks N]
    python -m nano_tpu_torch.data sft -i qa.jsonl -k tok.json -b 512 -o dataset/sft
    python -m nano_tpu_torch.data convert -i old.base64 -o new.npz
    python -m nano_tpu_torch.data tokenizer -o tok.json \\
        [-i text ...] [--preset N] [--charset F] [--wordlist F] [--from_vocab F]
    python -m nano_tpu_torch.data qa2jsonl -i qa.txt -o qa.jsonl
    python -m nano_tpu_torch.data jsonl2txt -i docs.jsonl -o corpus.txt

The arguments, defaults, printed lines and files are the root data.py's
(raw text -> shuffled (block_size+1)-token .npz shards; SFT JSONL
{question,answer} -> padded ids + answer-only loss masks; the reference's
base64-pickled lines -> .npz; charset and preset tokenizers).  Runs on the
host only: no device is involved.
"""

import argparse
import os

# the repository's shipped charset files for the 4096 / 6000 / 8192 presets
_SHIPPED = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tokenizer")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m nano_tpu_torch.data",
                                 description="Nano dataset preprocessing")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("pretrain")
    pt.add_argument("-i", "--input", nargs="+", required=True)
    pt.add_argument("-k", "--tokenizer", required=True,
                    help="tokenizer config JSON")
    pt.add_argument("-b", "--block_size", type=int, default=512)
    pt.add_argument("-o", "--output_prefix", required=True)
    pt.add_argument("--val_ratio", type=float, default=0.05)
    pt.add_argument("-j", "--workers", type=int, default=0)
    pt.add_argument("-s", "--seed", type=int, default=39)
    pt.add_argument("--part_blocks", type=int, default=0,
                    help="TB-scale mode: spill every N blocks to its own "
                         "shuffled shard (bounded RAM, two-level shuffle)")

    sft = sub.add_parser("sft")
    sft.add_argument("-i", "--input", nargs="+", required=True)
    sft.add_argument("-k", "--tokenizer", required=True)
    sft.add_argument("-b", "--block_size", type=int, default=512)
    sft.add_argument("-o", "--output_prefix", required=True)
    sft.add_argument("--val_ratio", type=float, default=0.05)
    sft.add_argument("-s", "--seed", type=int, default=39)

    cv = sub.add_parser("convert",
                        help="reference base64-line file -> .npz shard")
    cv.add_argument("-i", "--input", required=True)
    cv.add_argument("-o", "--output", required=True)

    tk = sub.add_parser("tokenizer",
                        help="build a charset tokenizer from raw text "
                             "(reference: tokenizer.py:327-412 builders)")
    tk.add_argument("-i", "--input", nargs="*", default=[])
    tk.add_argument("-o", "--output", required=True,
                    help="tokenizer config JSON path")
    tk.add_argument("--preset", type=int, default=None,
                    choices=[4096, 6000, 8192, 16384, 32768],
                    help="Unicode-range preset vocab instead of corpus "
                         "charset")
    tk.add_argument("--wordlist", default=None,
                    help="optional word-list file (one token per line) "
                         "merged into a --preset vocab")
    tk.add_argument("--charset", default=None,
                    help="charset file for the 4096/6000/8192 presets "
                         "(reference: tokenizer/charset_*.txt format)")
    tk.add_argument("--from_vocab", default=None,
                    help="existing vocab JSON to extract word/char "
                         "tokens from (reference-vocab reproduction)")

    qa = sub.add_parser("qa2jsonl",
                        help="[Q]/[A] text file -> {question,answer} "
                             "JSONL (reference: dataset/parse_arexam.py)")
    qa.add_argument("-i", "--input", required=True)
    qa.add_argument("-o", "--output", required=True)

    j2t = sub.add_parser("jsonl2txt",
                         help='{"text": ...} JSONL -> <|bos|>text<|eos|> '
                              "lines (reference: parse_arexam.py "
                              "general_jsonl)")
    j2t.add_argument("-i", "--input", required=True)
    j2t.add_argument("-o", "--output", required=True)
    return ap


def _tokenizer(ap, args) -> None:
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer
    tok = TrieTokenizer()
    if args.preset in (4096, 6000, 8192) and not args.charset:
        shipped = os.path.join(_SHIPPED, f"charset_{args.preset}.txt")
        if os.path.exists(shipped):
            args.charset = shipped
    if args.preset and (args.charset or args.from_vocab or args.wordlist):
        from nano_tpu_torch.tokenizer import presets
        tok = presets.build_preset(args.preset, charset_file=args.charset,
                                   words_file=args.wordlist,
                                   from_vocab=args.from_vocab)
    elif args.preset:
        tok.build_preset(args.preset)
    else:
        if not args.input:
            ap.error("tokenizer requires -i files or --preset")
        text = ""
        for p in args.input:
            with open(p, encoding="utf-8") as f:
                text += f.read()
        tok.build_from_text(text)
    tok.dump_config_file(args.output)
    print(f"built {tok.vocab_size}-token vocab -> {args.output}")


def main(argv=None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)

    from nano_tpu_torch.data import preprocess
    from nano_tpu_torch.tokenizer.trie import TrieTokenizer

    if args.cmd == "convert":
        preprocess.convert_base64_to_shard(args.input, args.output)
        print(f"converted {args.input} -> {args.output}")
        return
    if args.cmd == "qa2jsonl":
        n = preprocess.qa_txt_to_jsonl(args.input, args.output)
        print(f"wrote {n} QA pairs -> {args.output}")
        return
    if args.cmd == "jsonl2txt":
        n = preprocess.jsonl_text_to_corpus(args.input, args.output)
        print(f"wrote {n} documents -> {args.output}")
        return
    if args.cmd == "tokenizer":
        _tokenizer(ap, args)
        return

    tok = TrieTokenizer.from_file(args.tokenizer)
    if args.cmd == "pretrain":
        if args.part_blocks:
            trains, vals = preprocess.generate_pretrain_dataset_parts(
                args.input, tok, args.block_size, args.output_prefix,
                part_blocks=args.part_blocks, val_ratio=args.val_ratio,
                num_workers=args.workers, seed=args.seed)
            print(f"wrote {len(trains)} parts:")
            for t, v in zip(trains, vals):
                print(f"  {t}  {v}")
            print('train_config dataset_path: '
                  + str([[t, v] for t, v in zip(trains, vals)]))
            return
        train, val = preprocess.generate_pretrain_dataset(
            args.input, tok, args.block_size, args.output_prefix,
            val_ratio=args.val_ratio, num_workers=args.workers,
            seed=args.seed)
    else:
        train, val = preprocess.generate_sft_dataset(
            args.input, tok, args.block_size, args.output_prefix,
            val_ratio=args.val_ratio, seed=args.seed)
    print(f"wrote {train} and {val}")


if __name__ == "__main__":
    main()
