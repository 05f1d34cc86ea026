"""Batched serving on the PyTorch port: prefill a batch of random prompts,
then greedy decode, with random weights drawn from a seed.

    PYTHONPATH=src python examples/serve_batch_torch.py --device cuda
    PYTHONPATH=src python examples/serve_batch_torch.py --device cuda --full \
        --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python examples/serve_batch_torch.py --device cuda --full \
        --arch recurrentgemma-9b --batch 4 --prompt-len 4096 --gen 32
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu
"""

import argparse

from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--full", action="store_true", help="published widths, not smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    out = serve(args.arch, smoke=not args.full, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen, device=args.device)
    toks = out["tokens"]
    print(f"[serve_batch_torch] generated {toks.shape[0]} sequences x "
          f"{toks.shape[1]} tokens on {args.device}")
    print(f"[serve_batch_torch] prefill {out['prefill_seconds'] * 1e3:.0f} ms, "
          f"{out['decode_seconds_per_token'] * 1e3:.1f} ms/token, "
          f"{out['throughput_tok_s']:.0f} tok/s")
    for i, row in enumerate(toks[: min(4, len(toks))]):
        print(f"  seq{i}: {row[:12].tolist()}...")


if __name__ == "__main__":
    main()
