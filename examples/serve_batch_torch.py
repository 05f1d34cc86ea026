"""Batched serving on the PyTorch port: prefill a batch of random prompts,
then greedy decode, with random weights drawn from a seed.  The batch is
admitted through the port's sharded lock table (``--admission-slots``, 4 by
default; 0 serves without admission).

    PYTHONPATH=src python examples/serve_batch_torch.py --device cuda
    PYTHONPATH=src python examples/serve_batch_torch.py --device cuda --full \
        --batch 8 --prompt-len 1024 --gen 32
    PYTHONPATH=src python examples/serve_batch_torch.py --device cuda --full \
        --arch recurrentgemma-9b --batch 4 --prompt-len 4096 --gen 32
    PYTHONPATH=src python examples/serve_batch_torch.py --device cuda --full \
        --arch xlstm-1.3b --batch 8 --prompt-len 2048 --gen 32
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu --arch deepseek-v2-236b
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu --arch xlstm-1.3b
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu --arch internvl2-76b
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
    ap.add_argument("--admission-slots", type=int, default=4)
    args = ap.parse_args()

    out = serve(args.arch, smoke=not args.full, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen, device=args.device,
                admission_slots=args.admission_slots)
    toks = out["tokens"]
    print(f"[serve_batch_torch] generated {toks.shape[0]} sequences x "
          f"{toks.shape[1]} tokens on {args.device}")
    print(f"[serve_batch_torch] prefill {out['prefill_seconds'] * 1e3:.0f} ms, "
          f"{out['decode_seconds_per_token'] * 1e3:.1f} ms/token, "
          f"{out['throughput_tok_s']:.0f} tok/s")
    for i, row in enumerate(toks[: min(4, len(toks))]):
        print(f"  seq{i}: {row[:12].tolist()}...")
    if "admission" in out:
        adm = out["admission"]
        print(f"[serve_batch_torch] admitted via {adm['slot_key']} "
              f"(fence token {adm['fence_token']}); "
              f"lock-table RDMA ops on the serving host: {adm['local_rdma_ops']}")


if __name__ == "__main__":
    main()
