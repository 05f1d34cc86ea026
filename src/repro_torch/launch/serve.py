"""Batched serving: prefill a prompt batch, then greedy decode.

Port of ``repro/launch/serve.py``'s bare path.  ``serve`` is the library
entry (used by ``examples/serve_batch_torch.py`` and ``chip_smoke.py``);
``main`` is the CLI.  Request admission through the lock table and meshes
are later slices of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import torch

from ..configs import ShapeConfig, get_config
from ..device import resolve_device
from ..models import Model, input_specs


def _clock(device: torch.device) -> float:
    """Host time after the device has finished the work queued so far."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def serve(
    arch: str,
    *,
    smoke: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    gen_len: int = 16,
    greedy: bool = True,
    seed: int = 0,
    device=None,
) -> Dict:
    """Serve one batch of random prompts with random weights drawn from ``seed``.

    Returns ``tokens`` ([batch, gen_len] int64 on the CPU), ``prefill_seconds``,
    ``decode_seconds_per_token`` and ``throughput_tok_s``.
    """
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    if not cfg.causal:
        raise ValueError(f"{arch} is encoder-only: no decode path")
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(seed))
    max_len = prompt_len + gen_len
    prompts = input_specs(cfg, ShapeConfig("serve", prompt_len, batch, "prefill"),
                          generator=torch.Generator(dev).manual_seed(seed + 1),
                          device=dev)
    sampler = torch.Generator(dev).manual_seed(seed + 2)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        if greedy:
            return torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        probs = torch.softmax(logits[:, -1].float(), dim=-1)
        return torch.multinomial(probs, 1, generator=sampler)

    t0 = _clock(dev)
    logits, caches = model.prefill(prompts, max_len)
    tok = pick(logits)
    prefill_s = _clock(dev) - t0

    generated = [tok]
    t1 = _clock(dev)
    for _ in range(gen_len - 1):
        logits, caches = model.decode_step(caches, tok)
        tok = pick(logits)
        generated.append(tok)
    decode_s = _clock(dev) - t1

    tokens = torch.cat(generated, dim=1).cpu()
    return {
        "tokens": tokens,
        "prefill_seconds": prefill_s,
        "decode_seconds_per_token": decode_s / max(gen_len - 1, 1),
        "throughput_tok_s": tokens.numel() / max(decode_s + prefill_s, 1e-9),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true", help="published widths, not smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    out = serve(args.arch, smoke=not args.full, batch=args.batch,
                prompt_len=args.prompt_len, gen_len=args.gen, device=args.device)
    print(f"[serve] generated {tuple(out['tokens'].shape)} tokens; "
          f"prefill {out['prefill_seconds']:.2f}s, "
          f"{out['decode_seconds_per_token'] * 1e3:.1f} ms/token, "
          f"{out['throughput_tok_s']:.1f} tok/s")
    print("[serve] first sequence:", out["tokens"][0][:16].tolist())


if __name__ == "__main__":
    main()
