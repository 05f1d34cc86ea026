#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit, then the build of every kernel source;
2. every kernel against its plain PyTorch version on the card: the reference
   test shapes (fp32 at 2e-5 with TF32 off, bf16 at 2e-2), then the serving
   shape, timed beside its bound and a PyTorch library call as yardstick;
3. the port against its own plain CPU path on a small fp32 model;
4. the main path: ``serve("llama3.2-1b")`` at full width, batch 8 x prompt
   1024 x 32 generated tokens, with every kernel launch counted.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  The script imports nothing of
JAX; with no CUDA card, or without the repository beside it, it exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# tests/test_kernels.py's FLASH_CASES, then cases that reach every kernel
# variant: bf16 windowed (mma, D 64), bf16 d 128 (mma, D 128), bf16 d 192/128
# (SIMT bf16).  B, T, H, K, dk, dv, causal, window, dtype
FLASH_CASES = [
    (2, 64, 4, 2, 32, 32, True, 0, "float32"),
    (1, 96, 8, 8, 64, 64, True, 24, "float32"),
    (2, 48, 4, 1, 16, 16, False, 0, "float32"),
    (1, 80, 4, 2, 32, 16, True, 0, "bfloat16"),
    (1, 50, 2, 2, 16, 16, True, 0, "float32"),
    (3, 32, 6, 3, 8, 8, True, 0, "float32"),
    (2, 200, 8, 2, 64, 64, True, 48, "bfloat16"),
    (1, 130, 4, 2, 128, 128, True, 0, "bfloat16"),
    (1, 70, 2, 1, 192, 128, True, 0, "bfloat16"),
]
SLICE = (8, 1024, 32, 8, 64, 64, True, 0, "bfloat16")  # llama3.2-1b prefill attention
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import torch.nn.functional as F

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model, input_specs

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------- 1. build --
    t0 = time.perf_counter()
    built = build.build()
    print(f"[build] {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    # --------------------------------------------------------- 2. kernels --
    gen = torch.Generator(dev).manual_seed(0)

    def inputs(B, T, H, K, dk, dv, dtype):
        dt = getattr(torch, dtype)
        mk = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)
        return mk(B, T, H, dk), mk(B, T, K, dk), mk(B, T, K, dv)

    def time_ms(fn, iters):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    for case in FLASH_CASES:
        B, T, H, K, dk, dv, causal, window, dtype = case
        q, k, v = inputs(B, T, H, K, dk, dv, dtype)
        out = flash_attention_fwd(q, k, v, causal=causal, window=window)
        expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (out.float() - expect.float()).abs().max().item()
        print(f"[kernel] flash_attention {case}: max_abs_err {err:.3e} (tol {TOL[dtype]})")
        if not err <= TOL[dtype]:
            raise AssertionError(f"flash_attention disagrees with its plain version on {case}")

    B, T, H, K, dk, dv, causal, window, dtype = SLICE
    q, k, v = inputs(B, T, H, K, dk, dv, dtype)
    out = flash_attention_fwd(q, k, v, causal=causal, window=window)
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    slice_err = (out.float() - expect.float()).abs().max().item()
    if not slice_err <= TOL[dtype]:
        raise AssertionError(f"flash_attention disagrees at the serving shape: {slice_err}")
    del expect
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal, window=window), 50)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window), 5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), 50)
    # Work this run's inputs need: unmasked (q, k) pairs, 2 FLOP per
    # multiply-add in QK^T (dk) and PV (dv); each of q, k, v, o moved once.
    pos = torch.arange(T)
    pairs = int((pos[None, :] <= pos[:, None]).sum()) if causal else T * T
    flops = 2 * (dk + dv) * B * H * pairs
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    print(f"[kernel] flash_attention {SLICE}: max_abs_err {slice_err:.3e}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)")
    del q, k, v, qt, kt, vt, out

    # -------------------------------- 3. port vs its plain path, small input --
    cfg = get_config("llama3.2-1b", smoke=True).with_overrides(dtype="float32")
    gpu = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    prompt = input_specs(cfg, ShapeConfig("p", 24, 2, "prefill"),
                         generator=torch.Generator().manual_seed(1), device="cpu")
    lg, cg = gpu.prefill({"tokens": prompt["tokens"].to(dev)}, 32)
    lc, cc = cpu.prefill(prompt, 32)
    for step in range(4):
        torch.testing.assert_close(lg.cpu(), lc, atol=2e-4, rtol=1e-3)
        tok = torch.argmax(lc[:, -1], dim=-1, keepdim=True)
        lg, cg = gpu.decode_step(cg, tok.to(dev))
        lc, cc = cpu.decode_step(cc, tok)
    torch.testing.assert_close(lg.cpu(), lc, atol=5e-3, rtol=1e-2)
    print("[check] llama3.2-1b smoke fp32: card prefill + 4 decode steps match the CPU path")
    del gpu, cpu

    # ------------------------------------------------------ 4. main path --
    arch, batch, prompt_len, gen_len = "llama3.2-1b", 8, 1024, 32
    full = get_config(arch)
    # Same weights and prompts as serve() draws from seed 0: the first token
    # it serves must be the argmax of these finite logits.
    model = Model(full, device=dev, generator=torch.Generator(dev).manual_seed(0))
    prompts = input_specs(full, ShapeConfig("serve", prompt_len, batch, "prefill"),
                          generator=torch.Generator(dev).manual_seed(1), device=dev)
    logits, _ = model.prefill(prompts, prompt_len + gen_len)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("full-width prefill logits are not finite")
    first = torch.argmax(logits[:, -1], dim=-1).cpu()
    del model, logits, prompts
    torch.cuda.empty_cache()

    flash_attention_fwd.launches = 0
    res = serve(arch, smoke=False, batch=batch, prompt_len=prompt_len,
                gen_len=gen_len, device="cuda")
    launches = flash_attention_fwd.launches
    toks = res["tokens"]
    print(f"[serve] {arch} full width bf16, batch {batch} x prompt {prompt_len} x "
          f"{gen_len} tokens: prefill {res['prefill_seconds']:.4f} s, "
          f"decode {res['decode_seconds_per_token'] * 1e3:.3f} ms/token, "
          f"{res['throughput_tok_s']:.1f} tok/s; flash_attention launches {launches}")
    if tuple(toks.shape) != (batch, gen_len):
        raise AssertionError(f"tokens shape {tuple(toks.shape)} != {(batch, gen_len)}")
    if not bool(((toks >= 0) & (toks < full.vocab_size)).all()):
        raise AssertionError("generated tokens out of vocabulary range")
    if not torch.equal(toks[:, 0], first):
        raise AssertionError("first served token is not the argmax of the prefill logits")
    if launches != full.num_layers:
        raise AssertionError(f"flash_attention launched {launches} times in prefill, "
                             f"expected {full.num_layers} (one per layer)")

    record = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:128",
        "launches": launches,
        "max_abs_err": slice_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
