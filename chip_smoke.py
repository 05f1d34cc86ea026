#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit, then the build of every kernel source
   with each kernel's registers, static shared memory and spill bytes (nvcc
   ``-Xptxas -v``); every ``flash_fwd_wgmma`` instantiation must spill
   nothing;
2. every kernel against its plain PyTorch version on the card: the reference
   test shapes (fp32 at 2e-5 with TF32 off; bf16 within 2e-2 and, per
   element, within 1.6e-2 of the value plus 1e-2 of its row's RMS, NaN-free;
   the RG-LRU scan at 1e-5), each flash case naming the kernel variant it
   launched (every bf16 case must launch ``wgmma``), then each serving shape,
   timed beside its bound and, where one PyTorch call computes the same
   function, that call as yardstick;
3. the port against its own plain CPU path on small fp32 models
   (llama3.2-1b and recurrentgemma-9b);
4. the main paths, each with every kernel launch counted from zero:
   ``serve("llama3.2-1b")`` at full width, batch 8 x prompt 1024 x 32
   generated tokens; then ``serve("recurrentgemma-9b")`` at full width and
   depth (38 layers, bf16), batch 4 x prompt 4096 x 32 generated tokens.
   Every flash-attention launch of both must be ``wgmma``;
5. admitted serving: llama3.2-1b's phase-4 request again, admitted through
   the lock table (``admission_slots=4``), with the kernel libraries
   unloaded first: the libraries are loaded when the slot is taken, the card
   is idle at each keepalive, the tokens equal phase 4's, the lease counters
   are 1 grant, 4 fast renewals, 0 expirations and 0 RDMA operations on the
   serving host, and flash attention launches 16 times on ``wgmma``; then
   three server threads share two slots, never more than two inside a
   lease, each with phase 4's tokens and its own fence token; then the host
   time of admit, keepalive and complete, and bare against admitted serving
   (through a private table and through a gate built beforehand) over three
   requests each, in turns, with the garbage collector's time in each;
6. training: (a) flash attention's gradients on the card (fp32 and bf16,
   causal and windowed, GQA and MQA) against the autograd of its plain
   version on the same CUDA tensors, then three fp32 train steps of
   llama3.2-1b and recurrentgemma-9b at smoke width on the card and on the
   CPU from one init (losses, grads' norms and final parameters within the
   CPU parity tests' atol 1e-5, rtol 1e-4); (b) a smoke run checkpointed at
   step 3 and resumed through step 6 gives an uninterrupted run's losses
   exactly; (c) the main path's second half: ``train("llama3.2-1b")`` at its
   published widths (16 layers, bf16 parameters, fp32 AdamW moments, block
   remat), ``train_4k``'s 4096 tokens per row at global batch 8 in 8
   microbatches, 10 steps at lr 3e-4 with 2 warmup steps, launches counted
   from zero: every loss finite, 256 flash launches per step, all
   ``wgmma``, and the 10th loss below the 1st; then one microbatch's
   backward timed with CUDA events around the whole and around each
   attention backward (the plain version's autograd); then that
   microbatch's loss and every gradient through the kernel against the
   same with the plain version in the forward and in remat's recompute,
   within ``TRAIN_BF16_TOL``, and a recompute that is wrong on purpose must
   exceed it.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  The script imports nothing of
JAX; with no CUDA card, or without the repository beside it, it exits 1.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, fp32 CUDA
# cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# tests/test_kernels.py's FLASH_CASES (fp32 on the simt variant, bf16 on
# wgmma), then bf16 cases at every wgmma head dim (D 64, 128, 256) and its
# edges: a window, d 128 with H/K = 4, dk 192 / dv 128 (MLA), recurrentgemma's
# windowed MQA at d 256, Tq no multiple of the 128-row work tile at d 256
# with a window, and a window that is no multiple of the KV tile.
# B, T, H, K, dk, dv, causal, window, dtype
FLASH_CASES = [
    (2, 64, 4, 2, 32, 32, True, 0, "float32"),
    (1, 96, 8, 8, 64, 64, True, 24, "float32"),
    (2, 48, 4, 1, 16, 16, False, 0, "float32"),
    (1, 80, 4, 2, 32, 16, True, 0, "bfloat16"),
    (1, 50, 2, 2, 16, 16, True, 0, "float32"),
    (3, 32, 6, 3, 8, 8, True, 0, "float32"),
    (2, 200, 8, 2, 64, 64, True, 48, "bfloat16"),
    (1, 130, 4, 2, 128, 128, True, 0, "bfloat16"),
    (2, 256, 8, 2, 128, 128, True, 0, "bfloat16"),
    (1, 70, 2, 1, 192, 128, True, 0, "bfloat16"),
    (1, 300, 4, 1, 192, 128, True, 0, "bfloat16"),
    (1, 300, 4, 1, 256, 256, True, 64, "bfloat16"),
    (2, 333, 4, 2, 256, 256, True, 200, "bfloat16"),
    (2, 500, 4, 2, 64, 64, True, 77, "bfloat16"),
]
FLASH_SLICES = {  # prefill attention of each main path
    "llama3.2-1b": (8, 1024, 32, 8, 64, 64, True, 0, "bfloat16"),
    "recurrentgemma-9b": (4, 4096, 16, 1, 256, 256, True, 2048, "bfloat16"),
}
# Largest |out - ref| allowed.  fp32 differs in summation order only.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 is also held per element to |out - ref| <= BF16_RTOL |ref| + BF16_ROW
# rms(ref's row over dv).  Rounding the output moves an element by at most
# one bf16 ulp of its value (2^-7 of it; the bound allows two); rounding P to
# bf16 adds noise of about 2^-9 of the row's scale.  A late row of 2048 keys
# has an RMS near 0.03, so one key more or less at a window edge, or a KV
# tile dropped or doubled, fails the bound where 2e-2 absolute would not.
BF16_RTOL, BF16_ROW = 1.6e-2, 1e-2

# tests/test_kernels.py's RG-LRU cases, a width that is no multiple of 32
# with an odd T, then recurrentgemma-9b's prefill scan.  B, T, W
RGLRU_CASES = [(2, 100, 48), (1, 64, 128), (3, 33, 20), (2, 257, 4100)]
RGLRU_SLICE = (4, 4096, 4096)
RGLRU_TOL = 1e-5  # atol and rtol: fp32, fma against mul-then-add rounding only

# Main paths: arch, batch, prompt, generated tokens.
SERVE = [("llama3.2-1b", 8, 1024, 32), ("recurrentgemma-9b", 4, 4096, 32)]

# Phase 6.  Flash gradient cases (B, T, H, K, dk, dv, causal, window, dtype):
# fp32 on simt, bf16 on wgmma; llama's d 64 GQA and recurrentgemma's d 256 MQA.
GRAD_CASES = [
    (2, 64, 4, 2, 32, 32, True, 0, "float32"),
    (1, 96, 8, 8, 64, 64, True, 24, "float32"),
    (2, 256, 8, 2, 64, 64, True, 0, "bfloat16"),
    (1, 300, 4, 1, 256, 256, True, 64, "bfloat16"),
]
# The CPU parity tests' tolerance for losses, gradients and parameters (fp32).
TRAIN_TOL = dict(atol=1e-5, rtol=1e-4)
# One full-width bf16 microbatch through the kernel against the same through
# its plain version: relative loss gap, the worst leaf's relative L2 gap of
# its gradient, and the worst leaf's relative gap of the gradient norms.  On
# an H100 the kernel read 3.4e-5, 2.8e-2 (the first layer's wk) and 9.7e-4;
# a recompute wrong on purpose (window 2048 in remat's calls) 0, 0.36 and
# 6.1e-2.  The limits sit about twice and five times above the kernel.
TRAIN_BF16_TOL = {"loss": 5e-4, "grad": 6e-2, "norm": 5e-3}
# Full width: arch, rows per step, tokens per row, microbatches, steps.
TRAIN = ("llama3.2-1b", 8, 4096, 8, 10)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def smoke_train_steps(arch: str, dev, steps: int = 3):
    """``steps`` fp32 train steps of ``arch``'s smoke config on ``dev`` and on
    the CPU from one init (drawn on ``dev``); two microbatches per step.
    Returns each step's (loss on dev, loss on CPU, grad-norm on dev, on CPU)
    and the largest parameter difference; raises on a disagreement."""
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import build_train_step, init_train_state
    from repro_torch.models import Model

    cfg = get_config(arch, smoke=True).with_overrides(dtype="float32")
    run = RunConfig(learning_rate=1e-3, warmup_steps=1, total_steps=steps, microbatches=2)
    card = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    models = {"card": card, "cpu": cpu}
    states = {k: init_train_state(m, run) for k, m in models.items()}
    fns = {k: build_train_step(m, run) for k, m in models.items()}
    data = SyntheticLMDataset(cfg, ShapeConfig("smoke", 64, 4, "train"), seed=0)
    rows = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).long() for k, v in data.batch(i).items()}
        out = {}
        for k, m in models.items():
            states[k], metrics = fns[k](states[k], {n: t.to(m.device) for n, t in batch.items()})
            out[k] = (metrics["loss"].item(), metrics["grad_norm"].item())
        rows.append((out["card"][0], out["cpu"][0], out["card"][1], out["cpu"][1]))
        for got, want in ((out["card"][0], out["cpu"][0]), (out["card"][1], out["cpu"][1])):
            torch.testing.assert_close(torch.tensor(got), torch.tensor(want), **TRAIN_TOL)
    worst = 0.0
    for key, p in cpu.named_parameters():
        got = card.get_parameter(key).detach().cpu()
        torch.testing.assert_close(got, p.detach(), **TRAIN_TOL, msg=f"{arch} {key}")
        worst = max(worst, (got - p.detach()).abs().max().item())
    return rows, worst


def resumed_losses(arch: str, dev, directory: str):
    """Losses of a 6-step smoke run, and of a run checkpointed at step 3 and
    resumed through step 6, in ``directory``."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch.train import train

    shape = ShapeConfig("smoke", 32, 4, "train")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=6, checkpoint_every=3)
    whole = train(arch, steps=6, shape=shape, log_every=1, device=dev,
                  run=RunConfig(checkpoint_dir=f"{directory}/whole", **kw))
    run = RunConfig(checkpoint_dir=f"{directory}/split", **kw)
    first = train(arch, steps=3, shape=shape, log_every=1, device=dev, run=run)
    rest = train(arch, steps=6, shape=shape, log_every=1, device=dev, run=run, resume=True)
    return ([h["loss"] for h in whole["history"]],
            [h["loss"] for h in first["history"] + rest["history"]])


def microbatch_grads(model, batch, flash_fwd=None):
    """One microbatch's loss and every parameter's gradient; with
    ``flash_fwd``, attention's forward and remat's recompute call it in place
    of ``ops._flash_fwd`` (the autograd Function and its backward stay)."""
    import torch

    from repro_torch.kernels import ops

    names, params = zip(*model.named_parameters())
    real = ops._flash_fwd
    ops._flash_fwd = flash_fwd or real
    try:
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, params)
    finally:
        ops._flash_fwd = real
    return loss.item(), dict(zip(names, grads))


def grad_gaps(got, want):
    """(relative loss gap, worst leaf's |g - g'| / |g'|, worst leaf's
    relative gap of the norms, that leaf's name) between two
    :func:`microbatch_grads` readings, in fp32."""
    (loss, grads), (loss_w, grads_w) = got, want
    l2, norm = {}, {}
    for key, w in grads_w.items():
        g, w = grads[key].float(), w.float()
        wn = w.norm().item()
        l2[key] = (g - w).norm().item() / wn
        norm[key] = abs(g.norm().item() - wn) / wn
    worst = max(l2, key=l2.get)
    return abs(loss - loss_w) / abs(loss_w), l2[worst], max(norm.values()), worst


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

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd
    from repro_torch.launch.serve import BatchAdmission, serve
    from repro_torch.launch.train import train
    from repro_torch.models import Model, input_specs, layer_plan

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"[card] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------- 1. build --
    t0 = time.perf_counter()
    built = build.build()
    print(f"[build] {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    wgmma_built = set()
    for name in build.sources():
        for use in build.ptxas_usage(build.log_path(name).read_text()):
            kernel = use["kernel"]
            print(f"[build] {name}.cu {kernel}: {use['registers']} registers at launch, "
                  f"static shared memory {use['static_smem']} B (dynamic: requested at "
                  f"launch), spill stores {use['spill_stores']} B, "
                  f"spill loads {use['spill_loads']} B")
            if kernel.startswith("flash_fwd_wgmma<"):
                wgmma_built.add(kernel)
                if use["spill_stores"] or use["spill_loads"]:
                    raise AssertionError(f"{kernel} spills registers: {use}")
    wanted = {f"flash_fwd_wgmma<{d}>" for d in (64, 128, 256)}
    if wgmma_built != wanted:
        raise AssertionError(f"nvcc's log shows {sorted(wgmma_built)}, expected {sorted(wanted)}")

    # --------------------------------------------------------- 2. kernels --
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

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

    def bound(flops, peak_flops, nbytes):
        t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    def flash_inputs(B, T, H, K, dk, dv, dtype):
        dt = getattr(torch, dtype)
        return randn(B, T, H, dk).to(dt), randn(B, T, K, dk).to(dt), randn(B, T, K, dv).to(dt)

    def flash_run(case, q, k, v):
        """The kernel's output, its plain version's, and the variant launched."""
        causal, window = case[6:8]
        before = dict(flash_attention_fwd.launches_by_variant)
        out = flash_attention_fwd(q, k, v, causal=causal, window=window)
        kind, = (n for n, c in flash_attention_fwd.launches_by_variant.items()
                 if c != before[n])
        expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        return out, expect, kind

    def flash_check(case, out, expect, kind):
        """Max abs error and, for bf16, the largest share of the per-element
        bound; raises on a disagreement, a NaN, or bf16 off wgmma."""
        dtype = case[-1]
        o, e = out.float(), expect.float()
        diff = (o - e).abs()
        err, share = diff.max().item(), 0.0
        if dtype == "bfloat16":
            limit = BF16_RTOL * e.abs() + BF16_ROW * e.pow(2).mean(-1, keepdim=True).sqrt()
            share = (diff / limit).max().item()
        if not (err <= TOL[dtype] and share <= 1.0) or bool(torch.isnan(out).any()):
            raise AssertionError(f"flash_attention ({kind}) disagrees with its plain version "
                                 f"on {case}: max_abs_err {err}, share of the bf16 bound "
                                 f"{share}")
        if dtype == "bfloat16" and kind != "wgmma":
            raise AssertionError(f"bf16 case {case} ran the {kind} variant, not wgmma")
        return err, share

    for case in FLASH_CASES:
        B, T, H, K, dk, dv, causal, window, dtype = case
        q, k, v = flash_inputs(B, T, H, K, dk, dv, dtype)
        out, expect, kind = flash_run(case, q, k, v)
        err, share = flash_check(case, out, expect, kind)
        print(f"[kernel] flash_attention {case} {kind}: max_abs_err {err:.3e} (tol {TOL[dtype]})"
              + (f", {share:.3f} of the per-element bound" if dtype == "bfloat16" else ""))

    records = {}  # kernel entries of the JSON line, keyed by the path they serve
    for arch, case in FLASH_SLICES.items():
        B, T, H, K, dk, dv, causal, window, dtype = case
        q, k, v = flash_inputs(B, T, H, K, dk, dv, dtype)
        out, expect, kind = flash_run(case, q, k, v)
        err, share = flash_check(case, out, expect, kind)
        del expect
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal, window=window), 20)
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                           window=window), 3)
        # Work this run's inputs need: unmasked (q, k) pairs, 2 FLOP per
        # multiply-add in QK^T (dk) and PV (dv); each of q, k, v, o moved once.
        pos = torch.arange(T)
        keep = torch.ones(T, T, dtype=torch.bool)
        if causal:
            keep &= pos[None, :] <= pos[:, None]
        if window:
            keep &= pos[None, :] > pos[:, None] - window
        flops = 2 * (dk + dv) * B * H * int(keep.sum())
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
        # Yardstick: SDPA on the same q, k, v, with the window as an explicit mask.
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if window:
            mask = keep.to(dev)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 20)
        else:
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        print(f"[kernel] flash_attention {case} {kind} ({arch} prefill): max_abs_err {err:.3e}, "
              f"{share:.3f} of the per-element bound; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
        records[("flash_attention", arch)] = {
            "name": "flash_attention",
            "variant": kind,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:128",
            "shape": list(case),
            "launches": None,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
        }
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()

    def scan_inputs(B, T, W):
        a = torch.sigmoid(randn(B, T, W)) * 0.6 + 0.3
        return a, randn(B, T, W) * 0.1, randn(B, W) * 0.1

    def scan_err(a, b, h0):
        out = rglru_scan_fwd(a, b, h0)
        expect = ref.rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        err = (out - expect).abs().max().item()
        if not torch.allclose(out, expect, atol=RGLRU_TOL, rtol=RGLRU_TOL):
            raise AssertionError(f"rglru_scan disagrees with its plain version at "
                                 f"{tuple(a.shape)}: max_abs_err {err}")
        return err

    for case in RGLRU_CASES:
        err = scan_err(*scan_inputs(*case))
        print(f"[kernel] rglru_scan {case}: max_abs_err {err:.3e} (tol {RGLRU_TOL})")

    B, T, W = RGLRU_SLICE
    a, b, h0 = scan_inputs(B, T, W)
    err = scan_err(a, b, h0)
    ms = time_ms(lambda: rglru_scan_fwd(a, b, h0), 20)
    plain_ms = time_ms(lambda: ref.rglru_scan_ref(a, b, h0), 1)
    # One fma per element; a and b read once, h written once, h0 read once (fp32).
    nbytes = 4 * (3 * a.numel() + h0.numel())
    bound_ms, bound_by = bound(2 * a.numel(), PEAK_FP32_FLOPS, nbytes)
    print(f"[kernel] rglru_scan {RGLRU_SLICE} (recurrentgemma-9b prefill): max_abs_err "
          f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, no library call "
          f"(no single PyTorch call computes this recurrence), bound {bound_ms:.4f} ms "
          f"({bound_by}: {nbytes / 1e6:.1f} MB)")
    records[("rglru_scan", "recurrentgemma-9b")] = {
        "name": "rglru_scan",
        "variant": "rglru_scan_kernel",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:78",
        "shape": list(RGLRU_SLICE),
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the recurrence",
    }
    del a, b, h0
    torch.cuda.empty_cache()

    # -------------------------------- 3. port vs its plain path, small input --
    for arch, _, _, _ in SERVE:
        cfg = get_config(arch, smoke=True).with_overrides(dtype="float32")
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
        print(f"[check] {arch} smoke fp32 (window {cfg.window}): card prefill + 4 decode "
              f"steps match the CPU path")
        del gpu, cpu

    # ----------------------------------------------------- 4. main paths --
    kernels = {"flash_attention": flash_attention_fwd, "rglru_scan": rglru_scan_fwd}

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0
        flash_attention_fwd.launches_by_variant = dict.fromkeys(
            flash_attention_fwd.launches_by_variant, 0)

    served = {}  # each main path's result
    for arch, batch, prompt_len, gen_len in SERVE:
        full = get_config(arch)
        plan = layer_plan(full)
        kinds = plan.pattern * plan.n_scan + plan.tail
        expect = {"flash_attention": kinds.count("attn"), "rglru_scan": kinds.count("rec")}
        # Same weights and prompts as serve() draws from seed 0: the first token
        # it serves must be the argmax of these finite logits.
        model = Model(full, device=dev, generator=torch.Generator(dev).manual_seed(0))
        prompts = input_specs(full, ShapeConfig("serve", prompt_len, batch, "prefill"),
                              generator=torch.Generator(dev).manual_seed(1), device=dev)
        logits, _ = model.prefill(prompts, prompt_len + gen_len)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} full-width prefill logits are not finite")
        first = torch.argmax(logits[:, -1], dim=-1).cpu()
        del model, logits, prompts
        torch.cuda.empty_cache()

        reset_counts()
        res = served[arch] = serve(arch, smoke=False, batch=batch, prompt_len=prompt_len,
                                   gen_len=gen_len, device="cuda")
        launches = {name: fn.launches for name, fn in kernels.items()}
        flash_variants = dict(flash_attention_fwd.launches_by_variant)
        toks = res["tokens"]
        print(f"[serve] {arch} full width bf16, {full.num_layers} layers, batch {batch} x "
              f"prompt {prompt_len} x {gen_len} tokens: prefill "
              f"{res['prefill_seconds']:.4f} s, decode "
              f"{res['decode_seconds_per_token'] * 1e3:.3f} ms/token, "
              f"{res['throughput_tok_s']:.1f} tok/s; launches "
              + ", ".join(f"{n} {c}" for n, c in launches.items())
              + " (flash by variant: " + ", ".join(f"{n} {c}" for n, c in flash_variants.items())
              + ")")
        torch.cuda.empty_cache()
        if tuple(toks.shape) != (batch, gen_len):
            raise AssertionError(f"tokens shape {tuple(toks.shape)} != {(batch, gen_len)}")
        if not bool(((toks >= 0) & (toks < full.vocab_size)).all()):
            raise AssertionError("generated tokens out of vocabulary range")
        if not torch.equal(toks[:, 0], first):
            raise AssertionError("first served token is not the argmax of the prefill logits")
        if launches != expect:
            raise AssertionError(f"{arch} prefill launched {launches}, expected {expect} "
                                 "(one per layer of each kernel's kind)")
        if flash_variants["wgmma"] != launches["flash_attention"]:
            raise AssertionError(f"{arch} prefill launched flash attention as {flash_variants}: "
                                 "every launch must be wgmma")
        for (name, path), rec in records.items():
            if path == arch:
                rec["launches"] = launches[name]

    # ----------------------------------------------- 5. admitted serving --
    arch, batch, prompt_len, gen_len = SERVE[0]
    kw = dict(smoke=False, batch=batch, prompt_len=prompt_len, gen_len=gen_len, device="cuda")
    bare = served[arch]
    host_us = {"admit": [], "keepalive": [], "complete": []}
    seen = []  # what admit and each keepalive found on the host and the card
    real = {name: getattr(BatchAdmission, name) for name in host_us}

    def instrumented(name):
        def call(self, *args, **kwargs):
            if name == "admit":
                seen.append(("admit", sorted(build._loaded)))
            elif name == "keepalive":
                seen.append(("keepalive", torch.cuda.current_stream().query()))
            t = time.perf_counter_ns()
            out = real[name](self, *args, **kwargs)
            host_us[name].append((time.perf_counter_ns() - t) / 1e3)
            return out
        return call

    build._loaded.clear()  # serve() must load the libraries again before it admits
    for name in host_us:
        setattr(BatchAdmission, name, instrumented(name))
    try:
        reset_counts()
        t = time.perf_counter()
        res = serve(arch, admission_slots=4, **kw)
        wall = time.perf_counter() - t
        launches = {name: fn.launches for name, fn in kernels.items()}
        flash_variants = dict(flash_attention_fwd.launches_by_variant)
    finally:
        for name, fn in real.items():
            setattr(BatchAdmission, name, fn)
    adm = res["admission"]
    request_s = res["prefill_seconds"] + res["decode_seconds_per_token"] * (gen_len - 1)
    print(f"[admission] {arch} batch {batch} x prompt {prompt_len} x {gen_len} tokens "
          f"admitted via {adm['slot_key']} (fence token {adm['fence_token']}): grants "
          f"{adm['grants']}, fast renewals {adm['fast_renews']}, expirations "
          f"{adm['expirations']}, RDMA ops on the serving host {adm['local_rdma_ops']}; "
          f"launches " + ", ".join(f"{n} {c}" for n, c in launches.items())
          + f" (flash by variant: " + ", ".join(f"{n} {c}" for n, c in flash_variants.items())
          + f"); libraries loaded at admit {seen[0][1]}, card idle at each keepalive "
          f"{[ok for what, ok in seen[1:]]}")
    if not torch.equal(res["tokens"], bare["tokens"]):
        raise AssertionError("admitted serve's tokens differ from the bare serve's")
    counters = {k: adm[k] for k in ("grants", "fast_renews", "expirations", "local_rdma_ops")}
    if counters != {"grants": 1, "fast_renews": 4, "expirations": 0, "local_rdma_ops": 0}:
        raise AssertionError(f"admission counters {counters}")
    if launches != {"flash_attention": 16, "rglru_scan": 0} or flash_variants["wgmma"] != 16:
        raise AssertionError(f"admitted serve launched {launches}, flash {flash_variants}")
    if seen[0] != ("admit", ["flash_attention"]):
        raise AssertionError(f"admit found the kernel libraries {seen[0][1]} loaded")
    if [what for what, _ in seen[1:]] != ["keepalive"] * 4 or not all(ok for _, ok in seen[1:]):
        raise AssertionError(f"keepalives found the card busy or were not 4: {seen[1:]}")
    records[("flash_attention", arch)]["admitted_launches"] = launches["flash_attention"]

    # Three server threads, two slots.
    guard, inside, peak = threading.Lock(), [0], [0]

    class Counted(BatchAdmission):
        def admit(self, *args, **kwargs):
            lease = super().admit(*args, **kwargs)
            with guard:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
            return lease

        def complete(self, lease, worker=None):
            with guard:
                inside[0] -= 1
            return super().complete(lease, worker)

    gate = Counted(num_slots=2)
    results, errors = [None] * 3, []

    def server(i):
        try:
            results[i] = serve(arch, admission=gate, **kw)
        except BaseException as exc:
            errors.append((i, repr(exc)))

    threads = [threading.Thread(target=server, args=(i,)) for i in range(3)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    threaded_s = time.perf_counter() - t
    torch.cuda.empty_cache()
    if errors:
        raise AssertionError(f"server threads failed: {errors}")
    fences = [(r["admission"]["slot_key"], r["admission"]["fence_token"]) for r in results]
    print(f"[admission] 3 server threads, 2 slots: at most {peak[0]} inside a lease, "
          f"fences {fences}, {threaded_s:.3f} s for the three requests")
    if not 1 <= peak[0] <= 2 or inside[0] != 0:
        raise AssertionError(f"{peak[0]} batches inside their leases at once with 2 slots")
    if not all(torch.equal(r["tokens"], bare["tokens"]) for r in results):
        raise AssertionError("a threaded serve's tokens differ from the single-thread serve's")
    if len(set(fences)) != 3:
        raise AssertionError(f"admissions share a fence: {fences}")

    # Host time of one admission's calls, in the request and over many.
    loop = BatchAdmission(num_slots=4)
    cycle = {name: [] for name in host_us}
    for _ in range(2000):
        t0 = time.perf_counter_ns()
        lease = loop.admit(timeout=1.0)
        t1 = time.perf_counter_ns()
        lease = loop.keepalive(lease)
        t2 = time.perf_counter_ns()
        loop.complete(lease)
        t3 = time.perf_counter_ns()
        for name, ns in zip(cycle, (t1 - t0, t2 - t1, t3 - t2)):
            cycle[name].append(ns / 1e3)
    print(f"[admission] host us in the request: admit {host_us['admit'][0]:.1f}, keepalives "
          f"{[round(x, 1) for x in host_us['keepalive']]}, complete "
          f"{host_us['complete'][0]:.1f}; request {request_s:.4f} s of prefill and decode, "
          f"{wall:.3f} s for the whole call; {smi}")
    print("[admission] host us over 2000 admit-keepalive-complete cycles, median / p99: "
          + ", ".join(f"{name} {statistics.median(v):.2f} / "
                      f"{sorted(v)[int(0.99 * len(v))]:.2f}" for name, v in cycle.items())
          + f"; {smi}")

    # Bare against admitted, in turns (the order rotates each round):
    # admitted through a private table that serve() builds, and through a
    # gate built beforehand; with the time the Python garbage collector took
    # during each call.
    gc_ms, gc_t0 = [0.0, 0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3
            gc_ms[1] += info["generation"] == 2

    modes = {"bare": {}, "admitted": {"admission_slots": 4},
             "shared gate": {"admission": BatchAdmission(num_slots=4)}}
    runs, gcs = {m: [] for m in modes}, {m: [] for m in modes}
    gc.callbacks.append(on_gc)
    try:
        for i in range(3):
            order = list(modes)[i:] + list(modes)[:i]
            for mode in order:
                gc_ms[:] = [0.0, 0]
                runs[mode].append(serve(arch, **modes[mode], **kw))
                gcs[mode].append((round(gc_ms[0], 3), gc_ms[1]))
                torch.cuda.empty_cache()
    finally:
        gc.callbacks.remove(on_gc)
    for mode, rs in runs.items():
        print(f"[admission] {mode} x {len(rs)}: prefill s "
              f"{[round(r['prefill_seconds'], 5) for r in rs]}, decode ms/token "
              f"{[round(r['decode_seconds_per_token'] * 1e3, 4) for r in rs]}, "
              f"garbage collection in the call (ms, full collections) {gcs[mode]}")
        if not all(torch.equal(r["tokens"], bare["tokens"]) for r in rs):
            raise AssertionError(f"a {mode} serve's tokens differ from phase 4's")

    # -------------------------------------------------------- 6. training --
    # (a) Flash gradients on the card against the plain version's autograd.
    for case in GRAD_CASES:
        B, T, H, K, dk, dv, causal, window, dtype = case
        inputs = flash_inputs(B, T, H, K, dk, dv, dtype)
        leaves = [x.clone().requires_grad_() for x in inputs]
        before = dict(flash_attention_fwd.launches_by_variant)
        out = ops.flash_attention(*leaves, causal, window)
        kind, = (n for n, c in flash_attention_fwd.launches_by_variant.items()
                 if c != before[n])
        g = randn(*out.shape).to(out.dtype)
        grads = torch.autograd.grad(out, leaves, g)
        oracle = [x.clone().requires_grad_() for x in inputs]
        expect = ref.flash_attention_ref(*oracle, causal=causal, window=window)
        expect_grads = torch.autograd.grad(expect, oracle, g)
        torch.cuda.synchronize()
        err, share = flash_check(case, out.detach(), expect.detach(), kind)
        grad_err = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(grads, expect_grads))
        if not grad_err <= TOL[dtype] or any(bool(torch.isnan(a).any()) for a in grads):
            raise AssertionError(f"flash_attention gradients on {case} disagree with the "
                                 f"plain version's autograd: max_abs_err {grad_err}")
        print(f"[train] flash_attention grads {case} {kind}: forward max_abs_err {err:.3e}, "
              f"dq/dk/dv max_abs_err {grad_err:.3e} (tol {TOL[dtype]})")
        del inputs, leaves, out, g, grads, oracle, expect, expect_grads

    for arch, _, _, _ in SERVE:
        reset_counts()
        rows, worst = smoke_train_steps(arch, dev)
        launches = {name: fn.launches for name, fn in kernels.items()}
        print(f"[train] {arch} smoke fp32, 3 steps x 2 microbatches, card vs CPU from one init: "
              f"losses {[(round(a, 6), round(b, 6)) for a, b, _, _ in rows]}, grad-norms "
              f"{[(round(c, 6), round(d, 6)) for _, _, c, d in rows]}, largest parameter "
              f"difference {worst:.3e} (atol {TRAIN_TOL['atol']}, rtol {TRAIN_TOL['rtol']}); "
              f"card launches " + ", ".join(f"{n} {c}" for n, c in launches.items()))
        # Per microbatch: every layer once in forward, and the stacked
        # super-blocks' layers once more in remat's recompute.
        plan = layer_plan(get_config(arch, smoke=True))
        expect = {name: 3 * 2 * (2 * plan.n_scan * plan.pattern.count(kind)
                                 + plan.tail.count(kind))
                  for name, kind in (("flash_attention", "attn"), ("rglru_scan", "rec"))}
        if launches != expect:
            raise AssertionError(f"{arch} smoke training launched {launches}, expected {expect}")

    # (b) Resume on the card.
    with tempfile.TemporaryDirectory() as tmp:
        whole, resumed = resumed_losses("llama3.2-1b", dev, tmp)
    print(f"[train] llama3.2-1b smoke resume: checkpoint at step 3, resumed through step 6: "
          f"losses {resumed} vs uninterrupted {whole}")
    if resumed != whole:
        raise AssertionError("the resumed run's losses differ from the uninterrupted run's")
    torch.cuda.empty_cache()

    # (c) The main path's second half: full-width llama3.2-1b training.
    arch, rows, seq, micro, n_steps = TRAIN
    full = get_config(arch)
    shape = ShapeConfig("train_4k", seq, rows, "train")
    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(learning_rate=3e-4, warmup_steps=2, total_steps=n_steps,
                        microbatches=micro, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res = train(arch, smoke=False, steps=n_steps, shape=shape, run=run, log_every=1,
                    device="cuda")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in kernels.items()}
    flash_variants = dict(flash_attention_fwd.launches_by_variant)
    hist = res["history"]
    n_params = sum(t.numel() for t in res["final_state"]["params"].values())
    del res
    torch.cuda.empty_cache()
    for h in hist:
        print(f"[train] {arch} full width step {h['step']}: loss {h['loss']:.6f}, grad-norm "
              f"{h['grad_norm']:.6f}, {h['seconds_per_step']:.4f} s")
    step_s = statistics.mean(h["seconds_per_step"] for h in hist[1:])
    tokens = rows * seq
    H, hd, L = full.num_heads, full.resolved_head_dim, full.num_layers
    # Model FLOPs: 6 N per token, plus causal attention's QK^T and PV (2 FLOP
    # per multiply-add over dk + dv) over the T(T+1)/2 unmasked pairs, three
    # times (forward and backward) in every layer.  Remat's recompute is not
    # model work and is not counted.
    attn_flops = 3 * 2 * 2 * hd * H * (seq * (seq + 1) // 2) * rows * L
    model_flops = 6 * n_params * tokens + attn_flops
    share = model_flops / step_s / PEAK_BF16_FLOPS
    print(f"[train] {arch} full width bf16 (fp32 moments, block remat), {L} layers, "
          f"{n_params} parameters, {rows} rows x {seq} tokens in {micro} microbatches, "
          f"lr {run.learning_rate} (warmup {run.warmup_steps}): {step_s:.4f} s per step after "
          f"the first (mean of steps 2-{n_steps}), {tokens / step_s:.1f} tokens/s, model FLOPs "
          f"{model_flops / 1e12:.2f} T per step ({attn_flops / 1e12:.2f} T attention), "
          f"{100 * share:.2f} % of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory "
          f"{peak_gb:.2f} GB; launches per step " + ", ".join(
              f"{n} {c / n_steps:g}" for n, c in launches.items())
          + " (flash by variant: " + ", ".join(
              f"{n} {c / n_steps:g}" for n, c in flash_variants.items()) + f"); {smi}")
    expect_flash = 2 * L * micro * n_steps  # forward + remat recompute, per microbatch
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss in {[h['loss'] for h in hist]}")
    if launches["flash_attention"] != expect_flash or flash_variants["wgmma"] != expect_flash:
        raise AssertionError(f"training launched flash {launches['flash_attention']} times "
                             f"({flash_variants}), expected {expect_flash}, all wgmma")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"loss did not fall: step 1 {hist[0]['loss']}, "
                             f"step {n_steps} {hist[-1]['loss']}")

    # One microbatch's backward, with events around the whole and around each
    # attention backward (the plain version's autograd); the flash kernel at
    # this shape beside its plain version and SDPA.
    model = Model(full, device=dev, generator=torch.Generator(dev).manual_seed(0))
    mb = SyntheticLMDataset(full, ShapeConfig("mb", seq, 1, "train"), seed=0).batch(0)
    mb = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in mb.items()}
    attn_events, attn_peaks = [], []
    real_backward = ops._FlashAttention.backward

    def timed_backward(ctx, g):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start.record()
        out = real_backward(ctx, g)
        end.record()
        attn_events.append((start, end))
        attn_peaks.append(torch.cuda.max_memory_allocated() - base)
        return out

    params = [p for p in model.parameters()]
    timings = []
    ops._FlashAttention.backward = staticmethod(timed_backward)
    try:
        for _ in range(2):  # the first warms up; the second is reported
            attn_events.clear()
            attn_peaks.clear()
            start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            start.record()
            loss, _ = model.loss(mb)
            mid.record()
            grads = torch.autograd.grad(loss, params)
            end.record()
            end.synchronize()
            timings = [start.elapsed_time(mid), mid.elapsed_time(end),
                       sum(a.elapsed_time(b) for a, b in attn_events)]
            del loss, grads
    finally:
        ops._FlashAttention.backward = real_backward
    fwd_ms, bwd_ms, attn_ms = timings
    print(f"[train] {arch} one microbatch (1 x {seq}): forward {fwd_ms:.2f} ms, backward "
          f"{bwd_ms:.2f} ms (with remat's recompute), of which the attention backward "
          f"(plain version's autograd) {attn_ms:.2f} ms in {len(attn_events)} calls = "
          f"{100 * attn_ms / bwd_ms:.1f} %, {attn_ms / len(attn_events):.2f} ms and "
          f"{max(attn_peaks) / 1e9:.2f} GB of transient memory per call; {smi}")
    del params

    # The same microbatch and weights with the plain version in place of the
    # kernel, in the forward and in remat's recompute: the wgmma kernel under
    # autograd and remat at the training shape, held to the plain version's
    # loss and gradients in bf16.  Then a recompute that is wrong on purpose
    # (window 2048 in remat's calls only) must exceed the limits.
    def plain_fwd(q, k, v, causal, window, scale):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)

    calls = []

    def wrong_recompute(q, k, v, causal, window, scale):
        calls.append(None)  # the first L calls are the forward, then remat's
        return plain_fwd(q, k, v, causal, seq // 2 if len(calls) > L else window, scale)

    before = flash_attention_fwd.launches_by_variant["wgmma"]
    kernel_run = microbatch_grads(model, mb)
    wgmma = flash_attention_fwd.launches_by_variant["wgmma"] - before
    plain_run = microbatch_grads(model, mb, plain_fwd)
    wrong_run = microbatch_grads(model, mb, wrong_recompute)
    del model
    gaps = grad_gaps(kernel_run, plain_run)
    wrong = grad_gaps(wrong_run, plain_run)
    print(f"[train] {arch} one microbatch (1 x {seq}), kernel (wgmma launches {wgmma}) vs plain "
          f"version in forward and recompute: loss {kernel_run[0]:.6f} vs {plain_run[0]:.6f}, "
          f"relative gap {gaps[0]:.3e} (limit {TRAIN_BF16_TOL['loss']}); worst leaf "
          f"|g - g_plain| / |g_plain| {gaps[1]:.3e} ({gaps[3]}; limit {TRAIN_BF16_TOL['grad']}); "
          f"worst leaf norm gap {gaps[2]:.3e} (limit {TRAIN_BF16_TOL['norm']}); a wrong "
          f"recompute (window {seq // 2}): {wrong[0]:.3e}, {wrong[1]:.3e} ({wrong[3]}), "
          f"{wrong[2]:.3e}")
    if wgmma != 2 * L:
        raise AssertionError(f"the kernel's microbatch launched wgmma {wgmma} times, "
                             f"expected {2 * L}")
    if not (gaps[0] <= TRAIN_BF16_TOL["loss"] and gaps[1] <= TRAIN_BF16_TOL["grad"]
            and gaps[2] <= TRAIN_BF16_TOL["norm"]):
        raise AssertionError(f"training through the kernel disagrees with the plain version "
                             f"at the training shape: {gaps}")
    if wrong[1] <= TRAIN_BF16_TOL["grad"]:
        raise AssertionError(f"the gradient check does not see a wrong recompute: {wrong}")
    del kernel_run, plain_run, wrong_run
    torch.cuda.empty_cache()

    case = (1, seq, full.num_heads, full.num_kv_heads, hd, hd, True, 0, "bfloat16")
    q, k, v = flash_inputs(*case[:6], case[-1])
    out, expect, kind = flash_run(case, q, k, v)
    err, _ = flash_check(case, out, expect, kind)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True), 20)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    flops = 2 * 2 * hd * H * (seq * (seq + 1) // 2)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
    bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
    print(f"[kernel] flash_attention {case} {kind} ({arch} training microbatch): max_abs_err "
          f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    records[("flash_attention", f"{arch} train")] = {
        "name": "flash_attention", "variant": kind, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:128",
        "shape": list(case), "launches": launches["flash_attention"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "backward_ms": attn_ms / len(attn_events),
    }
    del q, k, v, qt, kt, vt, out, expect
    torch.cuda.empty_cache()

    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
