#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit, then the build of every kernel source
   with each kernel's registers, static shared memory and spill bytes (nvcc
   ``-Xptxas -v``); every ``flash_fwd_wgmma`` and ``flash_bwd_wgmma``
   instantiation (``flash_bwd_wgmma<64/128>`` and, past head dim 128,
   ``flash_bwd_wgmma_dkdv<256>`` and ``flash_bwd_wgmma_dq<256>``) must spill
   nothing;
2. every kernel against its plain PyTorch version on the card: the reference
   test shapes (fp32 at 2e-5 with TF32 off; bf16 within 2e-2 and, per
   element, within 1.6e-2 of the value plus 1e-2 of its row's RMS, NaN-free;
   the RG-LRU scan at 1e-5), each flash case naming the kernel variant it
   launched (every bf16 case must launch ``wgmma``), then each serving shape,
   timed beside its bound and, where one PyTorch call computes the same
   function, that call as yardstick; then the flash backward: the forward's
   lse against the plain version's (1e-4), and dq, dk, dv against the plain
   backward on the kernel's own output and against the oracle's autograd on
   fp32 upcasts (fp32 within 1e-4 of both; bf16 per element against the
   plain backward and in relative L2 against the oracle, see ``GRAD_RTOL``),
   each case naming its variant (``wgmma`` for bf16 that the TMA can load,
   up to head dim 256, with Tk other than Tq where a key tile sees no query;
   ``simt`` for fp32 and for bf16 with a head dim no multiple of 8 or off
   16-byte aligned storage);
   then the forward and the backward at llama3-8b's training shape (head dim
   128) and at recurrentgemma-9b's (head dim 256, MQA, window 2048: the
   backward on ``flash_bwd_wgmma_dkdv`` and ``flash_bwd_wgmma_dq``), each
   timed beside its plain version, its bound (at d 256 also the bound of the
   seven products the split design runs, a second call that must repeat
   the first bit for bit, and the time at every head-group count the
   launch can choose) and SDPA (a window as a boolean
   mask; the SDPA backend that ran is named), the backward's device time
   split by launch; then the
   RG-LRU scan's forward and its backward kernel (``rglru_scan_bwd``) against
   their plain versions at 1e-5 (the backward also at T 1 and with a large
   h0), each timed at recurrentgemma-9b's prefill shape (B 4) and training
   shape (B 1) beside its bound and its plain version (the backward's: the
   oracle's autograd with its forward, and the plain reverse loop);
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
6. training: (a) flash attention's gradients on the card through its
   autograd Function (fp32 and bf16, causal and windowed, GQA and MQA)
   against the plain backward and the oracle's autograd, with phase 2's
   tolerances, then three fp32 train steps of
   llama3.2-1b and recurrentgemma-9b at smoke width on the card and on the
   CPU from one init (losses, grads' norms and final parameters within the
   CPU parity tests' atol 1e-5, rtol 1e-4; each kernel's launches printed,
   the scan backward's among them); (b) a smoke run checkpointed at
   step 3 and resumed through step 6 gives an uninterrupted run's losses
   exactly; (c) the main path's second half: ``train("llama3.2-1b")`` at its
   published widths (16 layers, bf16 parameters, fp32 AdamW moments, block
   remat), ``train_4k``'s 4096 tokens per row at global batch 8 in 8
   microbatches, 10 steps at lr 3e-4 with 2 warmup steps, launches counted
   from zero: every loss finite, 256 flash launches and 128 flash backward
   launches per step, all ``wgmma``, no call of a plain version, and the
   10th loss below the 1st; then one microbatch's backward timed with CUDA
   events around the whole and around each attention backward (the
   kernel); then that microbatch's loss and every gradient through the
   kernels against the same with the plain versions in the forward, remat's
   recompute and the backward, within ``TRAIN_BF16_TOL``, and a recompute
   that is wrong on purpose must exceed it; then the forward and the
   backward at this shape, as in phase 2; (d) the main path's third part:
   ``train("recurrentgemma-9b")`` at its published widths cut to 8 layers
   (two ``(rec, rec, attn)`` super-blocks under remat and the two tail
   ``rec`` layers; ``get_config`` patched in train's namespace for the
   call), bf16 parameters, fp32 AdamW moments, 4 rows of 4096 tokens in 4
   microbatches, 6 steps at lr 3e-4 with 2 warmup steps: every loss finite,
   the 6th below the 1st, each step's launches counted from zero and equal
   to what ``layer_plan`` implies (scan forward 40, scan backward 24, flash
   forward 16 and flash backward 8, both required on ``wgmma``), no call of
   a plain version, with
   s/step, tokens/s, the model-FLOPs share and the peak memory; then one
   microbatch's backward timed with CUDA events (the whole, each scan
   backward, each attention backward), and again with the parent tree's
   scan route (its backward the oracle's autograd) swapped in for that
   measurement only; then that microbatch's loss and every gradient
   through the kernels against the plain versions in the forward, remat's
   recompute and the backward, within ``RG_TRAIN_BF16_TOL``, and a scan
   backward wrong on purpose (da from h_t) must exceed it.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  The script imports nothing of
JAX; with no CUDA card, or without the repository beside it, it exits 1.
"""

from __future__ import annotations

import contextlib
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
# The scan's backward: RGLRU_CASES, T 1, and an h0 ten times the others' (every
# case has a nonzero h0).  B, T, W, h0 scale.
RGLRU_BWD_CASES = [(*c, 1.0) for c in RGLRU_CASES] + [(2, 1, 64, 1.0), (2, 33, 96, 10.0)]
# recurrentgemma-9b's training scan: one row of train_4k's 4096 tokens.
RGLRU_TRAIN = (1, 4096, 4096)
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
# Flash backward cases: GRAD_CASES, then d 128 with H/K = 4, a d 64 window that
# is no multiple of the KV tile over a ragged tail, and dk 192 / dv 128 (MLA,
# on the d-256 kernels); then the edges of the wgmma backward's schedule:
# H/K = 1 and H/K = 8 at d 64 (the group sets the number of steps and which
# consumer owns each step's dQ), a T whose last 128-key block leaves the
# second consumer only padding keys, and a window at d 128; then those of the
# d-256 kernels: H/K = 16 (each head its own group of blocks), a window
# shorter than half a 64-key tile (whole consumer halves masked), Tq with a
# ragged last 64-row tile under a window, and Tk 300 against Tq 100 (an
# optional tenth entry): key tiles past the last query see no query tile, so
# every head group of theirs walks no step; then bf16 that the TMA cannot
# load, on the simt backward: dv 60, and d 256 with q, k and v one element
# off 16-byte aligned storage (an optional eleventh entry).  bwd_want names
# the variant each case must launch.
BWD_CASES = GRAD_CASES + [
    (2, 256, 8, 2, 128, 128, True, 0, "bfloat16"),
    (2, 500, 4, 2, 64, 64, True, 77, "bfloat16"),
    (1, 70, 2, 1, 192, 128, True, 0, "bfloat16"),
    (1, 512, 8, 8, 64, 64, True, 0, "bfloat16"),
    (1, 512, 8, 1, 64, 64, True, 0, "bfloat16"),
    (1, 4160, 4, 2, 64, 64, True, 0, "bfloat16"),
    (1, 600, 4, 1, 128, 128, True, 100, "bfloat16"),
    (1, 320, 16, 1, 256, 256, True, 128, "bfloat16"),
    (1, 200, 4, 2, 256, 256, True, 16, "bfloat16"),
    (2, 333, 4, 2, 256, 256, True, 200, "bfloat16"),
    (1, 100, 8, 1, 256, 256, True, 0, "bfloat16", 300),
    (1, 70, 2, 1, 64, 60, True, 0, "bfloat16"),
    (1, 130, 4, 1, 256, 256, True, 64, "bfloat16", None, 1),
]
# llama3-8b's attention at train_4k's length (B, T, H, K, dk, dv, causal,
# window, dtype), timed in phase 2: the flash kernels at head dim 128.
TRAIN_D128 = (1, 4096, 32, 8, 128, 128, True, 0, "bfloat16")
# recurrentgemma-9b's attention in one training microbatch (phase 6(d)): MQA
# at d 256 with the 2048 window, forward and backward on wgmma.
TRAIN_RG_ATTN = (1, 4096, 16, 1, 256, 256, True, 2048, "bfloat16")
# The launches of one flash_attention_bwd call on each variant (``wgmma`` up
# to head dim 128, ``wgmma`` past it, ``simt``), each with the name its
# kernel has in a profiler trace, and the main kernels of each.
BWD_LAUNCHES = {
    "wgmma": {"dq_acc zeroing": "FillFunctor", "flash_bwd_rows": "flash_bwd_rows",
              "flash_bwd_wgmma": "flash_bwd_wgmma<", "flash_bwd_dq_cast": "flash_bwd_dq_cast"},
    "wgmma d 256": {"flash_bwd_rows": "flash_bwd_rows",
                    "flash_bwd_wgmma_dkdv": "flash_bwd_wgmma_dkdv<",
                    "flash_bwd_wgmma_dq": "flash_bwd_wgmma_dq<",
                    "flash_bwd_dkdv_sum": "flash_bwd_dkdv_sum"},
    "simt": {"flash_bwd_rows": "flash_bwd_rows", "flash_bwd_simt_dkdv": "flash_bwd_simt_dkdv",
             "flash_bwd_simt_dq": "flash_bwd_simt_dq"},
}
BWD_MAIN = {"wgmma": ("flash_bwd_wgmma",),
            "wgmma d 256": ("flash_bwd_wgmma_dkdv", "flash_bwd_wgmma_dq"),
            "simt": ("flash_bwd_simt_dkdv", "flash_bwd_simt_dq")}
LSE_TOL = 1e-4  # the forward's lse against the plain version's: fp32 order only
# fp32 gradients: largest |g - oracle|, the oracle's autograd on the same inputs.
GRAD_FP32_TOL = 1e-4
# bf16 gradients are held per element to |g - w| <= GRAD_RTOL |w| + GRAD_ROW
# rms(w's row over d) + GRAD_FLOOR rms(w), w the plain backward in fp32 on fp32
# upcasts of the inputs and the kernel's bf16 output (the floor is for rows
# whose terms cancel, as dq's first row).  tests/test_torch_flash_bwd.py holds
# the bound to both sides on the CPU: an emulation of the wgmma variant's
# roundings (P and dS in bf16, outputs in bf16) reads under 0.5 of it, a window
# off by one key above 2, a dropped KV tile above 10.  The oracle's autograd on
# the same upcasts is not the per-element reference: its D = rowsum(dO O) uses
# the unrounded output, which moves rows whose terms cancel (dq's first row is
# 0 there).  Against it each gradient is held to a relative L2 error of
# GRAD_ORACLE_L2 (bf16 rounding reads about 2.5e-3; lse in the wrong units or a
# wrong mask reads near 1).
GRAD_RTOL, GRAD_ROW, GRAD_FLOOR = 1.6e-2, 2e-2, 1e-3
GRAD_ORACLE_L2 = 1e-2
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
# Phase 6(d): recurrentgemma-9b at published widths cut to 8 layers (two
# (rec, rec, attn) super-blocks and the two tail rec layers): arch, layers,
# rows per step, tokens per row, microbatches, steps.
RG_TRAIN = ("recurrentgemma-9b", 8, 4, 4096, 4, 6)
# Its microbatch through the kernels against the plain versions, read as
# TRAIN_BF16_TOL.  On an H100 the kernels read 3.9e-5, 2.0e-2 (the last tail
# layer's w_a) and 3.3e-4; a scan backward wrong on purpose (da from h_t) 0,
# 1.44 (the first super-block's lam) and 2.4e-2.  The limits sit about five,
# two and five times above the kernels.
RG_TRAIN_BF16_TOL = {"loss": 2e-4, "grad": 4e-2, "norm": 1.5e-3}
# The ops-level functions that the plain versions replace in a microbatch.
KERNEL_ENTRIES = ("_flash_fwd", "_flash_bwd", "_scan_fwd", "_scan_bwd")


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


def plain_entries(wrong_scan_bwd: bool = False):
    """The plain versions in place of ``ops``' kernel entries
    (:data:`KERNEL_ENTRIES`); with ``wrong_scan_bwd``, a scan backward that
    is wrong on purpose: da from h_t in place of h_{t-1}."""
    from repro_torch.kernels import ref

    def flash_fwd(q, k, v, causal, window, scale, lse=False):
        fn = ref.flash_attention_lse_ref if lse else ref.flash_attention_ref
        return fn(q, k, v, causal=causal, window=window, scale=scale)

    def flash_bwd(q, k, v, out, lse, g, causal, window, scale):
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal=causal,
                                           window=window, scale=scale)

    def scan_bwd(a, h, h0, g):
        da, db, dh0 = ref.rglru_scan_bwd_ref(a, h, h0, g)
        return (db * h, db, dh0) if wrong_scan_bwd else (da, db, dh0)

    return {"_flash_fwd": flash_fwd, "_flash_bwd": flash_bwd,
            "_scan_fwd": lambda a, b, h0: ref.rglru_scan_ref(a, b, h0), "_scan_bwd": scan_bwd}


def microbatch_grads(model, batch, swap=None):
    """One microbatch's loss and every parameter's gradient; ``swap`` maps
    names of :data:`KERNEL_ENTRIES` to functions that ``ops`` calls in their
    place (the forward, remat's recompute and the backward), the autograd
    Functions staying as they are."""
    import torch

    from repro_torch.kernels import ops

    names, params = zip(*model.named_parameters())
    real = {name: getattr(ops, name) for name in KERNEL_ENTRIES}
    for name, fn in (swap or {}).items():
        setattr(ops, name, fn)
    try:
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, params)
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    return loss.item(), dict(zip(names, grads))


def expected_launches(plan, microbatches: int):
    """Kernel launches of one training step under block remat: per
    microbatch, each layer's forward once and the stacked super-blocks' once
    more in remat's recompute, and each layer's backward once."""
    def count(kind, recompute):
        return microbatches * ((1 + recompute) * plan.n_scan * plan.pattern.count(kind)
                               + plan.tail.count(kind))

    return {"flash_attention": count("attn", 1), "flash_attention_bwd": count("attn", 0),
            "rglru_scan": count("rec", 1), "rglru_scan_bwd": count("rec", 0)}


@contextlib.contextmanager
def counted_plain_calls():
    """Count every call of a plain version (``kernels/ref.py``) in the block;
    yields the counts by name."""
    from repro_torch.kernels import ref

    calls = {}
    names = ("flash_attention_ref", "flash_attention_lse_ref", "flash_attention_bwd_ref",
             "rglru_scan_ref", "rglru_scan_bwd_ref")
    real = {name: getattr(ref, name) for name in names}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*args, **kwargs)
        return call

    for name in names:
        setattr(ref, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(ref, name, fn)


@contextlib.contextmanager
def timed_backwards(functions):
    """CUDA events around each call of each autograd Function's backward in
    the block, and the transient memory it took; yields, per label of
    ``functions`` ({label: Function}), a list of (start, end, peak bytes)."""
    import torch

    log = {label: [] for label in functions}
    real = {label: fn.__dict__["backward"] for label, fn in functions.items()}

    def timed(label):
        inner = real[label].__func__

        def backward(ctx, *grads):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start.record()
            out = inner(ctx, *grads)
            end.record()
            log[label].append((start, end, torch.cuda.max_memory_allocated() - base))
            return out
        return staticmethod(backward)

    for label, fn in functions.items():
        fn.backward = timed(label)
    try:
        yield log
    finally:
        for label, fn in functions.items():
            fn.backward = real[label]


def timed_microbatch(model, batch, functions):
    """One microbatch's forward and backward (every parameter's gradient),
    each timed with CUDA events, and each call of the backward of each
    autograd Function in ``functions`` ({label: Function}): returns (forward
    ms, backward ms, {label: [(ms, transient bytes)]})."""
    import torch

    params = list(model.parameters())
    with timed_backwards(functions) as log:
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        loss, _ = model.loss(batch)
        mid.record()
        grads = torch.autograd.grad(loss, params)
        end.record()
        end.synchronize()
    del loss, grads
    return (start.elapsed_time(mid), mid.elapsed_time(end),
            {label: [(a.elapsed_time(b), peak) for a, b, peak in calls]
             for label, calls in log.items()})


def launch_counts():
    """Every kernel wrapper's launches, and the flash ones by variant."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd

    out = {"flash_attention": flash_attention_fwd.launches,
           "flash_attention_bwd": flash_attention_bwd.launches,
           "rglru_scan": rglru_scan_fwd.launches, "rglru_scan_bwd": rglru_scan_bwd.launches}
    for name, fn in (("flash_attention", flash_attention_fwd),
                     ("flash_attention_bwd", flash_attention_bwd)):
        out.update((f"{name}:{v}", c) for v, c in fn.launches_by_variant.items())
    return out


def counted_training(arch, layers, shape, run, device, smoke=False):
    """``train(arch)`` for ``run.total_steps`` steps at ``layers`` layers:
    ``get_config`` is patched in train's namespace for the call (no knob of
    train() changes), and each step's launches are counted from zero.
    Returns (train's result, each step's launch_counts(), the calls of each
    plain version during the run)."""
    from repro_torch.launch import train as train_mod

    step_counts = []
    real_config, real_step = train_mod.get_config, train_mod.build_train_step

    def counted_step(model, run_):
        step = real_step(model, run_)

        def call(state, batch):
            before = launch_counts()
            out = step(state, batch)
            step_counts.append({k: c - before[k] for k, c in launch_counts().items()})
            return out
        return call

    train_mod.get_config = lambda a, smoke=False: real_config(a, smoke).with_overrides(
        num_layers=layers)
    train_mod.build_train_step = counted_step
    try:
        with counted_plain_calls() as plain_calls:
            res = train_mod.train(arch, smoke=smoke, steps=run.total_steps, shape=shape,
                                  run=run, log_every=1, device=device)
    finally:
        train_mod.get_config, train_mod.build_train_step = real_config, real_step
    return res, step_counts, plain_calls


def parent_scan():
    """The RG-LRU scan's autograd Function as the parent tree had it, for a
    measurement only: the forward kernel, saving a, b and h0; the backward
    the oracle's autograd, its forward recomputed on detached copies."""
    import torch

    from repro_torch.kernels import ops, ref

    class ParentScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b, h0):
            ctx.save_for_backward(a, b, h0)
            return ops._scan_fwd(a, b, h0)

        @staticmethod
        def backward(ctx, g):
            with torch.enable_grad():
                xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
                return torch.autograd.grad(ref.rglru_scan_ref(*xs), xs, g)

    return ParentScan


def sdpa_backend(fn):
    """The SDPA backend that ran ``fn``, read from the names of the kernels a
    profiler trace of one call shows (flash, efficient, cudnn or math), and
    the three kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if t > 0:
            times[ev.key] = t
    names = " ".join(times).lower()
    backend = next((label for label, keys in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                                               ("efficient", ("fmha", "efficient", "mem_eff")))
                    if any(k in names for k in keys)), "math")
    top = sorted(times, key=times.get, reverse=True)[:3]
    return backend, [name[:90] for name in top]


def attn_pairs(T: int, causal: bool, window: int):
    """The [T, T] mask of kept (query, key) pairs, True = kept, on the CPU."""
    import torch

    pos = torch.arange(T)
    keep = torch.ones(T, T, dtype=torch.bool)
    if causal:
        keep &= pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[None, :] > pos[:, None] - window
    return keep


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
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels.flash_attention import (MAX_FUSED_BWD_DIM, flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd
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
            if kernel.startswith(("flash_fwd_wgmma<", "flash_bwd_wgmma")):
                wgmma_built.add(kernel)
                if use["spill_stores"] or use["spill_loads"]:
                    raise AssertionError(f"{kernel} spills registers: {use}")
    wanted = ({f"flash_fwd_wgmma<{d}>" for d in (64, 128, 256)}
              | {f"flash_bwd_wgmma<{d}>" for d in (64, 128)}
              | {"flash_bwd_wgmma_dkdv<256>", "flash_bwd_wgmma_dq<256>"})
    if wgmma_built != wanted:
        raise AssertionError(f"nvcc's log shows {sorted(wgmma_built)}, expected {sorted(wanted)}")

    # --------------------------------------------------------- 2. kernels --
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def time_ms(fn, iters, warmup=3):
        for _ in range(warmup):
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

    def flash_inputs(B, T, H, K, dk, dv, dtype, Tk=None, offset=0):
        """q, k, v; with ``offset``, each in storage that starts that many
        elements into its buffer."""
        dt, Tk = getattr(torch, dtype), Tk or T
        out = []
        for shape in ((B, T, H, dk), (B, Tk, K, dk), (B, Tk, K, dv)):
            x = randn(*shape).to(dt)
            if offset:
                buf = torch.empty(x.numel() + offset, dtype=dt, device=dev)
                x = buf[offset:].view(shape).copy_(x)
            out.append(x)
        return out

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

    def grad_refs(case, q, k, v, out, lse, g):
        """The plain backward on the kernel's output and lse, and the
        oracle's autograd, both in fp32 on fp32 upcasts of the inputs."""
        causal, window = case[6:8]
        qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, g))
        plain = ref.flash_attention_bwd_ref(qf, kf, vf, of, lse, gf, causal=causal,
                                            window=window)
        leaves = [x.clone().requires_grad_() for x in (qf, kf, vf)]
        oracle = torch.autograd.grad(
            ref.flash_attention_ref(*leaves, causal=causal, window=window), leaves, gf)
        return plain, oracle

    def bwd_want(case):
        """The backward variant a case must launch: ``wgmma`` for bf16 that
        the TMA can load (dk and dv multiples of 8, 16-byte aligned storage),
        ``simt`` otherwise."""
        dk, dv, dtype, offset = *case[4:6], case[8], (case[10:] or (0,))[0]
        tma = dtype == "bfloat16" and dk % 8 == 0 and dv % 8 == 0 and offset % 8 == 0
        return "wgmma" if tma else "simt"

    def grad_check(case, kind, got, plain, oracle):
        """Largest |g - oracle| over dq, dk, dv and, for bf16, the largest
        share of the per-element bound against the plain backward and the
        largest relative L2 error against the oracle; raises on a
        disagreement, a NaN or the wrong variant."""
        dtype, want = case[8], bwd_want(case)
        err, share, l2 = 0.0, 0.0, 0.0
        for g, w, o in zip(got, plain, oracle):
            g = g.float()
            err = max(err, (g - o).abs().max().item())
            if dtype == "bfloat16":
                limit = (GRAD_RTOL * w.abs() + GRAD_ROW * w.pow(2).mean(-1, keepdim=True).sqrt()
                         + GRAD_FLOOR * w.pow(2).mean().sqrt())
                share = max(share, ((g - w).abs() / limit).max().item())
                l2 = max(l2, ((g - o).norm() / o.norm()).item())
            elif (g - w).abs().max().item() > GRAD_FP32_TOL:
                err = math.inf
        nan = any(bool(torch.isnan(x).any()) for x in got)
        ok = (share <= 1.0 and l2 <= GRAD_ORACLE_L2 if dtype == "bfloat16"
              else err <= GRAD_FP32_TOL)
        if not ok or nan or kind != want:
            raise AssertionError(f"flash_attention backward ({kind}, expected {want}) on {case}: "
                                 f"max_abs_err vs the oracle {err}, share of the bf16 bound "
                                 f"{share}, relative L2 vs the oracle {l2}, NaN {nan}")
        return err, share, l2

    def bwd_note(dtype, err, share, l2):
        if dtype == "bfloat16":
            return (f"dq/dk/dv max_abs_err vs the fp32 oracle {err:.3e}, relative L2 {l2:.3e} "
                    f"(limit {GRAD_ORACLE_L2}), {share:.3f} of the per-element bound vs the "
                    f"plain backward")
        return f"dq/dk/dv max_abs_err vs the oracle {err:.3e} (tol {GRAD_FP32_TOL})"

    def bwd_split(kind, q, k, v, out, lse, g, causal, window, calls=10):
        """Device ms of each launch of one flash_attention_bwd call on the
        ``kind`` key of BWD_LAUNCHES, the mean of torch.profiler's kernel
        times over ``calls`` calls."""
        from torch.profiler import ProfilerActivity, profile

        launches = BWD_LAUNCHES[kind]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)
            torch.cuda.synchronize()
        us, count = dict.fromkeys(launches, 0.0), dict.fromkeys(launches, 0)
        for ev in prof.key_averages():
            for part, key in launches.items():
                if key in ev.key:
                    us[part] += (getattr(ev, "device_time_total", None)
                                 or getattr(ev, "cuda_time_total", 0))
                    count[part] += ev.count
        # The trace may miss a launch at its edges; more than one per call is
        # a fault.
        if not all(0 < count[n] <= calls and us[n] > 0 for n in launches):
            raise AssertionError(f"launches {count} and device us {us} in {calls} calls")
        return {n: us[n] / count[n] / 1e3 for n in launches}

    def attention_at_train_shape(case, label):
        """Flash attention's forward and backward at a training shape, each
        checked against its plain version and timed beside it, its bound and
        SDPA (the window as a boolean mask; the backward under autograd),
        with the SDPA backend that ran; the backward's time split by launch.
        Returns the two JSON records, ``launches`` still None."""
        B, T, H, K, dk, dv, causal, window, dtype = case
        q, k, v = flash_inputs(B, T, H, K, dk, dv, dtype)
        out, expect, kind = flash_run(case, q, k, v)
        err, share = flash_check(case, out, expect, kind)
        del expect
        mask = dict(causal=causal, window=window)
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, **mask), 20)
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **mask), 3)
        keep = attn_pairs(T, causal, window)
        # Yardstick: SDPA on the same q, k, v; a window goes in as a mask.
        sdpa_mask = (dict(attn_mask=keep.to(dev)) if window
                     else dict(is_causal=causal))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **sdpa_mask), 20)
        pairs = B * H * int(keep.sum())  # unmasked (query, key) pairs
        flops = 2 * (dk + dv) * pairs
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out))
        bound_ms, bound_by = bound(flops, PEAK_BF16_FLOPS, nbytes)
        print(f"[kernel] flash_attention {case} {kind} ({label}): max_abs_err {err:.3e}"
              + (f", {share:.3f} of the per-element bound" if dtype == "bfloat16" else "")
              + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, {pairs} pairs); {smi}")
        fwd = {"name": "flash_attention", "variant": kind, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:128",
               "shape": list(case), "launches": None, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}

        # The backward: checked against its plain version and the oracle,
        # then timed beside the oracle's autograd (its forward recomputed, as
        # a backward through the oracle does it), its bound and SDPA's.
        g = randn(*out.shape).to(out.dtype)
        out, lse = flash_attention_fwd(q, k, v, lse=True, **mask)
        before = dict(flash_attention_bwd.launches_by_variant)
        got = flash_attention_bwd(q, k, v, out, lse, g, **mask)
        bwd_kind, = (n for n, c in flash_attention_bwd.launches_by_variant.items()
                     if c != before[n])
        plain, oracle = grad_refs(case, q, k, v, out, lse, g)
        torch.cuda.synchronize()
        bwd_err, bwd_share, bwd_l2 = grad_check(case, bwd_kind, got, plain, oracle)
        del plain, oracle
        split_kind = ("wgmma d 256" if bwd_kind == "wgmma" and max(dk, dv) > MAX_FUSED_BWD_DIM
                      else bwd_kind)
        # The d-256 kernels use no atomics: a second call must repeat the first
        # bit for bit.
        repeat_note = ""
        if split_kind == "wgmma d 256":
            again = flash_attention_bwd(q, k, v, out, lse, g, **mask)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd on {case} does not repeat bit for bit")
            repeat_note = "; a second call repeats it bit for bit"
            del again
        del got
        torch.cuda.empty_cache()
        bwd_ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, g, **mask), 20)
        split = bwd_split(split_kind, q, k, v, out, lse, g, **mask)
        # Past head dim 128: the time at every head-group count the launch
        # could choose (a divisor of H/K), beside bwd_groups' choice.
        groups_rec = {}
        if split_kind == "wgmma d 256":
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            chosen = flash_mod.bwd_groups(B, K, T, H // K, sms)
            choose, by_groups = flash_mod.bwd_groups, {}
            try:
                for n in (n for n in range(1, H // K + 1) if (H // K) % n == 0):
                    flash_mod.bwd_groups = lambda *_, n=n: n
                    by_groups[n] = time_ms(
                        lambda: flash_attention_bwd(q, k, v, out, lse, g, **mask), 20)
            finally:
                flash_mod.bwd_groups = choose
            print(f"[kernel] flash_attention_bwd {case} ({label}) ms per call by head groups "
                  f"(blocks = {B * K * -(-T // 64)} key tiles x groups on {sms} SMs): "
                  + ", ".join(f"{n} {t:.4f}" for n, t in by_groups.items())
                  + f"; bwd_groups chooses {chosen}")
            groups_rec = {"head_groups": chosen,
                          "ms_by_head_groups": {str(n): t for n, t in by_groups.items()}}
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        bwd_plain_ms = time_ms(lambda: torch.autograd.grad(
            ref.flash_attention_ref(*leaves, **mask), leaves, g), 3)
        qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_mask)
        gt = g.transpose(1, 2).contiguous()
        bwd_library_ms = time_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), gt,
                                                             retain_graph=True), 20)
        backend, top = sdpa_backend(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_mask),
            (qt, kt, vt), gt))
        # Five products per unmasked pair (S, dP, dV, dK, dQ: 2 FLOP per
        # multiply-add over 3 dk + 2 dv); q, k, v, out, dout, lse read once
        # and dq, dk, dv written once.
        bwd_flops = 2 * (3 * dk + 2 * dv) * pairs
        bwd_bytes = (sum(x.numel() * x.element_size() for x in (q, k, v, out, g, lse))
                     + sum(x.numel() * x.element_size() for x in (q, k, v)))
        bwd_bound_ms, bwd_bound_by = bound(bwd_flops, PEAK_BF16_FLOPS, bwd_bytes)
        main_ms = sum(split[n] for n in BWD_MAIN[split_kind])
        # Past head dim 128 the dq kernel recomputes S and dP: seven products
        # per unmasked pair (4 dk + 3 dv).
        design_note, design = "", {}
        if split_kind == "wgmma d 256":
            flops7 = 2 * (4 * dk + 3 * dv) * pairs
            bound7_ms, _ = bound(flops7, PEAK_BF16_FLOPS, bwd_bytes)
            design_note = (f"; the split design's seven products {flops7 / 1e9:.2f} GFLOP, bound "
                           f"{bound7_ms:.4f} ms, of which the main kernels reach "
                           f"{100 * bound7_ms / main_ms:.1f} %")
            design = {"bound_7_products_ms": bound7_ms}
        print(f"[kernel] flash_attention_bwd {case} {bwd_kind} ({label}): "
              + bwd_note(dtype, bwd_err, bwd_share, bwd_l2) + repeat_note
              + f"; kernel {bwd_ms:.4f} ms, plain (the oracle's autograd, forward recomputed) "
              f"{bwd_plain_ms:.4f} ms, sdpa backward {bwd_library_ms:.4f} ms (forward and "
              f"backward on SDPA's {backend} backend: {top}), bound "
              f"{bwd_bound_ms:.4f} ms ({bwd_bound_by}: {bwd_flops / 1e9:.2f} GFLOP, "
              f"{bwd_bytes / 1e6:.1f} MB); {smi}")
        print(f"[kernel] flash_attention_bwd {case} ({label}) device ms per call by launch: "
              + ", ".join(f"{n} {t:.4f}" for n, t in split.items())
              + f" (sum {sum(split.values()):.4f}); the main kernel"
              f"{'s' if len(BWD_MAIN[split_kind]) > 1 else ''} reach "
              f"{100 * bwd_bound_ms / main_ms:.1f} % of the bound, the call "
              f"{100 * bwd_bound_ms / bwd_ms:.1f} %" + design_note)
        bwd = {"name": "flash_attention_bwd", "variant": bwd_kind, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:128",
               "replaces_note": "the backward of its custom_vjp (src/repro/kernels/ops.py:30-60), "
                                "the oracle's vjp",
               "shape": list(case), "launches": None, "max_abs_err": bwd_err, "ms": bwd_ms,
               "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms, "bound_by": bwd_bound_by,
               "library_ms": bwd_library_ms, "library_backend": backend, "split_ms": split,
               **design, **groups_rec}
        del q, k, v, qt, kt, vt, out, lse, g, gt, o_sdpa, leaves
        torch.cuda.empty_cache()
        return fwd, bwd

    # The backward against its plain version and the oracle's autograd.
    for case in BWD_CASES:
        B, T, H, K, dk, dv, causal, window, dtype, *tk = case
        q, k, v = flash_inputs(B, T, H, K, dk, dv, dtype, *tk)
        g = randn(B, T, H, dv).to(q.dtype)
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, lse=True)
        _, lse_plain = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
        before = dict(flash_attention_bwd.launches_by_variant)
        got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)
        kind, = (n for n, c in flash_attention_bwd.launches_by_variant.items() if c != before[n])
        plain, oracle = grad_refs(case, q, k, v, out, lse, g)
        torch.cuda.synchronize()
        lse_err = (lse - lse_plain).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise AssertionError(f"flash_attention lse on {case}: max_abs_err {lse_err}")
        err, share, l2 = grad_check(case, kind, got, plain, oracle)
        print(f"[kernel] flash_attention_bwd {case} {kind}: lse max_abs_err {lse_err:.3e} "
              f"(tol {LSE_TOL}); " + bwd_note(dtype, err, share, l2))
        del q, k, v, g, out, lse, got, plain, oracle

    # llama3-8b's training shape (d 128): no main path runs it yet; its
    # records take their wrappers' launches on the training path (phase 6).
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_D128, "llama3-8b training shape")
    for rec in (fwd_rec, bwd_rec):
        rec["launches_note"] = ("the wrapper's launches on llama3.2-1b's training path "
                                "(d 64); no main path runs d 128 yet")
    records[("flash_attention", "llama3-8b train")] = fwd_rec
    records[("flash_attention_bwd", "llama3-8b train")] = bwd_rec
    # recurrentgemma-9b's training shape (d 256, MQA, window 2048); its records
    # take phase 6(d)'s launches.
    fwd_rec, bwd_rec = attention_at_train_shape(TRAIN_RG_ATTN,
                                                "recurrentgemma-9b training microbatch")
    records[("flash_attention", "recurrentgemma-9b train")] = fwd_rec
    records[("flash_attention_bwd", "recurrentgemma-9b train")] = bwd_rec

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

    def scan_bwd_err(a, h, h0, g):
        """Largest |kernel - plain| over da, db and dh0; raises beyond RGLRU_TOL."""
        got = rglru_scan_bwd(a, h, h0, g)
        want = ref.rglru_scan_bwd_ref(a, h, h0, g)
        torch.cuda.synchronize()
        err = max((x - y).abs().max().item() for x, y in zip(got, want))
        if not all(torch.allclose(x, y, atol=RGLRU_TOL, rtol=RGLRU_TOL)
                   for x, y in zip(got, want)):
            raise AssertionError(f"rglru_scan_bwd disagrees with its plain version at "
                                 f"{tuple(a.shape)}: max_abs_err {err}")
        return err

    for case in RGLRU_CASES:
        err = scan_err(*scan_inputs(*case))
        print(f"[kernel] rglru_scan {case}: max_abs_err {err:.3e} (tol {RGLRU_TOL})")
    for B, T, W, scale in RGLRU_BWD_CASES:
        a, b, h0 = scan_inputs(B, T, W)
        h0 = h0 * scale
        err = scan_bwd_err(a, rglru_scan_fwd(a, b, h0), h0, randn(B, T, W))
        print(f"[kernel] rglru_scan_bwd {(B, T, W)} (h0 x {scale:g}): da/db/dh0 max_abs_err "
              f"{err:.3e} (atol and rtol {RGLRU_TOL})")

    def scan_record(name, shape, err, ms, plain_ms, bound_ms, bound_by, **extra):
        return {"name": name, "variant": f"{name}_kernel", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
                "replaces": "src/repro/kernels/rglru_scan.py:78", "shape": list(shape),
                "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                "library_note": "no single PyTorch call computes the recurrence", **extra}

    # Timed: the forward at the prefill and the training shape, the backward
    # at both.  The forward moves a, b in and h out, one fma per element; the
    # backward g, a, h in and da, db out, an add and two multiplies per
    # element; both read h0 (and the backward writes dh0) once (fp32).  The
    # backward's plain time is the oracle's autograd with its forward, as the
    # parent tree ran it; the plain reverse loop is timed beside it.
    scan_times = {}
    for shape in (RGLRU_SLICE, RGLRU_TRAIN):
        a, b, h0 = scan_inputs(*shape)
        g = randn(*shape)
        err = scan_err(a, b, h0)
        h = rglru_scan_fwd(a, b, h0)
        bwd_err = scan_bwd_err(a, h, h0, g)
        n, n0 = a.numel(), h0.numel()
        fwd = dict(ms=time_ms(lambda: rglru_scan_fwd(a, b, h0), 20),
                   plain_ms=time_ms(lambda: ref.rglru_scan_ref(a, b, h0), 1, warmup=1))
        fwd.update(zip(("bound_ms", "bound_by"), bound(2 * n, PEAK_FP32_FLOPS, 4 * (3 * n + n0))))
        leaves = [x.detach().requires_grad_() for x in (a, b, h0)]
        bwd = dict(ms=time_ms(lambda: rglru_scan_bwd(a, h, h0, g), 20),
                   plain_ms=time_ms(lambda: torch.autograd.grad(
                       ref.rglru_scan_ref(*leaves), leaves, g), 1, warmup=1),
                   plain_loop_ms=time_ms(lambda: ref.rglru_scan_bwd_ref(a, h, h0, g), 1,
                                         warmup=1))
        bwd_bytes = 4 * (5 * n + 2 * n0)
        bwd.update(zip(("bound_ms", "bound_by"), bound(3 * n, PEAK_FP32_FLOPS, bwd_bytes)))
        scan_times[shape] = (err, fwd, bwd_err, bwd)
        print(f"[kernel] rglru_scan {shape}: max_abs_err {err:.3e}; kernel {fwd['ms']:.4f} ms, "
              f"plain {fwd['plain_ms']:.4f} ms, no library call (no single PyTorch call "
              f"computes this recurrence), bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}: "
              f"{4 * (3 * n + n0) / 1e6:.1f} MB); {smi}")
        print(f"[kernel] rglru_scan_bwd {shape}: max_abs_err {bwd_err:.3e}; kernel "
              f"{bwd['ms']:.4f} ms, plain (the oracle's autograd, forward recomputed) "
              f"{bwd['plain_ms']:.4f} ms, plain reverse loop {bwd['plain_loop_ms']:.4f} ms, no "
              f"library call, bound {bwd['bound_ms']:.4f} ms ({bwd['bound_by']}: "
              f"{bwd_bytes / 1e6:.1f} MB), {100 * bwd['bound_ms'] / bwd['ms']:.1f} % of it; {smi}")
        del a, b, h0, g, h, leaves
        torch.cuda.empty_cache()
    err, fwd, _, _ = scan_times[RGLRU_SLICE]
    records[("rglru_scan", "recurrentgemma-9b")] = scan_record(
        "rglru_scan", RGLRU_SLICE, err, **fwd)
    err, fwd, bwd_err, bwd = scan_times[RGLRU_TRAIN]
    records[("rglru_scan", "recurrentgemma-9b train")] = scan_record(
        "rglru_scan", RGLRU_TRAIN, err, **fwd)
    prefill_bwd = scan_times[RGLRU_SLICE][3]
    records[("rglru_scan_bwd", "recurrentgemma-9b train")] = scan_record(
        "rglru_scan_bwd", RGLRU_TRAIN, bwd_err, **bwd,
        replaces_note="the backward of its custom_vjp (src/repro/kernels/ops.py:63-78), the vjp "
                      "of ref.rglru_scan_ref",
        prefill_shape={"shape": list(RGLRU_SLICE), "max_abs_err": scan_times[RGLRU_SLICE][2],
                       **prefill_bwd})

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
    kernels = {"flash_attention": flash_attention_fwd, "flash_attention_bwd": flash_attention_bwd,
               "rglru_scan": rglru_scan_fwd, "rglru_scan_bwd": rglru_scan_bwd}

    def reset_counts():
        for fn in kernels.values():
            fn.launches = 0
        for fn in (flash_attention_fwd, flash_attention_bwd):
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)

    served = {}  # each main path's result
    for arch, batch, prompt_len, gen_len in SERVE:
        full = get_config(arch)
        plan = layer_plan(full)
        kinds = plan.pattern * plan.n_scan + plan.tail
        expect = {"flash_attention": kinds.count("attn"), "flash_attention_bwd": 0,
                  "rglru_scan": kinds.count("rec"), "rglru_scan_bwd": 0}
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
    if (launches != {"flash_attention": 16, "flash_attention_bwd": 0, "rglru_scan": 0,
                     "rglru_scan_bwd": 0} or flash_variants["wgmma"] != 16):
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
    # (a) Flash gradients on the card, through the autograd Function, against
    # the plain backward and the oracle's autograd.
    for case in GRAD_CASES:
        B, T, H, K, dk, dv, causal, window, dtype = case
        inputs = flash_inputs(B, T, H, K, dk, dv, dtype)
        leaves = [x.clone().requires_grad_() for x in inputs]
        before = dict(flash_attention_fwd.launches_by_variant)
        before_bwd = dict(flash_attention_bwd.launches_by_variant)
        out = ops.flash_attention(*leaves, causal, window)
        kind, = (n for n, c in flash_attention_fwd.launches_by_variant.items()
                 if c != before[n])
        g = randn(*out.shape).to(out.dtype)
        grads = torch.autograd.grad(out, leaves, g)
        bwd_kind, = (n for n, c in flash_attention_bwd.launches_by_variant.items()
                     if c != before_bwd[n])
        expect, lse = ref.flash_attention_lse_ref(*inputs, causal=causal, window=window)
        plain, oracle = grad_refs(case, *inputs, out.detach(), lse, g)
        torch.cuda.synchronize()
        err, share = flash_check(case, out.detach(), expect, kind)
        print(f"[train] flash_attention grads {case} forward {kind}, backward {bwd_kind}: "
              f"forward max_abs_err {err:.3e}; "
              + bwd_note(dtype, *grad_check(case, bwd_kind, grads, plain, oracle)))
        del inputs, leaves, out, g, grads, expect, lse, plain, oracle

    for arch, _, _, _ in SERVE:
        reset_counts()
        rows, worst = smoke_train_steps(arch, dev)
        launches = {name: fn.launches for name, fn in kernels.items()}
        print(f"[train] {arch} smoke fp32, 3 steps x 2 microbatches, card vs CPU from one init: "
              f"losses {[(round(a, 6), round(b, 6)) for a, b, _, _ in rows]}, grad-norms "
              f"{[(round(c, 6), round(d, 6)) for _, _, c, d in rows]}, largest parameter "
              f"difference {worst:.3e} (atol {TRAIN_TOL['atol']}, rtol {TRAIN_TOL['rtol']}); "
              f"card launches " + ", ".join(f"{n} {c}" for n, c in launches.items()))
        # 3 steps of 2 microbatches.
        expect = {name: 3 * c for name, c in
                  expected_launches(layer_plan(get_config(arch, smoke=True)), 2).items()}
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
        # Calls of the plain versions during the run: there must be none.
        with counted_plain_calls() as plain_calls:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            res = train(arch, smoke=False, steps=n_steps, shape=shape, run=run, log_every=1,
                        device="cuda")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {name: fn.launches for name, fn in kernels.items()}
    flash_variants = dict(flash_attention_fwd.launches_by_variant)
    bwd_variants = dict(flash_attention_bwd.launches_by_variant)
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
              f"{n} {c / n_steps:g}" for n, c in flash_variants.items())
          + "; backward by variant: " + ", ".join(
              f"{n} {c / n_steps:g}" for n, c in bwd_variants.items())
          + f"); calls of the plain versions {plain_calls}; {smi}")
    per_step = expected_launches(layer_plan(full), micro)
    expect_flash = per_step["flash_attention"] * n_steps
    expect_bwd = per_step["flash_attention_bwd"] * n_steps
    if (launches["flash_attention_bwd"] != expect_bwd or bwd_variants["wgmma"] != expect_bwd
            or plain_calls):
        raise AssertionError(f"training launched the flash backward "
                             f"{launches['flash_attention_bwd']} times ({bwd_variants}), "
                             f"expected {expect_bwd}, all wgmma, and called the plain "
                             f"versions {plain_calls} times, expected never")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss in {[h['loss'] for h in hist]}")
    if launches["flash_attention"] != expect_flash or flash_variants["wgmma"] != expect_flash:
        raise AssertionError(f"training launched flash {launches['flash_attention']} times "
                             f"({flash_variants}), expected {expect_flash}, all wgmma")
    if launches["rglru_scan"] or launches["rglru_scan_bwd"]:
        raise AssertionError(f"llama training launched the scan: {launches}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"loss did not fall: step 1 {hist[0]['loss']}, "
                             f"step {n_steps} {hist[-1]['loss']}")

    # One microbatch's backward, with events around the whole and around each
    # attention backward (the kernel); the flash kernels at this shape beside
    # their plain versions and SDPA.
    model = Model(full, device=dev, generator=torch.Generator(dev).manual_seed(0))
    mb = SyntheticLMDataset(full, ShapeConfig("mb", seq, 1, "train"), seed=0).batch(0)
    mb = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in mb.items()}
    for _ in range(2):  # the first warms up; the second is reported
        fwd_ms, bwd_ms, calls = timed_microbatch(model, mb, {"attention": ops._FlashAttention})
    attn = calls["attention"]
    attn_ms = sum(t for t, _ in attn)
    print(f"[train] {arch} one microbatch (1 x {seq}): forward {fwd_ms:.2f} ms, backward "
          f"{bwd_ms:.2f} ms (with remat's recompute), of which the attention backward "
          f"(the kernel) {attn_ms:.2f} ms in {len(attn)} calls = "
          f"{100 * attn_ms / bwd_ms:.1f} %, {attn_ms / len(attn):.2f} ms and "
          f"{max(p for _, p in attn) / 1e9:.2f} GB of transient memory per call; {smi}")

    # The same microbatch and weights with the plain versions in place of the
    # kernels, in the forward, remat's recompute and the backward: the wgmma
    # kernels under autograd and remat at the training shape, held to the
    # plain versions' loss and gradients in bf16.  Then a recompute that is
    # wrong on purpose (window 2048 in remat's calls only) must exceed the
    # limits.
    plain = plain_entries()
    calls = []

    def wrong_recompute(q, k, v, causal, window, scale, lse=False):
        calls.append(None)  # the first L calls are the forward, then remat's
        return plain["_flash_fwd"](q, k, v, causal, seq // 2 if len(calls) > L else window,
                                   scale, lse)

    before = flash_attention_fwd.launches_by_variant["wgmma"]
    before_bwd = flash_attention_bwd.launches_by_variant["wgmma"]
    kernel_run = microbatch_grads(model, mb)
    wgmma = flash_attention_fwd.launches_by_variant["wgmma"] - before
    wgmma_bwd = flash_attention_bwd.launches_by_variant["wgmma"] - before_bwd
    plain_run = microbatch_grads(model, mb, plain)
    wrong_run = microbatch_grads(model, mb, {**plain, "_flash_fwd": wrong_recompute})
    del model
    gaps = grad_gaps(kernel_run, plain_run)
    wrong = grad_gaps(wrong_run, plain_run)
    print(f"[train] {arch} one microbatch (1 x {seq}), kernels (wgmma launches: forward "
          f"{wgmma}, backward {wgmma_bwd}) vs plain versions in forward, recompute and "
          f"backward: loss {kernel_run[0]:.6f} vs {plain_run[0]:.6f}, "
          f"relative gap {gaps[0]:.3e} (limit {TRAIN_BF16_TOL['loss']}); worst leaf "
          f"|g - g_plain| / |g_plain| {gaps[1]:.3e} ({gaps[3]}; limit {TRAIN_BF16_TOL['grad']}); "
          f"worst leaf norm gap {gaps[2]:.3e} (limit {TRAIN_BF16_TOL['norm']}); a wrong "
          f"recompute (window {seq // 2}): {wrong[0]:.3e}, {wrong[1]:.3e} ({wrong[3]}), "
          f"{wrong[2]:.3e}")
    if wgmma != 2 * L or wgmma_bwd != L:
        raise AssertionError(f"the kernel's microbatch launched wgmma {wgmma} / {wgmma_bwd} "
                             f"times (forward / backward), expected {2 * L} / {L}")
    if not (gaps[0] <= TRAIN_BF16_TOL["loss"] and gaps[1] <= TRAIN_BF16_TOL["grad"]
            and gaps[2] <= TRAIN_BF16_TOL["norm"]):
        raise AssertionError(f"training through the kernel disagrees with the plain version "
                             f"at the training shape: {gaps}")
    if wrong[1] <= TRAIN_BF16_TOL["grad"]:
        raise AssertionError(f"the gradient check does not see a wrong recompute: {wrong}")
    del kernel_run, plain_run, wrong_run
    torch.cuda.empty_cache()

    case = (1, seq, full.num_heads, full.num_kv_heads, hd, hd, True, 0, "bfloat16")
    fwd_rec, bwd_rec = attention_at_train_shape(case, f"{arch} training microbatch")
    fwd_rec["launches"] = launches["flash_attention"]
    in_step_ms = attn_ms / len(attn)
    print(f"[kernel] flash_attention_bwd at {arch}'s training shape: {in_step_ms:.4f} ms per "
          f"call in the microbatch's backward; {smi}")
    fwd_rec.update(
        backward_ms=bwd_rec["ms"], backward_ms_in_step=in_step_ms,
        backward_plain_ms=bwd_rec["plain_ms"], backward_bound_ms=bwd_rec["bound_ms"],
        backward_library_ms=bwd_rec["library_ms"],
        backward_launches=launches["flash_attention_bwd"])
    bwd_rec["launches"] = launches["flash_attention_bwd"]
    records[("flash_attention", f"{arch} train")] = fwd_rec
    records[("flash_attention_bwd", f"{arch} train")] = bwd_rec
    for name in ("flash_attention", "flash_attention_bwd"):
        records[(name, "llama3-8b train")]["launches"] = launches[name]
    torch.cuda.empty_cache()

    # (d) recurrentgemma-9b training at published widths, cut to 8 layers,
    # through train() with get_config patched in its namespace for the call.
    arch, layers, rows, seq, micro, n_steps = RG_TRAIN
    cfg = get_config(arch).with_overrides(num_layers=layers)
    plan = layer_plan(cfg)
    H, hd = cfg.num_heads, cfg.resolved_head_dim

    def expected_counts(microbatches):
        """launch_counts()' keys: the kernels' launches and, by variant, every
        flash launch, forward and backward, on ``wgmma``."""
        out = dict.fromkeys(launch_counts(), 0)
        out.update(expected_launches(plan, microbatches))
        out["flash_attention:wgmma"] = out["flash_attention"]
        out["flash_attention_bwd:wgmma"] = out["flash_attention_bwd"]
        return out

    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(learning_rate=3e-4, warmup_steps=2, total_steps=n_steps,
                        microbatches=micro, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res, step_counts, plain_calls = counted_training(
            arch, layers, ShapeConfig("train_4k", seq, rows, "train"), run, "cuda")
        launches = {name: fn.launches for name, fn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    n_params = sum(t.numel() for t in res["final_state"]["params"].values())
    trained_layers = res["config"].num_layers
    del res
    torch.cuda.empty_cache()
    for h, counts in zip(hist, step_counts):
        print(f"[train] {arch} {layers} layers step {h['step']}: loss {h['loss']:.6f}, grad-norm "
              f"{h['grad_norm']:.6f}, {h['seconds_per_step']:.4f} s; launches "
              + ", ".join(f"{n} {c}" for n, c in counts.items() if c))
    step_s = statistics.mean(h["seconds_per_step"] for h in hist[1:])
    tokens = rows * seq
    n_attn = plan.n_scan * plan.pattern.count("attn") + plan.tail.count("attn")
    pairs = int(attn_pairs(seq, cfg.causal, cfg.window).sum())
    # Model FLOPs: 6 N per token, plus windowed causal attention's QK^T and PV
    # (2 FLOP per multiply-add over dk + dv) over the unmasked pairs of each
    # row, three times (forward and backward) in each attention layer.  Remat's
    # recompute is not model work and is not counted.
    attn_flops = 3 * 2 * 2 * hd * H * pairs * rows * n_attn
    model_flops = 6 * n_params * tokens + attn_flops
    share = model_flops / step_s / PEAK_BF16_FLOPS
    expect = expected_counts(micro)
    print(f"[train] {arch} published widths at {trained_layers} layers ({plan.n_scan} x "
          f"{plan.pattern} + {plan.tail}), bf16 (fp32 moments, block remat), {n_params} "
          f"parameters, {rows} rows x {seq} tokens in {micro} microbatches, lr "
          f"{run.learning_rate} (warmup {run.warmup_steps}): {step_s:.4f} s per step after the "
          f"first (mean of steps 2-{n_steps}), {tokens / step_s:.1f} tokens/s, model FLOPs "
          f"{model_flops / 1e12:.2f} T per step ({attn_flops / 1e12:.2f} T attention over "
          f"{pairs} pairs per row and head), {100 * share:.2f} % of "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory {peak_gb:.2f} GB; launches per "
          f"step expected " + ", ".join(f"{n} {c}" for n, c in expect.items() if c)
          + f" (flash forward and backward at d {hd} both on wgmma); calls of the plain "
          f"versions {plain_calls}; {smi}")
    if trained_layers != layers or len(step_counts) != n_steps:
        raise AssertionError(f"trained {trained_layers} layers in {len(step_counts)} steps")
    if any(c != expect for c in step_counts) or plain_calls:
        raise AssertionError(f"{arch} training launched {step_counts}, expected {expect} per "
                             f"step, and called the plain versions {plain_calls} times, "
                             f"expected never")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss in {[h['loss'] for h in hist]}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"loss did not fall: step 1 {hist[0]['loss']}, "
                             f"step {n_steps} {hist[-1]['loss']}")

    # One microbatch's backward: events around the whole, each scan backward
    # and each attention backward; then the same microbatch with the parent
    # tree's scan route (its backward the oracle's autograd), swapped in for
    # this measurement only.
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    mb = SyntheticLMDataset(cfg, ShapeConfig("mb", seq, 1, "train"), seed=0).batch(0)
    mb = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in mb.items()}
    timed = {"scan": ops._RGLRUScan, "attention": ops._FlashAttention}
    for _ in range(2):  # the first warms up; the second is reported
        fwd_ms, bwd_ms, calls = timed_microbatch(model, mb, timed)
    oracle_scan, real_scan = parent_scan(), ops._RGLRUScan
    ops._RGLRUScan = oracle_scan
    try:
        _, oracle_bwd_ms, oracle_calls = timed_microbatch(model, mb, {**timed,
                                                                       "scan": oracle_scan})
    finally:
        ops._RGLRUScan = real_scan
    per_call = {label: sum(t for t, _ in c) / len(c) for label, c in calls.items()}

    def part(label, c):
        ms = sum(t for t, _ in c)
        return (f"the {label} backward {ms:.2f} ms in {len(c)} calls ({ms / len(c):.3f} ms each, "
                f"{100 * ms / bwd_ms:.1f} %)")

    print(f"[train] {arch} {layers} layers, one microbatch (1 x {seq}): forward {fwd_ms:.2f} ms, "
          f"backward {bwd_ms:.2f} ms (with remat's recompute), of which "
          + ", ".join(part(label, c) for label, c in calls.items())
          + f"; the parent's route (the scan backward through the oracle's autograd): backward "
          f"{oracle_bwd_ms:.2f} ms, of which the scan backward "
          f"{sum(t for t, _ in oracle_calls['scan']):.2f} ms in {len(oracle_calls['scan'])} "
          f"calls; {smi}")

    # The same microbatch through the kernels against the plain versions in the
    # forward, remat's recompute and the backward; then a scan backward wrong
    # on purpose (da from h_t) must exceed the limits.
    before = launch_counts()
    kernel_run = microbatch_grads(model, mb)
    mb_launches = {k: c - before[k] for k, c in launch_counts().items()}
    before = launch_counts()
    plain_run = microbatch_grads(model, mb, plain_entries())
    plain_launches = {k: c - before[k] for k, c in launch_counts().items() if c != before[k]}
    wrong_run = microbatch_grads(model, mb, plain_entries(wrong_scan_bwd=True))
    del model
    gaps = grad_gaps(kernel_run, plain_run)
    wrong = grad_gaps(wrong_run, plain_run)
    tol = RG_TRAIN_BF16_TOL
    print(f"[train] {arch} {layers} layers, one microbatch (1 x {seq}), kernels (launches "
          + ", ".join(f"{n} {c}" for n, c in mb_launches.items() if c)
          + f") vs plain versions in forward, recompute and backward: loss {kernel_run[0]:.6f} "
          f"vs {plain_run[0]:.6f}, relative gap {gaps[0]:.3e} (limit {tol['loss']}); worst leaf "
          f"|g - g_plain| / |g_plain| {gaps[1]:.3e} ({gaps[3]}; limit {tol['grad']}); worst leaf "
          f"norm gap {gaps[2]:.3e} (limit {tol['norm']}); a scan backward wrong on purpose "
          f"(da from h_t): {wrong[0]:.3e}, {wrong[1]:.3e} ({wrong[3]}), {wrong[2]:.3e}")
    if mb_launches != expected_counts(1) or plain_launches:
        raise AssertionError(f"the kernels' microbatch launched {mb_launches}, expected "
                             f"{expected_counts(1)}; the plain one {plain_launches}")
    if not (gaps[0] <= tol["loss"] and gaps[1] <= tol["grad"] and gaps[2] <= tol["norm"]):
        raise AssertionError(f"{arch} training through the kernels disagrees with the plain "
                             f"versions at published widths: {gaps}")
    if wrong[1] <= tol["grad"]:
        raise AssertionError(f"the gradient check does not see a wrong scan backward: {wrong}")
    del kernel_run, plain_run, wrong_run
    torch.cuda.empty_cache()

    for (name, path), rec in records.items():
        if path == f"{arch} train":
            rec["launches"] = launches[name]
            rec["launches_per_step"] = launches[name] // n_steps
    records[("rglru_scan_bwd", f"{arch} train")]["ms_in_step"] = per_call["scan"]
    records[("flash_attention_bwd", f"{arch} train")]["ms_in_step"] = per_call["attention"]

    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
