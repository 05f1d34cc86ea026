"""Does xlstm-1.3b learn in a few steps at lr 3e-4, in bf16 and in fp32?

A witness for ``chip_smoke.py``'s phase 6(e), run on one CUDA card at the
published width and depth (48 blocks):

1. one batch's loss and gradients at the initial weights, through the
   training path (block remat), in bf16 and in fp32 (the bf16 weights upcast,
   so both see one set of values), compared as a whole and leaf by leaf;
2. ``train("xlstm-1.3b")`` at phase 6(e)'s rows, steps and rate
   (``XLSTM_TRAIN``) with one warmup step, in bf16 (the phase's path) and
   then in fp32, from one seed and one data stream; each run's losses and grad norms, and the first step's batch
   under the initial and the trained weights;
3. optionally (``--long-steps N``) bf16 at the same rate for N steps on rows
   of ``--long-seq`` tokens, to see whether the loss falls given more steps;
4. optionally (``--slope-depths``) ``chip_smoke.py``'s fp32 gradient check
   (``gradient_slope``) on one row at each depth and each of
   ``--slope-changes``: how far the loss's change along the gradient follows
   its first-order prediction.

``--legs`` picks among ``grads``, ``train`` and ``slope``.

Every figure is printed and written to
``chiprun_out/xlstm_witness_<legs>_<seq>.json``.

    python3 tools/xlstm_train_witness.py [--seq 2048] [--long-steps 16]
        [--long-seq 512] [--legs grads,train,slope] [--slope-depths 8,48]
        [--slope-changes 1e-4,1e-3,1e-2]

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ARCH = "xlstm-1.3b"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def config(dtype: str):
    from repro_torch.configs import get_config
    return get_config(ARCH).with_overrides(dtype=dtype)


def batch_of(cfg, shape, index, dev):
    import torch

    from repro_torch.data import SyntheticLMDataset
    b = SyntheticLMDataset(cfg, shape, seed=0).batch(index)
    return {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in b.items()}


def grads_at_init(shape, dev) -> dict:
    """Loss and gradients of batch 0 at the initial weights in bf16, then in
    fp32 on the same weights upcast."""
    import torch

    from repro_torch.launch.steps import grad_fn
    from repro_torch.models import Model

    out = {}
    cfg = config("bfloat16")
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    batch = batch_of(cfg, shape, 0, dev)
    t = time.perf_counter()
    loss_b, _, g_b = grad_fn(model, 1)(batch)
    torch.cuda.synchronize()
    out["bf16_s"] = time.perf_counter() - t
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    model = Model(config("float32"), device=dev, generator=torch.Generator(dev).manual_seed(0))
    model.load_state_dict(weights)
    del weights
    t = time.perf_counter()
    loss_f, _, g_f = grad_fn(model, 1)(batch)
    torch.cuda.synchronize()
    out["fp32_s"] = time.perf_counter() - t
    del model
    dot = nb = nf = nd = 0.0
    leaves = []
    for k, gf in g_f.items():
        gb = g_b[k].float()
        d, b2, f2 = float((gb * gf).sum()), float((gb * gb).sum()), float((gf * gf).sum())
        e2 = float(((gb - gf) ** 2).sum())
        dot, nb, nf, nd = dot + d, nb + b2, nf + f2, nd + e2
        leaves.append((k, math.sqrt(f2), math.sqrt(b2), math.sqrt(e2 / max(f2, 1e-30)),
                       d / max(math.sqrt(b2 * f2), 1e-30)))
    del g_b, g_f
    torch.cuda.empty_cache()
    out.update(loss_bf16=float(loss_b), loss_fp32=float(loss_f),
               grad_norm_bf16=math.sqrt(nb), grad_norm_fp32=math.sqrt(nf),
               cosine=dot / math.sqrt(nb * nf), rel_l2=math.sqrt(nd / nf))
    by_norm = sorted(leaves, key=lambda r: -r[1])
    out["largest_leaves"] = [
        {"leaf": k, "norm_fp32": f, "norm_bf16": b, "rel_l2": e, "cosine": c,
         "share_of_sq_norm": f * f / nf} for k, f, b, e, c in by_norm[:6]]
    worst = max(leaves, key=lambda r: r[3] if r[1] > 0 else -1)
    out["worst_leaf"] = {"leaf": worst[0], "rel_l2": worst[3], "cosine": worst[4]}
    print(f"[witness] {ARCH} batch 0 at the initial weights ({shape.global_batch} x "
          f"{shape.seq_len}): loss bf16 {out['loss_bf16']:.6f}, fp32 {out['loss_fp32']:.6f}; "
          f"grad norm bf16 {out['grad_norm_bf16']:.3f}, fp32 {out['grad_norm_fp32']:.3f}; "
          f"bf16 against fp32: cosine {out['cosine']:.6f}, relative L2 {out['rel_l2']:.4e}; "
          f"worst leaf {worst[0]} (relative L2 {worst[3]:.4e}, cosine {worst[4]:.6f}); "
          f"{out['bf16_s']:.1f} s / {out['fp32_s']:.1f} s")
    for r in out["largest_leaves"]:
        print(f"[witness]   largest gradient leaf {r['leaf']}: norm fp32 {r['norm_fp32']:.3f} "
              f"({100 * r['share_of_sq_norm']:.2f} % of the squared norm), bf16 "
              f"{r['norm_bf16']:.3f}, relative L2 {r['rel_l2']:.4e}, cosine {r['cosine']:.6f}")
    return out


def training(dtype, shape, steps, lr, dev) -> dict:
    """train(ARCH) in ``dtype`` for ``steps`` steps (warmup 1, no checkpoint),
    then batch 0 under the initial and the trained weights."""
    import torch

    from repro_torch.configs import RunConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model

    real = train_mod.get_config
    train_mod.get_config = lambda a, smoke=False: real(a, smoke).with_overrides(dtype=dtype)
    torch.cuda.reset_peak_memory_stats()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run = RunConfig(learning_rate=lr, warmup_steps=1, total_steps=steps,
                            microbatches=1, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
            t = time.perf_counter()
            res = train_mod.train(ARCH, smoke=False, steps=steps, shape=shape, run=run,
                                  log_every=1, device=dev)
            train_s = time.perf_counter() - t
    finally:
        train_mod.get_config = real
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    cfg = config(dtype)
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(run.seed))
    first = batch_of(cfg, shape, 0, dev)
    with torch.no_grad():
        before = model.loss(first)[0].item()
        model.load_state_dict(res["final_state"]["params"])
        after = model.loss(first)[0].item()
    del res, model, first
    torch.cuda.empty_cache()
    out = {"dtype": dtype, "rows": shape.global_batch, "seq": shape.seq_len, "steps": steps,
           "lr": lr, "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "seconds_per_step": [h["seconds_per_step"] for h in hist],
           "first_batch_before": before, "first_batch_after": after,
           "peak_gb": peak, "train_s": train_s}
    print(f"[witness] {ARCH} {dtype} {shape.global_batch} x {shape.seq_len}, {steps} steps at "
          f"lr {lr} (warmup 1): losses {[round(x, 6) for x in out['losses']]}, grad norms "
          f"{[round(x, 3) for x in out['grad_norms']]}; last loss below the first: "
          f"{out['losses'][-1] < out['losses'][0]}; batch 0: {before:.6f} at init, {after:.6f} "
          f"trained; peak {peak:.2f} GB; {train_s:.1f} s")
    return out


def chip_smoke():
    """chip_smoke.py as a module (it imports torch only inside main)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def slopes(cs, seq, depths, changes, dev) -> list:
    """chip_smoke.gradient_slope in fp32 on one row of batch 0, at each depth
    (the published pattern, cut to ``depth`` blocks) and each change."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import Model

    out = []
    for depth in depths:
        cfg = config("float32").with_overrides(num_layers=depth)
        model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
        row = batch_of(cfg, ShapeConfig("row", seq, 1, "train"), 0, dev)
        t = time.perf_counter()
        got = cs.gradient_slope(model, row, changes)
        secs = time.perf_counter() - t
        del model, row
        torch.cuda.empty_cache()
        for change, (measured, predicted) in zip(changes, got):
            out.append({"depth": depth, "change": change, "measured": measured,
                        "predicted": predicted, "ratio": measured / predicted})
            print(f"[witness] {ARCH} fp32 at {depth} blocks, 1 x {seq}: change {change:g} a "
                  f"side asked, the loss moved {measured:.6e}, predicted {predicted:.6e} "
                  f"(ratio {measured / predicted:.4f})")
        print(f"[witness]   {secs:.1f} s at {depth} blocks")
    return out


def main() -> int:
    import torch

    cs = chip_smoke()
    _, rows, seq, _, steps, lr = cs.XLSTM_TRAIN
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=seq)
    ap.add_argument("--long-steps", type=int, default=0)
    ap.add_argument("--long-seq", type=int, default=512)
    ap.add_argument("--legs", default="grads,train")
    ap.add_argument("--slope-depths", default="8,48")
    ap.add_argument("--slope-changes", default="1e-4,1e-3,1e-2")
    args = ap.parse_args()
    legs = args.legs.split(",")
    if not torch.cuda.is_available():
        print("xlstm_train_witness: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    print(card)
    shape = ShapeConfig("witness", args.seq, rows, "train")
    result = {"card": card, "runs": []}
    if "grads" in legs:
        result["grads_at_init"] = grads_at_init(shape, dev)
    for dtype in ("bfloat16", "float32") if "train" in legs else ():
        result["runs"].append(training(dtype, shape, steps, lr, dev))
    if "slope" in legs:
        result["slopes"] = slopes(cs, args.seq, [int(d) for d in args.slope_depths.split(",")],
                                  [float(c) for c in args.slope_changes.split(",")], dev)
    if args.long_steps:
        long_shape = ShapeConfig("witness_long", args.long_seq, rows, "train")
        result["runs"].append(training("bfloat16", long_shape, args.long_steps, lr, dev))
    out = ROOT / "chiprun_out" / f"xlstm_witness_{'_'.join(legs)}_{args.seq}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
