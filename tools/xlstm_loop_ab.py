"""Times xlstm-1.3b's host-bound paths on one CUDA card for several source
trees in one call, so that two versions of the package compare on one
machine (run them as parent, change, change, parent):

1. ``serve("xlstm-1.3b")`` at ``chip_smoke.py``'s phase 4 request: published
   width and depth (48 blocks, bf16), batch 8 x prompt 2048, then
   ``--tokens`` tokens: prefill s and decode ms/token, twice (the first run
   warms the allocator);
2. ``train("xlstm-1.3b")`` at phase 6(e)'s cut: 8 of 48 blocks, 4 rows x
   2048 tokens in one microbatch, ``--steps`` steps at lr 3e-4 (block
   remat): s per step after the first.

Each tree runs in a process of its own, in the order given, with only that
tree's ``src/`` on the path.  One JSON line is printed per run, and all of
them are written to ``chiprun_out/xlstm_loop_ab.json`` with the card's name
and power limit.

    python3 tools/xlstm_loop_ab.py TREE [TREE ...] [--tokens 8] [--steps 2]
        [--smoke --device cpu]

TREE: a directory that holds the package under ``src/``.  Needs one CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def child(tree: str, tokens: int, steps: int, smoke: bool, device: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    assert serve_mod.__file__.startswith(os.path.abspath(tree)), serve_mod.__file__
    seq = 64 if smoke else 2048
    out = {"tree": tree, "prefill_s": [], "decode_ms_per_token": []}
    for _ in range(2):
        res = serve_mod.serve("xlstm-1.3b", smoke=smoke, batch=8, prompt_len=seq,
                              gen_len=tokens, device=device)
        out["prefill_s"].append(res["prefill_seconds"])
        out["decode_ms_per_token"].append(res["decode_seconds_per_token"] * 1e3)
        del res
        if device == "cuda":
            torch.cuda.empty_cache()
    real = train_mod.get_config
    train_mod.get_config = lambda a, smoke=False: real(a, smoke).with_overrides(num_layers=8)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run = RunConfig(learning_rate=3e-4, warmup_steps=1, total_steps=steps,
                            microbatches=1, checkpoint_every=10 ** 9, checkpoint_dir=tmp)
            res = train_mod.train("xlstm-1.3b", smoke=smoke, steps=steps,
                                  shape=ShapeConfig("train", seq, 4, "train"), run=run,
                                  log_every=1, device=device)
    finally:
        train_mod.get_config = real
    out["s_per_step"] = [h["seconds_per_step"] for h in res["history"]]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config at 64 tokens (a check of the script itself)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0], args.tokens, args.steps, args.smoke,
                               args.device)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout if args.device == "cuda" else args.device
    print(card.strip())
    runs = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), os.path.abspath(tree),
                               "--child", "--tokens", str(args.tokens), "--steps", str(args.steps),
                               "--device", args.device] + ["--smoke"] * args.smoke,
                              capture_output=True, text=True, cwd=os.path.abspath(tree))
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "xlstm_loop_ab.json"), "w") as f:
        json.dump({"card": card.strip(), "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
