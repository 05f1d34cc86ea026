"""End-to-end training on the PyTorch port: train a ~100M-parameter
llama-family model for a few hundred steps with checkpointing and resume.

    PYTHONPATH=src python examples/train_lm_torch.py              # ~100M, 200 steps, on the card
    PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu
    PYTHONPATH=src python examples/train_lm_torch.py --resume     # restart demo

The port's counterpart of ``examples/train_lm.py``, over
``repro_torch.launch.train.train``: the ~100M config is the llama3.2-1b
family at reduced width and depth (same block structure, GQA ratio and tied
embeddings); ``--tiny`` changes the scale only, not the code paths.  On the
card every attention layer runs the hand-written flash kernels forward and
backward; with ``--device cpu`` their plain PyTorch versions.
"""

import argparse
import os
import tempfile

import repro_torch.launch.train as train_mod
from repro_torch.configs import RunConfig, ShapeConfig, get_config
from repro_torch.models import param_count
from repro_torch.models.transformer import model_specs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    if args.tiny:
        overrides = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=128, vocab_size=512)
        steps = args.steps or 30
        shape = ShapeConfig("e2e", seq_len=64, global_batch=8, kind="train")
    else:
        # ~100M params: 12L, d=768, untouched llama3.2 structure otherwise.
        overrides = dict(num_layers=12, d_model=768, num_heads=12,
                         num_kv_heads=4, d_ff=2048, vocab_size=32768)
        steps = args.steps or 200
        shape = ShapeConfig("e2e", seq_len=256, global_batch=16, kind="train")

    cfg = get_config("llama3.2-1b").with_overrides(**overrides)
    n = param_count(model_specs(cfg))
    print(f"[train_lm] model: {n / 1e6:.1f}M params, {steps} steps")

    # train() looks its config up by name: a transient arch for this run.
    def patched(arch, smoke=False):
        return cfg if arch == "_train_lm" else get_config(arch, smoke)

    train_mod.get_config = patched
    run = RunConfig(
        learning_rate=6e-4, warmup_steps=max(10, steps // 20),
        total_steps=steps, checkpoint_every=max(10, steps // 4),
        checkpoint_dir=args.ckpt_dir,
    )
    out = train_mod.train("_train_lm", smoke=False, steps=steps, shape=shape, run=run,
                          resume=args.resume, log_every=max(1, steps // 20),
                          device=args.device)
    losses = [h["loss"] for h in out["history"]]
    print(f"[train_lm] loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    # Inside the warmup the rate ramps from 0: the loss is held past it only.
    if steps > run.warmup_steps:
        assert losses[-1] < losses[0], "training failed to reduce loss"


if __name__ == "__main__":
    main()
