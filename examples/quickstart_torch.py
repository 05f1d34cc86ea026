"""Quickstart for the PyTorch port: train a small LM and watch the loss fall.

    PYTHONPATH=src python examples/quickstart_torch.py [--arch llama3.2-1b] [--device cpu]

The port's counterpart of ``examples/quickstart.py``: the reduced ("smoke")
config of a GQA architecture, trained by ``repro_torch.launch.train.train``
on the CUDA card, or on the CPU with ``--device cpu``.  On the card every
attention layer runs the hand-written flash kernels forward and backward
(the smoke config is fp32, so their CUDA-core variants, which repeat a run
bit for bit); on the CPU their plain PyTorch versions run, the backward from
the same flash-backward equations.
"""

import argparse
import os
import tempfile

from repro_torch.configs import RunConfig, ShapeConfig
from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    out = train(
        args.arch,
        smoke=True,
        steps=args.steps,
        shape=ShapeConfig("quickstart", seq_len=64, global_batch=8, kind="train"),
        run=RunConfig(
            learning_rate=1e-3, warmup_steps=5, total_steps=args.steps,
            checkpoint_every=10 ** 9,
            checkpoint_dir=os.path.join(tempfile.gettempdir(), "repro_torch_quickstart"),
        ),
        log_every=5,
        device=args.device,
    )
    losses = [h["loss"] for h in out["history"]]
    print(f"\nquickstart: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'LEARNING' if losses[-1] < losses[0] else 'NOT LEARNING'})")


if __name__ == "__main__":
    main()
