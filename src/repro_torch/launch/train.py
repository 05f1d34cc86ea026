"""Training loop: data pipeline → train step → checkpoints → metrics.

Port of ``repro/launch/train.py`` for one device.  ``train`` is the library
entry (used by ``examples/quickstart_torch.py`` and ``chip_smoke.py``);
``main`` is the CLI.  Fault-tolerance wiring as in the reference:

* checkpoint every ``run.checkpoint_every`` steps — async, atomic,
  integrity-checked, writer elected through the paper's ALock
  (``repro_torch.coord``), in the JAX package's file format;
* restart: ``resume=True`` restores the newest verified checkpoint and the
  data pipeline continues at the restored step (stateless batch addressing).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint import CheckpointManager, load_checkpoint
from ..configs import RunConfig, ShapeConfig, get_config
from ..coord import CoordinationService
from ..data import SyntheticLMDataset, make_batch_iterator
from ..device import resolve_device
from ..kernels import ops
from ..models import Model, layer_plan
from .steps import build_train_step, init_train_state, restore_train_state


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A batch array on ``device``: integers (tokens, labels) as ``int64``,
    floating arrays (a stub frontend's embeddings) as ``float32``, the dtype
    that JAX's ``device_put`` keeps; the model casts them."""
    dtype = torch.float32 if np.issubdtype(array.dtype, np.floating) else torch.int64
    return torch.from_numpy(array).to(device, dtype)


def train(
    arch: str,
    *,
    smoke: bool = True,
    steps: int = 50,
    shape: Optional[ShapeConfig] = None,
    run: Optional[RunConfig] = None,
    resume: bool = False,
    log_every: int = 10,
    device=None,
) -> Dict:
    """Train ``arch`` for ``steps`` steps on one device (``None``: the CUDA
    card).  Returns ``{"history", "final_state", "config"}``; each history
    entry holds the step's metrics as floats, its ``step`` and
    ``seconds_per_step`` (host clock since the previous entry, after the
    device finished the step)."""
    cfg = get_config(arch, smoke=smoke)
    run = run or RunConfig(total_steps=steps, checkpoint_every=max(1, steps // 2))
    shape = shape or ShapeConfig("e2e", seq_len=128, global_batch=8, kind="train")
    dev = resolve_device(device)
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(run.seed))
    if dev.type == "cuda":
        plan = layer_plan(cfg)
        ops.prepare(plan.pattern + plan.tail)  # no build inside the timed loop

    svc = CoordinationService(num_hosts=1)
    ckpt = CheckpointManager(run.checkpoint_dir, every=run.checkpoint_every, svc=svc, host=0)
    step_fn = build_train_step(model, run)
    state = init_train_state(model, run)
    start_step = 0
    if resume:
        try:
            restored, start_step, _ = load_checkpoint(run.checkpoint_dir, state)
            restore_train_state(state, restored)
            print(f"[train] resumed from step {start_step}")
        except FileNotFoundError:
            pass

    data = SyntheticLMDataset(cfg, shape, seed=run.seed)
    it = make_batch_iterator(data, start_step=start_step)
    history = []
    try:
        t_last, n_since = time.perf_counter(), 0
        for i in range(start_step, steps):
            batch = {k: to_device(v, dev) for k, v in next(it).items()}
            state, metrics = step_fn(state, batch)
            n_since += 1
            if (i + 1) % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}  # waits for the step
                now = time.perf_counter()
                m["step"] = i + 1
                m["seconds_per_step"] = (now - t_last) / n_since
                t_last, n_since = now, 0
                history.append(m)
                print(f"[train] step {i + 1}/{steps} loss={m['loss']:.4f} "
                      f"grad_norm={m['grad_norm']:.3f} ({m['seconds_per_step']:.2f}s/step)")
            ckpt.maybe_save(i + 1, state, extra={"arch": arch})
        ckpt.wait()
    finally:
        it.close()
    return {"history": history, "final_state": state, "config": cfg}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    run = RunConfig(
        total_steps=args.steps,
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=max(1, args.steps // 2),
    )
    shape = ShapeConfig("cli", seq_len=args.seq_len, global_batch=args.batch, kind="train")
    out = train(args.arch, smoke=args.smoke, steps=args.steps, shape=shape,
                run=run, resume=args.resume, device=args.device)
    losses = [h["loss"] for h in out["history"]]
    print(f"[train] done; first logged loss {losses[0]:.4f} → last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
