"""Training loop: data pipeline → train step → checkpoints → metrics.

Port of ``repro/launch/train.py``.  ``train`` is the library entry (used by
``examples/quickstart_torch.py`` and ``chip_smoke.py``); ``main`` is the
CLI.  On a mesh of more than one rank every rank calls ``train`` inside one
initialised process group (``launch.mesh.spawn_ranks`` starts such ranks on
one host); each draws the same global batch from the stateless pipeline and
the step takes its rows.  On a ``(pod, data, model)`` mesh each rank holds
only its blocks of the parameters and moments (FSDP on ``data``, TP on
``model``: ``sharding/shard.py``), the same blocks in every pod, and only
they cross the slow fabric (``launch/steps.py``).  Fault-tolerance wiring as in the
reference:

* checkpoint every ``run.checkpoint_every`` steps — async, atomic,
  integrity-checked, in the JAX package's file format and layout: whole
  tensors (gathered over ``data`` and ``model``; swiglu's ``wi`` as ``[gate
  | up]``), with a leading pod dim in ``local`` mode and for ``ef``
  (stacked over the pod group); rank 0 writes, its writer elected through
  the paper's ALock (``repro_torch.coord``);
* restart: ``resume=True`` restores the newest verified checkpoint on every
  rank (each takes its pod's slice and its blocks, so a checkpoint of one
  mesh resumes on another) and the data pipeline continues at the restored
  step (stateless batch addressing).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch llama3.2-1b --mesh-shape 2,1 --mesh-axes pod,data --sync-mode local
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-1b --mesh-shape 2,2 --mesh-axes data,model
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-1b --mesh-shape 2,1,2 --mesh-axes pod,data,model --sync-mode sync
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager, load_checkpoint
from ..configs import RunConfig, ShapeConfig, get_config
from ..coord import CoordinationService
from ..data import SyntheticLMDataset, make_batch_iterator
from ..kernels import ops
from ..models import Model, layer_plan
from .mesh import TIMEOUT, make_mesh
from .steps import (build_train_step, checkpoint_like, checkpoint_tree, init_train_state,
                    pod_slice, restore_train_state)


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
    mesh_shape=(1, 1),
    mesh_axes=("data", "model"),
    run: Optional[RunConfig] = None,
    resume: bool = False,
    log_every: int = 10,
    num_hosts: int = 1,
    device=None,
) -> Dict:
    """Train ``arch`` for ``steps`` steps on this rank of the mesh
    ``mesh_shape`` over ``mesh_axes`` (``launch.mesh.make_mesh``; ``device``
    ``None``: the CUDA card).  Returns ``{"history", "final_state",
    "config"}``; each history entry holds the step's metrics as floats (the
    mean over ranks), its ``step`` and ``seconds_per_step`` (host clock
    since the previous entry, after the device finished the step); on more
    than one rank also, per step since the previous entry, each group's
    ``wire_bytes`` and ``exchange_seconds`` (``launch.mesh.Traffic``).
    ``num_hosts`` sizes the coordination service that elects the
    checkpoint writer."""
    cfg = get_config(arch, smoke=smoke)
    run = run or RunConfig(total_steps=steps, checkpoint_every=max(1, steps // 2))
    shape = shape or ShapeConfig("e2e", seq_len=128, global_batch=8, kind="train")
    mesh = make_mesh(mesh_shape, mesh_axes, device)
    dev, rank0 = mesh.device, not any(mesh.coords.values())
    model = Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(run.seed),
                  mesh=mesh)
    if dev.type == "cuda":
        plan = layer_plan(cfg)
        ops.prepare(plan.pattern + plan.tail)  # no build inside the timed loop

    svc = CoordinationService(num_hosts=max(num_hosts, 1))
    ckpt = CheckpointManager(run.checkpoint_dir, every=run.checkpoint_every, svc=svc, host=0)
    step_fn = build_train_step(model, run, mesh)
    state = init_train_state(model, run, mesh)
    start_step = 0
    if resume:
        try:
            restored, start_step, _ = load_checkpoint(
                run.checkpoint_dir, checkpoint_like(state, run, mesh, model.layout))
            restore_train_state(state, pod_slice(restored, run, mesh, model.layout))
            print(f"[train] resumed from step {start_step}")
        except FileNotFoundError:
            pass

    data = SyntheticLMDataset(cfg, shape, seed=run.seed)
    it = make_batch_iterator(data, start_step=start_step)
    history = []
    try:
        t_last, n_since = time.perf_counter(), 0
        mesh.traffic.reset()
        for i in range(start_step, steps):
            batch = {k: to_device(v, dev) for k, v in next(it).items()}
            state, metrics = step_fn(state, batch)
            n_since += 1
            if (i + 1) % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}  # waits for the step
                now = time.perf_counter()
                m["step"] = i + 1
                m["seconds_per_step"] = (now - t_last) / n_since
                if mesh.world_size > 1:
                    m["wire_bytes"] = {g: b / n_since for g, b in mesh.traffic.wire_bytes.items()}
                    m["exchange_seconds"] = {g: t / n_since
                                             for g, t in mesh.traffic.seconds.items()}
                    mesh.traffic.reset()
                t_last, n_since = now, 0
                history.append(m)
                if rank0:
                    print(f"[train] step {i + 1}/{steps} loss={m['loss']:.4f} "
                          f"grad_norm={m['grad_norm']:.3f} ({m['seconds_per_step']:.2f}s/step)")
            if (i + 1) % ckpt.every == 0:
                tree = checkpoint_tree(state, run, mesh, model.layout)
                if rank0:
                    ckpt.maybe_save(i + 1, tree, extra={"arch": arch})
                del tree
        ckpt.wait()
    finally:
        it.close()
    return {"history": history, "final_state": state, "config": cfg}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--mesh-shape", default="1,1", help="axis sizes, e.g. 2,1")
    ap.add_argument("--mesh-axes", default="data,model", help="axis names, e.g. pod,data")
    ap.add_argument("--sync-mode", default="flat",
                    help="flat, sync or local; other than flat needs a pod axis above 1")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    mesh_shape = tuple(int(s) for s in args.mesh_shape.split(","))
    mesh_axes = tuple(args.mesh_axes.split(","))
    if args.sync_mode != "flat" and dict(zip(mesh_axes, mesh_shape)).get("pod", 1) == 1:
        ap.error(f"--sync-mode {args.sync_mode} needs a pod axis above 1 in --mesh-axes "
                 "and --mesh-shape")
    world = int(np.prod(mesh_shape))
    # A mesh of several ranks: one process a rank, started by torchrun, which
    # sets the rendezvous (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).
    own_group = world > 1 and not dist.is_initialized()
    if own_group:
        dist.init_process_group("gloo", init_method="env://", timeout=TIMEOUT)
    run = RunConfig(
        total_steps=args.steps,
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=max(1, args.steps // 2),
        sync_mode=args.sync_mode,
    )
    shape = ShapeConfig("cli", seq_len=args.seq_len, global_batch=args.batch, kind="train")
    try:
        out = train(args.arch, smoke=args.smoke, steps=args.steps, shape=shape,
                    mesh_shape=mesh_shape, mesh_axes=mesh_axes, run=run, resume=args.resume,
                    device=args.device)
    finally:
        if own_group:
            dist.destroy_process_group()
    losses = [h["loss"] for h in out["history"]]
    print(f"[train] done; first logged loss {losses[0]:.4f} → last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
