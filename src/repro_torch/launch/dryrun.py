"""Multi-pod dry run: one rank's step of every (architecture x input-shape)
cell on the production meshes, on the ``meta`` device, with its FLOPs, HBM
bytes, wire bytes and memory.

Port of ``repro/launch/dryrun.py``, with the same tables, CLI and record
layout.  Where the reference lowered and compiled the whole mesh's program
on 512 host devices, the port builds rank 0's model on a mesh of the
production shape (``(16, 16)`` over ``(data, model)``, or ``(2, 16, 16)``
with ``pod``) that has no process group (``launch.mesh.meta_mesh``), with
every tensor on ``meta``, and runs the rank's step under
``launch.roofline.StepCounter``: a train step (``launch.steps``), a prefill
(``Model.prefill``; an encoder's ``build_encode_step``), or a decode step
from a cache of ``seq_len``.  Nothing is drawn or allocated; the collectives
count their wire bytes and move nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k [--multi-pod] [--sync-mode sync] [--out results/]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/

Each cell writes ``results/<arch>__<shape>__<mesh>__<mode>.json`` with
``params``, ``model_flops``, ``memory_analysis`` (per-rank bytes: the
argument bytes are the rank's train state, parameters and moments in
``optimizer_state_dtype`` and int8's error feedback, or its serving state,
parameters and KV cache, and the batch it is given; the temporaries the
step's highest live bytes over them), ``parsed`` (the counted FLOPs and
HBM bytes per rank and the wire bytes per rank over NVLink and
InfiniBand, ``launch/roofline.py``) and ``collectives`` (calls and wire
bytes per group).  A cell that the model
refuses on the mesh is written ``skipped`` with the refusal's text, as the
reference writes ``shape_cells``' skips; only the expert-parallel island
refuses, where the reference's ``shard_map`` raises (``models/moe.py``:
expert weights that do not split evenly over ``model`` and ``data``), at
the step's first MoE call.  A width that does not divide over its ranks
(xlstm-1.3b's 4 heads over 16, deepseek-v2's 160 experts over ``ep2d``'s
256) stays whole, as ``fit_pspec`` leaves it, and MoE groups may straddle
row ranks.  A host read inside a step (``.item()``,
``int(t)``) fails on ``meta`` and is not caught.  Every operation runs
through PyTorch's Python meta kernels and the counter's dispatch mode, so a
cell takes from a second (prefill, decode) to two minutes (xlstm-1.3b's
train step) on one CPU core.  The xLSTM's loops (the sLSTM's over time,
the mLSTM's over chunks) run one step on ``meta`` and count it once per
step (``models/xlstm.py::_CountedLoop``, ``kernels.work.repeated``), as
the reference's ``hloparse`` multiplies a while loop's counts by its trip
count: op by op, an xlstm-1.3b ``prefill_32k`` cell had not ended after 24
minutes and a ``train_4k`` cell ran over 30.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, RunConfig, get_config, shape_cells
from ..models import Model, input_specs, param_count, rank_inputs
from ..models.transformer import model_specs
from .mesh import meta_mesh
from .roofline import StepCounter
from .steps import (build_encode_step, build_train_step, init_train_state, pod_mode,
                    rank_rows)

# Per-arch production knobs (from the §Perf napkin math: activation bytes
# per chip ≈ L·(B_loc/mb)·T·D·2; target ≤ ~8 GB with params+optimizer).
PRODUCTION_RUN = {
    "llama3.2-1b": dict(microbatches=2),
    "llama3-8b": dict(microbatches=8),
    "glm4-9b": dict(microbatches=8),
    "codeqwen1.5-7b": dict(microbatches=8),
    "hubert-xlarge": dict(microbatches=4),
    "internvl2-76b": dict(microbatches=16, optimizer_state_dtype="bfloat16"),
    "recurrentgemma-9b": dict(microbatches=8),
    # xlstm + MoE archs use fully-manual shard_map islands (sLSTM cell, EP
    # a2a), which do not compose with the vmap-over-pod "sync" lowering —
    # their multi-pod cells run the flat GSPMD schedule instead (see §Perf).
    "xlstm-1.3b": dict(microbatches=8, _flat_multipod=True),
    "deepseek-v2-236b": dict(microbatches=4, optimizer_state_dtype="bfloat16",
                             _flat_multipod=True),
    "deepseek-v3-671b": dict(microbatches=4, optimizer_state_dtype="bfloat16",
                             _flat_multipod=True),
}

# Expert-weight layout per MoE arch (§Perf iteration: the baseline fsdp_d
# moves expert weights over the fabric every layer).
EXPERT_SHARDING = {
    "deepseek-v2-236b": "ep_a2a",   # EP over model axis + weight FSDP gather
    "deepseek-v3-671b": "ep_a2a",   # E=256 → one expert per chip, manual a2a
}


def production_config(arch: str, expert_sharding: str = None,
                      microbatches: int = None):
    """Full config with launcher overrides for the production mesh."""
    cfg = get_config(arch)
    if cfg.moe is not None:
        # group-local dispatch: one group per data shard
        cfg = cfg.with_overrides(
            moe=dataclasses.replace(
                cfg.moe,
                groups=16,
                expert_sharding=expert_sharding
                or EXPERT_SHARDING.get(arch, cfg.moe.expert_sharding),
            )
        )
    return cfg


def production_run(arch: str, sync_mode: str, microbatches: int = None,
                   multi_pod: bool = False) -> RunConfig:
    kw = dict(PRODUCTION_RUN.get(arch, {}))
    if kw.pop("_flat_multipod", False) and multi_pod and sync_mode == "sync":
        sync_mode = "flat"
    if microbatches is not None:
        kw["microbatches"] = microbatches
    return RunConfig(sync_mode=sync_mode, **kw)


def _routed_expert_fraction(cfg) -> float:
    """Fraction of params that are routed experts (for active-param count)."""
    if cfg.moe is None:
        return 0.0
    from ..models.moe import moe_spec
    spec = moe_spec(cfg)
    routed = param_count({"wi": spec["wi"], "wo": spec["wo"]})
    return routed


def model_flops_estimate(cfg, shape, n_params: int) -> float:
    """MODEL_FLOPS: 6·N·D (train, dense) / 6·N_active·D (MoE) / 2·N·D (fwd)."""
    model = Model(cfg, device="meta")
    n_total = n_params
    if cfg.moe is not None:
        plan = model.plan
        n_moe_layers = plan.n_scan * len(plan.pattern) + len(plan.tail)
        routed_per_layer = _routed_expert_fraction(cfg)
        routed_total = routed_per_layer * n_moe_layers
        active = n_total - routed_total * (1 - cfg.moe.top_k / cfg.moe.num_experts)
    else:
        active = n_total
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * active * tokens


def tree_bytes(tree) -> int:
    """The bytes of every tensor in a nested dict/list/NamedTuple tree (a
    train state's, the step count among them; a cache's)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return 0
    return sum(tree_bytes(v) for v in tree)


def build_rank(arch: str, shape_name, multi_pod: bool, sync_mode: str,
               expert_sharding: str = None, microbatches: int = None, rank: int = 0,
               cfg=None, mesh_shape=None):
    """Rank ``rank``'s model of a cell on a :func:`~.mesh.meta_mesh` of the
    production shape: returns (cfg, shape, mesh, run, model).  ``cfg`` and
    ``mesh_shape`` (the shape and its axes' names) override the production
    config and mesh; ``shape_name`` may be a ``ShapeConfig``.  Raises
    ``NotImplementedError`` where the model refuses the mesh."""
    cfg = cfg or production_config(arch, expert_sharding=expert_sharding)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if mesh_shape is None:
        mesh_shape = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
            (16, 16), ("data", "model"))
    mesh = meta_mesh(*mesh_shape, rank=rank)
    run = production_run(arch, sync_mode, microbatches, multi_pod=multi_pod)
    # Cap microbatches so each microbatch still fills every data shard --
    # otherwise XLA pads rows and every chip burns flops on padding
    # (measured: internvl2 2-pod at mb=16 ran the FULL batch per pod).
    mb_cap = max(1, shape.global_batch // (mesh.size("pod") * mesh.size("data")))
    if run.microbatches > mb_cap:
        run = dataclasses.replace(run, microbatches=mb_cap)
    return cfg, shape, mesh, run, Model(cfg, mesh=mesh)


def _rank_inputs(batch, cfg, shape, mesh):
    """The rank's rows of ``batch``; a batch of fewer rows than the row ranks
    (long_500k's one) whole on every rank, as the reference's fitted input
    sharding replicates it."""
    if shape.global_batch % (mesh.size("pod") * mesh.size("data")):
        return batch
    return rank_inputs(batch, cfg, shape, mesh)


def run_rank(arch: str, shape_name, multi_pod: bool, sync_mode: str, max_len: int = None,
             **kw):
    """One rank's step of a cell on ``meta``, counted (the reference's
    ``lower_cell``): a train step from a fresh train state, a prefill (an
    encoder's encode step), or a decode step from a cache of ``seq_len``
    (either cache ``max_len`` long where it is given).  ``kw`` as
    :func:`build_rank`'s.  Returns (cfg, shape, mesh, run, the
    rank's argument bytes: its state and its share of the batch, the
    step's :class:`~.roofline.StepCounter`)."""
    cfg, shape, mesh, run, model = build_rank(arch, shape_name, multi_pod, sync_mode, **kw)
    batch = input_specs(cfg, shape, generator=None, device=torch.device("meta"))
    if shape.kind == "train":
        state = init_train_state(model, run, mesh)
        rows = rank_rows(batch, mesh, pod_mode(run, mesh), run.microbatches)
        args = tree_bytes([state, rows])
        step = build_train_step(model, run, mesh)
        with StepCounter() as counted:
            step(state, batch)
    elif shape.kind == "prefill":
        rows = _rank_inputs(batch, cfg, shape, mesh)
        args = tree_bytes([dict(model.named_parameters()), rows])
        with StepCounter() as counted:
            if not cfg.causal:
                # Encoder-only: "prefill" is a plain forward (no cache).
                build_encode_step(model, mesh)(batch)
            else:
                model.prefill(rows, max_len or shape.seq_len)
    else:  # decode
        tokens = _rank_inputs(batch, cfg, shape, mesh)["tokens"]
        caches = model.cache(tokens.shape[0], max_len or shape.seq_len)
        args = tree_bytes([dict(model.named_parameters()), caches, tokens])
        with StepCounter() as counted:
            model.decode_step(caches, tokens)
    return cfg, shape, mesh, run, args, counted


def _spans_pod(name: str, mesh) -> bool:
    """Whether the group ``name`` crosses pods (the slow fabric)."""
    return mesh.size("pod") > 1 and (name == "world" or "pod" in name.split("+"))


def run_cell(arch: str, shape_name: str, multi_pod: bool, sync_mode: str,
             out_dir: str, skip_existing: bool = True, tag: str = "",
             expert_sharding: str = None, microbatches: int = None):
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}__{sync_mode}" + (
        f"__{tag}" if tag else "")
    out_path = os.path.join(out_dir, cell_id + ".json")
    if skip_existing and os.path.exists(out_path):
        print(f"[dryrun] {cell_id}: cached")
        with open(out_path) as f:
            return json.load(f)

    def write(rec):
        os.makedirs(out_dir, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    for shp, skip in shape_cells(arch):
        if shp.name == shape_name and skip:
            print(f"[dryrun] {cell_id}: SKIP ({skip})")
            return write({"cell": cell_id, "skipped": skip})

    t0 = time.time()
    print(f"[dryrun] {cell_id}: running on meta...", flush=True)
    try:
        cfg, shape, mesh, run, args, counted = run_rank(
            arch, shape_name, multi_pod, sync_mode,
            expert_sharding=expert_sharding, microbatches=microbatches)
    except NotImplementedError as e:  # the model refuses the mesh
        print(f"[dryrun] {cell_id}: SKIP (refused: {e})")
        return write({"cell": cell_id, "skipped": f"refused: {e}"})
    t1 = time.time()

    n_params = param_count(model_specs(cfg))
    mf = model_flops_estimate(cfg, shape, n_params)
    traffic = mesh.traffic
    coll_summary = {
        f"{name}{'@ib' if _spans_pod(name, mesh) else '@nvlink'}": {
            "instances": traffic.calls[name],
            "wire_bytes_per_chip": traffic.wire_bytes[name]}
        for name in sorted(traffic.calls)}
    ib = sum(b for n, b in traffic.wire_bytes.items() if _spans_pod(n, mesh))
    nvlink = sum(b for n, b in traffic.wire_bytes.items() if not _spans_pod(n, mesh))

    rec = {
        "cell": cell_id,
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "sync_mode": sync_mode,
        "pod_mode": pod_mode(run, mesh) if shape.kind == "train" else None,
        "microbatches": run.microbatches if shape.kind == "train" else None,
        "num_devices": mesh.world_size,
        "hardware": "H100 (data sheet constants)",
        "run_seconds": round(t1 - t0, 1),
        "params": n_params,
        "model_flops": mf,
        "memory_analysis": {
            "argument_bytes_per_device": args,
            "output_bytes_per_device": 0,
            "temp_bytes_per_device": counted.peak_bytes,
            "peak_estimate_bytes_per_device": args + counted.peak_bytes,
        },
        "parsed": {
            "flops_per_device": counted.flops,
            "hbm_bytes_per_device": counted.bytes,
            "ici_wire_bytes_per_chip": nvlink,
            "dcn_wire_bytes_per_chip": ib,
        },
        "kernel_launches": counted.kernels,
        "collectives": coll_summary,
    }
    write(rec)
    print(f"[dryrun] {cell_id}: done ({time.time() - t0:.1f}s total)", flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--sync-mode", default="sync",
                    choices=("flat", "sync", "local"))
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape x mesh) cell")
    ap.add_argument("--out", default="results")
    ap.add_argument("--no-skip", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--expert-sharding", default=None,
                    choices=(None, "fsdp_d", "fsdp_f", "ep2d"))
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args()

    failures = []
    if args.all:
        for arch in ARCHS:
            for shape_name in SHAPES:
                for multi_pod in (False, True):
                    try:
                        run_cell(arch, shape_name, multi_pod, args.sync_mode,
                                 args.out, not args.no_skip)
                    except Exception as e:
                        traceback.print_exc()
                        failures.append((arch, shape_name, multi_pod, str(e)))
    else:
        meshes = []
        if args.multi_pod or not args.single_pod:
            meshes.append(True)
        if args.single_pod or not args.multi_pod:
            meshes.append(False)
        for mp in sorted(set(meshes)):
            run_cell(args.arch, args.shape, mp, args.sync_mode, args.out,
                     not args.no_skip, tag=args.tag,
                     expert_sharding=args.expert_sharding,
                     microbatches=args.microbatches)
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)


if __name__ == "__main__":
    main()
