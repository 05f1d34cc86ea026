"""Functions that the multi-rank CPU tests run in each spawned rank
(``repro_torch.launch.mesh.spawn_ranks``).  They import torch and the port
only, so that a rank starts without JAX; each returns numpy arrays.  Also
:func:`side_by_side`, which the tests' fixtures run their parts with."""

import contextlib
import dataclasses
import math
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import RunConfig, ShapeConfig, get_config
from repro_torch.convert import shard_params
from repro_torch.core.cohort import (SyncConfig, bucket_mean, cohort_all_reduce,
                                     flat_all_reduce, pod_sync_grads)
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.steps import build_train_step, init_train_state
from repro_torch.models import Model, rank_inputs
from repro_torch.sharding.shard import gather_tree, sharded

POD_DATA = ("pod", "data")
DATA_MODEL = ("data", "model")
POD_DATA_MODEL = ("pod", "data", "model")


def _numpy(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _wire(mesh, fn):
    """``fn()``'s result and the wire bytes it put on each group."""
    mesh.traffic.reset()
    out = fn()
    return out, dict(mesh.traffic.wire_bytes)


def cohort_checks(g):
    """On a 2 x 2 mesh: the cohort and flat all-reduces of a 27-element tree
    (rank ``r`` adds ``r``) and the bytes each puts on each group; those of
    a 64-element bucket, and of its all-reduce over ``pod`` alone; then 24
    int8 exchanges of the same gradient ``g`` with error feedback and the
    running mean's worst error after each."""
    mesh = make_mesh((2, 2), POD_DATA, "cpu")
    r = dist.get_rank()
    tree = lambda: {"w": torch.arange(24, dtype=torch.float32).view(4, 6) + r,
                    "b": torch.full((3,), 0.5) + r}
    cohort, cohort_bytes = _wire(mesh, lambda: cohort_all_reduce(tree(), mesh))
    flat, flat_bytes = _wire(mesh, lambda: flat_all_reduce(tree(), mesh))
    even = lambda: {"g": torch.ones(64)}
    _, even_cohort = _wire(mesh, lambda: cohort_all_reduce(even(), mesh))
    _, even_flat = _wire(mesh, lambda: flat_all_reduce(even(), mesh))
    _, even_pod = _wire(mesh, lambda: bucket_mean(even(), mesh, "pod"))

    cfg = SyncConfig(mode="sync", compress_int8=True)
    grads, ef = {"w": torch.from_numpy(g)}, {"w": torch.zeros(g.shape)}
    acc, errs = torch.zeros(g.shape), []
    for i in range(24):
        mean, ef = pod_sync_grads(dict(grads), cfg, mesh, ef)  # it empties the dict
        acc += mean["w"]
        errs.append(float((acc / (i + 1) - grads["w"]).abs().max()))
    return {"cohort": _numpy(cohort), "flat": _numpy(flat), "cohort_bytes": cohort_bytes,
            "flat_bytes": flat_bytes, "even_cohort": even_cohort, "even_flat": even_flat,
            "even_pod": even_pod, "ef_errors": errs, "backends": dict(mesh.backends)}


def side_by_side(parts):
    """Run each of ``parts`` (name -> a function of no arguments) in a thread
    of its own, all at once, and wait for every one.  Prints each part's
    seconds and outcome; returns the results by name, or, where any part
    raised, raises one error that names every part's time and the errors in
    full, so that a part that fails under load can be read."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()

    def timed(fn):
        try:
            return True, fn(), time.perf_counter() - t0
        except BaseException:  # reported below with the other parts' times
            import traceback
            return False, traceback.format_exc(), time.perf_counter() - t0

    with ThreadPoolExecutor(len(parts)) as pool:
        done = dict(zip(parts, pool.map(timed, parts.values())))
    times = ", ".join(f"{n} {'ok' if ok else 'FAILED'} at {t:.1f} s"
                      for n, (ok, _, t) in done.items())
    print(f"[parts] {times}", flush=True)
    failed = {n: out for n, (ok, out, _) in done.items() if not ok}
    if failed:
        raise AssertionError(f"parts: {times}\n" + "\n".join(
            f"--- {n} ---\n{out}" for n, out in failed.items()))
    return {n: out for n, (_, out, _) in done.items()}


def threaded_ranks(shape, fn, axes=DATA_MODEL):
    """``fn(mesh)`` on every rank of a mesh of ``shape`` over ``axes``, each
    rank a thread of this process (no process group): the meshes' all-gathers
    and all-reduces meet in memory, every rank calling each collective in
    the same order, as the ranks of one program do (a rank that waits 120 s
    at one breaks it for all).  Returns the results in rank order
    (row-major over ``axes``)."""
    sizes = dict(zip(axes, shape))
    n = math.prod(shape)
    coords = [dict(zip(axes, c)) for c in np.ndindex(*shape)]
    slots, meet = [None] * n, threading.Barrier(n, timeout=120)

    def members(mesh, r, group):
        name = mesh.group_name(group)
        spans = (set(axes) if name == "world" else set() if name == "self"
                 else set(name.split("+")))
        return [q for q in range(n)
                if all(coords[q][a] == coords[r][a] for a in axes if a not in spans)]

    def exchange(mesh, r, t, group):
        slots[r] = t.detach().clone()
        meet.wait()
        got = [slots[q] for q in members(mesh, r, group)]
        meet.wait()
        return got

    def rank(r):
        mesh = Mesh(axes=tuple(axes), shape=dict(sizes), coords=dict(coords[r]),
                    device=torch.device("cpu"))

        def all_gather(t, group):
            return torch.cat(exchange(mesh, r, t, group))

        def all_reduce(t, group, op="sum"):
            got = torch.stack(exchange(mesh, r, t, group))
            return t.copy_(got.sum(0) if op == "sum" else got.amax(0))

        mesh.all_gather, mesh.all_reduce = all_gather, all_reduce
        return fn(mesh)

    out = [None] * n
    errors = []

    def run(r):
        try:
            out[r] = rank(r)
        except BaseException as e:  # noqa: BLE001 - raised below, with the others abandoned
            errors.append(e)
            meet.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"ranks {[r for r, t in enumerate(threads) if t.is_alive()]} "
                           "did not end")
    return out


def _model(arch, params, moe=None):
    model = Model(_fp32(arch, moe), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def step_modes(arch, shape, params, batches, runs, axes=POD_DATA, moe=None):
    """For each ``RunConfig`` keyword set of ``runs``: ``arch`` (smoke, fp32,
    MoE fields ``moe``, from the whole ``params``; on a sharded mesh this
    rank's blocks of them) stepped over ``batches`` on a mesh of ``shape``
    over ``axes``.  Returns, per run, the losses, grad-norms, wire bytes per
    step on each group, this rank's pod's final parameters (and ``ef``),
    gathered whole, and the elements and leaves of the rank's own blocks."""
    mesh = make_mesh(shape, axes, "cpu")
    out = []
    for kw in runs:
        model = (_sharded(arch, params, mesh, moe) if sharded(mesh)
                 else _model(arch, params, moe))
        whole = lambda tree: _numpy(gather_tree(dict(tree), model.layout, mesh)
                                    if model.mesh is not None else tree)
        run = RunConfig(total_steps=10, **kw)
        state, step = init_train_state(model, run, mesh), build_train_step(model, run, mesh)
        losses, norms, wire = [], [], []
        for b in batches:
            mesh.traffic.reset()
            state, m = step(state, {"tokens": torch.from_numpy(b[:, :-1]).long(),
                                    "labels": torch.from_numpy(b[:, 1:]).long()})
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            wire.append(dict(mesh.traffic.wire_bytes))
        out.append({"loss": losses, "grad_norm": norms, "wire": wire,
                    "params": whole(state["params"]),
                    "ef": whole(state["ef"]) if "ef" in state else None,
                    "n_rank": sum(p.numel() for p in state["params"].values()),
                    "n_leaves": len(state["params"])})
    return {"coords": mesh.coords, "runs": out}


def train_fp32(arch, shape, steps, run_kw, resume=False, axes=POD_DATA):
    """``train(arch)`` (smoke, fp32) on a mesh of ``shape`` over ``axes``,
    two ranks per host, logging every step; returns its history."""
    real = train_mod.get_config
    train_mod.get_config = lambda a, smoke: real(a, smoke).with_overrides(dtype="float32")
    try:
        out = train_mod.train(arch, steps=steps, shape=ShapeConfig("t", 16, 8, "train"),
                              mesh_shape=shape, mesh_axes=axes, run=RunConfig(**run_kw),
                              resume=resume, log_every=1,
                              num_hosts=max(int(np.prod(shape)) // 2, 1), device="cpu")
    finally:
        train_mod.get_config = real
    return out["history"]


def _fp32(arch, moe=None, over=None):
    """``arch``'s smoke config in fp32, its MoE config's fields ``moe``
    (a dict) replaced, and its own fields ``over`` (a dict; a dict value
    replaces fields of that sub-config, as ``{"rglru": {"width": 60}}``)."""
    cfg = get_config(arch, smoke=True)
    over = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict) else v
            for k, v in (over or {}).items()}
    cfg = cfg.with_overrides(dtype="float32", **over)
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg


def _sharded(arch, params, mesh, moe=None, over=None):
    """``arch`` (smoke, fp32, MoE fields ``moe``, fields ``over``) on
    ``mesh`` holding this rank's blocks of the whole ``params`` (numpy,
    ``state_dict`` keys)."""
    model = Model(_fp32(arch, moe, over), device="cpu", mesh=mesh)
    model.load_state_dict(shard_params({k: torch.from_numpy(v) for k, v in params.items()},
                                       model))
    return model


def _batch(b, cfg):
    """A train batch from a token array [B, T + 1] (the frontends' embeds
    drawn from the tokens' values, as the tests' one-process runs do)."""
    out = {"tokens": torch.from_numpy(b[:, :-1]).long(),
           "labels": torch.from_numpy(b[:, 1:]).long()}
    if cfg.frontend == "audio":
        out = {"embeds": torch.from_numpy(np.sin(b[:, :-1, None] * np.arange(cfg.d_model)))
               .float() * 0.02, "labels": out["labels"]}
    elif cfg.frontend == "vision":
        ft = cfg.frontend_tokens
        out = {"embeds": torch.from_numpy(np.cos(b[:, :ft, None] * np.arange(cfg.d_model)))
               .float() * 0.02, "tokens": out["tokens"][:, ft:], "labels": out["labels"][:, ft:]}
    return out


def counted_drops(calls):
    """Wrap ``models/moe.py``'s ``_slots`` to append to ``calls`` the
    choices that each call drops (position past the capacity)."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod._slots

    def slots(flat_e, pos, C, E, local=None):
        calls.append(int((pos >= C).sum()))
        return real(flat_e, pos, C, E, local)

    moe_mod._slots = slots


def first_grads(model, batch, run, mesh):
    """Every leaf's gradient of ``batch`` as a train step takes it: each
    rank's over its rows, their mean over ``data``, gathered whole (numpy)."""
    from repro_torch.launch.steps import data_mean, grad_fn, pod_mode, rank_rows, step_rows

    mode = pod_mode(run, mesh)
    _, _, grads = grad_fn(model, run.microbatches, step_rows(mode, mesh))(
        rank_rows(batch, mesh, mode, run.microbatches))
    return _numpy(gather_tree(data_mean(grads, model.layout, mesh), model.layout, mesh))


def tp_steps(arch, shape, params, batches, run_kw, moe=None, over=None, grads=False):
    """``arch`` (smoke, fp32, MoE fields ``moe``, fields ``over``, from the
    whole ``params``) stepped over ``batches`` on a ``(data, model)`` mesh
    of ``shape``.  Returns the losses, grad-norms, MoE load-balance losses
    (where the model has them), wire bytes per step, the final parameters
    gathered whole, the keys of the leaves whole on ``model``, the choices
    each MoE call dropped and, with ``grads``, every leaf's gradient of the
    first batch (:func:`first_grads`)."""
    mesh = make_mesh(shape, DATA_MODEL, "cpu")
    model = _sharded(arch, params, mesh, moe, over)
    drops = []
    counted_drops(drops)
    run = RunConfig(total_steps=10, **run_kw)
    state, step = init_train_state(model, run, mesh), build_train_step(model, run, mesh)
    first = first_grads(model, _batch(batches[0], model.cfg), run, mesh) if grads else None
    losses, norms, aux, wire = [], [], [], []
    for b in batches:
        mesh.traffic.reset()
        state, m = step(state, _batch(b, model.cfg))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if "aux" in m:
            aux.append(m["aux"].item())
        wire.append(dict(mesh.traffic.wire_bytes))
    whole = gather_tree(dict(state["params"]), model.layout, mesh)
    return {"loss": losses, "grad_norm": norms, "aux": aux, "wire": wire,
            "params": _numpy(whole), "coords": dict(mesh.coords), "drops": drops,
            "grads": first, "whole_on_model": [k for k, pl in model.layout.items()
                                               if pl.dim_of("model") is None]}


def _served(arch, shape, axes, params, prompts, batch, prompt_len, gen_len, moe=None):
    """``serve(arch)`` (smoke, fp32) on a mesh of ``shape`` over ``axes``, its
    weights the whole ``params`` and its prompts ``prompts`` (numpy) in place
    of its own draws; returns every rank's tokens and the rows of each of
    this rank's prefills."""
    rows = []

    class Loaded(Model):
        def __init__(self, cfg, **kw):
            super().__init__(cfg, **kw)
            self.load_state_dict(shard_params(
                {k: torch.from_numpy(v) for k, v in params.items()}, self))

        def prefill(self, batch_, max_len):
            rows.append(next(iter(batch_.values())).shape[0])
            return super().prefill(batch_, max_len)

    real = (serve_mod.Model, serve_mod.get_config, serve_mod.input_specs)
    serve_mod.Model = Loaded
    serve_mod.get_config = lambda a, smoke: _fp32(a, moe)
    serve_mod.input_specs = lambda *a, **kw: {k: torch.from_numpy(v).long()
                                              for k, v in prompts.items()}
    try:
        out = serve_mod.serve(arch, batch=batch, prompt_len=prompt_len, gen_len=gen_len,
                              mesh_shape=shape, mesh_axes=axes, device="cpu")
    finally:
        serve_mod.Model, serve_mod.get_config, serve_mod.input_specs = real
    return out["tokens"].numpy(), rows


def tp_serve(arch, shape, params, prompts, batch, prompt_len, gen_len, moe=None):
    """:func:`_served` on a ``(data, model)`` mesh: every rank's tokens."""
    return _served(arch, shape, DATA_MODEL, params, prompts, batch, prompt_len, gen_len,
                   moe)[0]


def pod_serve(arch, shape, params, prompts, batch, prompt_len, gen_len, axes=POD_DATA_MODEL,
              moe=None):
    """:func:`_served` on a pod mesh of ``shape`` over ``axes``: every
    rank's tokens and the rows of this rank's prefill."""
    return _served(arch, shape, axes, params, prompts, batch, prompt_len, gen_len, moe)


def pod_alone_steps(*args, **kw):
    """:func:`step_modes` under ``chip_smoke.py``'s ``pod_alone_rows``: each
    pod's rows routed alone (a MoE group over one pod's data ranks), where
    the reference's flat groups span ``(pod, data)``: the fault that the
    tests must catch."""
    with _chip_smoke().pod_alone_rows():
        return step_modes(*args, **kw)


def block_scaled_steps(*args):
    """:func:`step_modes` where int8 takes a scale per *block* (each rank's
    own absmax, no max over the pod's ranks): a quantiser other than the
    reference's one scale per leaf per pod, which the tests must tell."""
    from repro_torch.core import cohort

    real = cohort.int8_block_mean
    cohort.int8_block_mean = lambda g, e, mesh, axis="pod": real(g, e, mesh, axis, ())
    try:
        return step_modes(*args)
    finally:
        cohort.int8_block_mean = real


def tp_logits(arch, shape, params, prompts, max_len, moe=None, over=None, fault=None,
              axes=DATA_MODEL):
    """This rank's rows' last-token logits of a prefill of ``prompts`` and of
    one greedy decode step after it, over the whole vocab, on a mesh of
    ``shape`` over ``axes`` (``fault``: under the context manager of
    ``chip_smoke.py`` of that name)."""
    mesh = make_mesh(shape, axes, "cpu")
    model = _sharded(arch, params, mesh, moe, over)
    with getattr(_chip_smoke(), fault)() if fault else contextlib.nullcontext():
        return _logits(model, prompts, max_len)


def tp_grads(arch, shape, params, tokens, keys=None, over=None, fault=None):
    """The gradients of the leaves ``keys`` (every leaf if None) of the loss
    of ``arch`` (smoke, fp32, fields ``over``, from the whole ``params``)
    over ``tokens`` ``[B, T + 1]`` on a ``(data, model)`` mesh of ``shape``,
    gathered whole from the ranks' blocks; under ``fault``, the context
    manager of ``chip_smoke.py`` of that name."""
    mesh = make_mesh(shape, DATA_MODEL, "cpu")
    model = _sharded(arch, params, mesh, None, over)
    named = dict(model.named_parameters())
    keys = list(named) if keys is None else keys
    with getattr(_chip_smoke(), fault)() if fault else contextlib.nullcontext():
        grads = torch.autograd.grad(model.loss(_batch(tokens, model.cfg))[0],
                                    [named[k] for k in keys])
    return _numpy(gather_tree(dict(zip(keys, grads)), model.layout, mesh))


def _logits(model, prompts, max_len):
    mesh = model.mesh
    rows = next(iter(prompts.values())).shape[0]
    batch = rank_inputs({k: torch.from_numpy(v).long() for k, v in prompts.items()},
                        model.cfg, ShapeConfig("s", 0, rows, "prefill"), model.mesh)
    logits, caches = model.prefill(batch, max_len)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    step, _ = model.decode_step(caches, tok)
    return {"prefill": logits[:, -1].numpy(), "decode": step[:, -1].numpy(),
            "coords": dict(mesh.coords)}


def tp_serve_admitted(arch, shape, slots):
    """``serve(arch)`` (smoke) on a ``(data, model)`` mesh of ``shape``
    with ``slots`` admission slots: this rank's tokens and its admission
    record (rank 0 alone holds the lease)."""
    out = serve_mod.serve(arch, batch=2, prompt_len=8, gen_len=10, mesh_shape=shape,
                          mesh_axes=DATA_MODEL, device="cpu", admission_slots=slots)
    return out["tokens"].numpy(), out.get("admission")


def tp_encode(arch, shape, params, embeds):
    """``build_encode_step`` of ``arch`` (smoke, fp32) on a ``(data, model)``
    mesh of ``shape`` over the global ``embeds``: the whole logits."""
    from repro_torch.launch.steps import build_encode_step

    mesh = make_mesh(shape, DATA_MODEL, "cpu")
    model = _sharded(arch, params, mesh)
    return build_encode_step(model, model.mesh)({"embeds": torch.from_numpy(embeds)}).numpy()


def cli_main(argv):
    """The training CLI (``train.main``) with ``argv``, inside the ranks'
    process group."""
    train_mod.main(argv)


def ranks_main(jobs):
    """Each ``(name, args)`` of ``jobs`` in turn (``name`` a function of this
    module); their results, in order."""
    return [globals()[name](*args) for name, args in jobs]


def chip_smoke_pod_rank(*args):
    """chip_smoke.py's phase-7 rank (``pod_rank``), the script loaded by path."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.pod_rank(*args)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def chip_smoke_tp_serve_rank(*args):
    """chip_smoke.py's phase-8(a) rank (``tp_serve_rank``)."""
    return _chip_smoke().tp_serve_rank(*args)


def chip_smoke_tp_train_rank(*args):
    """chip_smoke.py's phase-8(b) rank (``tp_train_rank``)."""
    return _chip_smoke().tp_train_rank(*args)


def chip_smoke_tp_recurrent_rank(*args):
    """chip_smoke.py's phase-10 rank (``tp_recurrent_rank``)."""
    return _chip_smoke().tp_recurrent_rank(*args)


def model_axis_grads(xs, ws, t, dims):
    """On a mesh of one data rank and ``M`` model ranks, this rank's
    gradients through ``sharding/shard.py``'s four exchanges over
    ``model`` of the loss sum over ranks of ``(y · w).sum()``: ``y`` the
    reduce-scatter (two blocks along ``dims[0]``), the all-reduce and the
    all-gather (along ``dims[1]``) of this rank's ``xs[rank]``, and the
    slice (two blocks along ``dims[2]``) of ``t``, which every rank holds
    whole; ``ws[rank]`` each of their weights.  Returns the outputs and the
    gradients of ``x`` and ``t``."""
    from repro_torch.sharding.shard import (all_gather_model, all_reduce_model,
                                            reduce_scatter_model, slice_model)

    M = len(xs)
    mesh = make_mesh((1, M), DATA_MODEL, "cpu")
    m = mesh.coords["model"]
    tp = mesh
    out = {}
    for name, fn in (("reduce_scatter", lambda x: reduce_scatter_model(x, tp, dims[0], 2)),
                     ("all_reduce", lambda x: all_reduce_model(x, tp)),
                     ("all_gather", lambda x: all_gather_model(x, tp, dims[1]))):
        x = torch.from_numpy(xs[m]).requires_grad_()
        y = fn(x)
        w = torch.from_numpy(ws[name][m])
        g, = torch.autograd.grad((y * w).sum(), [x])
        out[name] = (y.detach().numpy(), g.numpy())
    whole = torch.from_numpy(t).requires_grad_()
    y = slice_model(whole, tp, dims[2], 2)
    g, = torch.autograd.grad((y * torch.from_numpy(ws["slice"][m])).sum(), [whole])
    out["slice"] = (y.detach().numpy(), g.numpy())
    return out


def island_summed_steps(arch, shape, params, batches, run_kw, moe):
    """:func:`tp_steps` with the island's output summed over ``model`` (the
    block's *g* applied to an output that is already whole): the wrong rule
    that the tests must catch."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.sharding.shard import model_parallel, reduce_from_model

    real = moe_mod._island

    def summed(p, x, xf, m, mesh):
        y, aux = real(p, x, xf, m, mesh)
        return reduce_from_model(y, model_parallel(mesh)), aux

    moe_mod._island = summed
    try:
        return tp_steps(arch, shape, params, batches, run_kw, moe)
    finally:
        moe_mod._island = real


def chip_smoke_ep_rank(*args):
    """chip_smoke.py's phase-9 rank (``ep_rank``: serving, then training)."""
    return _chip_smoke().ep_rank(*args)


def chip_smoke_uneven_ep_rank(*args):
    """chip_smoke.py's phase-15 rank (``uneven_ep_rank``)."""
    return _chip_smoke().uneven_ep_rank(*args)


def chip_smoke_pod_tp_rank(*args):
    """chip_smoke.py's phase-11 rank (``pod_tp_rank``)."""
    return _chip_smoke().pod_tp_rank(*args)


def chip_smoke_pods_rank(serving, training, ep_serving, smoke=False, device=None):
    """chip_smoke.py's phase-11 rank (``pod_tp_rank`` of ``serving`` and
    ``training``), then, in the same process, its phase-12 rank
    (``ep_pod_rank`` of ``ep_serving``) under ``"eppod"``."""
    cs = _chip_smoke()
    return {**cs.pod_tp_rank(serving, training, smoke, device),
            "eppod": cs.ep_pod_rank(*ep_serving, smoke, device)}


@contextlib.contextmanager
def gathered_experts():
    """``models/moe.py`` running experts split over ``(data, model)`` on
    their weights gathered over ``data``, not by sending the tokens to them:
    the same numbers, with the weights on the wire, which ``ep2d``'s byte
    check must catch."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.sharding.shard import gather_data

    real = moe_mod._exchanged_experts
    moe_mod._exchanged_experts = lambda wi, wo, xe, mesh: moe_mod._experts(
        gather_data(wi, 0, mesh), gather_data(wo, 0, mesh), xe)
    try:
        yield
    finally:
        moe_mod._exchanged_experts = real


def moe_data_bytes(arch, shape, params, tokens, moe, fault=False):
    """One forward of ``arch``'s loss (smoke, fp32, MoE fields ``moe``,
    from the whole ``params``) over the rank's rows of ``tokens`` ``[B, T +
    1]`` on a ``(data, model)`` mesh of ``shape``, without gradients;
    returns the ``data`` group's wire bytes inside each MoE call (with
    ``fault``, under :func:`gathered_experts`) and the rank's coordinates."""
    from repro_torch.launch.steps import rank_rows
    from repro_torch.models import moe as moe_mod

    mesh = make_mesh(shape, DATA_MODEL, "cpu")
    model = _sharded(arch, params, mesh, moe)
    real, calls = moe_mod.moe_ffn, []

    def counted(*a, **kw):
        before = mesh.traffic.wire_bytes.get("data", 0.0)
        out = real(*a, **kw)
        calls.append(mesh.traffic.wire_bytes.get("data", 0.0) - before)
        return out

    moe_mod.moe_ffn = counted
    try:
        with torch.no_grad(), gathered_experts() if fault else contextlib.nullcontext():
            model.loss(rank_rows(_batch(tokens, model.cfg), mesh, "flat", 1))
    finally:
        moe_mod.moe_ffn = real
    return {"calls": calls, "coords": dict(mesh.coords)}
