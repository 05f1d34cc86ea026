"""The port's sharding rules against the JAX package's, and its shard and
gather of a parameter tree.

For every config (published and smoke), from the spec trees alone (nothing
is allocated): ``param_pspecs``, ``fit_pspec`` of each leaf, ``batch_pspec``
and ``cache_pspecs`` equal JAX's on ``(data, model)`` meshes of (2, 2),
(1, 2) and (16, 16).  Then ``shard_tree`` and ``gather_tree`` on a (2, 2)
mesh whose four ranks are threads here (no process group): the round trip
returns the tree bit for bit, swiglu's ``wi`` shards as ``[gate_m | up_m]``,
and a dim that ``fit_pspec`` leaves whole stays whole.  The expert-parallel
layouts (``ep_a2a``, experts on ``model`` with FSDP on ``data``, or on
``(data, model)`` jointly where E divides by 256) against JAX's for both MoE
configs.  Last, the refusals of tensor parallelism that the port does not
take."""

import dataclasses
import threading
import types

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro_torch.configs import ARCHS, ShapeConfig, get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import Model, model_specs  # noqa: E402
from repro_torch.models.transformer import cache_tree  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.shard import (gather_tree, param_layout, shard,  # noqa: E402
                                        shard_tree)

MESHES = [(2, 2), (1, 2), (16, 16)]
CASES = [(arch, smoke) for arch in ARCHS for smoke in (False, True)]


def _fake(shape):
    """What the rules read of a mesh: its axis sizes."""
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)))


def _flat(tree, prefix=""):
    """(path, leaf) pairs of dicts, lists and named tuples; a partition spec
    (a tuple) is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list) or hasattr(tree, "_fields"):
        items = (((f if hasattr(tree, "_fields") else str(i)), v)
                 for i, (f, v) in enumerate(zip(getattr(tree, "_fields", tree), tree)))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flat(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def _specs(tree, prefix=""):
    """(key, ParamSpec) pairs of either package's spec tree."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _specs(v, f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _specs(v, f"{prefix}.{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("arch,smoke", CASES)
def test_param_and_fitted_pspecs_equal_jax(arch, smoke):
    want = dict(_specs(JaxModel(jax_config(arch, smoke=smoke)).specs()))
    got = dict(_specs(model_specs(get_config(arch, smoke=smoke))))
    assert set(got) == set(want)
    jax_ps = dict(_flat(jax_rules.param_pspecs(JaxModel(jax_config(arch, smoke=smoke)).specs())))
    port_ps = dict(_flat(rules.param_pspecs(model_specs(get_config(arch, smoke=smoke)))))
    for key, spec in got.items():
        assert port_ps[key] == tuple(jax_ps[key]), key
        for shape in MESHES:
            fake = _fake(shape)
            assert (rules.fit_pspec(port_ps[key], spec.shape, fake)
                    == tuple(jax_rules.fit_pspec(jax_ps[key], want[key].shape, fake))), (key, shape)


def _ep_a2a(cfg, experts=None):
    moe = dataclasses.replace(cfg.moe, expert_sharding="ep_a2a",
                              num_experts=experts or cfg.moe.num_experts)
    return cfg.with_overrides(moe=moe)


@pytest.mark.parametrize("arch,smoke,experts", [
    (a, smoke, e) for a in ("deepseek-v2-236b", "deepseek-v3-671b") for smoke in (False, True)
    for e in (None, 256)])
def test_ep_a2a_layouts_equal_jax(arch, smoke, experts):
    """The island's expert layouts: deepseek-v2's 160 experts (and either
    config's smoke 8) on ``model`` with ``wi``'s d_model and ``wo``'s FFN dim
    FSDP on ``data``; deepseek-v3's 256 (and the smokes overridden to 256)
    on ``(data, model)`` jointly.  The specs and their fits equal JAX's."""
    jcfg = _ep_a2a(jax_config(arch, smoke=smoke), experts)
    cfg = _ep_a2a(get_config(arch, smoke=smoke), experts)
    want = dict(_specs(JaxModel(jcfg).specs()))
    got = dict(_specs(model_specs(cfg)))
    assert set(got) == set(want)
    jax_ps = dict(_flat(jax_rules.param_pspecs(JaxModel(jcfg).specs())))
    port_ps = dict(_flat(rules.param_pspecs(model_specs(cfg))))
    two_d = cfg.moe.num_experts % 256 == 0
    assert port_ps["blocks.b0.ffn.wi"] == ((None, ("data", "model"), None, None) if two_d
                                           else (None, "model", "data", None))
    assert port_ps["blocks.b0.ffn.wo"] == ((None, ("data", "model"), None, None) if two_d
                                           else (None, "model", "data", None))
    for key, spec in got.items():
        assert port_ps[key] == tuple(jax_ps[key]), key
        for shape in MESHES:
            fake = _fake(shape)
            assert (rules.fit_pspec(port_ps[key], spec.shape, fake)
                    == tuple(jax_rules.fit_pspec(jax_ps[key], want[key].shape, fake))), (key, shape)


@pytest.mark.parametrize("arch,smoke", CASES)
def test_batch_and_cache_pspecs_equal_jax(arch, smoke):
    jcfg, cfg = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("s", 2048, 32, kind)
        for axes in (("data",), ("pod", "data")):
            want = jax_rules.batch_pspec(jcfg, shape, batch_axes=axes)
            got = rules.batch_pspec(cfg, shape, batch_axes=axes)
            assert got == {k: tuple(v) for k, v in want.items()}, (kind, axes)
    if not cfg.causal:
        return
    spec = JaxModel(jcfg).cache(32, 2048, as_spec=True)
    tree = cache_tree(cfg, 32, 2048, "meta")
    for shape in MESHES:
        want = _flat(jax_rules.cache_pspecs(spec, mesh=_fake(shape)))
        got = _flat(rules.cache_pspecs(tree, mesh=_fake(shape)))
        assert [(k, v) for k, v in got] == [(k, tuple(v)) for k, v in want], shape


class ThreadMesh(Mesh):
    """A rank of a mesh whose ranks are threads of this process: its
    all-gather meets the others at a barrier (every rank gathers the same
    tensors in the same order, as ``gather_tree`` does)."""

    def __init__(self, shape, rank, hub):
        sizes = dict(zip(("data", "model"), shape))
        super().__init__(axes=("data", "model"), shape=sizes,
                         coords={"data": rank // shape[1], "model": rank % shape[1]},
                         device=torch.device("cpu"))
        self.rank, self.hub = rank, hub

    def all_gather(self, t, axes):
        slots, barrier = self.hub
        slots[self.rank] = t
        barrier.wait()
        M, other = self.shape["model"], "model" if axes == "data" else "data"
        coord = lambda r: {"data": r // M, "model": r % M}[other]
        out = torch.cat([slots[r] for r in sorted(slots) if coord(r) == self.coords[other]])
        barrier.wait()
        return out


def _round_trip(full, layout, shape):
    world = shape[0] * shape[1]
    hub = ({}, threading.Barrier(world))
    meshes = [ThreadMesh(shape, r, hub) for r in range(world)]
    blocks = [shard_tree(full, layout, m) for m in meshes]
    out = [None] * world

    def run(r):
        out[r] = gather_tree(blocks[r], layout, meshes[r])

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return meshes, blocks, out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge", "recurrentgemma-9b",
                                  "xlstm-1.3b", "deepseek-v2-236b"])
def test_shard_then_gather_is_the_tree_bit_for_bit(arch):
    """Smoke width on a (2, 2) mesh; hubert with a vocab of 63, which
    ``fit_pspec`` leaves whole on ``model``."""
    cfg = get_config(arch, smoke=True)
    if arch == "hubert-xlarge":
        cfg = cfg.with_overrides(vocab_size=63)
    full = {k: v.detach() for k, v in Model(cfg, device="cpu").state_dict().items()}
    layout = param_layout(model_specs(cfg), cfg.act, ThreadMesh((2, 2), 0, None))
    meshes, blocks, out = _round_trip(full, layout, (2, 2))
    for r, tree in enumerate(out):
        assert set(tree) == set(full)
        for key, t in full.items():
            assert torch.equal(tree[key], t), (r, key)
    for m, b in zip(meshes, blocks):
        for key, t in full.items():
            want = [n // (2 if ax else 1) for n, ax in zip(t.shape, layout[key].spec)]
            assert list(b[key].shape) == want, key
        if arch == "hubert-xlarge":
            assert layout["unembed.w"].spec == ("data", None)
            assert b["unembed.w"].shape[1] == 63
        fused = [k for k in full if layout[k].blocks == 2]
        # xlstm's smoke sLSTM FFN is 2 x 85 wide: no block splits in two, so
        # the whole dim splits (a contiguous split, as GSPMD's).
        assert bool(fused) == (cfg.act == "swiglu" and arch != "xlstm-1.3b"), fused
        for key in fused:
            w = full[key]
            gate, up = w.chunk(2, dim=-1)
            n, c = gate.shape[-1] // 2, m.coords["model"]
            half = w.shape[-2] // 2
            rows = slice(m.coords["data"] * half, (m.coords["data"] + 1) * half)
            want = torch.cat([gate[..., rows, c * n:(c + 1) * n],
                              up[..., rows, c * n:(c + 1) * n]], dim=-1)
            assert torch.equal(b[key], want), key


def test_contiguous_split_would_hand_out_gate_alone():
    """The trap that the [gate_m | up_m] layout avoids: model rank 0's block
    of a contiguous split is all gate."""
    cfg = get_config("llama3.2-1b", smoke=True)
    w = torch.arange(64 * 256, dtype=torch.float32).view(64, 256)
    layout = param_layout(model_specs(cfg), cfg.act, ThreadMesh((1, 2), 0, None))
    pl = layout["blocks.b0.ffn.wi"]
    mesh = ThreadMesh((1, 2), 0, None)
    fused = shard(w[None], pl, mesh)[0]
    contiguous = shard(w[None], type(pl)(pl.spec), mesh)[0]
    assert torch.equal(contiguous, w[:, :128])
    assert torch.equal(fused, torch.cat([w[:, :64], w[:, 128:192]], dim=1))


def _mesh(shape):
    return Mesh(axes=("data", "model"), shape=dict(zip(("data", "model"), shape)),
                coords={"data": 0, "model": 0}, device=torch.device("cpu"))


@pytest.mark.parametrize("arch,layout", [("deepseek-v2-236b", "ep2d")])
def test_model_axis_keeps_experts_that_do_not_divide_whole(arch, layout):
    """Of MoE, experts that do not divide over the ranks that split them
    (``ep2d`` here: its 8 experts over ``(data, model)``, 3 ranks): the
    rules drop the ``(data, model)`` entry whole, and every rank holds every
    expert, as the reference's ``fit_pspec`` places them."""
    cfg = get_config(arch, smoke=True)
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, expert_sharding=layout))
    model, whole = Model(cfg, device="cpu", mesh=_mesh((1, 3))), Model(cfg, device="cpu")
    for key in ("blocks.b0.ffn.wi", "blocks.b0.ffn.wo"):
        assert model.layout[key].spec == (None,) * 4, key
        assert model.state_dict()[key].shape == whole.state_dict()[key].shape, key


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_model_axis_builds_recurrent_blocks_by_the_rules(arch):
    """RG-LRU and xLSTM blocks on (1, 2): every leaf holds the block of its
    whole shape that ``param_layout`` assigns a rank, and the caches hold a
    rank's RG-LRU channels and mLSTM heads (the sLSTM's state whole)."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu", mesh=_mesh((1, 2)))
    full = Model(cfg, device="cpu")
    for key, p in full.state_dict().items():
        pl = model.layout[key]
        assert tuple(model.state_dict()[key].shape) == tuple(
            n // (2 if "model" in pl.axes(d) else 1) for d, n in enumerate(p.shape)), key
    split = [k for k, pl in model.layout.items() if pl.dim_of("model") is not None]
    assert any(".cell.w_if" in k or ".rec.w_a" in k for k in split), split
    # The dim each stacked cache splits: channels, the one KV head's head
    # dim, the mLSTM's heads; the sLSTM's state stays whole.
    halved = {"RGLRUState": -1, "KVCache": -1, "MLSTMState": 2}
    caches, whole = model.cache(2, 8), full.cache(2, 8)
    for name, c in caches["blocks"].items():
        for field, t in c._asdict().items():
            if isinstance(t, torch.Tensor):
                want = list(getattr(whole["blocks"][name], field).shape)
                if type(c).__name__ in halved:
                    want[halved[type(c).__name__]] //= 2
                assert list(t.shape) == want, (name, field)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "glm4-9b"])
def test_model_axis_4_splits_the_kv_heads_head_dim(arch):
    """Smoke llama3.2-1b and glm4-9b have 2 KV heads: on model 4 no rank
    holds a whole one, so ``wk`` and ``wv`` split their ``K·hd`` columns
    contiguously (a rank holds half a head) and the KV cache holds each
    rank's ``hd/4`` of every head, as the reference's cache rule puts
    ``hd`` on ``model``."""
    cfg = get_config(arch, smoke=True)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    assert K == 2
    model = Model(cfg, device="cpu", mesh=_mesh((1, 4)))
    p = model.blocks.layer(0)["b0"]["attn"]
    assert tuple(p["wk"].shape) == tuple(p["wv"].shape) == (cfg.d_model, K * hd // 4)
    assert tuple(p["wq"].shape) == (cfg.d_model, cfg.num_heads * hd // 4)
    cache = model.cache(3, 8)["blocks"]["b0"]
    assert tuple(cache.k.shape) == tuple(cache.v.shape) == (model.plan.n_scan, 3, 8, K, hd // 4)
    specs = rules.cache_pspecs(cache_tree(cfg, 3, 8, "meta", 4), mesh=_fake((1, 4)))
    assert specs["blocks"]["b0"].k == (None, "data", None, None, "model")


def test_model_axis_keeps_heads_that_do_not_divide_whole():
    """No width is refused on ``model`` any more: a rank holds what
    ``fit_pspec`` gives it.  Smoke llama's 4 query heads over 2 KV heads on
    model 3: nothing of the attention or the FFN splits, so every rank holds
    them whole and runs them whole (``gqa_layout`` "whole"); 6 query heads
    over one KV head of 5 columns: the query heads split and ``wk``/``wv``
    stay whole ("kv_whole"), and the cache holds the whole KV head.
    ``tests/test_torch_tp_uneven.py`` holds such layouts to JAX."""
    from repro_torch.models.attention import gqa_layout

    cfg = get_config("llama3.2-1b", smoke=True)
    model = Model(cfg, device="cpu", mesh=_mesh((1, 3)))
    assert gqa_layout(cfg, 3) == "whole"
    whole = Model(cfg, device="cpu").state_dict()
    for key in ("blocks.b0.attn.wq", "blocks.b0.attn.wk", "blocks.b0.attn.wo",
                "blocks.b0.ffn.wi", "blocks.b0.ffn.wo"):
        assert model.state_dict()[key].shape == whole[key].shape, key
    cfg = cfg.with_overrides(num_heads=6, num_kv_heads=1, head_dim=5, d_ff=96)
    model = Model(cfg, device="cpu", mesh=_mesh((1, 3)))
    assert gqa_layout(cfg, 3) == "kv_whole"
    p = model.blocks.layer(0)["b0"]["attn"]
    assert tuple(p["wq"].shape) == (cfg.d_model, 10)
    assert tuple(p["wk"].shape) == tuple(p["wv"].shape) == (cfg.d_model, 5)
    cache = model.cache(3, 8)["blocks"]["b0"]
    assert tuple(cache.k.shape) == (model.plan.n_scan, 3, 8, 1, 5)


def test_moe_groups_straddle_data_ranks_and_rglru_fsdp_taken():
    """MoE at data 2 with 3 groups over the 2 data ranks' 12 tokens (a group
    of 4 straddles the ranks): each rank, a thread, holds its 6 tokens'
    output of one process's routing of all 12; recurrentgemma's FSDP takes
    every leaf."""
    import torch_rank_fns
    from repro_torch.models import moe as moe_mod

    cfg = get_config("deepseek-v2-236b", smoke=True).with_overrides(dtype="float32")
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, groups=3, capacity_factor=0.5))
    p = Model(cfg, device="cpu").blocks.layer(0)["b0"]["ffn"]
    x = torch.randn(4, 3, cfg.d_model, generator=torch.Generator().manual_seed(5))
    want, _ = moe_mod.moe_ffn(p, x, cfg)
    ranks = torch_rank_fns.threaded_ranks((2, 1), lambda mesh: moe_mod.moe_ffn(
        p, x[2 * mesh.coords["data"]:][:2], cfg, mesh, moe_mod.Rows(mesh, ("data",)))[0])
    torch.testing.assert_close(torch.cat(ranks), want, rtol=1e-5, atol=1e-6)
    model = Model(get_config("recurrentgemma-9b", smoke=True), device="cpu", mesh=_mesh((2, 1)))
    full = Model(get_config("recurrentgemma-9b", smoke=True), device="cpu")
    for key, p in full.state_dict().items():
        pl = model.layout[key]
        assert tuple(model.state_dict()[key].shape) == tuple(
            n // (2 if "data" in pl.axes(d) else 1) for d, n in enumerate(p.shape)), key
    assert model.layout["blocks.b0.rec.lam"].spec == (None, None)


def test_staging_buffer_first_made_in_inference_mode_takes_writes_after(monkeypatch):
    """A gloo group on a card stages its tensors in pinned host buffers, one
    per dtype, made at first use.  A MoE decode step's all-gather of int64
    counts is that first use under ``inference_mode``; ``serve()``'s token
    gather writes the same buffer after it, which an inference tensor
    refuses (the card's phase 12 met it).  The buffer is a normal tensor."""
    real = torch.empty
    # Without a CUDA device no memory pins: the buffer's other properties count.
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **kw: real(*a, **kw))
    mesh = Mesh(axes=("pod",), shape={"pod": 2}, coords={"pod": 0}, device=torch.device("cpu"))
    with torch.inference_mode():
        buf = mesh._host(torch.int64, 0, 4)
        buf.copy_(torch.arange(4))
    assert not buf.is_inference()
    mesh._host(torch.int64, 0, 4).copy_(torch.arange(4))
