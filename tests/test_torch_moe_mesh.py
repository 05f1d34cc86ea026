"""MoE's scatter path over gloo ranks and MLA's tensor parallelism against
the JAX package's GSPMD, the block's *g* rule, phase 9 of ``chip_smoke.py``
rehearsed at smoke width, and MoE on counts that do not divide: groups that
straddle data ranks and experts that do not divide over model, each rank a
thread (``torch_rank_fns.threaded_ranks``), held to one process.

JAX runs in four subprocesses with four host devices each (``conftest``'s
``run_multidevice``, ``tests/test_torch_ep.py``'s ``jax_parts``), its cases
split over them and run in threads: deepseek-v2 smoke on the ``fsdp_d``
layout (experts on ``model``, d_model FSDP on ``data``) at (data 2, model 1)
with one MoE group (its slots continue across the data ranks) and with two
(one on each), at (2, 2), and at (1, 2), where MLA runs a rank's heads; on
``fsdp_f`` (experts on ``model``, the FFN dim FSDP on ``data``) and on
``ep2d`` (experts on ``(data, model)`` jointly: the slots go to the
experts' owners over ``data``) at (1, 2) and (2, 2); each two steps of
``build_train_step`` (two microbatches; one on ``fsdp_f`` and ``ep2d``), and
at (2, 2) and on the two new layouts the logits of ``build_prefill_step``
and of one ``build_decode_step``.  Beside it the port runs on 2 gloo ranks
in one spawn and on 4 in another, from the same initial parameters, in fp32
within ``GRAD_TOL``; the parameters are conditioned and the learning rate is
1e-4, as in ``tests/test_torch_ep.py``.  The 4-rank spawn also reads the
``data`` group's bytes inside each MoE call of ``ep2d``: the tokens' alone,
and not so with the weights gathered over ``data``.

A second 2-rank spawn runs the island (``ep_a2a`` at (1, 2)) as it is and
with its output summed over ``model`` (the block's *g* on an output that is
already whole), each against one process whose MoE routes each model rank's
slice as a group of its own (``chip_smoke.py``'s ``island_groups``), and
phase 9's ranks at smoke width in bf16 (``ep_rank``: ``ep_serve_rank``,
then ``ep_train_rank``), whose checks must pass and must fail on planted
faults."""

import copy
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import input_specs as jax_input_specs  # noqa: E402
from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, spawn_ranks  # noqa: E402
from repro_torch.launch.steps import build_train_step, init_train_state  # noqa: E402
from repro_torch.models import Model, model_specs  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

import torch_rank_fns  # noqa: E402
from test_torch_ep import _params, jax_parts, jax_results  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
V2 = "deepseek-v2-236b"
SERVE = (4, 8, 4)
FSDP = {"expert_sharding": "fsdp_d"}
FSDP_F, EP2D = {"expert_sharding": "fsdp_f"}, {"expert_sharding": "ep2d"}
FSDP_D_CASES = [
    dict(name="g1_21", arch=V2, mesh=(2, 1), moe=FSDP, B=8, T=16, steps=2, micro=2, lr=1e-4),
    dict(name="g2_21", arch=V2, mesh=(2, 1), moe=dict(FSDP, groups=2), B=8, T=16, steps=2,
         micro=2, lr=1e-4),
    dict(name="mla_12", arch=V2, mesh=(1, 2), moe=FSDP, B=8, T=16, steps=2, micro=2, lr=1e-4),
    dict(name="fsdp_22", arch=V2, mesh=(2, 2), moe=FSDP, B=8, T=16, steps=2, micro=2, lr=1e-4,
         serve=SERVE),
]
LAYOUT_CASES = [dict(name=f"{name}_{''.join(map(str, mesh))}", arch=V2, mesh=mesh, moe=moe, B=8,
                     T=16, steps=2, micro=1, lr=1e-4, serve=SERVE)
                for name, moe in (("fsdp_f", FSDP_F), ("ep2d", EP2D)) for mesh in ((1, 2), (2, 2))]
CASES = FSDP_D_CASES + LAYOUT_CASES
BY_NAME = {c["name"]: c for c in CASES}
# The island at (1, 2): sound, and with its output summed over model.
ISLAND = dict(name="island", arch=V2, mesh=(1, 2), moe={"expert_sharding": "ep_a2a"}, B=8,
              T=16, steps=2, micro=2, lr=1e-4)
# chip_smoke.py's phase 9 at smoke width (bf16): serving rows, prompt,
# generated tokens; training rows, tokens per row (2048: the chunked
# vocab-parallel cross-entropy, as at 4096), microbatches, steps, lr.
REHEARSE_SERVE, REHEARSE_TRAIN = (4, 64, 6), (2, 2048, 1, 1, 3e-4)
# Phase 9's limits at smoke width on the CPU (bf16): a sound run read 1.55e-2
# (logits), 3.2e-5 (loss), 3.2e-3 (grad-norm) and 0 (the island against the
# one-rank route of its inputs, in serving and in training), the planted
# fault 4.6e-2, 2.0e-4, 7.1e-3 and 1.35.
REHEARSE_LIMITS = dict(EP_LOGITS_RTOL=5e-2, EP_LOSS_RTOL=1e-4, EP_NORM_RTOL=5e-3,
                       EP_ISLAND_RTOL=1e-2)


def _cfg(c, framework_config):
    cfg = framework_config(c["arch"], smoke=True).with_overrides(dtype="float32")
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **c["moe"]))


def _batches(c, vocab):
    return np.random.default_rng(7).integers(0, vocab, (c["steps"], c["B"], c["T"] + 1))


def _run(c):
    return dict(learning_rate=c["lr"], warmup_steps=0, microbatches=c["micro"])


def _jobs(c, fn="tp_steps"):
    cfg, params = _params(c)
    jobs = [(fn, (c["arch"], c["mesh"], params, _batches(c, cfg.vocab_size), _run(c),
                  c["moe"]))]
    if c.get("serve"):
        bs, plen, glen = c["serve"]
        prompts = {k: np.asarray(v) for k, v in jax_input_specs(
            cfg, JaxShapeConfig("serve", plen, bs, "prefill"), concrete=True,
            rng=jax.random.PRNGKey(1)).items()}
        jobs.append(("tp_logits", (c["arch"], c["mesh"], params, prompts, plen + glen,
                                   c["moe"])))
    return jobs


def _one_island(cs):
    """One process of the island case whose MoE routes each model rank's
    slice as a group (phase 9's reference): losses and grad-norms."""
    _, params = _params(ISLAND)
    model = Model(_cfg(ISLAND, get_config), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    run = RunConfig(total_steps=10, **_run(ISLAND))
    state, step = init_train_state(model, run), build_train_step(model, run)
    losses, norms = [], []
    with cs.island_groups(ISLAND["mesh"][1]):
        for b in _batches(ISLAND, model.cfg.vocab_size):
            state, m = step(state, torch_rank_fns._batch(b, model.cfg))
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
    return {"loss": losses, "grad_norm": norms}


# The ep2d byte probe: one forward of the fsdp_22 case's first batch on (2, 2)
# with ep2d, the data group's bytes inside each MoE call recorded, as it is
# and with the experts' weights gathered over data (the same numbers).
EP2D_PROBE = BY_NAME["ep2d_22"]


def _ep2d_probe_jobs():
    c = EP2D_PROBE
    _, params = _params(c)
    batch = _batches(c, get_config(V2, smoke=True).vocab_size)[0]
    return [("moe_data_bytes", (c["arch"], c["mesh"], params, batch, c["moe"], fault))
            for fault in (False, True)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocesses and the two spawns side by side, and the
    one-process references of the island and of phase 9
    (``torch_rank_fns.side_by_side``: each part's time is printed, and a
    part that fails is reported with the others' times)."""
    cs = torch_rank_fns._chip_smoke()
    out = tmp_path_factory.mktemp("jax_moe_mesh")
    two = [c for c in CASES if math.prod(c["mesh"]) == 2]
    four = [c for c in CASES if math.prod(c["mesh"]) == 4]

    def spawned(n, jobs):
        return spawn_ranks(torch_rank_fns.ranks_main, n, (jobs(),), timeout=600)

    ranks2 = lambda: spawned(2, lambda: [j for c in two for j in _jobs(c)])
    island2 = lambda: spawned(2, lambda: _jobs(ISLAND) + _jobs(ISLAND, "island_summed_steps") + [
        ("chip_smoke_ep_rank", (REHEARSE_SERVE, REHEARSE_TRAIN, True, "cpu"))])
    ranks4 = lambda: spawned(4, lambda: [j for c in four for j in _jobs(c)] + _ep2d_probe_jobs())

    parts = torch_rank_fns.side_by_side({
        **jax_parts(CASES, out), "2 ranks": ranks2, "2 ranks, the island": island2,
        "4 ranks": ranks4, "island": lambda: _one_island(cs),
        "rehearsal": lambda: cs.ep_references(REHEARSE_SERVE, REHEARSE_TRAIN, smoke=True,
                                              device="cpu")})
    ref = jax_results(parts, out)
    port = {}
    for n, cases in ((2, two), (4, four)):
        for rank in parts[f"{n} ranks"]:
            results = iter(rank)
            for c in cases:
                got = port.setdefault(c["name"], [])
                got.append({"steps": next(results)})
                if c.get("serve"):
                    got[-1]["logits"] = next(results)
            if n == 4:
                for name in ("ep2d_bytes", "ep2d_bytes_fault"):
                    port.setdefault(name, []).append(next(results))
    for rank in parts["2 ranks, the island"]:
        results = iter(rank)
        for name in ("island", "island_summed"):
            port.setdefault(name, []).append(next(results))
        ep = next(results)
        port.setdefault("ep_serve", []).append(ep["serve"])
        port.setdefault("ep_train", []).append(ep["train"])
    return {"jax": ref, "port": port, "island": parts["island"],
            "rehearsal": parts["rehearsal"], "cs": cs}


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_scatter_path_steps_as_jax(runs, name):
    """Every rank's losses and grad-norms, and the final parameters gathered
    whole, against JAX's GSPMD train step: one group over two data ranks,
    two groups one on each, MLA and the experts over model 2, and both."""
    ref = runs["jax"]
    want = {k[len(name) + 8:]: v for k, v in ref.items() if k.startswith(f"{name}/params/")}
    data, model = BY_NAME[name]["mesh"]
    for rank in runs["port"][name]:
        res = rank["steps"]
        np.testing.assert_allclose(res["loss"], ref[f"{name}/loss"], **GRAD_TOL)
        np.testing.assert_allclose(res["grad_norm"], ref[f"{name}/grad_norm"], **GRAD_TOL)
        assert set(res["params"]) == set(want)
        for key, w in want.items():
            np.testing.assert_allclose(res["params"][key], w, err_msg=f"{res['coords']} {key}",
                                       **GRAD_TOL)
        assert all(("data" in w) == (data > 1) and ("model" in w) == (model > 1)
                   for w in res["wire"])


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c.get("serve")])
def test_mla_prefill_and_decode_logits_match_jax(runs, name):
    """MLA on a rank's heads (its latent cache whole on every model rank)
    and the experts' partial sums: each rank's rows' last-token logits of
    the prefill and of one decode step against JAX's."""
    ref, c = runs["jax"], BY_NAME[name]
    rows = c["serve"][0] // c["mesh"][0]
    for rank in runs["port"][name]:
        res = rank["logits"]
        sl = slice(res["coords"]["data"] * rows, (res["coords"]["data"] + 1) * rows)
        np.testing.assert_allclose(res["prefill"], ref[f"{name}/prefill"][sl], **GRAD_TOL)
        np.testing.assert_allclose(res["decode"], ref[f"{name}/decode"][sl], **GRAD_TOL)


def test_island_output_must_not_pass_through_g(runs):
    """The island's output is whole on every model rank: as it is, the steps
    are one process's whose MoE routes each slice as a group; through the
    block's *g* (summed over model, doubled) they lie far outside
    GRAD_TOL."""
    one = runs["island"]
    for sound, summed in zip(runs["port"]["island"], runs["port"]["island_summed"]):
        np.testing.assert_allclose(sound["loss"], one["loss"], **GRAD_TOL)
        np.testing.assert_allclose(sound["grad_norm"], one["grad_norm"], **GRAD_TOL)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(summed["loss"], one["loss"], **GRAD_TOL)
        # It read 1.8e-3, 18 times the tolerance.
        gap = abs(summed["loss"][0] - one["loss"][0]) / one["loss"][0]
        assert gap > 10 * GRAD_TOL["rtol"], gap


@pytest.fixture
def rehearsal_limits(runs):
    cs = runs["cs"]
    real = {k: getattr(cs, k) for k in REHEARSE_LIMITS}
    train = cs.EP_TRAIN
    for k, v in REHEARSE_LIMITS.items():
        setattr(cs, k, v)
    cs.EP_TRAIN = (V2, *REHEARSE_TRAIN)
    try:
        yield cs
    finally:
        for k, v in real.items():
            setattr(cs, k, v)
        cs.EP_TRAIN = train


def test_phase_9_serving_rehearses_at_smoke_width(runs, rehearsal_limits):
    """Phase 9(a) on CPU ranks: its checks pass (logits, the island against
    the one-rank route of its inputs, first tokens, the model group's bytes
    of the prefill and of each decode step equal to the formulas); they fail
    when a decode step counts 4 bytes more and when the planted fault's
    island output reads as the sound one's."""
    cs, (logits, _) = rehearsal_limits, runs["rehearsal"]
    cfg = cs.ep_config(smoke=True)
    batch, plen, _ = REHEARSE_SERVE
    serving = runs["port"]["ep_serve"]
    assert cs.check_ep_serving(serving, cfg, batch, plen, logits, None) <= cs.EP_LOGITS_RTOL
    extra = copy.deepcopy(serving)
    extra[1]["decode_bytes"][2]["model"] += 4
    with pytest.raises(AssertionError, match="decode wire bytes"):
        cs.check_ep_serving(extra, cfg, batch, plen, logits, None)
    assert all(r["fault_island_gap"] > cs.EP_ISLAND_RTOL >= r["island_gap"] for r in serving)
    blind = copy.deepcopy(serving)
    blind[0]["fault_island_gap"] = blind[0]["island_gap"]
    with pytest.raises(AssertionError, match="cannot tell"):
        cs.check_ep_serving(blind, cfg, batch, plen, logits, None)


def test_phase_9_training_rehearses_at_smoke_width(runs, rehearsal_limits):
    """Phase 9(b) on CPU ranks: its checks pass (step 1 against one rank's,
    each step's bytes equal to the formulas: the island's all-to-alls in the
    forward, remat's recompute and the backward among them, each rank's
    parameter and bf16 moment bytes its blocks', the island against the
    one-rank route of its inputs); they fail when a step counts 4 bytes
    more, when the fault's loss or its island output reads as the sound
    one's, and when a rank holds a whole replica's state."""
    cs, (_, ref) = rehearsal_limits, runs["rehearsal"]
    cfg = cs.ep_config(smoke=True)
    training = runs["port"]["ep_train"]
    gaps = cs.check_ep_training(training, cfg, ref, None, None)
    assert all(map(math.isfinite, gaps))
    extra = copy.deepcopy(training)
    extra[1]["history"][0]["wire_bytes"]["model"] += 4
    with pytest.raises(AssertionError, match="wire bytes"):
        cs.check_ep_training(extra, cfg, ref, None, None)
    blind = copy.deepcopy(training)
    blind[0]["fault"] = (blind[0]["history"][0]["loss"], blind[0]["history"][0]["grad_norm"])
    with pytest.raises(AssertionError, match="cannot tell"):
        cs.check_ep_training(blind, cfg, ref, None, None)
    blind = copy.deepcopy(training)
    blind[1]["fault_island_gap"] = blind[1]["island_gap"]
    with pytest.raises(AssertionError, match="cannot tell"):
        cs.check_ep_training(blind, cfg, ref, None, None)
    whole = copy.deepcopy(training)
    whole[1]["param_bytes"], whole[1]["moment_bytes"] = cs.shard_bytes(cfg, (1, 1),
                                                                       moment_bytes=4)
    with pytest.raises(AssertionError, match="its blocks by the rules"):
        cs.check_ep_training(whole, cfg, ref, None, None)


def _mesh(shape):
    return Mesh(axes=("data", "model"), shape=dict(zip(("data", "model"), shape)),
                coords={"data": 0, "model": 0}, device=torch.device("cpu"))


def test_ep2d_moves_no_expert_weight_over_data(runs):
    """ep2d on (2, 2): the data group's bytes inside each MoE call of a
    forward are the tokens' alone: the all-gather of the [E] int64 counts
    (one group spans both data ranks) and the two all-to-alls of the
    [data, groups, experts a rank, C, d_model] fp32 slots.  With the experts'
    weights gathered over data instead (the same numbers) they are not."""
    from repro_torch.core.asymmetry import all_gather_wire_bytes, all_to_all_wire_bytes
    from repro_torch.models.moe import _capacity

    c = EP2D_PROBE
    cfg = _cfg(c, get_config)
    D, M = c["mesh"]
    E, S = cfg.moe.num_experts, c["B"] // D * c["T"]
    slots = D * 1 * (E // (D * M)) * _capacity(S * D, cfg.moe) * cfg.d_model
    want = all_gather_wire_bytes(D * E * 8, D) + 2 * all_to_all_wire_bytes(4 * slots, D)
    for sound, fault in zip(runs["port"]["ep2d_bytes"], runs["port"]["ep2d_bytes_fault"]):
        assert sound["calls"] == [want] * 2, (sound["coords"], sound["calls"], want)
        assert all(b != want for b in fault["calls"]), (fault["calls"], want)


def _jax_block_shapes(cfg, shape):
    """The block a rank holds of each MoE expert weight under JAX's
    ``param_pspecs`` fitted to a (data, model) mesh of ``shape``."""
    from types import SimpleNamespace

    from repro.sharding import rules as jax_rules

    sizes = dict(zip(("data", "model"), shape))
    specs = jax_rules.param_pspecs(JaxModel(cfg).specs())["blocks"]["b0"]["ffn"]
    spec_shapes = JaxModel(cfg).specs()["blocks"]["b0"]["ffn"]
    out = {}
    for key in ("wi", "wo"):
        full = spec_shapes[key].shape
        ps = jax_rules.fit_pspec(specs[key], full, SimpleNamespace(shape=sizes))
        axes = [(e,) if isinstance(e, str) else e or () for e in ps]
        axes += [()] * (len(full) - len(axes))
        out[key] = tuple(n // math.prod(sizes[a] for a in ax) for n, ax in zip(full, axes))
    return out


@pytest.mark.parametrize("layout", ["fsdp_f", "ep2d"])
def test_gspmd_layouts_build_the_references_blocks(layout):
    """``fsdp_f`` (experts on model, the FFN dim FSDP on data: ``wi``'s fused
    ``[gate | up]`` split contiguously, as any FSDP dim) and ``ep2d``
    (experts on (data, model) jointly) hold, on (1, 2), (2, 2) and (3, 1),
    the blocks of JAX's ``param_pspecs``, so that checkpoints load in both
    packages: at (3, 1) the FFN dim 32 and the 8 experts do not divide and
    stay whole.  ``fsdp_f`` at an FFN dim of 12 over data 8 splits ``wi``'s
    24 columns and keeps ``wo``'s 12 rows whole, each leaf by its own fit,
    and gathers each on use by its own placement."""
    cfg = get_config(V2, smoke=True)
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, expert_sharding=layout))
    jcfg = jax_config(V2, smoke=True)
    jcfg = jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe, expert_sharding=layout))
    for shape in ((1, 2), (2, 2), (3, 1)):
        model = Model(cfg, device="cpu", mesh=_mesh(shape))
        got = {k: tuple(model.state_dict()[f"blocks.b0.ffn.{k}"].shape) for k in ("wi", "wo")}
        assert got == _jax_block_shapes(jcfg, shape), (shape, got)
        assert model.layout["blocks.b0.ffn.wi"].blocks == 1
    if layout == "fsdp_f":
        narrow = lambda c: c.with_overrides(moe=dataclasses.replace(c.moe, d_expert=12))
        model = Model(narrow(cfg), device="cpu", mesh=_mesh((8, 1)))
        got = {k: tuple(model.state_dict()[f"blocks.b0.ffn.{k}"].shape) for k in ("wi", "wo")}
        assert got == _jax_block_shapes(narrow(jcfg), (8, 1)) == {
            "wi": (2, 8, 64, 3), "wo": (2, 8, 12, 64)}, got
        assert model.layout["blocks.b0.ffn.wo"].dim_of("data") is None


def _straddled(cfg, x, shape, rows_on=("data",)):
    """``moe_ffn`` of the smoke model's first MoE layer on every rank of a
    mesh of ``shape``, each rank a thread that builds the model on its mesh
    (its blocks of the one-process weights, gathered over ``data`` on use)
    and holds its share of the rows of ``x``: the data ranks' outputs in row
    order, the mean of the ranks' aux, and every rank's output."""
    share = x.shape[0] // shape[0]

    def rank(mesh):
        d = mesh.coords["data"]
        p = Model(cfg, device="cpu", mesh=mesh)._params("blocks", 0)["b0"]["ffn"]
        with torch.no_grad():
            return moe_mod.moe_ffn(p, x[d * share:(d + 1) * share], cfg, mesh,
                                   moe_mod.Rows(mesh, rows_on))

    out = torch_rank_fns.threaded_ranks(shape, rank)
    M = shape[1]
    return (torch.cat([y for y, _ in out[::M]]), sum(a.item() for _, a in out) / len(out),
            [y for y, _ in out])


def test_groups_that_straddle_data_ranks_route_as_one_process():
    """3 groups of 64 tokens over 2 data ranks of 96 (rank 0 holds group 0
    and half of group 1, rank 1 the rest: neither count divides the other),
    2 groups over 4 data ranks (each spans 2 ranks) and 4 groups one a
    rank: each rank's rows' output, and the mean of the ranks' load-balance losses, are one
    process's routing of the whole microbatch, at capacity factor 0.5 where
    choices drop, so that a slot offset other than the earlier pieces'
    counts would change the output."""
    cfg = get_config(V2, smoke=True).with_overrides(dtype="float32")
    x = torch.randn(8, 24, cfg.d_model, generator=torch.Generator().manual_seed(0))
    for groups, data in ((3, 2), (2, 4), (4, 4)):
        c = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, groups=groups,
                                                       capacity_factor=0.5))
        whole, aux = moe_mod.moe_ffn(Model(c, device="cpu").blocks.layer(0)["b0"]["ffn"], x, c)
        y, got_aux, _ = _straddled(c, x, (data, 1))
        torch.testing.assert_close(y, whole, rtol=1e-5, atol=1e-6)
        assert got_aux == pytest.approx(aux.item(), rel=1e-5), (groups, data)
    pc = moe_mod.pieces(96, dataclasses.replace(cfg.moe, groups=3),
                        moe_mod.Rows(_mesh((2, 1)), ("data",)))
    assert (pc.groups, pc.starts, pc.group_size) == ((0, 1), (0, 64, 96), 64)


def test_experts_that_do_not_divide_stay_whole():
    """6 experts over model 4: ``fit_pspec`` leaves ``wi`` and ``wo`` whole,
    and every model rank runs every expert on the FFN input before *f*: the
    output, whole on every rank, is one process's, and no rank's output
    passes through *g* (through it, it would be 4 times as large)."""
    cfg = get_config(V2, smoke=True).with_overrides(dtype="float32")
    cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, num_experts=6,
                                                     capacity_factor=0.5))
    model = Model(cfg, device="cpu", mesh=_mesh((1, 4)))
    for key in ("wi", "wo"):
        assert model.layout[f"blocks.b0.ffn.{key}"].dim_of("model") is None, key
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(3))
    whole, _ = moe_mod.moe_ffn(Model(cfg, device="cpu").blocks.layer(0)["b0"]["ffn"], x, cfg)
    y, _, each = _straddled(cfg, x, (1, 4))
    for got in each:
        torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-6)


def test_rglru_at_model_2_builds_and_an_odd_width_stays_whole():
    """RG-LRU blocks take model 2 where their width divides
    (``tests/test_torch_tp_recurrent.py`` holds them to JAX); a width that
    does not divide is not refused: the rules leave every weight of the
    block whole, and the block's state is whole on every rank
    (``tests/test_torch_tp_uneven.py`` holds such a block to JAX)."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    Model(cfg, device="cpu", mesh=_mesh((1, 2)))
    odd = cfg.with_overrides(rglru=dataclasses.replace(cfg.rglru, width=65))
    model = Model(odd, device="cpu", mesh=_mesh((1, 2)))
    assert all(model.layout[f"blocks.b0.rec.{k}"].dim_of("model") is None
               for k in ("w_x", "w_a", "w_out", "conv_w"))
    assert model.cache(2, 8)["blocks"]["b0"].h.shape[-1] == 65