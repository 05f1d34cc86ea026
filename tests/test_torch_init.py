"""The port's init one tensor at a time: a sharded rank's blocks are the
one-device draw's bit for bit, no two whole draws are alive at once, and
every published config builds on the ``meta`` device with the reference's
parameter count."""

import math
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.mesh import Mesh, _coords, meta_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding.shard import shard  # noqa: E402

MESHES = [((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model"))]
SMOKE = ("llama3.2-1b", "deepseek-v2-236b")


def _cpu_mesh(shape, axes, rank):
    """Rank ``rank``'s mesh on the CPU, with no process group: the init
    runs no collective."""
    sizes = dict(zip(axes, shape))
    return Mesh(axes=axes, shape=sizes, coords=_coords(rank, sizes), device=torch.device("cpu"))


@pytest.mark.parametrize("arch", SMOKE)
@pytest.mark.parametrize("shape,axes", MESHES)
def test_sharded_blocks_are_the_one_device_draw_bit_for_bit(arch, shape, axes):
    cfg = get_config(arch, smoke=True)
    whole = Model(cfg, device="cpu", generator=torch.Generator("cpu").manual_seed(3))
    want = whole.state_dict()
    for rank in range(math.prod(shape)):
        mesh = _cpu_mesh(shape, axes, rank)
        model = Model(cfg, mesh=mesh, generator=torch.Generator("cpu").manual_seed(3))
        got = model.state_dict()
        assert set(got) == set(want)
        split = 0
        for key, t in got.items():
            block = shard(want[key], model.layout[key], mesh)
            assert t.dtype == block.dtype and t.shape == block.shape, key
            assert torch.equal(t.view(torch.uint8) if t.dtype == torch.bfloat16 else t,
                               block.view(torch.uint8) if t.dtype == torch.bfloat16 else block
                               ), (key, rank)
            split += t.numel() < want[key].numel()
        assert split > 0  # the mesh splits some tensors


def test_a_sharded_init_holds_one_whole_draw_at_a_time(monkeypatch):
    """Every normal draw is let go before the next one is drawn."""
    alive, draws, real = [], [0], torch.randn

    def randn(*args, **kw):
        assert not [r for r in alive if r() is not None], "two whole draws alive at once"
        t = real(*args, **kw)
        alive.append(weakref.ref(t))
        draws[0] += 1
        return t

    monkeypatch.setattr(torch, "randn", randn)
    mesh = _cpu_mesh((2, 1, 2), ("pod", "data", "model"), 3)
    model = Model(get_config("deepseek-v2-236b", smoke=True), mesh=mesh,
                  generator=torch.Generator("cpu").manual_seed(0))
    assert draws[0] > 10
    assert sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_build_of_every_published_config(arch):
    from repro.models import Model as JaxModel
    from repro.models import param_count
    from repro.configs import get_config as jax_config

    model = Model(get_config(arch), device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    n = sum(p.numel() for p in model.parameters())
    assert n == param_count(JaxModel(jax_config(arch)).specs())
    published = {"llama3-8b": 8.0e9, "llama3.2-1b": 1.2e9, "deepseek-v2-236b": 236e9,
                 "deepseek-v3-671b": 671e9}  # tests/test_models_smoke.py's band
    if arch in published:
        assert 0.75 * published[arch] < n < 1.30 * published[arch]


def test_meta_mesh_model_holds_its_blocks_and_moves_nothing():
    """On a production-shaped mesh of the meta device the model holds rank
    0's blocks; a collective returns its shape and counts its bytes."""
    mesh = meta_mesh((2, 16, 16), ("pod", "data", "model"))
    model = Model(get_config("llama3-8b"), mesh=mesh)
    whole = Model(get_config("llama3-8b"), device="meta")
    ratio = (sum(p.numel() for p in model.parameters())
             / sum(p.numel() for p in whole.parameters()))
    assert 1 / 256 <= ratio < 1 / 64
    t = torch.empty(1024, device="meta")
    assert mesh.all_gather(t, "data").shape == (16 * 1024,)
    assert mesh.reduce_scatter(t, "model").shape == (64,)
    assert mesh.all_to_all(t, ("data", "model")).shape == (1024,)
    assert mesh.all_reduce(t, "pod") is t
    assert mesh.traffic.calls == {"data": 1, "model": 1, "data+model": 1, "pod": 1}
    assert mesh.traffic.wire_bytes["pod"] == 2 * (1 / 2) * 4096
