"""The port's flash attention (plain version, CPU dispatch, Hopper kernel)
against the JAX package's oracle and its Pallas kernel in interpret mode.

Inputs are drawn once with numpy and handed to both frameworks.  The JAX
modules are imported inside a fixture so that the card-only test at the end
also runs where JAX is not installed.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    WIDTHS, flash_attention_fwd, variant, widths)

# tests/test_kernels.py's FLASH_CASES, dtypes by name.
FLASH_CASES = [
    # B, T, H, K, dk, dv, qb, kb, causal, window, dtype
    (2, 64, 4, 2, 32, 32, 16, 32, True, 0, "float32"),
    (1, 96, 8, 8, 64, 64, 32, 32, True, 24, "float32"),
    (2, 48, 4, 1, 16, 16, 16, 16, False, 0, "float32"),
    (1, 80, 4, 2, 32, 16, 32, 16, True, 0, "bfloat16"),  # MLA-style dk!=dv
    (1, 50, 2, 2, 16, 16, 16, 16, True, 0, "float32"),   # ragged T
    (3, 32, 6, 3, 8, 8, 32, 32, True, 0, "float32"),     # single block
]
# fp32: summation order only; bf16: one rounding of the output and of P.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The kernel's bf16 output is also held per element to
# |out - ref| <= BF16_RTOL |ref| + BF16_ROW rms(ref's row over dv): two bf16
# ulps of the value for the output's rounding, and a share of the row's scale
# for P's.  Late rows of long windows have an RMS near 0.03, where 2e-2
# absolute would pass a wrong mask.
BF16_RTOL, BF16_ROW = 1.6e-2, 1e-2

# The kernel variant each shape runs: fp32 and bf16 that the TMA cannot load
# on "simt", other bf16 on "wgmma".  (B, T, H, K, dk, dv), dtype, variant.
VARIANT_CASES = [(c[:6], c[10], "simt" if c[10] == "float32" else "wgmma")
                 for c in FLASH_CASES] + [
    ((1, 70, 2, 1, 192, 128), "bfloat16", "wgmma"),   # MLA: widths (192, 128)
    ((1, 130, 4, 2, 128, 128), "bfloat16", "wgmma"),  # llama3-8b's d 128
    ((2, 300, 4, 4, 80, 80), "bfloat16", "wgmma"),    # hubert's d 80: D 128 covers it
    ((1, 300, 4, 1, 256, 256), "bfloat16", "wgmma"),  # recurrentgemma's d 256
    ((1, 40, 2, 1, 4, 4), "bfloat16", "simt"),        # 8-byte rows: no TMA stride
    ((1, 40, 2, 1, 64, 60), "bfloat16", "simt"),      # dv no multiple of 8
    ((1, 40, 2, 1, 256, 256), "float32", "simt"),
    ((1, 40, 2, 1, 264, 64), "bfloat16", "simt"),     # past the largest D
]
# Card-only cases beyond FLASH_CASES: bf16 at every wgmma head dim and its
# tile edges, and one bf16 shape the TMA cannot take.
CARD_CASES = [
    (2, 200, 8, 2, 64, 64, 0, 0, True, 48, "bfloat16"),
    (1, 130, 4, 2, 128, 128, 0, 0, True, 0, "bfloat16"),
    (2, 256, 8, 2, 128, 128, 0, 0, True, 0, "bfloat16"),    # H/K = 4 at d 128
    (1, 300, 4, 1, 192, 128, 0, 0, True, 0, "bfloat16"),    # dk 192 / dv 128
    (1, 333, 4, 2, 192, 128, 0, 0, True, 0, "bfloat16"),    # H/K = 2, ragged tail
    (1, 300, 4, 4, 192, 128, 0, 0, False, 0, "bfloat16"),   # no causal mask
    (1, 200, 2, 1, 136, 128, 0, 0, True, 0, "bfloat16"),    # dk zero-filled to 192
    (1, 300, 4, 1, 256, 256, 0, 0, True, 64, "bfloat16"),
    (2, 333, 4, 2, 256, 256, 0, 0, True, 200, "bfloat16"),  # Tq % 128 != 0, window
    (2, 500, 4, 2, 64, 64, 0, 0, True, 77, "bfloat16"),     # window % KV tile != 0
    (1, 40, 2, 1, 4, 4, 0, 0, True, 0, "bfloat16"),         # simt
    # No causal mask: hubert's d 80 (wgmma<128>, columns 80-127 zero-filled)
    # with a T that no tile divides, GQA at d 64, and d 128.
    (2, 300, 4, 4, 80, 80, 0, 0, False, 0, "bfloat16"),
    (1, 200, 8, 2, 64, 64, 0, 0, False, 0, "bfloat16"),
    (1, 130, 4, 2, 128, 128, 0, 0, False, 0, "bfloat16"),
]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return SimpleNamespace(jax=jax, jnp=jnp, ops=jops, ref=jref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(case, seed=0):
    B, T, H, K, dk, dv = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, dk), np.float32),
            rng.standard_normal((B, T, K, dk), np.float32),
            rng.standard_normal((B, T, K, dv), np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrays]


def _np(x):
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def _bf16_bound_share(out, expect):
    """Largest |out - ref| as a share of its per-element bf16 bound."""
    o, e = out.float(), expect.float()
    limit = BF16_RTOL * e.abs() + BF16_ROW * e.pow(2).mean(-1, keepdim=True).sqrt()
    return ((o - e).abs() / limit).max().item()


def _online_bf16(q, k, v, causal, window, bk=64, skip_tile=None):
    """bf16 attention as the wgmma variant rounds it: fp32 scores, running max
    and sum over KV tiles of ``bk`` keys, P rounded to bf16 before P V, the
    output rounded to bf16.  ``skip_tile`` drops one KV tile, as a broken
    kernel would."""
    B, T, H, dk = q.shape
    G = H // k.shape[2]
    kf = k.repeat_interleave(G, 2).float()
    vf = v.repeat_interleave(G, 2).float()
    s = torch.einsum("bqhd,blhd->bhql", q.float(), kf) / np.sqrt(dk)
    pos = torch.arange(T)
    keep = torch.ones(T, T, dtype=torch.bool)
    if causal:
        keep &= pos[None] <= pos[:, None]
    if window:
        keep &= pos[None] > pos[:, None] - window
    s = s.masked_fill(~keep, -torch.inf)
    m = torch.full((B, H, T, 1), -torch.inf)
    l = torch.zeros(B, H, T, 1)
    acc = torch.zeros(B, H, T, v.shape[-1])
    for t in range(0, T, bk):
        if t // bk == skip_tile:
            continue
        st = s[..., t:t + bk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(st - safe)
        corr = torch.exp(m - safe)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhql,blhd->bhqd", p.to(torch.bfloat16).float(),
                                        vf[:, t:t + bk])
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("path", ["ref", "ops"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_jax_ref(jx, case, path):
    B, T, H, K, dk, dv, qb, kb, causal, window, dt = case
    arrays = _inputs(case)
    jq, jk, jv = (jx.jnp.asarray(a, getattr(jx.jnp, dt)) for a in arrays)
    expect = jx.ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    q, k, v = _torch(arrays, dt)
    if path == "ref":
        out = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    else:
        out = ops.flash_attention(q, k, v, causal, window, qb, kb, None)
    assert out.shape == (B, T, H, dv) and out.dtype == v.dtype
    np.testing.assert_allclose(_np(out), _np(expect), atol=TOL[dt])


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[3]])
def test_flash_attention_matches_pallas_interpret(jx, case):
    """The Pallas kernel itself (interpret mode) against the port's CPU path."""
    B, T, H, K, dk, dv, qb, kb, causal, window, dt = case
    arrays = _inputs(case, seed=1)
    jq, jk, jv = (jx.jnp.asarray(a, getattr(jx.jnp, dt)) for a in arrays)
    expect = jx.ops.flash_attention(jq, jk, jv, causal, window, qb, kb, None)
    out = ops.flash_attention(*_torch(arrays, dt), causal, window, qb, kb, None)
    np.testing.assert_allclose(_np(out), _np(expect), atol=TOL[dt])


def test_flash_attention_explicit_scale(jx):
    case = FLASH_CASES[0]
    arrays = _inputs(case, seed=2)
    jq, jk, jv = (jx.jnp.asarray(a) for a in arrays)
    expect = jx.ref.flash_attention_ref(jq, jk, jv, causal=True, scale=0.3)
    out = ops.flash_attention(*_torch(arrays, "float32"), True, 0, 16, 16, 0.3)
    np.testing.assert_allclose(_np(out), _np(expect), atol=TOL["float32"])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors or raises; it never computes on the CPU."""
    q, k, v = _torch(_inputs(FLASH_CASES[0]), "float32")
    before = flash_attention_fwd.launches
    by_variant = dict(flash_attention_fwd.launches_by_variant)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_fwd(q, k, v)
    assert flash_attention_fwd.launches == before
    assert flash_attention_fwd.launches_by_variant == by_variant
    assert set(by_variant) == {"simt", "wgmma"}


def test_ops_refuses_unknown_device():
    """A device other than cuda, cpu and meta raises; meta (the dry run's)
    gets the output's shape and dtype."""
    other = SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="no flash_attention path"):
        ops._flash_fwd(other, other, other, True, 0, None)
    q = torch.empty((1, 4, 2, 8), device="meta")
    out = ops.flash_attention(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    assert "flash_attention" in build.sources()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["flash_attention"])


def test_builds_started_together_compile_each_source_once(tmp_path, monkeypatch):
    """Two builds of a fresh tree at once, as the ranks of a mesh start:
    under the build lock each source compiles once.  The stub nvcc notes
    each call, takes 0.3 s and writes its ``-o`` file."""
    csrc, calls, nvcc = tmp_path / "csrc", tmp_path / "calls", tmp_path / "nvcc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text("")
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {calls}\nsleep 0.3\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(build.build, ["a", "b"]) for _ in range(2)]
        done = [f.result(timeout=60) for f in futures]
    assert sorted(map(sorted, done)) == [[], ["a", "b"]]
    assert len(calls.read_text().splitlines()) == 2
    assert not any(build._stale(name) for name in ("a", "b"))


@pytest.mark.parametrize("shape,dtype,expect", VARIANT_CASES)
def test_flash_variant_dispatch(shape, dtype, expect):
    q, k, v = _torch(_inputs(shape), dtype)
    assert variant(q, k, v) == expect


# (dk, dv) -> the widths (DK, DV) of the wgmma instantiation: the head dims
# of VARIANT_CASES, then dk past 128 beside dv 128 and both at 192, 200 and
# 256.  Only 128 < dk <= 192 with dv <= 128 runs (192, 128); every other
# shape keeps the smallest (D, D) of 64, 128 and 256 that covers it.
WIDTH_CASES = [((32, 32), (64, 64)), ((64, 64), (64, 64)), ((16, 16), (64, 64)),
               ((32, 16), (64, 64)), ((8, 8), (64, 64)), ((4, 4), (64, 64)),
               ((64, 60), (64, 64)), ((80, 80), (128, 128)), ((128, 128), (128, 128)),
               ((192, 128), (192, 128)), ((136, 128), (192, 128)), ((192, 192), (256, 256)),
               ((200, 128), (256, 256)), ((256, 256), (256, 256))]


def _widths_before_mla(dk, dv):
    """The rule before (192, 128) existed: the smallest (D, D) that covers
    both head dims."""
    d = next(w for w in (64, 128, 256) if max(dk, dv) <= w)
    return d, d


@pytest.mark.parametrize("dims,expect", WIDTH_CASES)
def test_flash_widths(dims, expect):
    dk, dv = dims
    got = widths(dk, dv)
    assert got == expect and got in WIDTHS and dk <= got[0] and dv <= got[1]
    if not (128 < dk <= 192 and dv <= 128):
        assert got == _widths_before_mla(dk, dv)


def test_flash_widths_refuse_past_256():
    with pytest.raises(ValueError, match="no wgmma instantiation"):
        widths(264, 64)


@pytest.mark.parametrize("operand", [0, 1, 2])
def test_flash_variant_needs_aligned_storage(operand):
    """The TMA reads from 16-byte aligned bases only: q, k or v in a view 2
    bytes off goes to the simt variant."""
    qkv = _torch(_inputs((1, 8, 2, 1, 64, 64)), "bfloat16")
    assert variant(*qkv) == "wgmma"
    x = qkv[operand]
    qkv[operand] = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    assert qkv[operand].is_contiguous()
    assert variant(*qkv) == "simt"


# B, T, H, K, d, causal, window: a late row of 1024 keys, d 256 with a
# window and a ragged last tile, and hubert's rows of 1500 keys at d 80 with
# no causal mask.
BOUND_CASES = [(1, 1200, 2, 1, 64, True, 1024), (1, 333, 2, 1, 256, True, 200),
               (1, 1500, 2, 2, 80, False, 0)]


def _bound_inputs(case):
    B, T, H, K, d, causal, window = case
    return _torch(_inputs((B, T, H, K, d, d), seed=3), "bfloat16"), causal, window


@pytest.mark.parametrize("case", BOUND_CASES)
def test_bf16_bound_accepts_kernel_rounding(case):
    """The card test's bf16 bound passes the wgmma variant's own roundings."""
    (q, k, v), causal, window = _bound_inputs(case)
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    out = _online_bf16(q, k, v, causal, window)
    assert _np((out.float() - expect.float()).abs()).max() <= TOL["bfloat16"]
    assert _bf16_bound_share(out, expect) <= 0.9


# MLA's widths on the (192, 128) forward, 128 keys a tile: B, T, H, K,
# causal; a ragged tail with H/K = 2, and no causal mask.
MLA_BOUND_CASES = [(1, 600, 4, 1, True), (1, 333, 4, 2, True), (1, 300, 4, 4, False)]


@pytest.mark.parametrize("case", MLA_BOUND_CASES)
def test_bf16_bound_accepts_mla_tile_rounding(case):
    """The card test's bf16 bound passes the roundings of flash_fwd_wgmma<192,
    128>, whose KV tiles hold 128 keys, at dk 192 / dv 128."""
    B, T, H, K, causal = case
    q, k, v = _torch(_inputs((B, T, H, K, 192, 128), seed=3), "bfloat16")
    expect = ref.flash_attention_ref(q, k, v, causal=causal)
    out = _online_bf16(q, k, v, causal, 0, bk=128)
    assert _np((out.float() - expect.float()).abs()).max() <= TOL["bfloat16"]
    assert _bf16_bound_share(out, expect) <= 0.9


@pytest.mark.parametrize("case", BOUND_CASES)
def test_bf16_bound_rejects_window_off_by_one(case):
    (q, k, v), causal, window = _bound_inputs(case)
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    wrong = ref.flash_attention_ref(q, k, v, causal=causal, window=window + 1)
    assert _bf16_bound_share(wrong, expect) > 2


@pytest.mark.parametrize("case", BOUND_CASES)
def test_bf16_bound_rejects_dropped_kv_tile(case):
    (q, k, v), causal, window = _bound_inputs(case)
    expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    wrong = _online_bf16(q, k, v, causal, window, skip_tile=q.shape[1] // 64 - 2)
    assert _bf16_bound_share(wrong, expect) > 2


_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897915flash_fwd_wgmmaILi256EEEv14CUtensorMap_stS1_S1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897915flash_fwd_wgmmaILi256EEEv14CUtensorMap_stS1_S1_NS_6ParamsE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1264 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897914flash_fwd_simtIfEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897914flash_fwd_simtIfEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 1024 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_kernel():
    """The build keeps nvcc's -Xptxas -v output; each kernel's registers,
    spills and static shared memory are read from it."""
    assert build.NVCC_FLAGS[-2:] == ["-Xptxas", "-v"]
    wgmma, simt = build.ptxas_usage(_PTXAS_LOG)
    assert (wgmma["kernel"], simt["kernel"]) == ("flash_fwd_wgmma<256>", "flash_fwd_simt<float>")
    assert (wgmma["registers"], wgmma["spill_stores"], wgmma["spill_loads"]) == (168, 8, 12)
    assert (simt["registers"], simt["spill_stores"], simt["static_smem"]) == (40, 0, 1024)


# nvcc's name for the anonymous namespace of flash_attention.cu.
_NVCC_NS = "_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c138979"


@pytest.mark.parametrize("symbol,name", [
    (f"{_NVCC_NS}15flash_fwd_wgmmaILi64EEEv14CUtensorMap_stS1_S1_NS_6ParamsE",
     "flash_fwd_wgmma<64>"),
    (f"{_NVCC_NS}14flash_fwd_simtI13__nv_bfloat16EEvNS_6ParamsE",
     "flash_fwd_simt<__nv_bfloat16>"),
    ("_ZN46_GLOBAL__N__d8a8c85f_13_rglru_scan_cu_1719ef2717rglru_scan_kernelEPKfS1_S1_Pfii",
     "rglru_scan_kernel"),
    ("_ZN12_GLOBAL__N_16kernelILi8EEEvv", "kernel<8>"),
    ("_Z6kernelILi3EfEvv", "kernel<3, float>"),
    ("plain_c_kernel", "plain_c_kernel"),
])
def test_kernel_name_from_symbol(symbol, name):
    assert build.kernel_name(symbol) == name


def test_build_is_stale_without_its_log(tmp_path, monkeypatch):
    """A library built without nvcc's log beside it is rebuilt."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    build.lib_path("flash_attention").write_bytes(b"")
    assert build._stale("flash_attention")
    build.log_path("flash_attention").write_text("")
    assert not build._stale("flash_attention")


# ------------------------------------------------------------ autograd --
@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[10] == "float32"])
def test_flash_grads_match_jax_custom_vjp(jx, case):
    """ops.flash_attention under autograd against the reference's
    ``jax.custom_vjp`` (Pallas forward in interpret mode, the oracle's vjp
    as backward), for every fp32 case: causal, windowed, GQA, MQA, ragged."""
    B, T, H, K, dk, dv, qb, kb, causal, window, _ = case
    arrays = _inputs(case, seed=2)
    g = np.random.default_rng(3).standard_normal((B, T, H, dv)).astype(np.float32)
    jg = jx.jnp.asarray(g)
    want = jx.jax.grad(
        lambda q, k, v: jx.jnp.sum(jx.ops.flash_attention(q, k, v, causal, window, qb, kb) * jg),
        argnums=(0, 1, 2))(*(jx.jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = ops.flash_attention(*leaves, causal, window, qb, kb)
    for got, exp in zip(torch.autograd.grad(out, leaves, torch.from_numpy(g)), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4, rtol=1e-4)


def test_flash_autograd_saves_only_its_inputs():
    """Under autograd the function keeps what its backward reads and nothing
    else: its inputs q, k and v, its own output and each row's lse (fp32
    [B,H,T]), all of them results of the forward that non-reentrant
    torch.utils.checkpoint recomputes; without grad it records no graph."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _inputs(FLASH_CASES[0]))
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = ops.flash_attention(q, k, v, True, 0)
    assert out.grad_fn is not None
    assert [t.data_ptr() for t in saved[:4]] == [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                 out.data_ptr()]
    B, T, H = q.shape[:3]
    assert len(saved) == 5 and saved[4].shape == (B, H, T) and saved[4].dtype == torch.float32
    _, lse = ref.flash_attention_lse_ref(q.detach(), k.detach(), v.detach())
    assert torch.equal(saved[4], lse)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, True, 0).grad_fn is None


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card(cuda):
    """Every case, plus bf16 at each wgmma head dim and tile edge and one bf16
    shape on the simt variant, on the card: each within its tolerance (bf16
    also within its per-element bound), NaN-free, on the variant that
    ``variant`` names and the launch counted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for case in FLASH_CASES + CARD_CASES:
        causal, window, dt = case[8:]
        q, k, v = _torch(_inputs(case), dt, cuda)
        kind = variant(q, k, v)
        assert kind == ("simt" if dt == "float32" or case[4] % 8 else "wgmma"), case
        before = flash_attention_fwd.launches_by_variant[kind]
        out = flash_attention_fwd(q, k, v, causal=causal, window=window)
        assert flash_attention_fwd.launches_by_variant[kind] == before + 1, case
        expect = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert not torch.isnan(out).any(), case
        np.testing.assert_allclose(_np(out), _np(expect), atol=TOL[dt],
                                   err_msg=f"{case} ({kind})")
        if dt == "bfloat16":
            assert _bf16_bound_share(out, expect) <= 1.0, f"{case} ({kind})"
