"""The port's flash-attention backward: the plain lse and backward versions
against torch's autograd of the oracle and the JAX package's ``custom_vjp``,
the bf16 bound that the card checks hold the kernel to, the backward's
variant rule and refusals, autograd under remat, and (on a card) the Hopper
kernel against the plain backward.

Inputs are drawn with numpy.  The JAX modules are imported inside a fixture
so that the card-only test also runs where JAX is not installed.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_groups, flash_attention_bwd, flash_attention_fwd, variant)

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
# chip_smoke.py's bf16 gradient bound: |g - w| <= GRAD_RTOL |w| + GRAD_ROW
# rms(w's row over d) + GRAD_FLOOR rms(w), w the plain backward in fp32 on the
# same bf16 output and lse.
GRAD_RTOL, GRAD_ROW, GRAD_FLOOR = 1.6e-2, 2e-2, 1e-3
# B, T, H, K, d, causal, window: a late row of 1024 keys, d 256 with a window
# and a ragged tail, a window that is no multiple of the KV tile with GQA, and
# d 128 with H/K = 4; then the wgmma backward's schedule edges that the card
# checks run: H/K = 1 and H/K = 8 at d 64, a last 128-key block whose second
# half is all padding (T 4160), a window at d 128, and d 256 with H/K = 16
# (dK and dV summed over 16 heads, in fp32 before the one cast, as the d-256
# kernels sum their head groups' partials); and hubert's rows of 1500 keys at
# d 80 with no causal mask.
BOUND_CASES = [(1, 1200, 2, 1, 64, True, 1024), (1, 333, 2, 1, 256, True, 200),
               (2, 500, 4, 2, 64, True, 77), (1, 512, 8, 2, 128, True, 0),
               (1, 512, 8, 8, 64, True, 0), (1, 512, 8, 1, 64, True, 0),
               (1, 4160, 2, 1, 64, True, 0), (1, 600, 4, 1, 128, True, 100),
               (1, 320, 16, 1, 256, True, 128), (1, 1500, 2, 2, 80, False, 0)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    return SimpleNamespace(jax=jax, jnp=jnp, ops=jops)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, seed=0, dtype="float32", device="cpu"):
    """q, k, v and an output cotangent g for (B, Tq, H, K, dk, dv[, Tk])."""
    B, Tq, H, K, dk, dv = shape[:6]
    Tk = shape[6] if len(shape) > 6 else Tq
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, Tq, H, dk), np.float32),
              rng.standard_normal((B, Tk, K, dk), np.float32),
              rng.standard_normal((B, Tk, K, dv), np.float32),
              rng.standard_normal((B, Tq, H, dv), np.float32))
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype)) for a in arrays]


def _oracle_grads(q, k, v, g, causal, window, scale=None):
    """torch's autograd of the oracle, in fp32 on fp32 upcasts."""
    leaves = [x.float().clone().requires_grad_() for x in (q, k, v)]
    out = ref.flash_attention_ref(*leaves, causal=causal, window=window, scale=scale)
    return torch.autograd.grad(out, leaves, g.float())


def _grad_bound_share(got, want):
    """Largest |g - w| over dq, dk, dv as a share of its per-element bound."""
    share = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        limit = (GRAD_RTOL * w.abs() + GRAD_ROW * w.pow(2).mean(-1, keepdim=True).sqrt()
                 + GRAD_FLOOR * w.pow(2).mean().sqrt())
        share = max(share, ((g - w).abs() / limit).max().item())
    return share


def _bwd_bf16(q, k, v, g, causal, window, bwd_window=None, skip_tile=None):
    """The backward as the wgmma variant rounds it, from the forward's own bf16
    output and lse: P rounded to bf16 before dV = P^T dO, dS before dK and dQ,
    the results rounded to bf16.  ``bwd_window`` masks the backward with
    another window than the forward's; ``skip_tile`` drops one tile of 64
    keys; either is what a broken kernel would do."""
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    B, T, H, dk = q.shape
    G = H // k.shape[2]
    scale = 1 / np.sqrt(dk)
    w = window if bwd_window is None else bwd_window
    s, _ = ref._masked_scores(q, k, scale, causal, w)
    p = torch.exp(s - lse[..., None])
    if skip_tile is not None:
        p[..., 64 * skip_tile:64 * (skip_tile + 1)] = 0
    kf, vf, do = k.float().repeat_interleave(G, 2), v.float().repeat_interleave(G, 2), g.float()
    d = (do * out.float()).sum(-1).transpose(1, 2)
    dv = torch.einsum("bhql,bqhd->blhd", p.to(torch.bfloat16).float(), do)
    dp = torch.einsum("bqhd,blhd->bhql", do, vf)
    ds = (p * (dp - d[..., None])).to(torch.bfloat16).float()
    dq = torch.einsum("bhql,blhd->bqhd", ds, kf) * scale
    dk_ = torch.einsum("bhql,bqhd->blhd", ds, q.float()) * scale
    K = k.shape[2]
    return (dq.to(torch.bfloat16), dk_.reshape(B, T, K, G, dk).sum(3).to(torch.bfloat16),
            dv.reshape(B, T, K, G, -1).sum(3).to(torch.bfloat16)), out, lse


# ------------------------------------------------------- plain versions --
@pytest.mark.parametrize("case", FLASH_CASES)
def test_lse_is_logsumexp_of_masked_scaled_scores(case):
    B, T, H, K, dk, dv, _, _, causal, window, dt = case
    q, k, v, _ = _inputs(case[:6], dtype=dt)
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, causal=causal, window=window))
    kf = k.float().repeat_interleave(H // K, 2)
    s = torch.einsum("bqhd,blhd->bhql", q.float(), kf) / np.sqrt(dk)
    pos = torch.arange(T)
    keep = torch.ones(T, T, dtype=torch.bool)
    if causal:
        keep &= pos[None] <= pos[:, None]
    if window:
        keep &= pos[None] > pos[:, None] - window
    want = torch.logsumexp(s.masked_fill(~keep, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-6)


# (B, Tq, H, K, dk, dv, Tk), causal, window: FLASH_CASES' shapes, and one
# with more queries than keys, whose last rows see no key (Tq > Tk + window - 1).
BWD_REF_CASES = [(c[:6], c[8], c[9], c[10]) for c in FLASH_CASES] + [
    ((1, 60, 4, 2, 16, 8, 30), True, 12, "float32"),
    ((1, 45, 4, 4, 80, 80), False, 0, "float32")]  # hubert's d 80, no causal mask


@pytest.mark.parametrize("shape,causal,window,dt", BWD_REF_CASES)
def test_bwd_ref_matches_oracle_autograd(shape, causal, window, dt):
    """The flash-backward equations on lse give the oracle's cotangents, fully
    masked rows included, with dk and dv summed over GQA groups in fp32."""
    q, k, v, g = _inputs(shape, seed=4, dtype=dt)
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, causal=causal, window=window)
    want = _oracle_grads(q, k, v, g, causal, window)
    if dt == "float32":
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    else:  # bf16: the results' rounding and the bf16 output in D only
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16
            torch.testing.assert_close(a.float(), b, atol=2e-2, rtol=1.6e-2)


def test_flash_grads_with_explicit_scale_match_jax_custom_vjp(jx):
    """ops.flash_attention's backward with a non-default scale against the
    reference's ``custom_vjp`` (Pallas forward in interpret mode)."""
    B, T, H, K, dk, dv, qb, kb, causal, window, _ = FLASH_CASES[1]
    q, k, v, g = _inputs(FLASH_CASES[1][:6], seed=5)
    jg = jx.jnp.asarray(g.numpy())
    want = jx.jax.grad(
        lambda q, k, v: jx.jnp.sum(
            jx.ops.flash_attention(q, k, v, causal, window, qb, kb, 0.3) * jg),
        argnums=(0, 1, 2))(*(jx.jnp.asarray(x.numpy()) for x in (q, k, v)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal, window, qb, kb, 0.3)
    for got, exp in zip(torch.autograd.grad(out, leaves, g), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------- the bf16 bound --
@pytest.mark.parametrize("case", BOUND_CASES)
def test_grad_bound_accepts_kernel_rounding(case):
    """The card checks' bf16 gradient bound passes the wgmma variant's own
    roundings, against the plain backward on the same output and lse."""
    B, T, H, K, d, causal, window = case
    q, k, v, g = _inputs((B, T, H, K, d, d), seed=3, dtype="bfloat16")
    got, out, lse = _bwd_bf16(q, k, v, g, causal, window)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                       g.float(), causal=causal, window=window)
    assert _grad_bound_share(got, want) <= 0.6


@pytest.mark.parametrize("case", [c for c in BOUND_CASES if c[-1]])
def test_grad_bound_rejects_window_off_by_one(case):
    B, T, H, K, d, causal, window = case
    q, k, v, g = _inputs((B, T, H, K, d, d), seed=3, dtype="bfloat16")
    got, out, lse = _bwd_bf16(q, k, v, g, causal, window, bwd_window=window + 1)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                       g.float(), causal=causal, window=window)
    assert _grad_bound_share(got, want) > 2


@pytest.mark.parametrize("case", BOUND_CASES)
def test_grad_bound_rejects_dropped_kv_tile(case):
    B, T, H, K, d, causal, window = case
    q, k, v, g = _inputs((B, T, H, K, d, d), seed=3, dtype="bfloat16")
    got, out, lse = _bwd_bf16(q, k, v, g, causal, window, skip_tile=T // 64 - 2)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                       g.float(), causal=causal, window=window)
    assert _grad_bound_share(got, want) > 10


# ------------------------------------------------ dispatch and refusals --
# (B, T, H, K, dk, dv), dtype, the backward variant.
BWD_VARIANT_CASES = [
    ((1, 40, 2, 1, 64, 64), "bfloat16", "wgmma"),    # llama3.2-1b's d 64
    ((1, 40, 4, 2, 128, 128), "bfloat16", "wgmma"),  # llama3-8b's d 128
    ((1, 40, 4, 4, 80, 80), "bfloat16", "wgmma"),    # hubert's d 80 on the D-128 kernel
    ((1, 40, 4, 2, 32, 16), "bfloat16", "wgmma"),    # dk != dv under 64
    ((1, 40, 2, 1, 192, 128), "bfloat16", "wgmma"),  # MLA: the d-256 kernels
    ((1, 40, 2, 1, 256, 256), "bfloat16", "wgmma"),  # recurrentgemma's d 256
    ((1, 40, 2, 1, 64, 60), "bfloat16", "simt"),     # dv no multiple of 8
    ((1, 40, 2, 1, 64, 64), "float32", "simt"),
    ((1, 40, 2, 1, 264, 64), "bfloat16", "simt"),    # past head dim 256
    ((1, 40, 2, 1, 256, 256), "float32", "simt"),
]


@pytest.mark.parametrize("shape,dtype,expect", BWD_VARIANT_CASES)
def test_flash_backward_variant_dispatch(shape, dtype, expect):
    q, k, v, _ = _inputs(shape, dtype=dtype)
    assert variant(q, k, v) == expect


def test_flash_backward_variant_needs_aligned_storage():
    q, k, v, _ = _inputs((1, 8, 2, 1, 64, 64), dtype="bfloat16")
    assert variant(q, k, v) == "wgmma"
    k = torch.zeros(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape)
    assert variant(q, k, v) == "simt"


def test_flash_backward_variant_at_d256_needs_aligned_storage():
    q, k, v, _ = _inputs((1, 8, 2, 1, 256, 256), dtype="bfloat16")
    assert variant(q, k, v) == "wgmma"
    q = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    assert variant(q, k, v) == "simt"


# B, K, Tk, H/K, SMs -> head groups of the d-256 backward: recurrentgemma-9b's
# training shape on an H100 (64 key tiles x 8 groups = 512 blocks, the first
# divisor past 3 x 132), its serving batch of 4 (256 tiles x 2), H/K 16 at a
# short T (every head its own group), and MQA at B 8 (no split needed).
BWD_GROUP_CASES = [((1, 1, 4096, 16, 132), 8), ((4, 1, 4096, 16, 132), 2),
                   ((1, 1, 320, 16, 132), 16), ((8, 1, 4096, 16, 132), 1)]


@pytest.mark.parametrize("args,expect", BWD_GROUP_CASES)
def test_bwd_groups_fill_the_card(args, expect):
    B, K, Tk, group, sms = args
    n = bwd_groups(*args)
    assert n == expect and group % n == 0
    assert n == group or B * K * -(-Tk // 64) * n >= 3 * sms


def test_backward_wrapper_refuses_cpu_tensors():
    """The backward launches on CUDA tensors or raises; it never computes on
    the CPU, and counts nothing it did not launch."""
    q, k, v, g = _inputs(FLASH_CASES[0][:6])
    out, lse = ref.flash_attention_lse_ref(q, k, v)
    before = dict(flash_attention_bwd.launches_by_variant)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_bwd(q, k, v, out, lse, g)
    assert flash_attention_bwd.launches_by_variant == before
    assert set(before) == {"simt", "wgmma"}


def test_ops_backward_refuses_unknown_device():
    q = torch.empty((1, 4, 2, 8), device="meta")
    lse = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no flash_attention backward"):
        ops._flash_bwd(q, q, q, q, lse, q, True, 0, None)


# ------------------------------------------------------------ autograd --
def test_flash_autograd_saves_lse_only_under_grad(monkeypatch):
    """The forward asks for lse only when a graph is recorded: under no_grad,
    and for inputs that need no gradient, it runs the plain forward alone."""
    asked = []
    real = ops._flash_fwd

    def spy(*args, **kwargs):
        asked.append(kwargs.get("lse", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "_flash_fwd", spy)
    q, k, v, _ = _inputs(FLASH_CASES[0][:6])
    ops.flash_attention(q, k, v)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    ops.flash_attention(q, k, v)
    assert asked == [False, False, True]


def test_remat_block_grads_equal_the_unremated_block():
    """A llama3.2-1b smoke model under non-reentrant checkpoint (the
    Function's saved output and lse are the recomputed forward's) gives the
    gradients of the same model without remat."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("llama3.2-1b", smoke=True).with_overrides(dtype="float32")
    assert cfg.remat != "none"
    remat = Model(cfg, device="cpu")
    plain = Model(cfg.with_overrides(remat="none"), device="cpu")
    plain.load_state_dict(remat.state_dict())
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33)))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    grads = []
    for model in (remat, plain):
        names, params = zip(*model.named_parameters())
        loss, _ = model.loss(batch)
        grads.append(dict(zip(names, torch.autograd.grad(loss, params))))
    assert grads[0].keys() == grads[1].keys()
    for key, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][key], atol=1e-6, rtol=1e-5, msg=key)


# ----------------------------------------------------------- on the card --
# (B, Tq, H, K, dk, dv[, Tk]), causal, window, dtype: FLASH_CASES, then bf16 at
# every wgmma head dim and its tile edges, the edges of the wgmma
# backward's schedules, and bf16 that stays on simt (as in chip_smoke.py's
# BWD_CASES); an optional fifth entry offsets q, k, v from aligned storage.
CARD_CASES = [(c[:6], c[8], c[9], c[10]) for c in FLASH_CASES] + [
    ((2, 256, 8, 2, 64, 64), True, 0, "bfloat16"),
    ((1, 200, 2, 1, 64, 64), False, 0, "bfloat16"),       # no mask, ragged tail
    ((2, 256, 8, 2, 128, 128), True, 0, "bfloat16"),      # H/K = 4 at d 128
    ((2, 500, 4, 2, 64, 64), True, 77, "bfloat16"),       # window % KV tile != 0
    ((1, 70, 2, 1, 192, 128), True, 0, "bfloat16"),       # dk 192 / dv 128: wgmma, d 256
    ((1, 300, 4, 1, 256, 256), True, 64, "bfloat16"),     # d 256: wgmma
    ((1, 40, 2, 1, 64, 64), True, 0, "float32"),
    ((1, 512, 8, 8, 64, 64), True, 0, "bfloat16"),        # H/K = 1
    ((1, 512, 8, 1, 64, 64), True, 0, "bfloat16"),        # H/K = 8
    ((1, 4160, 4, 2, 64, 64), True, 0, "bfloat16"),       # last block: 64 keys of 128
    ((1, 600, 4, 1, 128, 128), True, 100, "bfloat16"),    # window at d 128
    ((1, 320, 16, 1, 256, 256), True, 128, "bfloat16"),   # H/K = 16 at d 256
    ((1, 200, 4, 2, 256, 256), True, 16, "bfloat16"),     # window under half a tile
    ((1, 100, 8, 1, 256, 256, 300), True, 0, "bfloat16"),  # key tiles no query sees
    ((1, 70, 2, 1, 64, 60), True, 0, "bfloat16"),         # dv no multiple of 8: simt
    ((1, 130, 4, 1, 256, 256), True, 64, "bfloat16", 1),  # d 256 off by one element: simt
    # No causal mask: hubert's d 80 on flash_bwd_wgmma<128> (dq's box at
    # columns 64-95 clipped at 80) with a T that no tile divides, GQA at d 64,
    # and d 128.
    ((2, 300, 4, 4, 80, 80), False, 0, "bfloat16"),
    ((1, 200, 8, 2, 64, 64), False, 0, "bfloat16"),
    ((1, 130, 4, 2, 128, 128), False, 0, "bfloat16"),
]


def _offset_view(x, offset):
    """x's values in storage that starts ``offset`` elements into a buffer."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
def test_flash_bwd_kernel_matches_plain_on_card(cuda):
    """Every case on the card: the forward's lse against the plain version's,
    and dq, dk, dv against the plain backward on the kernel's own output and
    lse (fp32 within 1e-4; bf16 within the per-element bound), NaN-free, on
    ``wgmma`` for bf16 that the TMA can load and ``simt`` otherwise (a case's
    optional fifth entry puts q, k and v that many elements off 16-byte
    aligned storage), the launch counted.  Then
    rows that see no key (Tq > Tk + window - 1): the kernel's own rule, lse
    -inf, output 0, dq 0, and dk, dv those of the other rows alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape, causal, window, dt, *offset in CARD_CASES:
        q, k, v, g = _inputs(shape, seed=7, dtype=dt, device=cuda)
        if offset:
            q, k, v = (_offset_view(x, *offset) for x in (q, k, v))
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, lse=True)
        _, lse_plain = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=window)
        kind = variant(q, k, v)
        tma = dt == "bfloat16" and shape[4] % 8 == 0 and shape[5] % 8 == 0 and not offset
        assert kind == ("wgmma" if tma else "simt"), shape
        before = flash_attention_bwd.launches_by_variant[kind]
        got = flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)
        assert flash_attention_bwd.launches_by_variant[kind] == before + 1
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                           g.float(), causal=causal, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, lse_plain, atol=1e-4, rtol=0)
        assert not any(bool(torch.isnan(x).any()) for x in got), shape
        if dt == "float32":
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=f"{shape} ({kind})")
        else:
            assert _grad_bound_share(got, want) <= 1.0, f"{shape} ({kind})"

    for dt in ("float32", "bfloat16"):
        shape, causal, window = (1, 100, 4, 2, 64, 64, 40), True, 30
        q, k, v, g = _inputs(shape, seed=8, dtype=dt, device=cuda)
        empty = torch.arange(100, device=cuda) >= 40 + window - 1  # rows 69..99
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, lse=True)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, causal=causal, window=window)
        g0 = g.masked_fill(empty[None, :, None, None], 0)
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(), lse,
                                           g0.float(), causal=causal, window=window)
        torch.cuda.synchronize()
        assert bool(torch.isneginf(lse[:, :, empty]).all())
        assert not bool(torch.isinf(lse[:, :, ~empty]).any())
        assert not bool(out[:, empty].any()) and not bool(dq[:, empty].any())
        got = (dq, dk, dv)
        if dt == "float32":
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b.to(a.dtype), atol=1e-4, rtol=0)
        else:
            assert _grad_bound_share(got, want) <= 1.0
