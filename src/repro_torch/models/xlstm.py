"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, sequential) — Beck et al., arXiv:2405.04517.

Port of ``repro/models/xlstm.py`` (the reference's ``shard_map`` island
for the sLSTM scan has no counterpart: on a mesh its cell runs whole on
every model rank, as the island's does).  mLSTM
recurrence per head (stabiliser m):

    log i_t, log f_t = gate projections (log f via logsigmoid)
    m_t  = max(log f_t + m_{t-1}, log i_t)
    C_t  = e^{log f_t + m_{t-1} - m_t} C_{t-1} + e^{log i_t - m_t} v_t k_t^T
    n_t  = ...same decay... + e^{log i_t - m_t} k_t
    h_t  = (C_t q_t) / max(|n_t . q_t|, e^{-m_t})

Training and prefill run the chunkwise form: decay-masked attention inside
a chunk, and the state carried across chunks by a Python loop where the
reference runs ``lax.scan``.  Decode is the one-step recurrence.  The sLSTM
is a true sequential recurrence through h_{t-1}: a loop over time in every
mode.  Neither block reaches a kernel: both run as PyTorch ops.

The roundings follow the reference in a bf16 model: q·k is accumulated in
fp32 from bf16 inputs, the decay weights are cast to v's dtype before W·V,
the carried C and n are rounded to q's dtype before the inter-chunk products
and the state update is summed in fp32; the sLSTM's h_{t-1} is cast to the
recurrent weights' dtype before its product.  States are fp32, and ``m``
starts at -1e30.

Under tensor parallelism (``tp``, the model axis of a sharded mesh) the
mLSTM runs a rank's ``H/M`` heads: ``w_up`` and ``w_og`` (split on ``mlp``)
hold their contiguous ``inner/M`` columns and ``wq``, ``wk``, ``wv`` their
heads, so the head count comes from the weights.  ``w_if`` ``[inner, 2H]``
holds the rank's rows: its partial ``[B, T, 2H]`` is reduce-scattered over
``model`` to the rank's heads of each half (``log i`` heads, then ``raw f``
heads; ``sharding.shard.reduce_scatter_model`` with two blocks), and
``b_if``, whole on every rank, is cut the same way.  The group norm is an
RMS norm over the whole inner width: the rank's sum of squares is summed
over ``model`` by ``all_reduce_model``, whose backward sums too (each
rank's normalised slice feeds its own work), and ``gnorm.scale`` is cut to
the rank's columns.  ``w_down`` holds the rank's rows, and *g* sums the
block's output.  The state holds the rank's heads, ``c [B, H/M, dqk, dh]``,
``n`` and ``m``; the reference's cache rule puts ``model`` on ``dqk`` of
``c`` instead (it was written for ``[B, S, K, hd]`` caches), which no rank's
recurrence could use without an exchange each step.  The sLSTM cell stays
whole on every model rank, as the reference chooses (an exchange a time step
would cost far more than the idle axis): ``w_in``, ``r`` and ``gnorm`` are
replicated and no exchange runs inside the loop over time.  Its FFN is
tensor-parallel: *f* after ``gnorm``, ``ffn_wi`` as ``[gate_m | up_m]`` and
*g* after ``ffn_wo``.  Where the gate does not split in two over ``model``
(``sharding.shard.param_layout`` then splits ``ffn_wi``'s columns
contiguously and leaves ``ffn_wo`` whole, as at smoke width), the projection
is gathered whole over ``model`` and the rest runs whole, with no *g*.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, XLSTMConfig
from ..sharding.shard import (all_reduce_model, copy_to_model, gather_slices,
                              reduce_from_model, reduce_scatter_model, slice_model)
from .layers import rmsnorm, rmsnorm_spec
from .specs import ParamSpec

M_INIT = -1e30  # the stabiliser's initial value, and log i on padded steps


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(inner width, head dim, q/k head dim): q and k at half the head dim
    (the official qk_dim_factor 0.5)."""
    inner = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    dh = inner // cfg.num_heads
    return inner, dh, dh // 2


def mlstm_block_spec(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    D, H = cfg.d_model, cfg.num_heads
    inner, dh, dqk = _mlstm_dims(cfg)
    return {
        "w_up": ParamSpec((D, inner), ("embed", "mlp"), dtype=dtype),
        "w_og": ParamSpec((D, inner), ("embed", "mlp"), dtype=dtype),
        "wq": ParamSpec((H, dh, dqk), ("heads", None, None), dtype=dtype),
        "wk": ParamSpec((H, dh, dqk), ("heads", None, None), dtype=dtype),
        "wv": ParamSpec((H, dh, dh), ("heads", None, None), dtype=dtype),
        "w_if": ParamSpec((inner, 2 * H), ("mlp", None), init="normal",
                          scale=0.02, dtype=torch.float32),
        "b_if": ParamSpec((2 * H,), (None,), init="zeros", dtype=torch.float32),
        "gnorm": rmsnorm_spec(inner, dtype),
        "w_down": ParamSpec((inner, D), ("mlp", "embed"), dtype=dtype),
    }


class MLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, dqk, dh] fp32 (a rank's H/M heads)
    n: torch.Tensor   # [B, H, dqk] fp32
    m: torch.Tensor   # [B, H] fp32


def mlstm_state_spec(cfg: ModelConfig, batch: int, device: torch.device,
                     model_size: int = 1) -> MLSTMState:
    """A fresh state of a rank's ``H / model_size`` heads: C and n zero, m at
    -1e30."""
    H = cfg.num_heads // model_size
    _, dh, dqk = _mlstm_dims(cfg)
    return MLSTMState(
        c=torch.zeros((batch, H, dqk, dh), dtype=torch.float32, device=device),
        n=torch.zeros((batch, H, dqk), dtype=torch.float32, device=device),
        m=torch.full((batch, H), M_INIT, dtype=torch.float32, device=device),
    )


def _mlstm_qkv_gates(p, x2: torch.Tensor, cfg: ModelConfig, tp=None):
    """x2: [B, T, inner] → q, k, v [B, T, H, *] in x2's dtype, log_i and
    log_f [B, T, H] fp32, H the heads that the weights hold (``tp``: the
    rank's, ``x2`` its columns)."""
    H = p["wq"].shape[0]
    B, T, inner = x2.shape
    z = x2.reshape(B, T, H, inner // H)
    q = torch.einsum("bthd,hde->bthe", z, p["wq"])
    k = torch.einsum("bthd,hde->bthe", z, p["wk"]) / math.sqrt(p["wq"].shape[-1])
    v = torch.einsum("bthd,hde->bthe", z, p["wv"])
    gif = (reduce_scatter_model(x2.float() @ p["w_if"], tp, -1, blocks=2)
           + slice_model(p["b_if"], tp, blocks=2))
    log_i, raw_f = torch.chunk(gif, 2, dim=-1)            # [B, T, H]
    return q, k, v, log_i, F.logsigmoid(raw_f)


def mlstm_chunkwise(q, k, v, log_i, log_f, state: MLSTMState,
                    chunk: int) -> Tuple[torch.Tensor, MLSTMState]:
    """Chunkwise-parallel mLSTM.  q, k [B, T, H, dqk], v [B, T, H, dh], log_i
    and log_f [B, T, H] → (h [B, T, H, dh] fp32, the state after the last
    step).  A prompt that is no multiple of the chunk is padded with log i
    -1e30 and log f 0, which carry the state through unchanged."""
    B, T, H, dqk = q.shape
    dh = v.shape[-1]
    K = min(chunk, T)
    pad = (-T) % K
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=M_INIT)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    nC = q.shape[1] // K

    # [B, nC, K, H, d] → chunk c's [B, H, K, d]
    rs = lambda a: a.reshape(B, nC, K, H, -1).permute(1, 0, 3, 2, 4)
    qc, kc, vc = rs(q), rs(k), rs(v)
    li = rs(log_i.float())[..., 0]                         # [nC, B, H, K]
    lf = rs(log_f.float())[..., 0]
    keep = torch.ones((K, K), dtype=torch.bool, device=q.device).tril()

    C, n, m = state
    hs = []
    for c in range(nC):
        qb, kb, vb, lib = qc[c], kc[c], vc[c], li[c]
        G = torch.cumsum(lf[c], dim=-1)                    # within-chunk cumulative log f
        # A[t, s] = G_t - G_s + log i_s for s <= t
        A = (G[..., :, None] - G[..., None, :] + lib[..., None, :]).masked_fill(
            ~keep, -math.inf)
        m_intra = A.amax(dim=-1)                           # [B, H, K]
        m_t = torch.maximum(G + m[..., None], m_intra)
        S = torch.exp(A - m_t[..., None])                  # [B, H, K, K]
        qk = qb.float() @ kb.float().transpose(-1, -2)     # bf16 products, fp32 sums
        W = S * qk
        num_intra = W.to(vb.dtype) @ vb
        den_intra = W.sum(dim=-1)
        scale = torch.exp(G + m[..., None] - m_t)          # [B, H, K]
        num_inter = (qb @ C.to(qb.dtype)).float() * scale[..., None]
        den_inter = (qb @ n.to(qb.dtype)[..., None])[..., 0].float() * scale
        num = num_intra.float() + num_inter
        den = den_intra + den_inter
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the state at the chunk's end
        g_last = G[..., -1]                                # [B, H]
        w_end = G[..., -1:] - G + lib                      # [B, H, K]
        m_new = torch.maximum(g_last + m, w_end.amax(dim=-1))
        decay = torch.exp(g_last + m - m_new)
        wi = torch.exp(w_end - m_new[..., None])
        kw = kb.float() * wi[..., None]                    # [B, H, K, dqk]
        C = decay[..., None, None] * C + kw.transpose(-1, -2) @ vb.float()
        n = decay[..., None] * n + kw.sum(dim=-2)
        m = m_new
    h = torch.stack(hs, dim=1)                             # [B, nC, H, K, dh]
    h = h.transpose(2, 3).reshape(B, nC * K, H, dh)[:, :T]
    return h, MLSTMState(c=C, n=n, m=m)


def mlstm_step(q1, k1, v1, li1, lf1, state: MLSTMState):
    """One-token recurrence.  q1, k1 [B, H, dqk], v1 [B, H, dh], li1 and lf1
    [B, H] → (h [B, H, dh] fp32, the new state)."""
    m_new = torch.maximum(lf1 + state.m, li1)
    fd = torch.exp(lf1 + state.m - m_new)
    iw = torch.exp(li1 - m_new)
    k32, q32 = k1.float(), q1.float()
    C = fd[..., None, None] * state.c + iw[..., None, None] * (
        k32[..., :, None] * v1.float()[..., None, :])
    n = fd[..., None] * state.n + iw[..., None] * k32
    num = (q32[..., None, :] @ C)[..., 0, :]
    den = (q32 * n).sum(dim=-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, MLSTMState(c=C, n=n, m=m_new)


def _group_norm(p, h: torch.Tensor, tp, eps: float = 1e-6) -> torch.Tensor:
    """``layers.rmsnorm`` over the whole inner width of ``h`` (under ``tp``
    the rank's columns, the squares summed over ``model``)."""
    if tp is None:
        return rmsnorm(p, h, eps)
    hf = h.float()
    width = hf.shape[-1] * tp.size("model")
    var = all_reduce_model(torch.sum(hf * hf, dim=-1, keepdim=True), tp) / width
    scale = slice_model(p["scale"], tp)
    return (hf * torch.rsqrt(var + eps) * scale.float()).to(h.dtype)


def _mlstm_out(p, h: torch.Tensor, og: torch.Tensor, dtype, tp=None) -> torch.Tensor:
    """The gated, group-normed cell output through the down projection, and
    under ``tp`` *g*."""
    h = h.reshape(*og.shape).to(dtype)
    return reduce_from_model((_group_norm(p["gnorm"], h, tp) * og) @ p["w_down"], tp)


def _mlstm_in(p, x: torch.Tensor, cfg: ModelConfig, tp):
    """*f*, the up projection, the output gate, q, k, v and the gates."""
    x = copy_to_model(x, tp)
    x2 = x @ p["w_up"]
    og = torch.sigmoid(x @ p["w_og"])
    return og, *_mlstm_qkv_gates(p, x2, cfg, tp)


def mlstm_block(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MLSTMState] = None, tp=None
                ) -> Tuple[torch.Tensor, MLSTMState]:
    """Full mLSTM block.  x [B, T, D] → ([B, T, D], state); ``state=None``
    starts from a fresh state (training and prefill).  ``tp``: the model
    axis; the output is whole (summed by *g*)."""
    og, q, k, v, li, lf = _mlstm_in(p, x, cfg, tp)
    if state is None:
        state = mlstm_state_spec(cfg, x.shape[0], x.device,
                                 cfg.num_heads // q.shape[2])
    h, new_state = mlstm_chunkwise(q, k, v, li, lf, state, cfg.xlstm.chunk)
    return _mlstm_out(p, h, og, x.dtype, tp), new_state


def mlstm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: MLSTMState, tp=None):
    """One-token step.  x [B, 1, D] → ([B, 1, D], new state)."""
    og, q, k, v, li, lf = _mlstm_in(p, x, cfg, tp)
    h, new_state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0], state)
    return _mlstm_out(p, h, og, x.dtype, tp), new_state


def mlstm_reference(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequential oracle: :func:`mlstm_step` over time from a fresh state
    (the tests' and the card check's reference for the chunkwise form)."""
    og, q, k, v, li, lf = _mlstm_in(p, x, cfg, None)
    s = mlstm_state_spec(cfg, x.shape[0], x.device)
    hs = []
    for t in range(x.shape[1]):
        h, s = mlstm_step(q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t], s)
        hs.append(h)
    return _mlstm_out(p, torch.stack(hs, dim=1), og, x.dtype)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_block_spec(cfg: ModelConfig, dtype=torch.bfloat16) -> Dict:
    x: XLSTMConfig = cfg.xlstm
    D, H = cfg.d_model, cfg.num_heads
    dh = D // H
    dff = int(x.proj_factor_s * D)
    return {
        "w_in": ParamSpec((D, 4 * D), ("embed", None), dtype=dtype),
        "r": ParamSpec((4, H, dh, dh), (None, None, None, None),
                       init="normal", scale=0.02, dtype=dtype),
        "gnorm": rmsnorm_spec(D, dtype),
        "ffn_wi": ParamSpec((D, 2 * dff), ("embed", "mlp"), dtype=dtype),
        "ffn_wo": ParamSpec((dff, D), ("mlp", "embed"), dtype=dtype),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, D] fp32
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def slstm_state_spec(cfg: ModelConfig, batch: int, device: torch.device) -> SLSTMState:
    """A fresh state: c, n and h zero, m at -1e30."""
    zeros = lambda: torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMState(c=zeros(), n=zeros(), h=zeros(),
                      m=torch.full((batch, cfg.d_model), M_INIT, dtype=torch.float32,
                                   device=device))


def _recurrent_weight(r: torch.Tensor) -> torch.Tensor:
    """The recurrent weights [4, H, dh, dh] as one [H, dh, 4 dh] operand per
    head: a step's four gate products are then one batched matmul.  Made
    once per scan: ``torch.einsum`` would copy ``r`` into this layout at
    every step, and autograd would keep every copy."""
    G, H, dh, _ = r.shape
    return r.permute(1, 2, 0, 3).reshape(H, dh, G * dh)


def _slstm_cell(p, wx_t: torch.Tensor, state: SLSTMState, cfg: ModelConfig,
                r2: Optional[torch.Tensor] = None) -> SLSTMState:
    """One step.  wx_t [B, 4D]: the step's input projections, the gates
    z, i, f, o in that order.  ``r2`` is ``p["r"]`` laid out by
    :func:`_recurrent_weight`; ``p`` is read only to make it when not given."""
    if r2 is None:
        r2 = _recurrent_weight(p["r"])
    B = wx_t.shape[0]
    D, H = cfg.d_model, cfg.num_heads
    hr = state.h.reshape(B, H, D // H).transpose(0, 1).to(r2.dtype)   # [H, B, dh]
    rec = torch.bmm(hr, r2).reshape(H, B, 4, D // H).permute(2, 1, 0, 3)
    # [4, B, D]: each gate's input plus its recurrent term, both in fp32
    pre = (wx_t.float().reshape(B, 4, D).transpose(0, 1)
           + rec.float().reshape(4, B, D))
    z = torch.tanh(pre[0])
    log_i = pre[1]
    log_f = F.logsigmoid(pre[2])
    o = torch.sigmoid(pre[3])
    decayed = log_f + state.m
    m_new = torch.maximum(decayed, log_i)
    fd = torch.exp(decayed - m_new)
    iw = torch.exp(log_i - m_new)
    c = fd * state.c + iw * z
    n = fd * state.n + iw
    # Not clamp: n is exactly 1 after a fresh state's first step, and there
    # jnp.maximum's gradient, which this port keeps, splits evenly.
    h = o * c / torch.maximum(n, torch.ones_like(n))
    return SLSTMState(c=c, n=n, m=m_new, h=h)


def _slstm_scan_local(p_r, wx: torch.Tensor, state: SLSTMState, cfg: ModelConfig):
    """The sequential cell over time.  wx [B, T, 4D] → (h [B, T, D] fp32,
    the state after the last step)."""
    wx = wx.float()  # once for every step: the cell's cast is then a no-op
    r2 = _recurrent_weight(p_r)
    hs = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(None, wx[:, t], state, cfg, r2)
        hs.append(state.h)
    return torch.stack(hs, dim=1), state


def _slstm_ffn(p, h: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """The group norm, then the position-wise gated FFN; the output whole.
    ``tp``: with ``ffn_wi`` as ``[gate_m | up_m]`` and ``ffn_wo``'s rows the
    rank's, *f* after the norm and *g* after ``ffn_wo``; with ``ffn_wi``'s
    columns split contiguously and ``ffn_wo`` whole, *f* and the projection
    gathered whole; with ``ffn_wi`` whole, no exchange."""
    h = rmsnorm(p["gnorm"], h)
    wi, wo = p["ffn_wi"], p["ffn_wo"]
    dff = int(cfg.xlstm.proj_factor_s * cfg.d_model)
    if tp is None or wi.shape[-1] == 2 * dff:
        proj, paired = h @ wi, False
    else:
        proj, paired = copy_to_model(h, tp) @ wi, wo.shape[0] < dff
        if not paired:
            proj = gather_slices(proj, tp, -1)
    g, u = torch.chunk(proj, 2, dim=-1)
    y = (F.silu(g) * u) @ wo
    return reduce_from_model(y, tp) if paired else y


def slstm_block(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SLSTMState] = None, tp=None
                ) -> Tuple[torch.Tensor, SLSTMState]:
    """x [B, T, D] → ([B, T, D], state), sequential over T; ``state=None``
    starts from a fresh state.  ``tp``: the model axis; the cell runs whole
    on every model rank, the output is whole."""
    if state is None:
        state = slstm_state_spec(cfg, x.shape[0], x.device)
    hs, new_state = _slstm_scan_local(p["r"], x @ p["w_in"], state, cfg)
    return _slstm_ffn(p, hs.to(x.dtype), cfg, tp), new_state


def slstm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: SLSTMState, tp=None):
    """One-token step.  x [B, 1, D] → ([B, 1, D], new state)."""
    new_state = _slstm_cell(p, (x @ p["w_in"])[:, 0], state, cfg)
    return _slstm_ffn(p, new_state.h[:, None].to(x.dtype), cfg, tp), new_state
