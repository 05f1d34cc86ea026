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
recurrence could use without an exchange each step.

Where the heads do not divide over ``model`` but the inner width does
(xlstm-1.3b's 4 heads on model 8 or 16), ``fit_pspec`` keeps ``wq``, ``wk``
and ``wv`` whole and still splits ``w_up``, ``w_og``, ``w_if``, ``gnorm``
and ``w_down`` on ``mlp``, so a rank's ``inner/M`` columns cut across a
head.  The rank's up-projection is then gathered whole over ``model``
(``sharding.shard.gather_slices``: every rank runs the same work on it, so
its backward keeps the rank's slice), and q, k, v, the chunkwise cell and
the decode step run whole on every model rank, over all ``H`` heads.  The
gates' partial ``[B, T, 2H]`` from ``w_if``'s rows is summed by *g*
(``reduce_from_model``: every rank then runs the same cell, so the
identity backward is right), and ``b_if`` is used whole.  The cell's output
goes back to the rank's columns by ``slice_model`` (:func:`_rank_columns`),
whose backward gathers: a plain slice would leave each rank only its own
columns' share of the gradient of the whole ``wq``, ``wk`` and ``wv``.  The
group norm, ``og``, ``w_down`` and *g* follow as above, and the state holds
all ``H`` heads on every rank.  Where the inner width does not divide
either, every weight of the block is whole and it runs whole, with no *f*
and no *g*.  The sLSTM cell stays
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
from ..sharding.shard import (all_reduce_model, copy_to_model, gather_slices, model_split,
                              reduce_from_model, reduce_scatter_model, slice_model)
from .layers import mlp, rmsnorm, rmsnorm_spec
from .specs import ParamSpec

M_INIT = -1e30  # the stabiliser's initial value, and log i on padded steps


def _counted(x: torch.Tensor, dim: int) -> bool:
    """Whether a loop over ``x``'s ``dim`` (the sLSTM's time steps, the
    mLSTM's chunks) runs as one step counted once per step
    (:class:`_CountedLoop`): on the meta device (the dry run), where only
    shapes exist, over more than one step.  Elsewhere the loop runs every
    step."""
    return x.device.type == "meta" and x.shape[dim] > 1


def _counted_loop(step, dim: int, xs, consts, state, y_state: Optional[int] = None):
    """``for t: y_t, state = step([x.select(dim, t) for x in xs], consts,
    state)`` on ``meta`` as :class:`_CountedLoop` → (the ys stacked on dim
    1, the last state's tensors)."""
    ys, *new = _CountedLoop.apply(step, dim, len(xs), len(consts), y_state,
                                  torch.is_grad_enabled(), *xs, *consts, *state)
    return ys, new


class _CountedLoop(torch.autograd.Function):
    """``for t: y_t, state = step([x.select(dim, t) for x in xs], consts,
    state)`` on ``meta`` (``state`` a sequence of tensors): one step, its
    FLOPs and bytes counted once per step (``kernels.work.repeated``),
    forward and backward, and the outputs stacked to their whole size.
    ``apply(step, dim, n_xs, n_consts, y_state, grad, *xs, *consts,
    *state)``; ``y_state``: the index of ``y_t`` in the state where the
    step's output is also its state (the sLSTM's h), else None; ``grad``:
    whether grad mode is on, and with it the loop's saved tensors count in
    the live bytes (:func:`_saved_by_steps`).  Returns (the stacked ys, *the
    last state).

    The backward counts the loop's three kinds of step: the first (from the
    given state, which takes no gradient unless it needs one), the last (no
    gradient of the final state unless it is used) and those between; then
    the sums that autograd makes between the steps: each step's gradient of
    every ``x`` (its slice's backward writes a zeroed tensor of the whole
    size) and of every ``const`` into the others', and, where ``y_t`` is
    state, its gradient from the next step into the stacked output's.  The
    counts equal the loop's (``tests/test_torch_dryrun.py``)."""

    @staticmethod
    def forward(ctx, step, dim, n_xs, n_consts, y_state, grad, *tensors):
        from ..kernels.work import repeated

        xs, consts = tensors[:n_xs], tensors[n_xs:n_xs + n_consts]
        state = tensors[n_xs + n_consts:]
        n = xs[0].shape[dim]
        ctx.step, ctx.dim, ctx.split, ctx.y_state = step, dim, (n_xs, n_consts), y_state
        ctx.set_materialize_grads(False)
        need = ctx.needs_input_grad[6:]
        held = (_saved_by_steps(step, dim, xs, consts, state, need, n) if grad and any(need)
                else None)
        ctx.n_in = len(tensors)
        ctx.save_for_backward(*tensors, *([] if held is None else [held]))
        # the ys of the steps before the last live beside it, as the loop's do
        with repeated(0):
            y = step([x.select(dim, 0) for x in xs], list(consts), state)[0]
        ys = [torch.empty_like(y) for _ in range(n - 1)]
        del y
        with repeated(n):
            y, new = step([x.select(dim, 0) for x in xs], list(consts), state)
        return (torch.stack(ys + [y], dim=1), *new)

    @staticmethod
    def backward(ctx, dys, *dstate):
        from ..kernels.work import repeated

        n_xs, n_consts = ctx.split
        tensors = ctx.saved_tensors[:ctx.n_in]
        k = n_xs + n_consts
        n = tensors[0].shape[ctx.dim]
        need = ctx.needs_input_grad[6:]
        carried = any(need[k:])
        final = any(d is not None for d in dstate)
        # (steps, whether the step's input state takes a gradient, whether
        # its output state gets one beside y's)
        legs = ([(n - 2, True, True), (1, carried, True), (1, True, final)] if n > 1
                else [(1, carried, final)])
        grads = None
        for steps, state_in, state_out in legs:
            with torch.enable_grad(), repeated(0):
                ins = [t.detach().requires_grad_(need[i] or (i >= k and state_in
                                                            and t.is_floating_point()))
                       for i, t in enumerate(tensors)]
                y, new = ctx.step([x.select(ctx.dim, 0) for x in ins[:n_xs]], ins[n_xs:k],
                                  ins[k:])
                outs = [y] + [t for i, t in enumerate(new) if state_out and i != ctx.y_state
                              and t.requires_grad]
                gouts = [dys.select(1, 0)] + [torch.zeros_like(t) for t in outs[1:]]
                wrt = [t for t in ins if t.requires_grad]
            with repeated(steps):
                got = iter(torch.autograd.grad(outs, wrt, gouts, allow_unused=True))
            if state_in == carried:
                grads = [next(got) if t.requires_grad else None for t in ins]
        with repeated(n - 1):
            for g in grads[:k]:
                if g is not None:
                    g + g
        if ctx.y_state is not None:
            with repeated(n - 1 + final):
                dys.select(1, 0) + dys.select(1, 0)
        return (None,) * 6 + tuple(g if need[i] else None for i, g in enumerate(grads))


def _saved_by_steps(step, dim, xs, consts, state, need, n: int) -> torch.Tensor:
    """What autograd would hold for the backward of ``n`` steps of
    :class:`_CountedLoop`'s loop, as one ``uint8`` tensor of ``n`` times the
    bytes that one step saves (the storages of its saved tensors, but those
    of the whole ``xs`` and ``consts``, which live through the loop anyway),
    saved with the loop's inputs so that the dry run's live bytes count it
    (under remat only in the recompute, as the real steps' are) until the
    loop's backward ends (the real loop frees them step by step there).  The
    step runs once here, uncounted."""
    from ..kernels.work import repeated

    stores, skip = {}, {t.untyped_storage()._cdata for t in (*xs, *consts)}

    def pack(t):
        storage = t.untyped_storage()
        if storage._cdata not in skip:
            stores[storage._cdata] = storage.nbytes()
        return t

    k = len(xs) + len(consts)
    # a step between the first and the last: its state takes a gradient
    ins = [t.detach().requires_grad_((need[i] or i >= k) and t.is_floating_point())
           for i, t in enumerate((*xs, *consts, *state))]
    with torch.enable_grad(), repeated(0), torch.autograd.graph.saved_tensors_hooks(
            pack, lambda t: t):
        step([x.select(dim, 0) for x in ins[:len(xs)]], ins[len(xs):k], ins[k:])
    return torch.empty(n * sum(stores.values()), dtype=torch.uint8, device=xs[0].device)


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
    c: torch.Tensor   # [B, H, dqk, dh] fp32 (a rank's H/M heads, or all H)
    n: torch.Tensor   # [B, H, dqk] fp32
    m: torch.Tensor   # [B, H] fp32


def mlstm_state_spec(cfg: ModelConfig, batch: int, device: torch.device,
                     model_size: int = 1) -> MLSTMState:
    """A fresh state of a rank's ``H / model_size`` heads (all ``H`` where
    they do not divide): C and n zero, m at -1e30."""
    H = cfg.num_heads // (model_size if cfg.num_heads % model_size == 0 else 1)
    _, dh, dqk = _mlstm_dims(cfg)
    return MLSTMState(
        c=torch.zeros((batch, H, dqk, dh), dtype=torch.float32, device=device),
        n=torch.zeros((batch, H, dqk), dtype=torch.float32, device=device),
        m=torch.full((batch, H), M_INIT, dtype=torch.float32, device=device),
    )


def _mlstm_tp(p, cfg: ModelConfig, tp):
    """(``tp`` where the block's inner width splits over ``model``, else
    None; whether the rank's columns cut across heads, whose weights are then
    whole)."""
    tp = model_split(tp, _mlstm_dims(cfg)[0])
    return tp, tp is not None and p["wq"].shape[0] == cfg.num_heads


def _mlstm_qkv_gates(p, x2: torch.Tensor, cfg: ModelConfig, tp=None, gathered: bool = False):
    """x2: [B, T, inner] → q, k, v [B, T, H, *] in x2's dtype, log_i and
    log_f [B, T, H] fp32, H the heads that the weights hold (``tp``: the
    rank's, ``x2`` its columns; ``gathered``: all heads, from ``x2``
    gathered whole)."""
    H = p["wq"].shape[0]
    z = gather_slices(x2, tp, -1) if gathered else x2
    B, T, inner = z.shape
    z = z.reshape(B, T, H, inner // H)
    q = torch.einsum("bthd,hde->bthe", z, p["wq"])
    k = torch.einsum("bthd,hde->bthe", z, p["wk"]) / math.sqrt(p["wq"].shape[-1])
    v = torch.einsum("bthd,hde->bthe", z, p["wv"])
    if gathered:
        gif = reduce_from_model(x2.float() @ p["w_if"], tp) + p["b_if"]
    else:
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

    if _counted(qc, 0):
        h, state = _counted_loop(_mlstm_chunk, 0, [qc, kc, vc, li, lf], [keep], state)
    else:
        hs = []
        for c in range(nC):
            h, state = _mlstm_chunk((qc[c], kc[c], vc[c], li[c], lf[c]), (keep,), state)
            hs.append(h)
        h = torch.stack(hs, dim=1)                         # [B, nC, H, K, dh]
    h = h.transpose(2, 3).reshape(B, nC * K, H, dh)[:, :T]
    return h, MLSTMState(*state)


def _mlstm_chunk(xs, consts, state):
    """One chunk of :func:`mlstm_chunkwise`: its q, k, v ``[B, H, K, d]``,
    log i and log f ``[B, H, K]`` (``xs``), the causal mask (``consts``) and
    the state before it → (h ``[B, H, K, dh]`` fp32, the state after it)."""
    qb, kb, vb, lib, lfb = xs
    keep, = consts
    C, n, m = state
    G = torch.cumsum(lfb, dim=-1)                          # within-chunk cumulative log f
    # A[t, s] = G_t - G_s + log i_s for s <= t
    A = (G[..., :, None] - G[..., None, :] + lib[..., None, :]).masked_fill(
        ~keep, -math.inf)
    m_intra = A.amax(dim=-1)                               # [B, H, K]
    m_t = torch.maximum(G + m[..., None], m_intra)
    S = torch.exp(A - m_t[..., None])                      # [B, H, K, K]
    qk = qb.float() @ kb.float().transpose(-1, -2)         # bf16 products, fp32 sums
    W = S * qk
    num_intra = W.to(vb.dtype) @ vb
    den_intra = W.sum(dim=-1)
    scale = torch.exp(G + m[..., None] - m_t)              # [B, H, K]
    num_inter = (qb @ C.to(qb.dtype)).float() * scale[..., None]
    den_inter = (qb @ n.to(qb.dtype)[..., None])[..., 0].float() * scale
    num = num_intra.float() + num_inter
    den = den_intra + den_inter
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    # the state at the chunk's end
    g_last = G[..., -1]                                    # [B, H]
    w_end = G[..., -1:] - G + lib                          # [B, H, K]
    m_new = torch.maximum(g_last + m, w_end.amax(dim=-1))
    decay = torch.exp(g_last + m - m_new)
    wi = torch.exp(w_end - m_new[..., None])
    kw = kb.float() * wi[..., None]                        # [B, H, K, dqk]
    C = decay[..., None, None] * C + kw.transpose(-1, -2) @ vb.float()
    n = decay[..., None] * n + kw.sum(dim=-2)
    return h, MLSTMState(c=C, n=n, m=m_new)


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


def _rank_columns(h: torch.Tensor, tp) -> torch.Tensor:
    """The rank's ``inner/M`` columns of the whole cell output ``h``
    ``[B, T, inner]``; the gradient gathered over ``model``
    (``slice_model``), so that every rank's whole-head work gets the whole
    gradient."""
    return slice_model(h, tp, -1)


def _mlstm_out(p, h: torch.Tensor, og: torch.Tensor, dtype, tp=None,
               gathered: bool = False) -> torch.Tensor:
    """The gated, group-normed cell output through the down projection, and
    under ``tp`` *g* (``gathered``: the whole cell output first cut to the
    rank's columns)."""
    h = h.reshape(*og.shape[:-1], -1).to(dtype)
    if gathered:
        h = _rank_columns(h, tp)
    return reduce_from_model((_group_norm(p["gnorm"], h, tp) * og) @ p["w_down"], tp)


def _mlstm_in(p, x: torch.Tensor, cfg: ModelConfig, tp, gathered: bool = False):
    """*f*, the up projection, the output gate, q, k, v and the gates."""
    x = copy_to_model(x, tp)
    x2 = x @ p["w_up"]
    og = torch.sigmoid(x @ p["w_og"])
    return og, *_mlstm_qkv_gates(p, x2, cfg, tp, gathered)


def mlstm_block(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MLSTMState] = None, tp=None
                ) -> Tuple[torch.Tensor, MLSTMState]:
    """Full mLSTM block.  x [B, T, D] → ([B, T, D], state); ``state=None``
    starts from a fresh state (training and prefill).  ``tp``: the model
    axis; the output is whole (summed by *g*)."""
    tp, gathered = _mlstm_tp(p, cfg, tp)
    og, q, k, v, li, lf = _mlstm_in(p, x, cfg, tp, gathered)
    if state is None:
        state = mlstm_state_spec(cfg, x.shape[0], x.device,
                                 cfg.num_heads // q.shape[2])
    h, new_state = mlstm_chunkwise(q, k, v, li, lf, state, cfg.xlstm.chunk)
    return _mlstm_out(p, h, og, x.dtype, tp, gathered), new_state


def mlstm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: MLSTMState, tp=None):
    """One-token step.  x [B, 1, D] → ([B, 1, D], new state)."""
    tp, gathered = _mlstm_tp(p, cfg, tp)
    og, q, k, v, li, lf = _mlstm_in(p, x, cfg, tp, gathered)
    h, new_state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], li[:, 0], lf[:, 0], state)
    return _mlstm_out(p, h, og, x.dtype, tp, gathered), new_state


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


def _slstm_step(xs, consts, state, cfg: ModelConfig):
    """One step of the loop over time: (h_t, the new state)."""
    state = _slstm_cell(None, xs[0], SLSTMState(*state), cfg, consts[0])
    return state.h, state


def _slstm_scan_local(p_r, wx: torch.Tensor, state: SLSTMState, cfg: ModelConfig):
    """The sequential cell over time.  wx [B, T, 4D] → (h [B, T, D] fp32,
    the state after the last step)."""
    wx = wx.float()  # once for every step: the cell's cast is then a no-op
    r2 = _recurrent_weight(p_r)
    if _counted(wx, 1):
        step = lambda xs, consts, st: _slstm_step(xs, consts, st, cfg)
        hs, state = _counted_loop(step, 1, [wx], [r2], state, y_state=3)
        return hs, SLSTMState(*state)
    hs = []
    for t in range(wx.shape[1]):
        state = _slstm_cell(None, wx[:, t], state, cfg, r2)
        hs.append(state.h)
    return torch.stack(hs, dim=1), state


def _slstm_ffn(p, h: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """The group norm, then the position-wise gated FFN (``layers.mlp``'s
    swiglu and its three layouts under ``tp``); the output whole."""
    return mlp({"wi": p["ffn_wi"], "wo": p["ffn_wo"]}, rmsnorm(p["gnorm"], h), "swiglu", tp,
               int(cfg.xlstm.proj_factor_s * cfg.d_model))


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
