"""Model assembly: inputs → layer stack → logits, for decoders built from
``"attn"`` (GQA or MLA attention, with a dense or MoE FFN), ``"rec"``
(RG-LRU), ``"mlstm"`` and ``"slstm"`` (xLSTM) blocks, and for the non-causal
encoder (``cfg.causal`` False).

Port of ``repro/models/transformer.py`` for the dense (``("attn",)``), MoE
(``("attn",)`` after ``num_dense_layers`` dense ``lead`` layers), hybrid
(``("rec", "rec", "attn")``) and xLSTM (``("mlstm",) * 7 + ("slstm",)``)
patterns, and for the stub frontends: ``"audio"`` (the batch's ``embeds``
``[B, T, D]`` replace the token embedding, which the model then never reads)
and ``"vision"`` (``embeds`` ``[B, frontend_tokens, D]`` ahead of the
embedded ``tokens``; the loss covers the text positions only).  The
parameters mirror the JAX tree
(``embed.table``; ``lead.{j}.*`` for the unrolled leading layers;
``blocks.b{i}.*`` for the super-block pattern, stacked on a leading dim of
``n_scan``; ``tail.{j}.*`` for the unrolled trailing layers;
``final_norm.scale``; ``mtp.*`` for DeepSeek-V3's multi-token prediction
head), so ``convert.params_from_jax`` loads a JAX ``Model.init`` tree
one-to-one.  A Python loop over the stacked leading dim replaces
``lax.scan``.  Caches are stacked the same way and written in place.

Entry points: ``loss(batch)`` and ``forward(batch)`` (training: gradients
reach every parameter the inputs use, each stacked super-block under
``torch.utils.checkpoint`` unless ``cfg.remat == "none"``; the MoE layers'
load-balance loss is summed), and ``prefill(batch, max_len)`` and
``decode_step(caches, tokens)`` (serving, under ``torch.inference_mode``).
An encoder is served by ``forward`` then ``_logits``
(``launch.steps.build_encode_step``).

On a mesh (``launch.mesh.Mesh`` with ``data`` or ``model`` above 1, of any
number of pods) the model holds only this rank's block of each parameter
(``sharding/shard.py``, under ``sharding/rules.py``; every pod the same
blocks) and takes this rank's rows: FSDP gathers each parameter's ``data`` dim on use, inside each
super-block's remat'd function (the recompute gathers again, so no gathered
weight outlives its block); tensor parallelism runs the rank's query and KV
heads (where the KV heads do not split, a slice of their head dim; MLA's
up-projections), MLP columns, RG-LRU channels, mLSTM heads, experts and
vocab range, with Megatron's *f* after each norm (MLA: on its latents,
``models/attention.py``; MoE: ``models/moe.py``; the sLSTM: after its group
norm, ``models/xlstm.py``) and *g* after each row-parallel product.  The MoE
FFN's output is whole: the expert-parallel island's as it is, the partial
sums through *g*.  Experts split over ``(data, model)`` jointly are not
gathered on use: the island runs its own block of them, and the scatter path
sends their slots to them (``models/moe.py``).  A MoE layer's groups lie
over the row ranks of the step (:attr:`Model.rows`).  Prefill and decode
return the whole vocab's logits (gathered over ``model`` for the argmax).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import recurrent as rec
from . import xlstm as xl
from ..sharding.shard import (copy_to_model, gather_model, gather_on_use, model_parallel,
                              param_layout, reduce_from_model, shard, sharded)
from .layers import (chunked_xent, embed, embed_spec, mlp, mlp_spec, rmsnorm, rmsnorm_spec,
                     softmax_xent, unembed, unembed_spec)
from .specs import ParamSpec, init_params, stack_layer_specs

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class LayerPlan(NamedTuple):
    lead: Tuple[str, ...]       # unrolled leading layers (kinds)
    pattern: Tuple[str, ...]    # stacked super-block pattern
    n_scan: int                 # number of stacked super-blocks
    tail: Tuple[str, ...]       # unrolled trailing layers


def layer_plan(cfg: ModelConfig) -> LayerPlan:
    kinds: List[str] = [
        cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.num_layers)
    ]
    n_lead = cfg.moe.num_dense_layers if cfg.moe is not None else 0
    lead = tuple("attn_dense" for _ in range(n_lead))
    rest = kinds[n_lead:]
    p = len(cfg.block_pattern)
    n_scan = len(rest) // p
    tail = tuple(rest[n_scan * p:])
    return LayerPlan(lead=lead, pattern=tuple(cfg.block_pattern), n_scan=n_scan,
                     tail=tail)


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = []
    kinds = set(cfg.block_pattern)
    if not kinds <= {"attn", "rec", "mlstm", "slstm"}:
        unsupported.append(f"block_pattern={cfg.block_pattern}")
    if cfg.attention not in ("gqa", "mla") and (cfg.attention != "none" or "attn" in kinds):
        unsupported.append(f"attention={cfg.attention!r}")
    if cfg.moe is not None and cfg.moe.expert_sharding not in moe_mod.LAYOUTS:
        unsupported.append(f"MoE expert_sharding={cfg.moe.expert_sharding!r}")
    if cfg.frontend not in ("none", "audio", "vision"):
        unsupported.append(f"frontend={cfg.frontend!r}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoders and encoders of GQA or MLA "
            "attention, dense or MoE FFNs, RG-LRU and xLSTM blocks, with the "
            "audio or vision stub frontend; not yet: " + ", ".join(unsupported))


def _check_mesh(cfg: ModelConfig, mesh) -> None:
    """What a sharded mesh refuses, never replicating a layer silently:
    experts that do not divide over the ranks that split them (``model``, or
    ``(data, model)`` for the 2-D layouts), an FFN dim of ``fsdp_f`` that
    does not divide over ``data``; at model above 1, query heads, a d_ff, an
    RG-LRU width or an mLSTM inner width that do not divide by the model
    axis, and KV heads whose count and whose ``K·hd`` columns both do not.
    MoE runs on any other mesh (``models/moe.py``)."""
    if not sharded(mesh):
        return
    M, m = mesh.size("model"), cfg.moe
    if m is not None:
        ep = M * (mesh.size("data") if moe_mod.two_d(m) else 1)
        if m.num_experts % ep:
            raise NotImplementedError(
                f"{cfg.name}: {m.num_experts} experts do not divide over {ep} ranks: the "
                f"{m.expert_sharding} layout needs a whole block of experts a rank")
        if m.expert_sharding == "fsdp_f" and m.d_expert % mesh.size("data"):
            raise NotImplementedError(
                f"{cfg.name}: fsdp_f's FFN dim {m.d_expert} does not divide over data "
                f"{mesh.size('data')}")
    if M == 1:
        return
    kinds = set(cfg.block_pattern)
    widths = {"query heads": cfg.num_heads, "d_ff": cfg.d_ff}
    if "rec" in kinds:
        widths["RG-LRU width"] = cfg.rglru.width or cfg.d_model
    if "mlstm" in kinds:
        widths["mLSTM inner width"] = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    bad = [f"{name} {n}" for name, n in widths.items() if n % M]
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if "attn" in kinds and cfg.attention == "gqa" and K % M and K * hd % M:
        bad.append(f"KV heads {K} and their {K * hd} columns")
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} do not all divide by model {M}")


def _block_spec(cfg: ModelConfig, kind: str, dtype) -> Dict:
    """``kind``: ``"attn"`` (its FFN MoE when ``cfg.moe``), ``"attn_dense"``
    (a lead layer of a MoE model: a dense FFN of ``dense_d_ff``), ``"rec"``,
    or ``"mlstm"`` and ``"slstm"`` (a norm and the cell, no FFN of its own)."""
    if kind == "mlstm":
        return {"ln": rmsnorm_spec(cfg.d_model, dtype), "cell": xl.mlstm_block_spec(cfg, dtype)}
    if kind == "slstm":
        return {"ln": rmsnorm_spec(cfg.d_model, dtype), "cell": xl.slstm_block_spec(cfg, dtype)}
    if kind == "rec":
        mixer = rec.rglru_block_spec(cfg, dtype)
    elif cfg.attention == "mla":
        mixer = attn.mla_spec(cfg, dtype)
    else:
        mixer = attn.gqa_spec(cfg, dtype)
    if cfg.moe is not None and kind == "attn":
        ffn = moe_mod.moe_spec(cfg, dtype)
    elif cfg.moe is not None:
        ffn = mlp_spec(cfg.d_model, cfg.moe.dense_d_ff or cfg.d_ff, cfg.act, dtype)
    else:
        ffn = mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return {
        "ln1": rmsnorm_spec(cfg.d_model, dtype),
        "rec" if kind == "rec" else "attn": mixer,
        "ln2": rmsnorm_spec(cfg.d_model, dtype),
        "ffn": ffn,
    }


_XLSTM = {"mlstm": (xl.mlstm_block, xl.mlstm_decode),
          "slstm": (xl.slstm_block, xl.slstm_decode)}


def _block_apply(cfg: ModelConfig, kind: str, p, x, mode: str, cache, tp=None,
                 mesh=None, rows=None):
    """One pre-norm block. mode: train | prefill | decode.  ``cache`` (a
    ``KVCache``, ``MLACache``, ``RGLRUState``, ``MLSTMState`` or
    ``SLSTMState`` of buffers; ``None`` in train mode) is written in place.
    ``tp`` (the model axis of ``mesh``, a sharded mesh): *f* after each norm
    (MLA, MoE and the xLSTM blocks place theirs inside), *g* after the
    attention's, the RG-LRU's and a dense FFN's output products; the MoE FFN
    and the xLSTM blocks return their output whole.  ``rows``: the ranks
    whose rows make up the microbatch, over which a MoE FFN's groups lie.
    Returns (x, cache, aux): aux is the MoE load-balance loss, ``None`` for a
    dense FFN or an xLSTM block."""
    if kind in _XLSTM:
        block, decode = _XLSTM[kind]
        h = rmsnorm(p["ln"], x)
        if mode == "train":
            return x + block(p["cell"], h, cfg, None, tp)[0], None, None
        # Prefill starts from a fresh state, whatever the cache holds.
        y, new = block(p["cell"], h, cfg, None, tp) if mode == "prefill" else decode(
            p["cell"], h, cfg, cache, tp)
        for buf, t in zip(cache, new):
            buf.copy_(t)
        return x + y, cache, None
    mla = kind != "rec" and cfg.attention == "mla"
    h = rmsnorm(p["ln1"], x)
    if not mla:
        h = copy_to_model(h, tp)
    if kind == "rec":
        if mode == "train":
            y = rec.rglru_block(p["rec"], h, cfg, tp)
        else:
            if mode == "prefill":
                y, new = rec.rglru_block_with_state(p["rec"], h, cfg, None, tp)
            else:
                y, new = rec.rglru_decode(p["rec"], h, cfg, cache, tp)
            cache.h.copy_(new.h)
            cache.conv.copy_(new.conv)
    elif mla:
        if mode == "train":
            y = attn.mla_attention(p["attn"], h, cfg, tp)
        else:
            step = attn.mla_prefill if mode == "prefill" else attn.mla_decode
            y, cache = step(p["attn"], h, cfg, cache, tp)
    else:
        if mode == "train":
            y = attn.gqa_attention(p["attn"], h, cfg, tp)
        else:
            step = attn.gqa_prefill if mode == "prefill" else attn.gqa_decode
            y, cache = step(p["attn"], h, cfg, cache, tp)
    x = x + reduce_from_model(y, tp)
    h = rmsnorm(p["ln2"], x)
    if cfg.moe is not None and kind == "attn":
        y, aux = moe_mod.moe_ffn(p["ffn"], h, cfg, mesh, rows)
        return x + y, cache, aux
    y = mlp(p["ffn"], copy_to_model(h, tp), cfg.act)
    return x + reduce_from_model(y, tp), cache, None


def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                 device: torch.device, model_size: int = 1):
    if kind == "mlstm":
        return xl.mlstm_state_spec(cfg, batch, device, model_size)
    if kind == "slstm":
        return xl.slstm_state_spec(cfg, batch, device)
    if kind == "rec":
        return rec.rglru_state_spec(cfg, batch, device, model_size)
    if cfg.attention == "mla":
        return attn.mla_cache_spec(cfg, batch, max_len, dtype, device)
    return attn.gqa_cache_spec(cfg, batch, max_len, dtype, device, model_size)


def _stacked(cache, n: int):
    """``n`` copies of a fresh cache (the xLSTM states' m at -1e30 too),
    stacked on a new leading dim."""
    return cache._replace(**{f: t.expand(n, *t.shape).clone()
                             for f, t in cache._asdict().items()
                             if isinstance(t, torch.Tensor)})


def _layer(cache, i: int):
    """Views of layer ``i`` of a stacked cache."""
    return cache._replace(**{f: t[i] for f, t in cache._asdict().items()
                             if isinstance(t, torch.Tensor)})


def cache_tree(cfg: ModelConfig, batch: int, max_len: int, device, model_size: int = 1
               ) -> Dict[str, Any]:
    """Fresh caches shaped like the JAX tree (:meth:`Model.cache`) for
    ``batch`` rows, a rank's share of ``model_size``: its KV heads (or its
    slice of their head dim), RG-LRU channels and mLSTM heads; on the
    ``meta`` device, their shapes alone (``sharding.rules.cache_pspecs``)."""
    plan, dtype, device = layer_plan(cfg), _DTYPES[cfg.dtype], torch.device(device)
    mk = lambda kind: _block_cache(cfg, kind, batch, max_len, dtype, device, model_size)
    blocks = {f"b{i}": _stacked(mk(k), plan.n_scan) for i, k in enumerate(plan.pattern)}
    return {"lead": [mk(k) for k in plan.lead], "blocks": blocks,
            "tail": [mk(k) for k in plan.tail]}


def model_specs(cfg: ModelConfig) -> Dict:
    """The parameter spec tree, without allocating anything."""
    _check_supported(cfg)
    dt = _DTYPES[cfg.dtype]
    plan = layer_plan(cfg)
    sb = {f"b{i}": _block_spec(cfg, k, dt) for i, k in enumerate(plan.pattern)}
    out: Dict[str, Any] = {
        "embed": embed_spec(cfg.vocab_size, cfg.d_model, dt),
        "lead": [_block_spec(cfg, k, dt) for k in plan.lead],
        "blocks": stack_layer_specs(sb, plan.n_scan),
        "tail": [_block_spec(cfg, k, dt) for k in plan.tail],
        "final_norm": rmsnorm_spec(cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = unembed_spec(cfg.vocab_size, cfg.d_model, dt)
    if cfg.mtp_depth:
        out["mtp"] = {
            "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), ("embed", None), dtype=dt),
            "block": _block_spec(cfg, _mtp_kind(cfg), dt),
            "norm": rmsnorm_spec(cfg.d_model, dt),
        }
    return out


def _mtp_kind(cfg: ModelConfig) -> str:
    """The MTP head's block: dense, also in a MoE model."""
    return "attn_dense" if cfg.moe else "attn"


class ParamTree(nn.Module):
    """Nested parameters under the JAX tree's keys; ``tree["key"]`` reads one.
    A list becomes a tree keyed ``"0"``, ``"1"``, ... as ``params_from_jax``
    flattens it."""

    def __init__(self, tree):
        super().__init__()
        if isinstance(tree, list):
            tree = {str(i): v for i, v in enumerate(tree)}
        for key, val in tree.items():
            if isinstance(val, (dict, list)):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def layer(self, i: int) -> Dict[str, Any]:
        """The tree of every parameter's slice ``[i]`` along the stacked dim."""
        return self.tree(i=i)

    def tree(self, use=None, prefix: str = "", i: Optional[int] = None) -> Dict[str, Any]:
        """The nested dict of the parameters (with ``i``, each one's slice
        ``[i]`` along the stacked dim), each passed through ``use(key, t)``
        when given, ``key`` its ``state_dict`` key under ``prefix``."""
        out = {name: mod.tree(use, f"{prefix}.{name}", i) for name, mod in self.named_children()}
        for name, t in self.named_parameters(recurse=False):
            t = t if i is None else t[i]
            out[name] = t if use is None else use(f"{prefix}.{name}", t)
        return out


class Model(nn.Module):
    """Decoder (dense, MoE, hybrid or xLSTM) or encoder on one device or on a
    rank of ``mesh``: ``loss`` for training, ``prefill`` then ``decode_step``
    for serving a decoder.

    Parameters are drawn on ``device`` from ``generator`` (a ``torch.Generator``
    on that device; seed 0 when omitted), with the JAX package's initializers.
    On a sharded mesh every rank draws each tensor whole, one at a time in
    the one-device order, and keeps its block of it before the next draw, so
    every layout starts from the one-device weights and a rank's init peaks
    at its blocks plus one whole fp32 draw (and, where the block is not
    contiguous in the whole, its fp32 copy).  On the ``meta`` device
    (``device="meta"``, or a mesh on it: ``launch.mesh.meta_mesh``) every
    parameter has its shape and dtype and nothing is drawn or allocated.
    ``layout`` maps each ``state_dict`` key to its ``sharding.shard.Placement``.
    """

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        self.dtype = _DTYPES[cfg.dtype]
        self.device = resolve_device(device) if mesh is None else mesh.device
        _check_mesh(cfg, mesh)
        specs = model_specs(cfg)
        self.mesh = mesh if sharded(mesh) else None
        # A step's rows by default: the (pod, data) ranks of the mesh given,
        # sharded or not (a MoE layer's groups lie over them).
        self.rows = moe_mod.Rows(mesh) if mesh is not None else None
        self.layout = param_layout(specs, cfg.act, self.mesh)
        self.tp = model_parallel(self.mesh)
        vocab_dim = (self.layout["embed.table"].axes(0) if cfg.tie_embeddings
                     else self.layout["unembed.w"].axes(1))
        self.vocab_tp = self.tp if "model" in vocab_dim else None
        if generator is None and self.device.type != "meta":
            generator = torch.Generator(self.device).manual_seed(0)
        take = ((lambda key, t, dtype: shard(t, self.layout[key], self.mesh, dtype))
                if self.mesh is not None else None)
        params = init_params(specs, generator, self.device, take)
        self.embed = ParamTree(params["embed"])
        self.lead = ParamTree(params["lead"])
        self.blocks = ParamTree(params["blocks"])
        self.tail = ParamTree(params["tail"])
        self.final_norm = ParamTree(params["final_norm"])
        if "unembed" in params:
            self.unembed = ParamTree(params["unembed"])
        if "mtp" in params:
            self.mtp = ParamTree(params["mtp"])

    def _use(self, key: str, t: torch.Tensor, stacked: bool = False) -> torch.Tensor:
        """Parameter ``key`` (or one layer's slice of it) whole over
        ``data``: the FSDP all-gather on use; a dim split over ``data`` and
        ``model`` jointly (the 2-D experts) as it is: the MoE FFN sends the
        tokens to them."""
        if self.mesh is None:
            return t
        pl = self.layout[key]
        d = pl.dim_of("data")
        if d is not None and len(pl.axes(d)) > 1:
            return t
        return gather_on_use(t, pl, self.mesh, stacked)

    def _params(self, name: str, i: Optional[int] = None) -> Dict[str, Any]:
        """The subtree ``name`` (``"lead.0"``, ``"blocks"``, ...; with ``i``
        the stacked blocks' layer ``i``), each tensor whole over ``data``."""
        tree = self
        for part in name.split("."):
            tree = tree[part] if isinstance(tree, ParamTree) else getattr(tree, part)
        return tree.tree(lambda k, t: self._use(k, t, i is not None), name, i)

    def _head(self) -> Dict[str, Any]:
        """The parameters around the stack, each gathered once for a forward:
        ``embed`` (not for the audio stub unless tied: its table is never
        read), ``final_norm`` and ``unembed``."""
        out = {"final_norm": self._params("final_norm")}
        if self.cfg.frontend != "audio" or self.cfg.tie_embeddings:
            out["embed"] = self._params("embed")
        if not self.cfg.tie_embeddings:
            out["unembed"] = self._params("unembed")
        return out

    def _logits(self, h: torch.Tensor, head: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Logits of ``h``: the rank's vocab range where the vocab is sharded
        over ``model`` (apply *f* to ``h`` first when training)."""
        head = head or self._head()
        if self.cfg.tie_embeddings:
            return h @ head["embed"]["table"].T
        return unembed(head["unembed"], h)

    def _whole_logits(self, h: torch.Tensor, head: Dict[str, Any]) -> torch.Tensor:
        """Logits of ``h`` over the whole vocab (no gradient)."""
        return gather_model(self._logits(h, head), self.vocab_tp)

    def cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """Fresh caches shaped like the JAX tree: ``blocks.b{i}`` stacks
        ``n_scan`` layers (``KVCache`` k/v ``[n, B, S, K, hd]``, ``MLACache``
        c_kv ``[n, B, S, kv_lora]`` and k_rope ``[n, B, S, dr]``,
        ``RGLRUState`` h ``[n, B, W]`` and conv ``[n, B, 3, W]``,
        ``MLSTMState`` c ``[n, B, H, dqk, dh]``, n ``[n, B, H, dqk]`` and m
        ``[n, B, H]``, ``SLSTMState`` c, n, m and h ``[n, B, D]``; every m
        at -1e30, everything else zero); ``lead`` and ``tail`` hold one per
        layer.  ``batch``: this rank's rows; on a model axis, the rank's
        ``K / M`` KV heads (where they do not split, ``[.., K, hd / M]``),
        ``W / M`` RG-LRU channels and ``H / M`` mLSTM heads (the sLSTM's
        state whole)."""
        M = self.tp.size("model") if self.tp is not None else 1
        return cache_tree(self.cfg, batch, max_len, self.device, M)

    def _stack(self, x: torch.Tensor, mode: str, caches: Dict[str, Any]):
        """The lead layers, the stacked super-blocks, then the tail, over
        :attr:`rows`.  Caches are written in place; the returned tree carries
        the new lengths."""
        plan, rows = self.plan, self.rows
        lead = []
        for j, kind in enumerate(plan.lead):
            x, c, _ = _block_apply(self.cfg, kind, self._params(f"lead.{j}"), x, mode,
                                   caches["lead"][j], self.tp, self.mesh, rows)
            lead.append(c)
        blocks = caches["blocks"]
        lengths = {}  # every layer of one stack starts from the same length
        for i in range(plan.n_scan):
            p_sb = self._params("blocks", i)
            for j, kind in enumerate(plan.pattern):
                key = f"b{j}"
                x, c, _ = _block_apply(self.cfg, kind, p_sb[key], x, mode,
                                       _layer(blocks[key], i), self.tp, self.mesh, rows)
                if kind == "attn":
                    lengths[key] = c.length
        blocks = {k: c._replace(length=lengths[k]) if k in lengths else c
                  for k, c in blocks.items()}
        tail = []
        for j, kind in enumerate(plan.tail):
            x, c, _ = _block_apply(self.cfg, kind, self._params(f"tail.{j}"), x, mode,
                                   caches["tail"][j], self.tp, self.mesh, rows)
            tail.append(c)
        return x, {"lead": lead, "blocks": blocks, "tail": tail}

    def _train_stack(self, x: torch.Tensor, rows: Optional[moe_mod.Rows] = None):
        """The unrolled lead layers, the stacked super-blocks, each under
        remat unless ``cfg.remat`` is ``"none"`` (the reference's
        per-super-block ``jax.checkpoint``), then the unrolled tail, over
        ``rows`` (default :attr:`rows`).  Each super-block gathers its FSDP
        shards inside the remat'd function.  Returns (x, the sum of the MoE
        layers' aux losses)."""
        plan, rows = self.plan, rows or self.rows
        total = torch.zeros((), dtype=torch.float32, device=x.device)

        def run(kind, p, x, total):
            x, _, aux = _block_apply(self.cfg, kind, p, x, "train", None, self.tp, self.mesh,
                                     rows)
            return x, total if aux is None else total + aux

        def superblock(i: int, x: torch.Tensor, total: torch.Tensor):
            p_sb = self._params("blocks", i)
            for j, kind in enumerate(plan.pattern):
                x, total = run(kind, p_sb[f"b{j}"], x, total)
            return x, total

        for j, kind in enumerate(plan.lead):
            x, total = run(kind, self._params(f"lead.{j}"), x, total)
        for i in range(plan.n_scan):
            if self.cfg.remat != "none":
                x, total = checkpoint(superblock, i, x, total, use_reentrant=False)
            else:
                x, total = superblock(i, x, total)
        for j, kind in enumerate(plan.tail):
            x, total = run(kind, self._params(f"tail.{j}"), x, total)
        return x, total

    def _embed_inputs(self, batch: Dict[str, torch.Tensor], head: Dict[str, Any]
                      ) -> torch.Tensor:
        """The stack's input [B, T, D]: the audio stub's ``embeds`` in the
        model dtype; else the embedded ``tokens``, the vision stub's
        ``embeds`` (in the embedding's dtype) ahead of them."""
        if self.cfg.frontend == "audio":
            return batch["embeds"].to(self.dtype)
        x = embed(head["embed"], batch["tokens"], self.vocab_tp)
        if self.cfg.frontend == "vision":
            x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
        return x

    def forward(self, batch: Dict[str, torch.Tensor], head: Optional[Dict[str, Any]] = None,
                rows: Optional[moe_mod.Rows] = None):
        """Training-mode forward to final hidden states [B, T, D], and the
        sum of the MoE layers' load-balance losses (0 without MoE).
        ``rows``: the ranks whose rows make up the microbatch (default
        :attr:`rows`; ``launch.steps.step_rows``)."""
        head = head or self._head()
        x, aux = self._train_stack(self._embed_inputs(batch, head), rows)
        return rmsnorm(head["final_norm"], x), aux

    def _xent(self, h: torch.Tensor, labels: torch.Tensor, mask, head: Dict[str, Any]
              ) -> torch.Tensor:
        """Cross-entropy of the logits of ``h``; from T 2048 in chunks
        (:func:`chunked_xent`).  A vocab sharded over ``model``: *f* on
        ``h``, then the vocab-parallel cross-entropy."""
        tp = self.vocab_tp
        h = copy_to_model(h, tp)
        logits = lambda hc: self._logits(hc, head)
        if labels.shape[1] >= 2048:
            return chunked_xent(h, logits, labels, mask, tp=tp)
        return softmax_xent(logits(h), labels, mask, tp)

    def loss(self, batch: Dict[str, torch.Tensor], rows: Optional[moe_mod.Rows] = None):
        """Mean next-token cross-entropy over ``labels`` (and ``mask``), plus
        ``aux_loss_weight`` times the MoE load-balance loss and 0.3 times
        DeepSeek-V3's multi-token-prediction loss where the config has them;
        returns (total, metrics with ``ce``, ``aux`` and ``mtp_ce`` where
        they apply, and ``loss``).  ``rows`` as in :meth:`forward`."""
        cfg = self.cfg
        head = self._head()
        h, aux = self.forward(batch, head, rows)
        if cfg.frontend == "vision":
            h = h[:, cfg.frontend_tokens:]  # the loss covers the text positions only
        ce = self._xent(h, batch["labels"], batch.get("mask"), head)
        total, metrics = ce, {"ce": ce}
        if cfg.moe is not None:
            total = total + cfg.moe.aux_loss_weight * aux
            metrics["aux"] = aux
        if cfg.mtp_depth:
            mtp_ce = self._mtp_loss(h, batch, head)
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, h: torch.Tensor, batch: Dict[str, torch.Tensor],
                  head: Dict[str, Any]) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: one extra block predicts t+2."""
        labels = batch["labels"]
        mtp = self._params("mtp")
        emb_next = embed(head["embed"], labels, self.vocab_tp)   # embedding of token t+1
        z = torch.cat([h.to(emb_next.dtype), emb_next], dim=-1) @ mtp["proj"]
        z, _, _ = _block_apply(self.cfg, _mtp_kind(self.cfg), mtp["block"], z, "train",
                               None, self.tp, self.mesh)
        z = rmsnorm(mtp["norm"], z)
        labels2 = torch.roll(labels, -1, dims=1)
        mask = torch.ones(labels2.shape, dtype=torch.float32, device=labels.device)
        mask[:, -1] = 0.0
        return self._xent(z, labels2, mask, head)

    @torch.inference_mode()
    def prefill(self, batch: Dict[str, torch.Tensor], max_len: int):
        """Process the prompt (this rank's rows); returns (last-token logits
        [B, 1, V], caches)."""
        head = self._head()
        x = self._embed_inputs(batch, head)
        caches = self.cache(x.shape[0], max_len)
        x, caches = self._stack(x, "prefill", caches)
        h = rmsnorm(head["final_norm"], x[:, -1:])
        return self._whole_logits(h, head), caches

    @torch.inference_mode()
    def decode_step(self, caches: Dict[str, Any], tokens: torch.Tensor):
        """One token for every sequence. tokens: [B, 1] → logits [B, 1, V]."""
        head = self._head()
        x = embed(head["embed"], tokens, self.vocab_tp)
        x, caches = self._stack(x, "decode", caches)
        return self._whole_logits(rmsnorm(head["final_norm"], x), head), caches

