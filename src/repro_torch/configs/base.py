"""Config dataclasses: model architecture, shapes, mesh, run options."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    num_shared: int = 0           # shared ("always-on") experts
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-3
    router: str = "softmax"       # softmax (v2) | sigmoid (v3)
    num_dense_layers: int = 1     # leading dense-FFN layers before MoE starts
    dense_d_ff: int = 0           # FFN dim of the leading dense layers
    # Dispatch groups: capacity and sorting are per-group (per data-shard at
    # scale), matching EP-system semantics and bounding the capacity buffer.
    # The launcher overrides this to the mesh's data-axis size.
    groups: int = 1
    # Expert weight sharding (§Perf iteration target):
    #   fsdp_d — experts on `model`, d_model dim FSDP on `data` (baseline:
    #            contraction dim sharded ⇒ weights all-gather every layer)
    #   fsdp_f — experts on `model`, FFN dim FSDP on `data` (contraction dim
    #            whole ⇒ no weight movement; grads reduce-scatter naturally)
    #   ep2d   — experts on `data`×`model` jointly (pure EP at E ≥ chips:
    #            weights never move; tokens all-to-all to expert owners)
    expert_sharding: str = "fsdp_d"


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536      # 0 → no query compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class RGLRUConfig:
    width: int = 0               # 0 → d_model
    conv_width: int = 4
    c: float = 8.0               # a_t = a^(c·r_t)


@dataclass(frozen=True)
class XLSTMConfig:
    proj_factor_m: float = 2.0   # mLSTM up-projection
    proj_factor_s: float = 4 / 3  # sLSTM FFN
    chunk: int = 64              # chunk size for the parallel mLSTM form


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | vlm | audio | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 → d_model // num_heads
    attention: str = "gqa"       # gqa | mla | none
    # Per-layer block pattern, cycled: e.g. ("rec","rec","attn") for 1:2
    # hybrids, ("mlstm",)*7 + ("slstm",) for xLSTM, ("attn",) for transformers.
    block_pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    rope_theta: float = 500000.0
    act: str = "swiglu"          # swiglu | gelu
    causal: bool = True          # False → encoder-only (no decode path)
    tie_embeddings: bool = False
    window: int = 0              # sliding-window size for "attn" when >0...
    mtp_depth: int = 0           # DeepSeek-V3 multi-token prediction heads
    frontend: str = "none"       # none | audio | vision (STUB embeddings)
    frontend_tokens: int = 256   # prepended embedding tokens for vlm
    dtype: str = "bfloat16"
    remat: str = "block"         # none | block | full
    # attention chunking (XLA online-softmax path; Pallas kernel on TPU)
    q_block: int = 512
    k_block: int = 1024
    use_pallas: bool = False     # TPU deployment flag (CPU container: False)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def scan_unit(self) -> Tuple[int, int]:
        """(#scanned super-blocks, #unrolled leftover layers)."""
        p = len(self.block_pattern)
        return self.num_layers // p, self.num_layers % p

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class RunConfig:
    """Trainer/server options."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer_state_dtype: str = "float32"
    sync_mode: str = "sync"      # none | sync | local (pod-axis schedule)
    sync_budget: int = 1
    compress_int8: bool = False
    microbatches: int = 1        # gradient accumulation
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0
