"""Model, shape, serving and training configuration dataclasses.

A standalone copy of ``repro/configs/base.py``'s ``ModelConfig``,
``ShapeConfig`` / ``SHAPE_PRESETS``, ``ServeConfig``, ``TrainConfig``,
``resolve_remat`` and ``reduced()``: same fields, same defaults, same
validation (a test holds the field lists and defaults equal). Fields the
port does not read yet (MoE, MLA, SSM, chunked prefill, prefix cache,
telemetry, chaos) are kept so a config round-trips between the packages
unchanged; the port's engine rejects settings it does not implement.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm

    # trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: int = 0            # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "swiglu"          # swiglu | gelu

    # attention approximation (the paper's technique)
    attention_impl: str = "full"
    decode_attention_impl: str = "spectral_shift"
    encoder_attention_impl: str = "spectral_shift"
    decode_streaming: str = "exact"    # recompute | exact | frozen
    num_landmarks: int = 64
    ss_method: str = "iterative"
    pinv_iters: int = 6
    include_shift_identity: bool = True
    landmark_via_matmul: bool = False
    cast_params_once: bool = True      # working copy cast once to compute_dtype
    kernels_interpret: bool = True     # reference-only (Pallas interpret mode)
    attention_backend: str = "auto"
    autotune: bool = False
    autotune_cache: str = ""
    seq_shard_fused: bool = True

    # MoE
    moe: bool = False
    moe_impl: str = "gspmd"
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # MLA (DeepSeek-V2 style)
    mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    conv_width: int = 4
    slstm_every: int = 0
    ssm_chunk: int = 256

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    cross_attention: bool = False
    encoder_seq_ratio: float = 1.0

    # modality frontend stub
    frontend: str = "none"
    num_patches: int = 0

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "full"
    unroll_scans: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_decoder_only(self) -> bool:
        return self.encoder_layers == 0


# Per-backend remat defaults for ``remat="auto"`` (``repro/configs/base.py``
# REMAT_DEFAULTS, pinned there from its remat study). The port's backends
# are "gpu" and "cpu".
REMAT_DEFAULTS: dict[str, str] = {
    "tpu": "ss_stats",
    "gpu": "ss_stats",
    "cpu": "full",
}


def resolve_remat(remat: str, backend: Optional[str] = None) -> str:
    """Map ``remat="auto"`` to the per-backend default (identity for every
    explicit policy). ``backend`` defaults to "gpu" when torch sees a GPU."""
    if remat != "auto":
        return remat
    if backend is None:
        import torch

        backend = "gpu" if torch.cuda.is_available() else "cpu"
    return REMAT_DEFAULTS.get(backend, "full")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPE_PRESETS: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-engine knobs: paged KV cache + two-phase scheduler."""

    max_lanes: int = 4
    max_seq: int = 512
    block_size: int = 16          # tokens per KV block; must divide max_seq
    num_blocks: int = 0           # 0 => max_lanes * max_seq / block_size
    paged: bool = True
    batched_prefill: bool = True
    prefill_bucket: int = 32      # prompts padded up to a bucket multiple
    prefill_impl: str = "replay"  # replay | ss_fused
    decode_impl: str = "gather"   # gather | paged
    chunked_prefill: bool = False
    prefill_chunk_tokens: int = 64
    prefill_token_budget: int = 0
    prefix_cache: bool = False
    prefix_cache_blocks: int = 0
    prefix_attach: str = "reseg"
    eos_id: int = 2
    seed: int = 0
    telemetry: bool = False
    numerics_probe_every: int = 0
    max_queue: int = 0
    watchdog_ticks: int = 0
    numerics_guard: bool = False
    numerics_demote_after: int = 2

    @property
    def blocks_per_lane(self) -> int:
        return self.max_seq // self.block_size

    @property
    def resolved_num_blocks(self) -> int:
        # +1: block 0 is reserved as the permanently-zero block that backs
        # unallocated block-table slots.
        n = self.num_blocks or self.max_lanes * self.blocks_per_lane
        # One lane must always be able to hold a full sequence.
        return max(n, self.blocks_per_lane) + 1

    def __post_init__(self):
        if self.paged and self.max_seq % self.block_size:
            raise ValueError(
                f"block_size {self.block_size} must divide max_seq "
                f"{self.max_seq} (or set paged=False)"
            )
        if self.prefill_impl not in ("replay", "ss_fused"):
            raise ValueError(f"unknown prefill_impl {self.prefill_impl!r}")
        if self.decode_impl not in ("gather", "paged"):
            raise ValueError(f"unknown decode_impl {self.decode_impl!r}")
        if self.numerics_probe_every < 0:
            raise ValueError(
                f"numerics_probe_every must be >= 0, "
                f"got {self.numerics_probe_every}"
            )
        if self.chunked_prefill and not self.batched_prefill:
            raise ValueError(
                "chunked_prefill=True requires batched_prefill=True (chunks "
                "are bucketed batched-prefill programs)"
            )
        if self.prefill_chunk_tokens <= 0:
            raise ValueError(
                f"prefill_chunk_tokens must be > 0, "
                f"got {self.prefill_chunk_tokens}"
            )
        if self.prefill_token_budget < 0:
            raise ValueError(
                f"prefill_token_budget must be >= 0, "
                f"got {self.prefill_token_budget}"
            )
        if self.prefix_attach not in ("reseg", "recompute"):
            raise ValueError(f"unknown prefix_attach {self.prefix_attach!r}")
        if self.prefix_cache_blocks < 0:
            raise ValueError(
                f"prefix_cache_blocks must be >= 0, "
                f"got {self.prefix_cache_blocks}"
            )
        if self.prefix_cache and not self.batched_prefill:
            raise ValueError(
                "prefix_cache=True requires batched_prefill=True (partial "
                "hits resume through chunked batched prefill)"
            )
        if self.max_queue < 0:
            raise ValueError(
                f"max_queue must be >= 0, got {self.max_queue}"
            )
        if self.watchdog_ticks < 0:
            raise ValueError(
                f"watchdog_ticks must be >= 0, got {self.watchdog_ticks}"
            )
        if self.numerics_demote_after < 1:
            raise ValueError(
                f"numerics_demote_after must be >= 1, "
                f"got {self.numerics_demote_after}"
            )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / trainer knobs."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1        # grad-accumulation steps
    opt_state_dtype: str = "float32"
    grad_compression: Optional[str] = None  # None | "int8"
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    seed: int = 0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving its family shape
    (GQA ratio kept; MoE/MLA/SSM sizes scale down as in the reference)."""
    kv_ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    heads = 4
    small: dict = dict(
        num_layers=2,
        d_model=128,
        num_heads=heads,
        num_kv_heads=max(1, heads // kv_ratio),
        d_ff=256,
        vocab_size=512,
        head_dim=32 if cfg.head_dim else 0,
        num_landmarks=16,
        scan_layers=cfg.scan_layers,
        remat="none",
        compute_dtype="float32",
    )
    if cfg.moe:
        small.update(num_experts=8, num_shared_experts=min(cfg.num_shared_experts, 1),
                     top_k=min(cfg.top_k, 2), moe_d_ff=64)
    if cfg.mla:
        small.update(kv_lora_rank=32, rope_head_dim=16)
    if cfg.ssm_state:
        small.update(ssm_state=8)
    if cfg.encoder_layers:
        small.update(encoder_layers=2)
    if cfg.num_patches:
        small.update(num_patches=16)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
