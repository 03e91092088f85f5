"""Config dataclasses, field for field the same as ``repro/configs/base.py``.

The port keeps its own copy because importing ``repro`` pulls in JAX
(``repro/__init__.py`` imports ``repro.compat``).  A test pins the field
names and defaults against the JAX package's.

Fields that select JAX-side machinery (``MoEConfig.kernel_backend``,
``kernel_backend_overrides``, ``kernel_tiles``) are carried for parity and
are not read by the port: its kernels are chosen by the device a tensor
lives on (kernels/dispatch.py).  ``ObsConfig`` turns on the in-graph
metrics and the phase ranges of the MoE layer (obs/).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Mixer kinds
ATTN = "attn"
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"
# FFN kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclass(frozen=True)
class LSHConfig:
    """Paper §3.2: LSH compression of the MoE all-to-all."""
    enabled: bool = False
    hash_type: str = "cross_polytope"   # "cross_polytope" | "spherical"
    num_hashes: int = 6
    rotation_dim: int = 64
    compression_rate: float = 0.2
    wire_format: str = "bf16"           # "bf16" | "int8" | "fp8"
    wire_dtype: str = "bfloat16"
    error_compensation: bool = True


@dataclass(frozen=True)
class CommConfig:
    a2a_impl: str = "auto"        # auto | flat | hierarchical | pipelined
    node_size: int = 0
    overlap_chunks: int = 1
    min_hierarchical_bytes: int = 1 << 20
    tuning: str = "off"


@dataclass(frozen=True)
class ObsConfig:
    """Observability of the MoE layer (obs/): off by default, and then the
    step runs no op and no collective of it.  ``metrics``: the in-graph
    ``MetricBag`` (obs_* step metrics); ``phases``: the
    ``record_function`` ranges of the paper's phases (obs/tracing.py)."""
    enabled: bool = False
    metrics: bool = True
    phases: bool = True

    @property
    def in_graph_metrics(self) -> bool:
        return self.enabled and self.metrics

    @property
    def phase_tracing(self) -> bool:
        return self.enabled and self.phases


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    expert_ffn_dim: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01     # load-balance loss weight
    router_z_weight: float = 1e-3
    lsh: LSHConfig = field(default_factory=LSHConfig)
    kernel_backend: str = "auto"
    kernel_backend_overrides: Tuple[Tuple[str, str], ...] = ()
    kernel_tiles: Tuple[Tuple[str, int], ...] = ()
    comm: CommConfig = field(default_factory=CommConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"               # dense|moe|hybrid|ssm|vlm|audio
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    d_ff: int = 2048
    vocab_size: int = 32000
    head_dim: int = 0                   # 0 => d_model // num_heads
    # Stack layout: `layout` repeated `num_super_blocks` times.
    layout: Tuple[Tuple[str, str], ...] = ((ATTN, DENSE),)
    num_super_blocks: int = 12
    mlp_act: str = "swiglu"             # swiglu|relu2|gelu
    pos_emb: str = "rope"               # rope|learned|none
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)
    encoder_decoder: bool = False
    num_encoder_super_blocks: int = 0
    frontend: Optional[str] = None      # None|"audio_stub"|"patch_stub"
    num_patches: int = 0
    dtype: str = "bfloat16"
    remat_policy: str = "nothing"       # nothing|dots|full
    train_microbatch: int = 0
    dp_only: bool = False
    pipeline_microbatches: int = 0
    q_chunk: int = 512
    kv_chunk: int = 1024
    z_loss_weight: float = 1e-4

    @property
    def num_layers(self) -> int:
        return len(self.layout) * self.num_super_blocks

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def has_moe(self) -> bool:
        return any(f == MOE for _, f in self.layout)

    def has_attention(self) -> bool:
        return ATTN in {m for m, _ in self.layout}

    def is_subquadratic(self) -> bool:
        """True where every mixer is O(seq) at decode and the family runs
        500k-token contexts (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embeddings + stacked blocks), the same
    formula as the JAX package's."""
    h, dh = cfg.d_model, cfg.resolved_head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    total = cfg.vocab_size * h                       # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * h                  # lm head
    if cfg.pos_emb == "learned":
        total += 8192 * h
    per_layout = 0
    for mixer, ffn in cfg.layout:
        per_layout += h                              # pre-mixer norm
        if mixer == ATTN:
            per_layout += h * (n_q * dh) + 2 * h * (n_kv * dh) + (n_q * dh) * h
        elif mixer == MAMBA:
            d_in = cfg.ssm.expand * h
            nh = d_in // cfg.ssm.head_dim
            per_layout += h * (2 * d_in)
            per_layout += d_in * cfg.ssm.conv_width
            per_layout += h * (2 * cfg.ssm.d_state + nh)
            per_layout += 2 * nh
            per_layout += d_in * h
        elif mixer == MLSTM:
            d_in = int(cfg.xlstm.mlstm_proj_factor * h)
            per_layout += h * 2 * d_in
            per_layout += 3 * h * d_in + 2 * d_in + d_in * h
        elif mixer == SLSTM:
            pf = cfg.xlstm.slstm_proj_factor
            per_layout += 8 * h * h + int(pf * h) * h * 2
        n_mat = 3 if cfg.mlp_act == "swiglu" else 2
        if ffn == DENSE:
            per_layout += h                          # norm
            per_layout += n_mat * h * cfg.d_ff
        elif ffn == MOE:
            per_layout += h
            per_layout += h * cfg.moe.num_experts    # router
            per_layout += (cfg.moe.num_experts * n_mat * h
                           * cfg.moe.expert_ffn_dim)
    total += per_layout * cfg.num_super_blocks
    if cfg.encoder_decoder:
        enc = cfg.num_encoder_super_blocks * (
            h * (n_q * dh) + 2 * h * (n_kv * dh) + (n_q * dh) * h
            + 2 * h * cfg.d_ff * (3 if cfg.mlp_act == "swiglu" else 2) // 2
            + 2 * h)
        dec_cross = cfg.num_layers * (h * (n_q * dh) + 2 * h * (n_kv * dh)
                                      + (n_q * dh) * h + h)
        total += enc + dec_cross
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (a MoE layer counts only top_k experts)."""
    if not cfg.has_moe():
        return param_count(cfg)
    n_mat = 3 if cfg.mlp_act == "swiglu" else 2
    per_expert = n_mat * cfg.d_model * cfg.moe.expert_ffn_dim
    n_moe_layers = sum(1 for _, f in cfg.layout if f == MOE) \
        * cfg.num_super_blocks
    inactive = n_moe_layers * (cfg.moe.num_experts - cfg.moe.top_k) \
        * per_expert
    return param_count(cfg) - inactive


# ---------------------------------------------------------------------------
# The dry run's shape grid (launch/dryrun.py): every arch with these four.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a dry-run cell applies: long_500k only for sub-quadratic
    mixers."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return False, ("long_500k needs sub-quadratic attention; %s is "
                       "full-attention" % cfg.family)
    return True, ""


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # float32|bfloat16|int8 (block-quantized)
    # Error-feedback int8 gradient all-reduce (explicit-DP mode only).
    grad_compression: bool = False


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    microbatch: int = 0                 # 0 = no gradient accumulation
