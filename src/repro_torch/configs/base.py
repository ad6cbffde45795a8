"""Architecture config schema for the model zoo (the port's copy of the
reference's ``configs/base.py``, field for field).

Every assigned architecture gets a module in this package exporting
``CONFIG`` (the exact published dims) — the registry in ``__init__``
resolves ``--arch <id>``. ``reduced()`` derives the CPU smoke-test config
(same family and code path, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    # --- attention ------------------------------------------------------
    attention: str = "gqa"      # gqa | mla | none
    rope_theta: float = 10000.0

    # --- MLA (MiniCPM3 / DeepSeek-V2 style) ------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE --------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    # decode-regime capacity factor; 0 = dropless (capacity = tokens).
    # See EXPERIMENTS.md §Perf: dropless decode computes every expert over
    # a mostly-empty buffer — factor ~4 cuts decode MoE FLOPs ~t*k/(4e)x.
    moe_decode_capacity_factor: float = 0.0

    # --- SSM (Mamba-2 / SSD) ----------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (Zamba2): shared attn+MLP block every k SSM layers --------
    shared_attn_every: int = 0
    shared_attn_d_ff: int = 0

    # --- encoder-decoder (Whisper) ----------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0        # precomputed frame embeddings (stub frontend)

    # --- VLM (InternVL2): vision-prefix embeddings (stub frontend) --------
    num_vision_tokens: int = 0

    # --- MLP / misc --------------------------------------------------------
    mlp_type: str = "swiglu"    # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # --- execution ---------------------------------------------------------
    scan_layers: bool = True
    remat: str = "full"         # none | full | dots
    dtype: str = "bfloat16"
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for 6ND."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.attention == "mla":
            attn = (d * self.q_lora_rank
                    + self.q_lora_rank * self.num_heads
                    * (self.nope_head_dim + self.rope_head_dim)
                    + d * self.kv_lora_rank + d * self.rope_head_dim
                    + self.kv_lora_rank * self.num_heads
                    * (self.nope_head_dim + self.v_head_dim)
                    + self.num_heads * self.v_head_dim * d)
        elif self.attention == "gqa":
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d
        else:
            attn = 0
        mlp_mult = 3 if self.mlp_type == "swiglu" else 2
        dense_mlp = mlp_mult * d * ff
        if self.family == "moe":
            experts = self.num_experts + self.num_shared_experts
            mlp = experts * mlp_mult * d * ff + d * self.num_experts
        else:
            mlp = dense_mlp
        if self.family in ("ssm", "hybrid"):
            d_in = self.d_inner
            ssm = (d * (2 * d_in + 2 * self.ssm_state + self.ssm_heads)
                   + d_in * d + (d_in + 2 * self.ssm_state)
                   * self.ssm_conv_width + 3 * self.ssm_heads)
            if self.family == "hybrid":
                shared = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * hd * d \
                    + 3 * d * (self.shared_attn_d_ff or ff)
                n += shared  # invoked repeatedly, stored once
                n += self.num_layers * ssm
                return n
            n += self.num_layers * ssm
            return n
        n += self.num_layers * (attn + mlp)
        if self.encoder_layers:
            n += self.encoder_layers * (attn + dense_mlp)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp_mult = 3 if self.mlp_type == "swiglu" else 2
        total = self.param_count()
        all_experts = (self.num_experts + self.num_shared_experts) \
            * mlp_mult * d * ff * self.num_layers
        active = (self.experts_per_token + self.num_shared_experts) \
            * mlp_mult * d * ff * self.num_layers
        return total - all_experts + active

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 if not self.shared_attn_every
                           else self.shared_attn_every + 1),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(max(self.num_kv_heads // 8, 1), 4)
            if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            rope_head_dim=16 if self.rope_head_dim else 0,
            nope_head_dim=16 if self.nope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            num_experts=min(self.num_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            moe_decode_capacity_factor=0.0,  # smoke tests: exact/dropless
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            shared_attn_every=min(self.shared_attn_every, 2)
            if self.shared_attn_every else 0,
            shared_attn_d_ff=256 if self.shared_attn_d_ff else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            num_vision_tokens=min(self.num_vision_tokens, 16),
            scan_layers=False,
            remat="none",
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One dry-run cell: kind selects which step gets lowered."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

# long_500k is sub-quadratic-only (assignment): SSM + hybrid run it, pure
# full-attention archs skip it (recorded in DESIGN.md §4 + EXPERIMENTS.md).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, "long_500k requires sub-quadratic attention " \
                      f"({cfg.family} is full-attention)"
    return True, ""
