"""Architecture config dataclass.

Port of ``repro/configs/base.py``: ``ModelConfig`` with its properties
and ``reduced()``, and the family constants, copied field for field so
the port and the JAX package describe a model by the same numbers, and
the input-shape cells (``ShapeConfig``, ``SHAPES``, ``shape_applicable``)
that training and the dry run take.

Every architecture gets one module in this package exporting ``CONFIG``
(exact published numbers). ``ModelConfig.reduced()`` derives the CPU
smoke-test variant of the same family (small widths/layers/experts,
tiny vocab).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# Families -----------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"

FAMILIES = (DENSE, MOE, SSM, HYBRID, VLM, AUDIO)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (decoder-only LM unless enc-dec)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention details ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    sliding_window: Optional[int] = None       # window for *local* layers
    # (n_local, n_global) repeating pattern; None => all layers global.
    local_global_pattern: Optional[Tuple[int, int]] = None

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                          # per-expert hidden size
    # per-expert buffer = ceil(k*T/E * factor); tokens over it are
    # dropped (GShard semantics). Serving paths may want this higher.
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- encoder/decoder (whisper) ---
    encoder_layers: int = 0
    max_decode_len: int = 0                    # architectural cap (whisper: 448)
    cross_kv_len: int = 0                      # encoder output length seen by decoder

    # --- VLM ---
    num_patches: int = 0                       # vision-prefix length (stub frontend)

    # --- common ---
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    fsdp: bool = False                         # shard params over the data axis too

    # ------------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == SSM

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer attention kind: 'local' / 'global' (dense archs only)."""
        if self.local_global_pattern is None:
            return ("global",) * self.num_layers
        n_local, n_global = self.local_global_pattern
        period = n_local + n_global
        kinds = []
        for i in range(self.num_layers):
            kinds.append("local" if (i % period) < n_local else "global")
        return tuple(kinds)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                   # unembed
        per_layer = 0
        if self.family != SSM:
            per_layer += d * self.q_dim + self.q_dim * d          # Wq, Wo
            per_layer += 2 * d * self.kv_dim                      # Wk, Wv
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
        if self.is_moe:
            per_layer += d * self.num_experts                     # router
            per_layer += self.num_experts * 3 * d * self.moe_d_ff
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff                        # SwiGLU
        if self.family in (SSM, HYBRID):
            inner = self.ssm_inner
            # in_proj -> [z, x, B, C, dt]; ngroups=1 so B,C are d_state wide
            per_layer += d * (2 * inner + 2 * self.ssm_state + self.ssm_heads)
            per_layer += inner * d                                 # out_proj
            per_layer += (inner + 2 * self.ssm_state) * self.ssm_conv  # conv1d
            per_layer += 2 * self.ssm_heads                        # A_log, dt_bias
        per_layer += 2 * d                                         # 2 RMSNorms
        n += per_layer * self.num_layers
        n += per_layer * self.encoder_layers                       # enc-dec approx
        n += d                                                     # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_experts = self.num_layers * self.num_experts * 3 * d * self.moe_d_ff
        active = self.num_layers * self.experts_per_token * 3 * d * self.moe_d_ff
        return full - all_experts + active

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Same-family smoke-test config: tiny but structurally identical."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            fsdp=False,
        )
        if self.local_global_pattern is not None:
            # keep one (local,global) group: 2 layers = 1 local + 1 global
            kw["local_global_pattern"] = (1, 1)
            kw["sliding_window"] = 8
        elif self.sliding_window is not None:
            kw["sliding_window"] = 8
        if self.is_moe:
            kw["num_experts"] = 8
            kw["experts_per_token"] = 2
            kw["moe_d_ff"] = 32
            kw["d_ff"] = 0
        if self.family in (SSM, HYBRID):
            kw["ssm_state"] = min(self.ssm_state, 8)
            kw["ssm_heads"] = 4
            kw["ssm_head_dim"] = 16
            kw["ssm_chunk"] = 16
        if self.encoder_layers:
            kw["encoder_layers"] = 1
            kw["num_layers"] = 1
            kw["max_decode_len"] = 32
            kw["cross_kv_len"] = 16
        if self.num_patches:
            kw["num_patches"] = 4
        return replace(self, **kw)


# Shapes --------------------------------------------------------------------
TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell.

    ``kind``:
      - ``train``   lowers ``train_step`` (fwd+bwd+opt) on (batch, seq).
      - ``prefill`` lowers ``serve_prefill`` on (batch, seq).
      - ``decode``  lowers ``serve_step`` — one new token against a KV
        cache of length ``seq_len``.
    """

    name: str
    kind: str
    seq_len: int
    global_batch: int

    def reduced(self) -> "ShapeConfig":
        return replace(
            self,
            name=self.name + "-smoke",
            seq_len=min(self.seq_len, 64),
            global_batch=min(self.global_batch, 2),
        )


SHAPES = {
    "train_4k": ShapeConfig("train_4k", TRAIN, 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", PREFILL, 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", DECODE, 32_768, 128),
    "long_500k": ShapeConfig("long_500k", DECODE, 524_288, 1),
}


# long-context eligibility: sub-quadratic / bounded-state archs only
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "hymba-1.5b", "gemma3-1b")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell is runnable, with a reason if not."""
    if shape.name.startswith("long_") and cfg.name not in LONG_CONTEXT_ARCHS:
        return False, ("pure full-attention arch: 500k decode is "
                       "quadratic-cost/unbounded-KV (skip per assignment)")
    return True, ""
