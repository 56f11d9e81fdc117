"""Architecture configuration for the assigned model zoo.

One :class:`ArchConfig` describes any of the 10 assigned architectures
(dense GQA / SWA, VLM & audio backbones with stub frontends, RG-LRU hybrid,
xLSTM, MoE).  The model builder (:mod:`repro_torch.models.model`) consumes
only this dataclass, so architectures are selectable with ``--arch <id>``.
A copy of the JAX package's ``repro.models.config`` (no JAX in either).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    shared_expert_dim: int = 0     # llama4-style always-on shared expert
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Encoder half of an encoder-decoder arch (seamless-m4t)."""

    num_layers: int
    max_source_len: int = 4096


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense|vlm|hybrid|audio|ssm|moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # block structure: cycled pattern of per-layer kinds.
    #   "attn"  full causal attention      "swa"   sliding-window attention
    #   "rglru" RG-LRU recurrent block     "mlstm" / "slstm" xLSTM blocks
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096             # swa / local-attn window
    mlp: str = "swiglu"            # swiglu|geglu|none
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    moe: Optional[MoESpec] = None
    encoder: Optional[EncoderSpec] = None
    # modality frontend stub: extra embedding inputs prepended to the
    # token sequence; input_specs() supplies them pre-computed per the task
    # spec ("the modality frontend is a STUB").
    frontend: str = "none"         # none|patch|frames
    frontend_len: int = 0          # patches / frames per example
    # long-context capability: True iff decode state is O(window) or O(1)
    subquadratic: bool = False
    # force online-softmax attention even at seq<=4096 (memory-bound archs:
    # materialized fp32 scores dominate the HBM roofline term)
    force_chunked_attn: bool = False

    def __post_init__(self):
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        assert self.family in ("dense", "vlm", "hybrid", "audio", "ssm", "moe")
        for k in self.block_pattern:
            assert k in ("attn", "swa", "rglru", "mlstm", "slstm"), k

    # -- derived -------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind, cycling block_pattern to num_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks), for 6ND math."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embeddings (tied output head)
        if not self.tie_embeddings:
            total += v * d
        for kind in self.layer_kinds():
            if kind in ("attn", "swa"):
                total += d * self.q_dim + 2 * d * self.kv_dim \
                    + self.q_dim * d
            elif kind == "rglru":
                # conv1d(4) + gates + in/out projections (lru_dim = d)
                total += 4 * d + 3 * d * d + 2 * d
            elif kind == "mlstm":
                total += 4 * d * d  # q,k,v,o projections + gates (approx)
                total += 2 * d
            elif kind == "slstm":
                total += 4 * d * d + 4 * d
            total += self._ffn_params()
            total += 2 * d  # norms
        if self.encoder is not None:
            for _ in range(self.encoder.num_layers):
                total += 2 * (d * self.q_dim + 2 * d * self.kv_dim
                              + self.q_dim * d)  # self+cross proj (approx)
                total += self._ffn_params() + 2 * d
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        full_moe = 3 * d * self.moe.d_expert * self.moe.num_experts
        active_moe = 3 * d * self.moe.d_expert * self.moe.top_k
        return self.n_params() - self.num_layers * (full_moe - active_moe)

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            total = d * m.num_experts          # router
            total += 3 * d * m.d_expert * m.num_experts
            if m.shared_expert_dim:
                total += 3 * d * m.shared_expert_dim
            return total
        if self.mlp == "none" or self.d_ff == 0:
            return 0
        return 3 * self.d_model * self.d_ff    # gated MLP (in, gate, out)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                      # train_4k / prefill_32k / ...
    seq_len: int
    global_batch: int
    kind: str                      # train|prefill|decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
