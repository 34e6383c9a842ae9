"""Model configuration for the PyTorch port (a copy of ``repro.core.model_config``).

``ModelSpec`` is the single source of truth for an architecture: the
analytical page sizing (core/analytical.py), the torch model
(models/lm.py) and the serve stack all consume the same dataclass.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts configuration for one FFN block."""

    num_experts: int
    top_k: int
    expert_ff: int                 # d_ff of each routed expert
    num_shared_experts: int = 0    # always-on shared experts (qwen2-moe style)
    shared_ff: int = 0             # d_ff of the fused shared expert block
    capacity_factor: float = 1.25
    # Experts are padded to a multiple of the EP axis so 60 experts shard
    # over 16 devices; dummy experts receive no router mass.
    pad_to_multiple: int = 1

    @property
    def padded_experts(self) -> int:
        return _round_up(self.num_experts, self.pad_to_multiple)


@dataclass(frozen=True)
class SSMSpec:
    """Mamba2-style state-space block configuration."""

    state_dim: int = 64
    head_dim: int = 64
    num_heads: int = 0             # derived: d_inner // head_dim when 0
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256               # chunked-scan block length for training


@dataclass(frozen=True)
class XLSTMSpec:
    """xLSTM block mix: mLSTM (matrix memory) + sLSTM blocks."""

    slstm_every: int = 8           # every k-th block is sLSTM, rest mLSTM
    proj_factor: float = 2.0       # mLSTM up-projection factor
    qk_dim_factor: float = 0.5     # mLSTM key/query dim relative to inner


@dataclass(frozen=True)
class ModelSpec:
    """Architecture description (assignment notation: L, d_model, H, kv, d_ff, V)."""

    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # derived: d_model // num_heads when 0

    # Attention flavour
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 = full attention
    local_global_ratio: int = 0    # gemma3: N local layers per 1 global
    attn_logit_softcap: float = 0.0

    # Norm / misc
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu
    tie_embeddings: bool = False

    # MoE / SSM / xLSTM blocks (None for plain dense)
    moe: Optional[MoESpec] = None
    moe_every: int = 1             # apply MoE FFN every k-th layer
    ssm: Optional[SSMSpec] = None
    attn_every: int = 0            # hybrid (zamba2): shared attn block every k SSM layers
    shared_attn_block: bool = False  # zamba2: the interleaved attn block reuses ONE set of weights
    xlstm: Optional[XLSTMSpec] = None

    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # fixed encoder length (audio frames)
    cross_attention: bool = False

    # VLM frontend stub (internvl2)
    vision_tokens: int = 0         # precomputed patch embeddings prepended
    vision_embed_dim: int = 0

    # Sharding-driven vocab padding
    vocab_pad_multiple: int = 256

    # Max position for RoPE tables etc.
    max_seq_len: int = 1 << 20

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, in order ("attn", "attn_global", "attn_local",
        "ssm", "mlstm", "slstm")."""
        kinds = []
        for i in range(self.num_layers):
            if self.xlstm is not None:
                k = "slstm" if (i + 1) % self.xlstm.slstm_every == 0 else "mlstm"
            elif self.ssm is not None:
                k = "ssm"
            elif self.local_global_ratio > 0:
                # pattern: N local then 1 global, repeating (gemma3 style)
                k = ("attn_global"
                     if (i % (self.local_global_ratio + 1)) == self.local_global_ratio
                     else "attn_local")
            else:
                k = "attn"
            kinds.append(k)
        return tuple(kinds)

    def num_attention_layers(self) -> int:
        """Layers that carry a KV cache (incl. zamba2's shared-block applications)."""
        kinds = self.layer_kinds()
        n = sum(1 for k in kinds if k.startswith("attn"))
        if self.ssm is not None and self.attn_every:
            n += sum(1 for i in range(self.num_layers) if (i + 1) % self.attn_every == 0)
        return n

    def with_(self, **kw) -> "ModelSpec":
        return dataclasses.replace(self, **kw)

    def scaled_down(self, layers: int = 2, width: int = 64, vocab: int = 512) -> "ModelSpec":
        """Reduced same-family config for CPU smoke tests."""
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        hd = max(8, width // heads)
        kw = dict(
            num_layers=layers,
            d_model=width,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=width * 4 if self.d_ff else 0,
            vocab_size=vocab,
            vocab_pad_multiple=16,
            max_seq_len=4096,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                expert_ff=width * 2,
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                shared_ff=width * 2 if self.moe.num_shared_experts else 0,
                pad_to_multiple=1)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16, head_dim=16, chunk=32)
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2)
        if self.encoder_layers:
            kw["encoder_layers"] = layers
            kw["encoder_seq"] = 16
        if self.vision_tokens:
            kw["vision_tokens"] = 8
            kw["vision_embed_dim"] = width
        return self.with_(**kw)


@dataclass(frozen=True)
class ShapeSpec:
    """Assigned input shape: (seq_len, global_batch, step kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch
