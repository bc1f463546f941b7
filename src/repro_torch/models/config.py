"""Architecture configuration schema (one instance per assigned arch)."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 => d_model // num_heads

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_pattern: tuple[str, ...] = ("global",)   # cycled over layers
    window: int = 4096              # size of "local" sliding windows
    attn_softcap: float = 0.0       # 0 => off (gemma2: 50)
    final_softcap: float = 0.0      # logits softcap (gemma2: 30)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1              # MoE FFN every N layers (llama4: 2)
    shared_expert: bool = False
    d_ff_dense: int = 0             # FFN width of non-MoE layers (0 => d_ff)
    # force the exact dropless dispatch on *every* path (training included);
    # every served forward is dropless regardless (model._sublayer).
    # Used by parity references: capacity-drop is not decode-exact.
    moe_dropless: bool = False

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0              # 0 => derived from d_inner / ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # structure
    hybrid: bool = False            # hymba: parallel attn ∥ SSM heads per layer
    encoder_layers: int = 0         # >0 => encoder-decoder (whisper)
    frontend_tokens: int = 0        # stub modality frontend sequence length
    frontend_dim: int = 0           # stub frontend embedding dim (0 => d_model)

    # misc
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "silu"               # silu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: bool = False       # gemma: scale embeddings by sqrt(d)

    # distribution policy
    fsdp: bool = False              # shard params over the data(+pod) axes too
    remat: bool = True
    # pad KV heads for TP in the *training* path too (serving paths always
    # pad — cache layout wins everywhere). Empirically per-arch: wins only
    # where the baseline partitioner replicates attention (H ∤ TP with wide
    # heads: phi3, qwen); costs reshards where heads already shard cleanly
    # (gemma, pixtral). See EXPERIMENTS.md §Perf hillclimb 1.
    pad_attn_train: bool = False

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
            raise ValueError(f"unknown family {self.family!r}")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 2048 = 128 (MXU lane) × 16 (TP):
        embedding/lm-head shards stay MXU-aligned on the production mesh.
        Logits beyond vocab_size are masked to -inf in the head."""
        if self.vocab_size % 2048 == 0 or self.vocab_size < 2048:
            return self.vocab_size
        return math.ceil(self.vocab_size / 2048) * 2048

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return self.d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (DESIGN.md §5)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return (all(p == "local" for p in self.attn_pattern)
                or "local" in self.attn_pattern)

    def layer_kind(self, i: int) -> dict:
        """Structural descriptor of layer i (drives block assembly)."""
        attn = self.attn_pattern[i % len(self.attn_pattern)]
        is_moe = (self.num_experts > 0) and (i % self.moe_every == self.moe_every - 1)
        return {"attn": attn, "moe": is_moe}

    @property
    def stack_period(self) -> int:
        """Length of the repeating structural pattern (scan superblock)."""
        return int(math.lcm(len(self.attn_pattern),
                            self.moe_every if self.num_experts else 1))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts + shared)."""
        if not self.num_experts:
            return self.param_count()
        total = self.param_count()
        per_moe_layer = self.num_experts * 3 * self.d_model * self.d_ff
        active_moe = self.experts_per_token * 3 * self.d_model * self.d_ff
        n_moe = sum(1 for i in range(self.num_layers)
                    if self.layer_kind(i)["moe"])
        return total - n_moe * (per_moe_layer - active_moe)

    def param_count(self) -> int:
        """Approximate parameter count (reported in DESIGN/EXPERIMENTS)."""
        d, hd = self.d_model, self.hd
        per_layer = 0
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        ffn_mats = 2 if self.family == "audio" else 3   # MLP vs SwiGLU
        ffn_dense = ffn_mats * d * (self.d_ff_dense or self.d_ff)
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            p = 0 if self.attn_free else attn
            if self.family == "ssm" or self.hybrid:
                din = self.d_inner
                p += d * (2 * din + 2 * self.ssm_state) + din * d
            if kind["moe"]:
                p += self.num_experts * 3 * d * self.d_ff
                if self.shared_expert:
                    p += 3 * d * self.d_ff
                p += d * self.num_experts
            elif self.family != "ssm":
                p += ffn_dense
            per_layer += p + 2 * d
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        enc = self.encoder_layers * (attn + ffn_dense + 2 * d)
        cross = self.num_layers * (attn if self.is_encdec else 0)
        return per_layer + emb + enc + cross


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str     # train | prefill | decode

SHAPES = (
    ShapeCfg("train_4k", 4096, 256, "train"),
    ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    ShapeCfg("decode_32k", 32768, 128, "decode"),
    ShapeCfg("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}
