"""Configuration dataclasses for the repro framework.

One ``ModelConfig`` describes any architecture in the assigned pool (dense /
MoE+MLA / Mamba2-hybrid / xLSTM / enc-dec audio / VLM).  ``ShapeConfig``
describes one (seq_len, global_batch, kind) input-shape cell of the dry-run
matrix.  ``reduced()`` shrinks a config for CPU smoke tests while keeping the
family topology (MoE stays MoE, hybrid stays hybrid, ...).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (DeepSeek-style)."""

    num_experts: int = 0              # routed experts
    num_shared_experts: int = 0       # always-on shared experts
    top_k: int = 0                    # routed experts per token
    d_ff: int = 0                     # per-expert FFN hidden size
    first_k_dense: int = 0            # leading dense layers (DeepSeek)
    dense_d_ff: int = 0               # FFN size of those dense layers
    router_aux_loss: float = 0.001    # load-balance loss coefficient

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention sub-config (DeepSeek v2/v3)."""

    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / xLSTM sub-config."""

    state_size: int = 0               # N: SSM state dimension per group
    conv_kernel: int = 4
    head_dim: int = 64                # P: channels per SSM head
    expand: int = 2                   # d_inner = expand * d_model
    ngroups: int = 1                  # B/C groups (shared across heads)
    chunk_size: int = 256             # chunked-scan block length
    # hybrid (Zamba2): a shared attention block applied every N ssm blocks
    attn_every: int = 0               # 0 = no interleaved attention
    # xLSTM: which block indices are sLSTM (rest mLSTM)
    slstm_layers: Tuple[int, ...] = ()

    @property
    def enabled(self) -> bool:
        return self.state_size > 0


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder sub-config (Whisper)."""

    encoder_layers: int = 0
    source_positions: int = 1500      # post-conv audio frames
    frontend: str = "stub"            # modality frontend is a STUB per spec

    @property
    def enabled(self) -> bool:
        return self.encoder_layers > 0


@dataclass(frozen=True)
class VLMConfig:
    """Cross-attention VLM sub-config (Llama-3.2-Vision)."""

    cross_attn_every: int = 0         # cross-attn layer every N layers
    vision_tokens: int = 1601         # patch embeddings per image (stub)
    vision_dim: int = 0               # dim of the (stub) vision embeddings

    @property
    def enabled(self) -> bool:
        return self.cross_attn_every > 0


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"             # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                 # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 512
    qkv_bias: bool = False
    gated_mlp: bool = True            # SwiGLU (3 mats) vs GELU (2 mats)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20
    # sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    encdec: EncDecConfig = field(default_factory=EncDecConfig)
    vlm: VLMConfig = field(default_factory=VLMConfig)
    # DeepSeek-v3 multi-token prediction depth (extra MTP module count)
    mtp_depth: int = 0
    # numerics
    dtype: str = "bfloat16"
    # remat policy for training: none | dots | full
    remat: str = "dots"
    # attention implementation for train/prefill: "reference" materializes
    # the full score matrix; "chunked" is the flash-pattern online-softmax
    # scan over KV blocks (§Perf iteration 1 — memory-roofline fix)
    attn_impl: str = "reference"
    # sub-quadratic? (drives long_500k eligibility)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encdec.enabled

    def param_count(self) -> int:
        """Analytic parameter count (matches the constructed pytree closely;
        used for roofline MODEL_FLOPS = 6*N*D and the perf model)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += V * d  # lm head
        for layer in range(L):
            n += self._attn_params(layer)
            n += self._ffn_params(layer)
            n += 2 * d  # norms
        if self.ssm.enabled and self.ssm.attn_every > 0:
            # hybrid: ONE weight-shared attention+MLP block (Zamba2)
            n += self._dense_attn_params() + self._mlp_params(self.d_ff) + 2 * d
        if self.encdec.enabled:
            # encoder stack (self-attn + FFN + norms per layer)
            n += self.encdec.encoder_layers * (
                self._dense_attn_params() + self._mlp_params(self.d_ff) + 2 * d)
        if self.mtp_depth:
            # each MTP module: one extra transformer layer + projection
            n += self.mtp_depth * (self._attn_params(L - 1) + self._ffn_params(0) + d * 2 * d)
        return n

    def active_param_count(self) -> int:
        """Active (per-token) parameters — for MoE roofline MODEL_FLOPS."""
        if not self.moe.enabled:
            return self.param_count()
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        n = V * d * (1 if self.tie_embeddings else 2)
        for layer in range(L):
            n += self._attn_params(layer) + 2 * d
            if layer < self.moe.first_k_dense:
                n += 3 * d * self.moe.dense_d_ff
            else:
                active = self.moe.top_k + self.moe.num_shared_experts
                n += 3 * d * self.moe.d_ff * active + d * self.moe.num_experts  # + router
        return n

    def _dense_attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        bias = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def _mlp_params(self, d_ff: int) -> int:
        if d_ff == 0:
            return 0
        mats = 3 if self.gated_mlp else 2
        return mats * self.d_model * d_ff

    def _attn_params(self, layer: int) -> int:
        d = self.d_model
        if self.ssm.enabled:
            # Mamba2 / xLSTM block parameters (hybrid shared-attn counted
            # separately, once, in param_count)
            di = self.ssm.expand * d
            nheads = max(di // max(self.ssm.head_dim, 1), 1)
            if self.family == "ssm" and layer in self.ssm.slstm_layers:
                # sLSTM block: 4 gates (i,f,z,o) recurrent + input proj + out
                return d * 4 * d + 4 * d * self.num_heads * 0 + 2 * d * di
            if self.family == "ssm":   # xLSTM mLSTM block
                return d * 3 * di + di * d + di * self.ssm.conv_kernel
            # mamba2: in_proj (z,x,B,C,dt) + conv(x,B,C) + out_proj
            bc = 2 * self.ssm.ngroups * self.ssm.state_size
            return d * (2 * di + bc + nheads) \
                + self.ssm.conv_kernel * (di + bc) + di * d
        if self.mla.enabled:
            m = self.mla
            nh = self.num_heads
            p = d * m.q_lora_rank + m.q_lora_rank * nh * m.qk_head_dim       # q path
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)                   # kv down
            p += m.kv_lora_rank * nh * (m.qk_nope_head_dim + m.v_head_dim)   # kv up
            p += nh * m.v_head_dim * d                                       # o proj
            return p
        p = self._dense_attn_params()
        if self.vlm.enabled and self._is_cross_attn_layer(layer):
            p *= 2  # cross-attn layer adds a parallel attention block
        if self.encdec.enabled:
            p += self._dense_attn_params()  # decoder cross-attention
        return p

    def _ffn_params(self, layer: int) -> int:
        d = self.d_model
        if self.ssm.enabled:
            return 0  # folded into the block
        if self.moe.enabled:
            if layer < self.moe.first_k_dense:
                return 3 * d * self.moe.dense_d_ff
            total = self.moe.num_experts + self.moe.num_shared_experts
            return 3 * d * self.moe.d_ff * total + d * self.moe.num_experts
        return self._mlp_params(self.d_ff)

    def _is_cross_attn_layer(self, layer: int) -> bool:
        return self.vlm.enabled and (layer % self.vlm.cross_attn_every == 0)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and the reason if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; arch is full-attention"
    return True, ""


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 256) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving family topology."""
    heads = 4
    kv = min(cfg.num_kv_heads, heads) if cfg.num_kv_heads < cfg.num_heads else heads
    kv = max(1, min(kv, heads))
    changes = dict(
        num_layers=layers, d_model=d_model, num_heads=heads, num_kv_heads=kv,
        head_dim=d_model // heads, d_ff=(128 if cfg.d_ff else 0),
        vocab_size=vocab, max_seq_len=4096, dtype="float32", remat="none",
    )
    if cfg.moe.enabled:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff=64, first_k_dense=min(cfg.moe.first_k_dense, 1), dense_d_ff=128)
        changes["d_ff"] = 0
    if cfg.mla.enabled:
        changes["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, q_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
        changes["head_dim"] = 16
    if cfg.ssm.enabled:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_size=16, head_dim=16, chunk_size=32,
            slstm_layers=tuple(i for i in cfg.ssm.slstm_layers if i < layers))
    if cfg.encdec.enabled:
        changes["encdec"] = dataclasses.replace(
            cfg.encdec, encoder_layers=layers, source_positions=16)
    if cfg.vlm.enabled:
        changes["vlm"] = dataclasses.replace(
            cfg.vlm, cross_attn_every=2, vision_tokens=8, vision_dim=d_model)
    if cfg.mtp_depth:
        changes["mtp_depth"] = 1
    return dataclasses.replace(cfg, **changes)
