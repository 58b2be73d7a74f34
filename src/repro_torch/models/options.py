"""Model options the copied ``configs/base.py`` cannot hold, owned by the
port: YaRN rope scaling for MLA, and the expert layer's routing and share.

:class:`DeepSeekConfig` is a ``ModelConfig`` with two more fields; every
default leaves a model as the plain ``ModelConfig`` runs it, and
:func:`yarn_of` / :func:`routing_of` read them from either class.  With
``routing.dropless`` the expert layer holds ``moe.num_experts`` experts
from ``routing.first_expert`` on, of ``routing.router_experts`` that its
router scores: one chip's share of a layer under expert parallelism, run
here without the exchange (``moe.py``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Mapping, Optional

import torch

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig


@dataclass(frozen=True)
class YarnConfig:
    """YaRN (DeepSeek's ``rope_scaling`` of type "yarn") for the rope
    columns of MLA's queries and keys."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float

    def __post_init__(self):
        # DeepSeek scales cos and sin by mscale(mscale) / mscale(
        # mscale_all_dim); every published config makes that 1
        if self.mscale != self.mscale_all_dim:
            raise NotImplementedError(
                "YaRN with mscale != mscale_all_dim (cos/sin scaled) is "
                "not supported")

    def correction_range(self, dim: int, theta: float):
        """(low, high) rope pair indices between which the inverse
        frequencies blend from interpolated to original."""
        def at(rotations):
            return (dim * math.log(self.original_max_position_embeddings
                                   / (rotations * 2 * math.pi))
                    / (2 * math.log(theta)))
        low = math.floor(at(self.beta_fast))
        high = math.ceil(at(self.beta_slow))
        return max(low, 0), min(high, dim - 1)

    def softmax_mscale(self) -> float:
        """The factor on the softmax scale: mscale(factor, all_dim)²."""
        if not self.mscale_all_dim or self.factor <= 1:
            return 1.0
        m = 0.1 * self.mscale_all_dim * math.log(self.factor) + 1.0
        return m * m


@functools.lru_cache(maxsize=16)
def yarn_inv_freq(yarn: YarnConfig, dim: int, theta: float,
                  device: torch.device) -> torch.Tensor:
    """(dim // 2,) f32 inverse frequencies, as DeepSeek's
    ``DeepseekV2YarnRotaryEmbedding``: the original ``theta^(-2i/dim)``
    below the correction range, those divided by ``factor`` above it, a
    linear ramp between."""
    extra = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=device) / dim))
    inter = extra / yarn.factor
    low, high = yarn.correction_range(dim, theta)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


@dataclass(frozen=True)
class RoutingConfig:
    """How the expert layer routes.  The defaults are the capacity path:
    every expert held, renormalised gates, the switch-style loss."""

    dropless: bool = False        # sort by expert; grouped products
    router_experts: int = 0       # the router's width; 0: moe.num_experts
    first_expert: int = 0         # the first expert this layer holds
    renormalize: bool = True      # gates / their sum over the top-k
    routed_scale: float = 1.0     # gates x this
    seq_aux: bool = False         # DeepSeek-V2's sequence-wise loss

    def __post_init__(self):
        if (self.router_experts or self.first_expert) and not self.dropless:
            raise ValueError("an expert share needs dropless routing")


@dataclass(frozen=True)
class DeepSeekConfig(ModelConfig):
    yarn: Optional[YarnConfig] = None
    routing: RoutingConfig = field(default_factory=RoutingConfig)


_ROUTING = RoutingConfig()


def yarn_of(cfg: ModelConfig) -> Optional[YarnConfig]:
    return getattr(cfg, "yarn", None)


def routing_of(cfg: ModelConfig) -> RoutingConfig:
    return getattr(cfg, "routing", _ROUTING)


def router_width(cfg: ModelConfig) -> int:
    return routing_of(cfg).router_experts or cfg.moe.num_experts


def mla_rope(cfg: ModelConfig, device: torch.device):
    """-> (inverse frequencies of MLA's rope columns or None for plain
    rope at ``cfg.rope_theta``, softmax scale)."""
    m = cfg.mla
    yarn = yarn_of(cfg)
    scale = m.qk_head_dim ** -0.5
    if yarn is None:
        return None, scale
    return (yarn_inv_freq(yarn, m.qk_rope_head_dim, float(cfg.rope_theta),
                          torch.device(device)),
            scale * yarn.softmax_mscale())


def deepseek_from_hf(c: Mapping, *, name: str = "deepseek", dtype: str =
                     "bfloat16", remat: str = "dots") -> DeepSeekConfig:
    """A DeepSeek-V2-style ``config.json`` (key names as published) ->
    the port's configuration, routed dropless.  ``n_routed_experts``
    counts the experts held; ``expert_share`` {"router_experts",
    "first_expert"} places them among the router's (absent: every expert
    held); ``aux_loss_alpha`` is the balance loss's coefficient."""
    if c.get("scoring_func", "softmax") != "softmax" or \
            c.get("topk_method", "greedy") != "greedy":
        raise NotImplementedError("routing other than softmax + greedy")
    rs = c.get("rope_scaling")
    yarn = None
    if rs:
        if rs["type"] != "yarn":
            raise NotImplementedError(f"rope_scaling {rs['type']!r}")
        yarn = YarnConfig(
            float(rs["factor"]), int(rs["original_max_position_embeddings"]),
            float(rs["beta_fast"]), float(rs["beta_slow"]),
            float(rs["mscale"]), float(rs["mscale_all_dim"]))
    share = c.get("expert_share", {})
    return DeepSeekConfig(
        name=name, family="moe", num_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c["v_head_dim"], d_ff=0, vocab_size=c["vocab_size"],
        tie_embeddings=c["tie_word_embeddings"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        moe=MoEConfig(num_experts=c["n_routed_experts"],
                      num_shared_experts=c["n_shared_experts"],
                      top_k=c["num_experts_per_tok"],
                      d_ff=c["moe_intermediate_size"],
                      first_k_dense=c["first_k_dense_replace"],
                      dense_d_ff=c["intermediate_size"],
                      router_aux_loss=c["aux_loss_alpha"]),
        mla=MLAConfig(kv_lora_rank=c["kv_lora_rank"],
                      q_lora_rank=c["q_lora_rank"] or 0,
                      qk_nope_head_dim=c["qk_nope_head_dim"],
                      qk_rope_head_dim=c["qk_rope_head_dim"],
                      v_head_dim=c["v_head_dim"]),
        yarn=yarn,
        routing=RoutingConfig(
            dropless=True,
            router_experts=share.get("router_experts", 0),
            first_expert=share.get("first_expert", 0),
            renormalize=c["norm_topk_prob"],
            routed_scale=float(c["routed_scaling_factor"]),
            seq_aux=c["seq_aux"]),
        dtype=dtype, remat=remat)
