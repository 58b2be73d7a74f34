"""The moe family (DeepSeek-V2-style: latent attention, a leading dense
layer, routed and shared experts): the port's model configuration from a
configuration file under the published ``config.json``'s key names, the
benchmark's weight scale of each leaf, and the model FLOPs of a train
step (for the mfu metric: 2 per multiply-add of each matrix product a
token needs, the routed experts at the rows they expect, recompute not
counted).  The file's ``n_routed_experts`` counts the experts this chip
holds and ``expert_share`` places them among the router's.  Its plain
reference is ``reference/moe.py``."""
from __future__ import annotations

from typing import Tuple

from hero_bench.costs import visible_pairs


def model_config(c: dict):
    """A moe configuration file -> the port's ``DeepSeekConfig``, routed
    dropless over the chip's share."""
    from repro_torch.models.options import deepseek_from_hf
    return deepseek_from_hf(c, name=c["name"], dtype=c["dtype"],
                            remat=c["run"]["remat"])


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def init_scale(name: str, shape: Tuple[int, ...], conf: dict) -> float:
    """0 marks ones (the norm scales, MLA's ``kv_norm`` among them), else
    the normal's scale by the leaf's fan-in: the routed experts' (E, d,
    ff) and (E, ff, d) by their second axis, ``wo`` (h, e, d) by h·e, the
    untied embedding at unit scale (each row is normed before use)."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1:
        return 0.0
    if leaf == "embed":
        return 1.0
    if leaf == "wo":
        return (shape[0] * shape[1]) ** -0.5
    if leaf in EXPERT_LEAVES and len(shape) == 3:
        return shape[1] ** -0.5
    return shape[0] ** -0.5


def attention_params(m: dict) -> int:
    d, h, r = m["hidden_size"], m["num_attention_heads"], m["kv_lora_rank"]
    en, er, ev = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                  m["v_head_dim"])
    return d * h * (en + er) + d * (r + er) + r * h * en + r * h * ev \
        + h * ev * d


def matmul_params(m: dict) -> float:
    """Multiply-adds a token needs in the blocks and the head: attention
    in every layer, the dense layers' MLP, and in each expert layer the
    shared experts, the router and the held experts at the share of the
    router's top-k choices they expect (k x held / router_experts)."""
    d = m["hidden_size"]
    nk, L = m["first_k_dense_replace"], m["num_hidden_layers"]
    ff = m["moe_intermediate_size"]
    E = m["expert_share"]["router_experts"]
    held = m["n_routed_experts"]
    routed = m["num_experts_per_tok"] * held / E
    expert = (3 * d * ff * m["n_shared_experts"] + d * E
              + routed * 3 * d * ff)
    return (L * attention_params(m) + nk * 3 * d * m["intermediate_size"]
            + (L - nk) * expert + d * m["vocab_size"])


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """6 per multiply-add a token (forward and backward) plus attention's
    QK (nope + rope wide) and PV (v wide) over the causal pairs, three
    times the forward's."""
    pairs = batch * visible_pairs(seq, seq, True, 0)
    width = m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"]
    attn_fwd = (2.0 * m["num_hidden_layers"] * m["num_attention_heads"]
                * width * pairs)
    return 6.0 * matmul_params(m) * batch * seq + 3.0 * attn_fwd
