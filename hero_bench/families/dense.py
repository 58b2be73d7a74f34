"""The dense family (Qwen3-style GQA blocks): the port's model
configuration from a configuration file under Hugging Face key names,
the benchmark's weight scale of each leaf, and the model FLOPs of a
train step (for the mfu metric: 2 per multiply-add of each matrix
product a token needs, recompute not counted).  Its plain reference is
``reference/dense.py``."""
from __future__ import annotations

from typing import Tuple

from hero_bench.costs import visible_pairs


def model_config(c: dict):
    """A dense configuration file -> ``ModelConfig``."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=c["name"], family="dense", num_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        tie_embeddings=c["tie_word_embeddings"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        remat=c["run"]["remat"], dtype=c["dtype"])


def init_scale(name: str, shape: Tuple[int, ...], conf: dict) -> float:
    """0 marks ones (norm scales), else the normal's scale; the leaf names
    are the program's (``lm.py``'s module docstring).  A tied embedding
    is drawn at hidden_size**-0.5: at unit scale its row of the current
    token outweighs every other logit."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        return 0.0
    if leaf == "embed":
        return shape[1] ** -0.5 if conf["tie_word_embeddings"] else 1.0
    if leaf == "wo":                       # (h, e, d)
        return (shape[0] * shape[1]) ** -0.5
    return shape[0] ** -0.5


def matmul_params(m: dict) -> int:
    """Multiply-adds a token needs in the blocks and the vocabulary head
    (the embedding lookup is none)."""
    d, h, n = m["hidden_size"], m["num_attention_heads"], \
        m["num_key_value_heads"]
    e, f = m["head_dim"], m["intermediate_size"]
    attn = d * h * e + 2 * d * n * e + h * e * d
    return m["num_hidden_layers"] * (attn + 3 * d * f) \
        + d * m["vocab_size"]


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """6 per multiply-add a token (forward and backward) plus attention's
    QK and PV over the causal pairs, three times the forward's."""
    pairs = batch * visible_pairs(seq, seq, True, 0)
    attn_fwd = (2.0 * m["num_hidden_layers"] * m["num_attention_heads"]
                * 2 * m["head_dim"] * pairs)
    return 6.0 * matmul_params(m) * batch * seq + 3.0 * attn_fwd
