"""Operations and bytes of the port's attention kernel (K2) and its
backward, from the shapes of each call, and the model FLOPs of a train
step from the configuration.  The kernels' arithmetic is that of
``repro_torch.kernels.ops._flash_cost`` / ``flash_bwd_cost``, copied
here and frozen so that a change to the program cannot change the
yardstick.  Each input byte counts as read
once and each output byte as written once; causal work counts only the
visible pairs."""
from __future__ import annotations

from dataclasses import dataclass

from hero_bench import peaks


@dataclass(frozen=True)
class Cost:
    flops: float
    nbytes: float
    dtype: str          # the arithmetic type that prices the flops

    def bound_s(self) -> float:
        """Least time on the chip: the larger of the compute and the
        memory bound."""
        return max(self.flops / peaks.flops_peak(self.dtype),
                   self.nbytes / peaks.HBM_BYTES_PER_S)


def visible_pairs(sq: int, kv_len: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs a causal mask leaves, query i at q_offset + i."""
    if not causal:
        return sq * kv_len
    total = 0
    for i in range(sq):
        total += max(0, min(kv_len, q_offset + i + 1))
    return total


def k2_forward(b: int, sq: int, h: int, n: int, e: int, ev: int,
               kv_len: int, causal: bool, q_offset: int, itemsize: int,
               dtype: str, lse: bool = False) -> Cost:
    """K2 (flash attention): QK over e and PV over ev on the visible
    pairs; q and the output once, the first kv_len K/V rows once (and
    the f32 LSE where the training forward writes it)."""
    flops = 2 * b * h * (e + ev) * visible_pairs(sq, kv_len, causal,
                                                 q_offset)
    nbytes = ((b * sq * h * e + b * sq * h * ev) * itemsize
              + b * kv_len * n * (e + ev) * itemsize
              + (4 * b * h * sq if lse else 0))
    return Cost(flops, nbytes, dtype)


def k2_backward(b: int, sq: int, h: int, n: int, e: int, ev: int,
                kv_len: int, causal: bool, q_offset: int, itemsize: int,
                dtype: str) -> Cost:
    """K2's backward: S recomputed, dQ and dK over e, dP and dV over ev
    (2·pairs·h·b·(3e + 2ev)); q, k, v, o, do and the LSE read once, dq,
    dk, dv written once."""
    flops = 2 * b * h * (3 * e + 2 * ev) * visible_pairs(sq, kv_len, causal,
                                                         q_offset)
    qb = b * sq * h * e * itemsize
    ob = b * sq * h * ev * itemsize
    kb = b * kv_len * n * e * itemsize
    vb = b * kv_len * n * ev * itemsize
    return Cost(flops, 2 * (qb + ob + kb + vb) + 4 * b * h * sq, dtype)


# ---------------------------------------------------------------------------
# model FLOPs (for the mfu metric): 2 per multiply-add of each matrix
# product a token needs, recompute not counted
# ---------------------------------------------------------------------------

def dense_matmul_params(m: dict) -> int:
    """Multiply-adds a token needs in a dense model's blocks and its
    vocabulary head (the embedding lookup is none)."""
    d, h, n = m["hidden_size"], m["num_attention_heads"], \
        m["num_key_value_heads"]
    e, f = m["head_dim"], m["intermediate_size"]
    attn = d * h * e + 2 * d * n * e + h * e * d
    return m["num_hidden_layers"] * (attn + 3 * d * f) \
        + d * m["vocab_size"]


def dense_train_step_flops(m: dict, batch: int, seq: int) -> float:
    """6 per multiply-add a token (forward and backward) plus attention's
    QK and PV over the causal pairs, three times the forward's."""
    pairs = batch * visible_pairs(seq, seq, True, 0)
    attn_fwd = (2.0 * m["num_hidden_layers"] * m["num_attention_heads"]
                * 2 * m["head_dim"] * pairs)
    return 6.0 * dense_matmul_params(m) * batch * seq + 3.0 * attn_fwd
