"""xLSTM blocks — port of ``repro/models/xlstm.py``: the mLSTM (matrix
memory, chunkwise-parallel) and the sLSTM (scalar memory, a sequential
scan), following arXiv:2405.04517.  The JAX package has no kernel here,
so this is plain torch on either device.

mLSTM state: ``C (b,H,P,P)`` matrix memory, ``n (b,H,P)`` normaliser and
``m (b,H)`` log-space stabiliser, all f32, plus the causal conv's last
``K-1`` inputs; H = expand·d / head_dim heads of P = head_dim (xlstm-350m:
8 heads of 256, whatever its ``num_heads``).  The chunkwise form runs
chunks of Q tokens: a masked quadratic term inside a chunk plus the
carried state, then the chunk-end state update.  A length that is not a
multiple of Q is padded, the padded steps made state-neutral (input gate
log -1e30, forget gate logit 30).  sLSTM state: ``c, n, h, m (b,d)`` f32.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.ssm import _causal_conv

Params = Mapping[str, torch.Tensor]
State = Dict[str, torch.Tensor]
NEG = -1e30             # the reference's "log 0"


def _heads(d: int, s: SSMConfig) -> Tuple[int, int]:
    return max(s.expand * d // s.head_dim, 1), s.head_dim


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(d: int, s: SSMConfig, dtype: torch.dtype,
               generator: torch.Generator,
               device: torch.device) -> Dict[str, torch.Tensor]:
    di = s.expand * d
    H, _ = _heads(d, s)

    def dense(shape, dt=dtype, scale=None):
        return dense_init(shape, dt, generator, device, scale)

    bias = torch.cat([torch.zeros(H), 3.0 + torch.arange(H) * 0.5])
    return {"wq": dense((d, di)), "wk": dense((d, di)), "wv": dense((d, di)),
            "wgate": dense((d, 2 * H), torch.float32),   # i, f gate logits
            "gate_bias": bias.to(device=device, dtype=torch.float32),
            "conv": dense((s.conv_kernel, di)),
            "w_out": dense((di, d), scale=di ** -0.5)}


def _mlstm_chunk(q, k, v, ig, fg, state):
    """One chunk of the stabilised chunkwise mLSTM.

    q/k/v (b,Q,H,P); ig/fg (b,Q,H) gate log-values; state (C, n, m).
    Returns (h (b,Q,H,P) f32, new_state)."""
    b, Q, H, P = q.shape
    C0, n0, m0 = state
    lf = F.logsigmoid(fg)
    Fc = torch.cumsum(lf, dim=1)                           # inclusive
    # intra-chunk log decay D[i, j] = F_i - F_j + ig_j (j <= i), -inf above
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + ig[:, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    logD = logD.masked_fill(~mask[None, :, :, None], float("-inf"))
    log_inter = Fc + m0[:, None, :]                        # (b,Q,H)
    m_new = torch.maximum(logD.amax(dim=2), log_inter).clamp_min(NEG)
    D = torch.exp(logD - m_new[:, :, None, :])
    inter_w = torch.exp(log_inter - m_new)

    qf = q.float() / float(P) ** 0.5
    kf, vf = k.float(), v.float()
    scores = torch.einsum("bqhp,bkhp->bqkh", qf, kf) * D
    num = (torch.einsum("bqkh,bkhp->bqhp", scores, vf)
           + inter_w[..., None] * torch.einsum("bqhp,bhpe->bqhe", qf, C0))
    den = (scores.sum(dim=2)
           + inter_w * torch.einsum("bqhp,bhp->bqh", qf, n0))
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]

    Fend = Fc[:, -1, :]                                    # (b,H)
    m_end = torch.maximum(Fend + m0, (Fc[:, -1:, :] - Fc + ig).amax(dim=1))
    w_prev = torch.exp(Fend + m0 - m_end)
    w_tok = torch.exp(Fend[:, None] - Fc + ig - m_end[:, None])
    C1 = (w_prev[..., None, None] * C0
          + torch.einsum("bqh,bqhp,bqhe->bhpe", w_tok, kf, vf))
    n1 = w_prev[..., None] * n0 + torch.einsum("bqh,bqhp->bhp", w_tok, kf)
    return h, (C1, n1, m_end)


@torch.no_grad()
def mlstm_forward(p: Params, x: torch.Tensor, s: SSMConfig, *,
                  init_state: Optional[State] = None,
                  return_state: bool = False
                  ) -> Tuple[torch.Tensor, Optional[State]]:
    """x (b,l,d) in chunks of ``min(chunk_size, l)``, the last padded."""
    b, l_real, d = x.shape
    di = s.expand * d
    H, P = _heads(d, s)
    Q = min(s.chunk_size, l_real)
    l = -(-l_real // Q) * Q
    if l != l_real:
        x = F.pad(x, (0, 0, 0, l - l_real))
    nc, dtype = l // Q, x.dtype

    gates = x.float() @ p["wgate"] + p["gate_bias"]
    ig, fg = gates[..., :H], gates[..., H:]
    if l != l_real:
        valid = (torch.arange(l, device=x.device) < l_real)[None, :, None]
        ig = torch.where(valid, ig, NEG)
        fg = torch.where(valid, fg, 30.0)     # log_sigmoid(30) ~ 0
    conv_s = init_state["conv"] if init_state else None
    xq, new_conv = _causal_conv(x @ p["wq"], p["conv"], conv_s,
                                state_len=l_real)
    q = xq.reshape(b, l, H, P)
    k = (x @ p["wk"]).reshape(b, l, H, P)
    v = (x @ p["wv"]).reshape(b, l, H, P)

    if init_state is not None:
        st = tuple(init_state[key].float() for key in "Cnm")
    else:
        st = (torch.zeros((b, H, P, P), device=x.device),
              torch.zeros((b, H, P), device=x.device),
              torch.full((b, H), NEG, device=x.device))
    hs = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        h, st = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], ig[:, sl],
                             fg[:, sl], st)
        hs.append(h)
    h = torch.cat(hs, dim=1).reshape(b, l, di).to(dtype)
    out = h @ p["w_out"]
    if l != l_real:
        out = out[:, :l_real]
    if not return_state:
        return out, None
    C1, n1, m1 = st
    return out, {"C": C1, "n": n1, "m": m1, "conv": new_conv}


def init_mlstm_state(batch: int, d: int, s: SSMConfig, dtype: torch.dtype,
                     device: torch.device) -> State:
    H, P = _heads(d, s)
    return {"C": torch.zeros((batch, H, P, P), device=device),
            "n": torch.zeros((batch, H, P), device=device),
            "m": torch.full((batch, H), NEG, device=device),
            "conv": torch.zeros((batch, s.conv_kernel - 1, s.expand * d),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(d: int, dtype: torch.dtype, generator: torch.Generator,
               device: torch.device) -> Dict[str, torch.Tensor]:
    def dense(shape):
        return dense_init(shape, dtype, generator, device)

    return {"W": dense((d, 4 * d)),        # i, f, z, o input weights
            "R": dense((d, 4 * d)),        # recurrent weights
            "bias": torch.zeros(4 * d, device=device),
            "w_out": dense((d, d))}


@torch.no_grad()
def slstm_forward(p: Params, x: torch.Tensor, *,
                  init_state: Optional[State] = None,
                  return_state: bool = False
                  ) -> Tuple[torch.Tensor, Optional[State]]:
    """A sequential scan over time.  x (b,l,d)."""
    b, l, d = x.shape
    dtype = x.dtype
    if init_state is not None:
        c, n, h, m = (init_state[key].float() for key in "cnhm")
    else:
        c = n = h = torch.zeros((b, d), device=x.device)
        m = torch.full((b, d), NEG, device=x.device)
    wx = (x @ p["W"]).float() + p["bias"]
    hs = []
    for t in range(l):
        # h is cast to the model dtype before R on every step
        g = wx[:, t] + (h.to(dtype) @ p["R"]).float()
        gi, gf, gz, go = g.chunk(4, dim=-1)
        m_new = torch.maximum(gf + m, gi)                 # exp-gate stabiliser
        i = torch.exp(gi - m_new)
        f = torch.exp(gf + m - m_new)
        c = f * c + i * torch.tanh(gz)
        n = f * n + i
        h = torch.sigmoid(go) * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).to(dtype) @ p["w_out"]
    if not return_state:
        return out, None
    return out, {"c": c, "n": n, "h": h, "m": m}


def init_slstm_state(batch: int, d: int, device: torch.device) -> State:
    z = torch.zeros((batch, d), device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full((batch, d), NEG, device=device)}
