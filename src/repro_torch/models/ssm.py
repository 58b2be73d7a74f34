"""Mamba2 (SSD) block — port of ``repro/models/ssm.py``: chunked scan for
the forward and prefill, and the single-token decode step.

The sequence is split into chunks of ``Q`` tokens.  Within a chunk the
output is a masked quadratic (attention-like) term and each chunk adds its
contribution to a ``(heads, head_dim, state)`` state; both go through the
kernel K5 (``ops.ssd_chunk``).  The state then flows from chunk to chunk
through a torch loop over the chunks.

Shapes: x (b, l, d); d_inner = expand·d; H = d_inner // P heads; the B/C
projections are per group (G groups, shared by H // G heads).  Parameters
and the decode state carry the JAX package's names and layouts:
``{"ssm": (b,H,P,N), "conv_x": (b,K-1,di), "conv_B", "conv_C": (b,K-1,G·N)}``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import chunk_cumsum
from repro_torch.models.layers import dense_init

Params = Mapping[str, torch.Tensor]
State = Dict[str, torch.Tensor]


def init_mamba2(d: int, s: SSMConfig, dtype: torch.dtype,
                generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Random weights with the reference's distributions."""
    di = s.expand * d
    H = di // s.head_dim
    gn = s.ngroups * s.state_size

    def dense(shape, scale=None):
        return dense_init(shape, dtype, generator, device, scale)

    return {
        "wz": dense((d, di)), "wx": dense((d, di)), "wB": dense((d, gn)),
        "wC": dense((d, gn)), "wdt": dense((d, H)),
        "dt_bias": torch.zeros(H, dtype=torch.float32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones(H, dtype=torch.float32, device=device),
        "conv_x": dense((s.conv_kernel, di)),
        "conv_B": dense((s.conv_kernel, gn)),
        "conv_C": dense((s.conv_kernel, gn)),
        "w_out": dense((di, d), scale=di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 state_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x (b,l,c), w (K,c); ``state`` (b,K-1,c) holds
    the last K-1 inputs for streaming decode.  ``state_len`` is the number
    of real (unpadded) positions: the new state is the last K-1 real
    inputs.  Returns (silu(y), new_state)."""
    K, l = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                       # (b, l+K-1, c)
    y = sum(xp[:, i:i + l] * w[i] for i in range(K))
    if K > 1:
        sl = l if state_len is None else state_len
        new_state = xp[:, sl:sl + K - 1]
    else:
        new_state = state
    return F.silu(y), new_state


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """(b,nc,Q,G,N) -> (b,nc,Q,G·rep,N), head h reading group h // rep: a
    stride-0 view for one group (what K5 reads in place), else a copy."""
    if t.shape[3] == 1:
        return t.expand(*t.shape[:3], rep, t.shape[4])
    return t.repeat_interleave(rep, dim=3)


@torch.no_grad()
def mamba2_forward(p: Params, x: torch.Tensor, s: SSMConfig, *,
                   init_state: Optional[State] = None,
                   return_state: bool = False
                   ) -> Tuple[torch.Tensor, Optional[State]]:
    """Chunked scan.  x (b,l,d); a length that is not a multiple of the
    chunk is padded, and the padded rows are made state-neutral by forcing
    dt = 0 there (decay 1, no contribution)."""
    b, l_real, d = x.shape
    di = s.expand * d
    H, P, N, G = di // s.head_dim, s.head_dim, s.state_size, s.ngroups
    Q = min(s.chunk_size, l_real)
    l = -(-l_real // Q) * Q
    if l != l_real:
        x = F.pad(x, (0, 0, 0, l - l_real))
    nc = l // Q
    dtype = x.dtype

    z = x @ p["wz"]
    xc = x @ p["wx"]
    Bc = x @ p["wB"]
    Cc = x @ p["wC"]
    dt_in = (x @ p["wdt"]).float() + p["dt_bias"]
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))     # softplus
    if l != l_real:
        dt = dt * (torch.arange(l, device=x.device) < l_real)[None, :, None]

    st = init_state or {}
    xc, ncx = _causal_conv(xc, p["conv_x"], st.get("conv_x"), l_real)
    Bc, ncB = _causal_conv(Bc, p["conv_B"], st.get("conv_B"), l_real)
    Cc, ncC = _causal_conv(Cc, p["conv_C"], st.get("conv_C"), l_real)

    A = -torch.exp(p["A_log"])                                 # (H,)
    xh = xc.reshape(b, nc, Q, H, P)
    Bg = _heads(Bc.reshape(b, nc, Q, G, N), H // G)
    Cg = _heads(Cc.reshape(b, nc, Q, G, N), H // G)
    dt = dt.reshape(b, nc, Q, H)
    dA = dt * A                                                # (b,nc,Q,H)

    # intra-chunk term and chunk states: the kernel K5
    y_intra, S = ops.ssd_chunk(xh, dt, Bg, Cg, dA)

    # inter-chunk recurrence over the nc chunk states
    dA_cum = chunk_cumsum(dA, dim=2)                           # (b,nc,Q,H)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])               # (b,nc,H)
    state = (init_state["ssm"].float() if init_state
             else torch.zeros((b, H, P, N), dtype=torch.float32,
                              device=x.device))
    prev = []
    for c in range(nc):
        prev.append(state)                 # the state *before* chunk c
        state = (state * chunk_decay[:, c, :, None, None]
                 + S[:, c].transpose(-1, -2))
    prev_states = torch.stack(prev, dim=1)                     # (b,nc,H,P,N)

    in_decay = torch.exp(dA_cum)                               # (b,nc,Q,H)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           Cg.float() * in_decay[..., None], prev_states)

    y = (y_intra + y_inter).reshape(b, l, H, P)
    y = y + p["D"][:, None] * xc.reshape(b, l, H, P).float()
    y = y.reshape(b, l, di).to(dtype)
    y = y * F.silu(z)
    out = y @ p["w_out"]
    if l != l_real:
        out = out[:, :l_real]
    if not return_state:
        return out, None
    # the cache holds the state in the model dtype, as the reference's
    return out, {"ssm": state.to(dtype), "conv_x": ncx, "conv_B": ncB,
                 "conv_C": ncC}


def mamba2_step(p: Params, x: torch.Tensor, s: SSMConfig,
                state: State) -> Tuple[torch.Tensor, State]:
    """Single-token decode.  x (b,1,d).  O(1) in the context length."""
    return mamba2_forward(p, x, s, init_state=state, return_state=True)


def init_mamba2_state(batch: int, d: int, s: SSMConfig, dtype: torch.dtype,
                      device: torch.device) -> State:
    di = s.expand * d
    H, P, N = di // s.head_dim, s.head_dim, s.state_size
    gn = s.ngroups * s.state_size
    K = s.conv_kernel

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"ssm": zeros(batch, H, P, N),
            "conv_x": zeros(batch, K - 1, di),
            "conv_B": zeros(batch, K - 1, gn),
            "conv_C": zeros(batch, K - 1, gn)}
