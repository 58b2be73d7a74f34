"""Mixture-of-Experts with capacity-based scatter dispatch (GShard-style)
— port of ``repro/models/moe.py``.

A softmax router in f32 picks the top-k experts of each token and
renormalises their gates; each assignment takes the next slot of its
expert's queue, in the flattened (token, choice) order, and one whose slot
is past the capacity ``C`` is dropped (the token keeps its residual).
Tokens are scattered into an ``(E, C, d)`` buffer, run through the
batched expert FFN (``torch.bmm``: a plain product that the JAX package
leaves to XLA, outside any Pallas kernel) and gathered back weighted by
their gates; shared experts see every token.  Like the reference, every
call runs all E experts over their C slots, so it reads every expert's
weights.  Returns the switch-style load-balance loss as well.

:func:`moe_ffn_dropless` (``RoutingConfig.dropless``, ``models/options.py``)
drops nothing: the layer holds ``num_experts`` experts from
``first_expert`` on, of the router's ``router_experts`` (one chip's share
under expert parallelism, without the exchange).  The assignments to held
experts are sorted by expert and run as grouped products over each
expert's exact rows, then weighted by their gates and added back to their
tokens; what the absent experts would add is left out.  Its three phases
record the spans ``moe.route``, ``moe.experts`` and ``moe.combine``, and
:data:`EXPERT_ROWS` counts the rows each held expert took.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.spans import (SPAN_MOE_COMBINE, SPAN_MOE_EXPERTS,
                                    SPAN_MOE_ROUTE, span)
from repro_torch.models.layers import dense_init
from repro_torch.models.options import RoutingConfig
from repro_torch.models.sharding import batch_rows, constrain

Params = Mapping[str, torch.Tensor]


def init_moe(d: int, cfg: MoEConfig, dtype: torch.dtype,
             generator: torch.Generator, device: torch.device,
             router_experts: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights with the reference's distributions; the shared
    experts' leaves are ``shared_w_gate``, ``shared_w_up`` and
    ``shared_w_down`` (the reference's ``shared: {w_gate, w_up,
    w_down}``).  The router scores ``router_experts`` (a share's whole
    layer) or, if 0, the ``num_experts`` held."""
    E, ff = cfg.num_experts, cfg.d_ff

    def dense(shape, dt=dtype):
        return dense_init(shape, dt, generator, device)

    p = {"router": dense((d, router_experts or E), torch.float32),
         "w_gate": dense((E, d, ff)), "w_up": dense((E, d, ff)),
         "w_down": dense((E, ff, d))}
    if cfg.num_shared_experts:
        sff = ff * cfg.num_shared_experts
        p.update(shared_w_gate=dense((d, sff)), shared_w_up=dense((d, sff)),
                 shared_w_down=dense((sff, d)))
    return p


def _router(p: Params, x2: torch.Tensor, cfg: MoEConfig,
            routing: RoutingConfig = RoutingConfig(), b: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 (T, d), the rows of b sequences -> gates (T, k) in f32, idx (T,
    k) over the router's experts, aux (scalar): the switch-style loss over
    the first choice, or with ``routing.seq_aux`` DeepSeek-V2's
    sequence-wise loss, ``alpha · mean_b Σ_e f_be · P_be`` with f_be the
    share of sequence b's k·s choices that picked e, times E, and P_be the
    mean probability of e over its tokens."""
    probs = torch.softmax(x2.float() @ p["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    if routing.renormalize:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    if routing.routed_scale != 1.0:
        gates = gates * routing.routed_scale
    T, E = probs.shape
    if routing.seq_aux:
        s, k = T // b, cfg.top_k
        picks = torch.zeros(b, E, device=x2.device).scatter_add_(
            1, idx.reshape(b, s * k), torch.ones(b, s * k, device=x2.device))
        aux = (picks * (E / (s * k)) * probs.reshape(b, s, E).mean(1)
               ).sum(1).mean() * cfg.router_aux_loss
        return gates, idx, aux
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_loss
    return gates, idx, aux


def capacity(T: int, cfg: MoEConfig, capacity_factor: float) -> int:
    """Slots per expert: ``T·k·cf / E`` rounded up, at least 8, rounded up
    to a multiple of 8 (the reference's static shape)."""
    C = int(max(8, -(-int(T * cfg.top_k * capacity_factor)
                     // cfg.num_experts)))
    return -(-C // 8) * 8


def dispatch(idx: torch.Tensor, E: int, C: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx (T, k) -> (slot, keep) per flattened assignment: its position
    in its expert's queue (an exclusive running count in (token, choice)
    order) and whether that is below C."""
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    slot = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
    return slot, slot < C


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig, *,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    T, E, k = b * s, cfg.num_experts, cfg.top_k
    # the rows keep x's batch layout, the gradient's too (sharding.py)
    x2 = batch_rows(x.reshape(T, d), b)
    gates, idx, aux = _router(p, x2, cfg)
    gates = gates.to(x2.dtype)
    C = capacity(T, cfg, capacity_factor)
    flat_e, flat_g = idx.reshape(-1), gates.reshape(-1)
    slot, keep = dispatch(idx, E, C)
    src = torch.arange(T, device=x.device).repeat_interleave(k)

    # the kept assignments into their (expert, slot), each pair unique; a
    # dropped one adds 0 at slot 0, as the reference's scatter-add does
    # (no mask selects the kept ones, so no shape depends on the data)
    slot_c = torch.where(keep, slot, 0)
    upd = torch.where(keep[:, None], x2[src], 0)
    grouped = x.new_zeros((E, C, d)).index_put_((flat_e, slot_c), upd,
                                                accumulate=True)
    # decode (few tokens): d over "data" keeps the expert weights
    # stationary; prefill and train keep d whole (the reference's layout)
    grouped = constrain(grouped, ("model", None, "data") if T <= 4096
                        else ("model", None, None))

    act = F.silu(torch.bmm(grouped, p["w_gate"])) * torch.bmm(grouped,
                                                              p["w_up"])
    out_g = torch.bmm(act, p["w_down"])                        # (E, C, d)

    # gather back with gate weighting: token t's k rows are contiguous
    picked = out_g[flat_e, slot_c]
    picked = torch.where(keep[:, None], picked, 0) * flat_g[:, None]
    y = picked.reshape(T, k, d).sum(1)

    if "shared_w_gate" in p:
        h = F.silu(x2 @ p["shared_w_gate"]) * (x2 @ p["shared_w_up"])
        y = y + h @ p["shared_w_down"]
    return batch_rows(y, b).reshape(b, s, d), aux


class ExpertRows:
    """Rows each held expert took, by layer: device tensors added to
    without a host sync in the forward (not again in remat's recompute,
    which runs inside the backward), read to the host by :meth:`read`."""

    def __init__(self):
        self._rows: Dict[int, torch.Tensor] = {}

    def add(self, layer: int, counts: torch.Tensor) -> None:
        """A layer's count restarts where another model's layer (another
        device or number of held experts) takes its place."""
        if torch._C._current_graph_task_id() != -1:
            return
        rows = self._rows.get(layer)
        if rows is None or rows.device != counts.device \
                or rows.shape != counts.shape:
            self._rows[layer] = counts.detach().clone()
        else:
            rows.add_(counts)

    def read(self) -> Dict[int, List[int]]:
        return {k: v.tolist() for k, v in sorted(self._rows.items())}

    def reset(self) -> None:
        self._rows.clear()


EXPERT_ROWS = ExpertRows()


def grouped_mm(a: torch.Tensor, w: torch.Tensor, ends: torch.Tensor,
               ends_host: List[int]) -> torch.Tensor:
    """a (n, k) in row groups ending at ``ends`` (G,) (on the host too:
    ``ends_host``) times w (G, k, m) group by group -> (n, m).  bf16 runs
    ``torch._grouped_mm`` (one launch, the group ends read on the
    device); other dtypes, which it does not take, one product a group."""
    if a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, w, offs=ends.to(torch.int32))
    sizes = [e - s for s, e in zip([0, *ends_host[:-1]], ends_host)]
    return torch.cat([ag @ w[g] for g, ag in enumerate(a.split(sizes))])


def _to_host(ends: torch.Tensor) -> Callable[[], List[int]]:
    """Starts copying ``ends`` to the host; -> a function that waits for
    the copy and returns it as a list."""
    if ends.device.type != "cuda":
        return ends.tolist
    host = torch.empty(ends.shape, dtype=ends.dtype, pin_memory=True)
    host.copy_(ends, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def wait() -> List[int]:
        copied.synchronize()
        return host.tolist()
    return wait


def moe_ffn_dropless(p: Params, x: torch.Tensor, cfg: MoEConfig,
                     routing: RoutingConfig, layer: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, d) -> (y, aux_loss), every assignment to a held expert
    computed.  The count of those assignments is read to the host (one
    sync a call): it sizes the gathered rows, so no row is padded.  The
    shared experts, which need no routing, are queued before the host
    waits for it, so the device works on them meanwhile."""
    b, s, d = x.shape
    T, H, k = b * s, cfg.num_experts, cfg.top_k
    x2 = x.reshape(T, d)
    with span(SPAN_MOE_ROUTE):
        gates, idx, aux = _router(p, x2, cfg, routing, b)
        local = idx.reshape(-1) - routing.first_expert
        key = torch.where((local >= 0) & (local < H), local, H)
        key, order = torch.sort(key, stable=True)
        ends = torch.searchsorted(key, torch.arange(
            1, H + 1, device=x.device, dtype=key.dtype))
        EXPERT_ROWS.add(layer, ends.diff(prepend=ends.new_zeros(1)))
        wait = _to_host(ends)
    shared = None
    if "shared_w_gate" in p:
        h = F.silu(x2 @ p["shared_w_gate"]) * (x2 @ p["shared_w_up"])
        shared = h @ p["shared_w_down"]
    with span(SPAN_MOE_ROUTE):
        ends_host = wait()
        rows = order[:ends_host[-1]]
        tok = rows // k
        xs = x2[tok]
    with span(SPAN_MOE_EXPERTS):
        act = F.silu(grouped_mm(xs, p["w_gate"], ends, ends_host)) \
            * grouped_mm(xs, p["w_up"], ends, ends_host)
        out = grouped_mm(act, p["w_down"], ends, ends_host)
    with span(SPAN_MOE_COMBINE):
        w = gates.reshape(-1)[rows]
        y = x2.new_zeros((T, d), dtype=torch.float32).index_add_(
            0, tok, out.float() * w[:, None]).to(x.dtype)
    if shared is not None:
        y = y + shared
    return y.reshape(b, s, d), aux
