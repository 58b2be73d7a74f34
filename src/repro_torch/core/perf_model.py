"""Heterogeneous performance models (paper §3.2).

Three layers, faithful to the paper's methodology:

1. **Ground-truth hardware model** — an analytic roofline cost per
   (stage, PU, shape) built from the PU specs (Table 2 SoCs, or TPU-v5e
   slices) plus per-PU efficiency curves and per-invocation overheads.
   This is what the *simulator* executes (it plays the role of the phone).

2. **Profiled estimates** — the paper profiles sampled measurements and
   fits a multi-feature linear regression (§5, following Band/CoDL).  We do
   exactly that: sample the ground truth on a grid of (workload size, batch
   shape, background bandwidth) and fit ``p^0_v(c)``, ``b_v(c)`` and
   ``φ_v(B)``.  The *scheduler* only ever sees these fitted estimates, so
   modeling error is part of the evaluation, as on real hardware.

3. **Contention model** — ``φ_v(B)``: monotone slowdown in aggregate
   bandwidth demand ``B(t)``; per-stage sensitivity (Eq. 1).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# processing units
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PU:
    """One processing unit (mobile accelerator or TPU mesh slice)."""

    name: str
    kind: str                  # cpu | gpu | npu | tpu_slice | io
    peak_flops: float          # effective FLOP/s at the stage dtype
    # fraction of DRAM bandwidth this PU can pull when alone
    mem_bw: float              # bytes/s
    # per-invocation overhead (s): graph launch / shape switch
    overhead: float = 1e-4
    # extra overhead per *token step* for streaming decode (NPU pays shape
    # switches per step; this is what makes generation GPU-affine, Fig. 2)
    step_overhead: float = 0.0
    # compute efficiency by workload kind
    eff_batch: float = 0.5     # batchable fixed-shape stages
    eff_stream: float = 0.5    # autoregressive decode
    # effective DRAM-bandwidth utilization for token-by-token streaming
    # (NPU runtimes pay per-step graph swaps + dequant pipeline stalls —
    # this is what makes LLM *generation* GPU-affine, Fig. 2, and why
    # mllm.npu-style systems decode off-NPU)
    mem_eff_stream: float = 0.85
    # native tile size: batch shapes off the tile grid lose efficiency
    # (shape sensitivity, Fig. 2) — sawtooth efficiency curve
    tile: int = 8
    tile_penalty: float = 0.35
    # batch sweet spot: beyond it, per-item efficiency *degrades* (compiled-
    # graph pipelining breaks, activations spill on-chip memory) — Fig. 2's
    # "larger batches do not always yield better per-item efficiency".
    batch_sweet: int = 64
    spill: float = 0.5
    # bytes of PU-local KV arena the runtime pins for resident caches
    # (paged-KV tier 0); 0 = unbounded (tiering effectively off for this PU)
    kv_arena: float = 0.0


@dataclass(frozen=True)
class SoCSpec:
    name: str
    pus: Tuple[PU, ...]
    dram_bw: float             # shared B0, bytes/s
    # φ shape parameters: φ(B) = 1 + gamma * max(0, B/B0 - knee)^2
    phi_knee: float = 0.20
    phi_gamma: float = 3.0
    # paged-KV spill tiers: shared-DRAM pool bytes reserved for evicted KV
    # pages (tier 1) and the storage read bandwidth behind the disk tier
    # (tier 2, UFS-class).  0 = unbounded pool / a conservative fraction of
    # DRAM bandwidth for the disk path.
    kv_dram_pool: float = 0.0
    disk_bw: float = 0.0

    def pu(self, name: str) -> PU:
        for p in self.pus:
            if p.name == name:
                return p
        raise KeyError(name)


def snapdragon_8gen3() -> SoCSpec:
    """Redmi K80 (Table 2).  FLOPs are INT8-effective (models are INT8)."""
    bw = 76.8e9
    return SoCSpec(
        name="sd8gen3",
        pus=(
            PU("cpu", "cpu", peak_flops=140e9, mem_bw=0.55 * bw,
               overhead=3e-5, step_overhead=1e-5, eff_batch=0.55,
               eff_stream=0.60, mem_eff_stream=0.70, tile=4,
               tile_penalty=0.15, batch_sweet=128, spill=0.15,
               kv_arena=384e6),
            PU("gpu", "gpu", peak_flops=2.8e12, mem_bw=0.80 * bw,
               overhead=8e-4, step_overhead=2e-4, eff_batch=0.15,
               eff_stream=0.50, mem_eff_stream=0.35, tile=16,
               tile_penalty=0.30, batch_sweet=48, spill=0.55,
               kv_arena=512e6),
            PU("npu", "npu", peak_flops=34e12, mem_bw=0.85 * bw,
               overhead=4e-3, step_overhead=3e-3, eff_batch=0.52,
               eff_stream=0.30, mem_eff_stream=0.30, tile=32,
               tile_penalty=0.45, batch_sweet=32, spill=0.85,
               kv_arena=256e6),
        ),
        dram_bw=bw, kv_dram_pool=2e9, disk_bw=3.5e9)


def snapdragon_8gen4() -> SoCSpec:
    """OnePlus 13 / 8 Elite (Table 2)."""
    bw = 84.8e9
    return SoCSpec(
        name="sd8gen4",
        pus=(
            PU("cpu", "cpu", peak_flops=210e9, mem_bw=0.55 * bw,
               overhead=2.5e-5, step_overhead=8e-6, eff_batch=0.58,
               eff_stream=0.62, mem_eff_stream=0.75, tile=4,
               tile_penalty=0.15, batch_sweet=128, spill=0.15,
               kv_arena=384e6),
            PU("gpu", "gpu", peak_flops=3.4e12, mem_bw=0.80 * bw,
               overhead=7e-4, step_overhead=1.6e-4, eff_batch=0.22,
               eff_stream=0.52, mem_eff_stream=0.50, tile=16,
               tile_penalty=0.30, batch_sweet=48, spill=0.55,
               kv_arena=512e6),
            PU("npu", "npu", peak_flops=50e12, mem_bw=0.85 * bw,
               overhead=3.5e-3, step_overhead=2.5e-3, eff_batch=0.55,
               eff_stream=0.32, mem_eff_stream=0.30, tile=32,
               tile_penalty=0.45, batch_sweet=32, spill=0.85,
               kv_arena=256e6),
        ),
        dram_bw=bw, kv_dram_pool=2e9, disk_bw=3.5e9)


def tpu_v5e_slices(slices: Dict[str, int]) -> SoCSpec:
    """TPU deployment: PU groups = disjoint mesh slices of a v5e pod.

    slices: {"slice_name": n_chips}.  The shared domain here is the pod's
    host-DMA/ICI fabric for inter-stage tensor handoff; per-chip HBM scales
    with the slice, so mem_bw = chips * 819 GB/s.
    """
    pus = []
    for name, chips in slices.items():
        pus.append(PU(
            name, "tpu_slice",
            peak_flops=chips * 394e12,     # int8 ~= 2x bf16 197 TFLOP/s
            mem_bw=chips * 819e9,
            overhead=2e-5 + 3e-6 * chips,  # dispatch + sync grows with slice
            step_overhead=6e-6,
            eff_batch=0.55, eff_stream=0.45, tile=8 * chips,
            tile_penalty=0.30))
    # inter-slice fabric ~ 50 GB/s/link * bisection links of smallest slice
    fabric = 50e9 * max(4, min(slices.values()))
    return SoCSpec(name="tpu_v5e_pod", pus=tuple(pus), dram_bw=fabric,
                   phi_knee=0.7, phi_gamma=4.0)


# ---------------------------------------------------------------------------
# stage workload characterization
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StageModel:
    """Static description of one RAG stage's compute (from its ModelConfig)."""

    name: str                   # e.g. "qwen3-embedding-0.6b"
    params: int                 # parameter count
    d_model: int
    kind: str                   # "batchable" | "stream_prefill" | "stream_decode" | "search" | "io"
    bytes_per_param: float = 1.0   # INT8
    # batchable: per-item token count; streaming: tokens handled elsewhere
    item_tokens: int = 128
    # KV-cache bytes appended per token (2 · layers · kv_heads · head_dim ·
    # bytes for a GQA transformer); 0 selects the d_model fallback below —
    # what KV-residency tracking and the migration-cost model charge
    kv_bytes_token: float = 0.0

    def kv_bytes_per_token(self) -> float:
        """Bytes of K+V cache one context token occupies on its PU."""
        return self.kv_bytes_token or 2.0 * self.d_model * self.bytes_per_param

    def flops(self, n_items: int, tokens: Optional[int] = None) -> float:
        t = tokens if tokens is not None else n_items * self.item_tokens
        if self.kind == "search":
            # vector search: 2*N*d per query (n_items = corpus size)
            return 2.0 * n_items * self.d_model
        return 2.0 * self.params * t

    def bytes_moved(self, n_items: int, tokens: Optional[int] = None) -> float:
        w = self.params * self.bytes_per_param
        if self.kind == "search":
            return n_items * self.d_model * 1.0  # int8 corpus scan
        if self.kind == "stream_decode":
            t = tokens if tokens is not None else n_items
            return w * t               # weights re-read per token step
        return w + (tokens or n_items * self.item_tokens) * self.d_model


# ---------------------------------------------------------------------------
# ground-truth cost model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Config:
    """One scheduling configuration c ∈ C_v: target PU + workload shape."""
    pu: str
    batch: int                  # items (batchable) or token-group size (stream)
    # decode only: number of sequences resident in the dispatch (continuous
    # cross-query batching).  1 = the paper's single-stream decode.
    width: int = 1


def _shape_eff(pu: PU, batch: int) -> float:
    """Sawtooth tiling efficiency + large-batch spill (Fig. 2)."""
    if batch <= 0:
        return 1.0
    rem = batch % pu.tile
    eff = 1.0 if rem == 0 else 1.0 - pu.tile_penalty * (1.0 - rem / pu.tile)
    if batch > pu.batch_sweet:
        eff *= (pu.batch_sweet / batch) ** pu.spill
    return eff


class GroundTruthPerf:
    """Analytic p0 / bandwidth per (stage, PU, shape) — simulator substrate."""

    def __init__(self, soc: SoCSpec, stages: Dict[str, StageModel]):
        self.soc = soc
        self.stages = stages

    def supported(self, stage: StageModel, pu: PU) -> bool:
        if stage.kind == "io":
            return pu.kind == "io"
        if pu.kind == "io":
            return False
        if stage.kind == "search" and pu.kind == "npu":
            return False           # FAISS-style scan not NPU-supported (§6.1)
        return True

    def p0(self, stage: StageModel, pu: PU, c: Config,
           tokens: Optional[int] = None) -> float:
        """Base latency of ONE sub-stage pass at batch c.batch."""
        if stage.kind == "io":
            return 0.35            # web search round trip (s)
        n = c.batch
        eff = _shape_eff(pu, n)
        if stage.kind == "batchable":
            fl = stage.flops(n)
            by = stage.bytes_moved(n)
            t = max(fl / (pu.peak_flops * pu.eff_batch * eff),
                    by / pu.mem_bw)
            return t + pu.overhead
        if stage.kind == "stream_prefill":
            t_tok = tokens if tokens is not None else n
            fl = stage.flops(1, t_tok)
            by = stage.params * stage.bytes_per_param
            t = max(fl / (pu.peak_flops * pu.eff_batch * eff),
                    by / pu.mem_bw)
            return t + pu.overhead
        if stage.kind == "stream_decode":
            # token-group of size n: memory-bound weight sweep per token.
            # At width w > 1 (continuous cross-query batching) the per-step
            # weight sweep is SHARED by all w resident sequences — the
            # vLLM/RAGDoll serving lever — while compute scales with w and
            # pays the width tiling efficiency.
            w = max(c.width, 1)
            by = stage.params * stage.bytes_per_param * n
            fl = stage.flops(1, n) * w
            weff = _shape_eff(pu, w) if w > 1 else 1.0
            t = max(fl / (pu.peak_flops * pu.eff_stream * weff),
                    by / (pu.mem_bw * pu.mem_eff_stream))
            return t + pu.overhead + pu.step_overhead * n
        if stage.kind == "search":
            by = stage.bytes_moved(n)
            return by / min(pu.mem_bw, self.soc.dram_bw) + pu.overhead
        raise ValueError(stage.kind)

    def bandwidth(self, stage: StageModel, pu: PU, c: Config,
                  tokens: Optional[int] = None) -> float:
        """Average demand b_v(c) on the SHARED domain, bytes/s.

        Mobile SoC: all PU traffic hits the unified DRAM -> full bytes.
        TPU slices: HBM is slice-private; only inter-stage activation
        handoff crosses the shared fabric."""
        if stage.kind == "io":
            return 0.0
        t = self.p0(stage, pu, c, tokens)
        if pu.kind == "tpu_slice":
            acts = (tokens or c.batch * max(stage.item_tokens, 1)) \
                * max(stage.d_model, 1) * 2.0
            return acts / max(t, 1e-9)
        if stage.kind in ("batchable", "stream_prefill"):
            by = stage.bytes_moved(c.batch, tokens)
        elif stage.kind == "stream_decode":
            by = stage.params * stage.bytes_per_param * c.batch
        else:
            by = stage.bytes_moved(c.batch, tokens)
        return by / max(t, 1e-9)

    def link_bandwidth(self, src: PU, dst: PU) -> float:
        """Effective KV-copy bandwidth between two PUs (bytes/s).

        On a unified-memory SoC a cache migration is a read at the source
        PU's DMA rate followed by a write at the destination's, both over
        the shared bus — the harmonic combination, never above the bus
        itself.  TPU slices pay the inter-slice fabric the same way."""
        eff = 1.0 / (1.0 / src.mem_bw + 1.0 / dst.mem_bw)
        return min(eff, self.soc.dram_bw)

    def migrate_cost(self, stage: StageModel, src: PU, dst: PU,
                     ctx_tokens: int) -> float:
        """Seconds to move ``ctx_tokens`` of ``stage``'s KV cache from
        ``src`` to ``dst`` (uncontended; the bus contention multiplier is
        applied by the caller, like every other p0)."""
        if src.name == dst.name:
            return 0.0
        by = stage.kv_bytes_per_token() * max(ctx_tokens, 0)
        return by / self.link_bandwidth(src, dst) + dst.overhead

    # -- paged-KV tier model (kv_pages subsystem) -------------------------
    # Tier names are PU names (tier 0, pinned arenas), "dram" (tier 1,
    # shared spill pool) and "disk" (tier 2, UFS-class storage).

    def kv_capacity(self, tier: str) -> float:
        """Capacity in bytes of one KV tier; ``inf`` = unbounded (specs
        that predate the tier model, e.g. TPU slices, never evict)."""
        if tier == "disk":
            return float("inf")
        if tier == "dram":
            return self.soc.kv_dram_pool or float("inf")
        return self.soc.pu(tier).kv_arena or float("inf")

    def _tier_bw(self, tier: str, pu: PU) -> float:
        """Effective copy bandwidth between a spill tier and a PU arena."""
        if tier == "disk":
            # storage reads stream at the UFS link, never above what the
            # PU side can absorb; unspecified = a conservative DRAM slice
            return min(self.soc.disk_bw or 0.05 * self.soc.dram_bw,
                       pu.mem_bw)
        # dram pool <-> PU arena: one read + one write over the shared bus
        return min(0.5 * self.soc.dram_bw, pu.mem_bw)

    def tier_transfer_cost(self, stage: StageModel, src: str, dst: str,
                           tokens: int) -> float:
        """Seconds to move ``tokens`` of ``stage``'s KV pages between two
        tiers (uncontended, like every other p0).  PU→PU pairs delegate to
        :meth:`migrate_cost` so the paged path prices link hops identically
        to the monolithic tracker."""
        if src == dst:
            return 0.0
        names = {p.name for p in self.soc.pus}
        if src in names and dst in names:
            return self.migrate_cost(stage, self.soc.pu(src),
                                     self.soc.pu(dst), tokens)
        by = stage.kv_bytes_per_token() * max(tokens, 0)
        if src in names:                       # spill: arena -> pool/disk
            return by / self._tier_bw(dst, self.soc.pu(src))
        if dst in names:                       # fetch: pool/disk -> arena
            p = self.soc.pu(dst)
            return by / self._tier_bw(src, p) + p.overhead
        # dram <-> disk (cascade demotion): storage link is the bottleneck
        bw = self.soc.disk_bw or 0.05 * self.soc.dram_bw
        return by / bw

    # -- speculative decoding (draft/verify pairs) ------------------------

    def spec_verify_p0(self, stage: StageModel, pu: PU, draft_width: int,
                       width: int = 1) -> float:
        """Base latency of ONE verify pass: the target model scores
        ``draft_width + 1`` positions per resident sequence in a single
        weight sweep — the speculative win, since a memory-bound decode
        otherwise pays one sweep *per token*.  Compute scales with the
        scored positions and the resident width; bytes do not."""
        w = max(int(draft_width), 0)
        rw = max(int(width), 1)
        by = stage.params * stage.bytes_per_param
        fl = stage.flops(1, w + 1) * rw
        weff = _shape_eff(pu, rw) if rw > 1 else 1.0
        t = max(fl / (pu.peak_flops * pu.eff_stream * weff),
                by / (pu.mem_bw * pu.mem_eff_stream))
        return t + pu.overhead + pu.step_overhead

    def spec_accept(self, draft: StageModel, verify: StageModel) -> float:
        """Ground-truth accept rate of ``draft`` proposing for ``verify``:
        a smooth deterministic proxy in the capacity ratio (a draft 1/16
        the size still agrees on most easy tokens — the quarter-power
        keeps the curve in the empirically reported 0.6–0.9 band),
        clipped away from the degenerate extremes."""
        ratio = max(draft.params, 1) / max(verify.params, 1)
        return float(min(max(ratio ** 0.25, 0.05), 0.95))

    def phi(self, stage: StageModel, B: float) -> float:
        """Contention slowdown φ_v(B) ≥ 1 (Eq. 1)."""
        soc = self.soc
        x = B / soc.dram_bw
        base = 1.0 + soc.phi_gamma * max(0.0, x - soc.phi_knee) ** 2
        # memory-bound stages feel contention harder
        sens = {"stream_decode": 1.6, "search": 1.4, "batchable": 1.0,
                "stream_prefill": 0.8, "io": 0.0}[stage.kind]
        return 1.0 + (base - 1.0) * sens


# ---------------------------------------------------------------------------
# profiled (regression) estimates — what the scheduler sees (§5)
# ---------------------------------------------------------------------------

class LinearPerfModel:
    """Profiled estimates, as in the paper (§5, after Band [13]/CoDL [14]):
    the offline-profiled candidate set N_{m,k} keeps its *measured* values
    in a lookup table; a multi-feature linear regression interpolates the
    irregular (off-grid) workload sizes."""

    def __init__(self):
        self.coef: Dict[Tuple[str, str], np.ndarray] = {}
        self.bw_coef: Dict[Tuple[str, str], np.ndarray] = {}
        self.phi_coef: Dict[str, np.ndarray] = {}
        self.table: Dict[Tuple[str, str], Dict[int, Tuple[float, float]]] = {}
        # batched-decode profile: (stage, pu) -> {(width, group): (p0, bw)}
        # plus a log-space regression for off-grid (width, group) shapes —
        # what Eq. 3 enumerates over the *current* width of a resident
        # continuous-batching decode group
        self.decode_table: Dict[Tuple[str, str],
                                Dict[Tuple[int, int],
                                     Tuple[float, float]]] = {}
        self.decode_coef: Dict[Tuple[str, str], np.ndarray] = {}
        self.decode_bw_coef: Dict[Tuple[str, str], np.ndarray] = {}
        # KV-migration profile (decode stages): (stage, src_pu, dst_pu) ->
        # (intercept, seconds-per-context-token) fitted over MIGRATE_CTX —
        # what prices a resident decode batch moving PU, replacing the
        # decode_migrate_cost constant (footprint / PU-pair link bandwidth)
        self.migrate_coef: Dict[Tuple[str, str, str], Tuple[float, float]] = {}
        # per-stage KV bytes per context token (copied exactly from the
        # profiled StageModels) — the residency tracker's footprint unit
        self.kv_bytes: Dict[str, float] = {}
        # paged-KV tier profile: (stage, src_tier, dst_tier) ->
        # (intercept, seconds-per-token) lines for spill/fetch hops that
        # involve the "dram"/"disk" tiers (PU↔PU pairs live in
        # migrate_coef), plus the profiled per-tier capacities in bytes
        # (0 = unbounded) the page table evicts against
        self.fetch_coef: Dict[Tuple[str, str, str], Tuple[float, float]] = {}
        self.kv_tiers: Dict[str, float] = {}
        # speculative-decoding profile (spec_decode subsystem):
        # - spec_table: (verify stage, pu) -> {(draft_width, width):
        #   (verify-pass p0, verify-pass bandwidth)} — one target sweep
        #   scoring draft_width+1 positions per resident
        # - spec_pair: (draft stage, verify stage, draft_pu, verify_pu) ->
        #   {(draft_width, width): (t_draft, t_verify)} — the coupled
        #   per-pass pair the effective-throughput term is built from
        # - spec_accept0: (draft stage, verify stage) -> profiled accept
        #   rate prior (the EWMA's init before any observed rounds)
        self.spec_table: Dict[Tuple[str, str],
                              Dict[Tuple[int, int],
                                   Tuple[float, float]]] = {}
        self.spec_pair: Dict[Tuple[str, str, str, str],
                             Dict[Tuple[int, int],
                                  Tuple[float, float]]] = {}
        self.spec_accept0: Dict[Tuple[str, str], float] = {}

    @staticmethod
    def _feats(n: np.ndarray, tile: int) -> np.ndarray:
        """Features for the log-space linear fit: latency curves span 4+
        orders of magnitude across batch sizes, so the regression targets
        log(p0) — positive by construction, multiplicatively accurate."""
        n = np.asarray(n, dtype=np.float64)
        frac = (n % tile) / max(tile, 1)
        ln = np.log(np.maximum(n, 1.0))
        return np.stack([np.ones_like(n), ln, ln * ln, frac], axis=-1)

    @staticmethod
    def _dfeats(w: np.ndarray, g: np.ndarray, tile: int) -> np.ndarray:
        """Features for the batched-decode fit over (width, token group)."""
        w = np.asarray(w, dtype=np.float64)
        g = np.asarray(g, dtype=np.float64)
        lw = np.log(np.maximum(w, 1.0))
        lg = np.log(np.maximum(g, 1.0))
        frac = (w % tile) / max(tile, 1)
        return np.stack([np.ones_like(w), lw, lg, lw * lg, lw * lw, frac],
                        axis=-1)

    def fit(self, gt: GroundTruthPerf,
            batch_grid: Sequence[int] = (1, 2, 4, 8, 16, 24, 32, 48, 64, 96,
                                         128, 192, 256),
            bw_grid: Optional[Sequence[float]] = None,
            noise: float = 0.0, seed: int = 0) -> "LinearPerfModel":
        rng = np.random.default_rng(seed)
        for sname, stage in gt.stages.items():
            for pu in gt.soc.pus:
                if not gt.supported(stage, pu):
                    continue
                ns = np.array(batch_grid)
                ys, bs = [], []
                tab: Dict[int, Tuple[float, float]] = {}
                for n in ns:
                    c = Config(pu.name, int(n))
                    y = gt.p0(stage, pu, c)
                    b = gt.bandwidth(stage, pu, c)
                    if noise:
                        y *= float(1 + rng.normal(0, noise))
                        b *= float(1 + rng.normal(0, noise))
                    ys.append(y)
                    bs.append(b)
                    tab[int(n)] = (y, b)
                self.table[(sname, pu.name)] = tab
                X = self._feats(ns, pu.tile)
                self.coef[(sname, pu.name)] = np.linalg.lstsq(
                    X, np.log(np.maximum(ys, 1e-9)), rcond=None)[0]
                self.bw_coef[(sname, pu.name)] = np.linalg.lstsq(
                    X, np.log(np.maximum(bs, 1e-3)), rcond=None)[0]
                if stage.kind == "stream_decode":
                    self._fit_decode(gt, sname, stage, pu, rng, noise)
            # φ: quadratic fit in B/B0 above the knee
            Bs = np.linspace(0, 1.6 * gt.soc.dram_bw, 24)
            phis = np.array([gt.phi(stage, B) for B in Bs])
            Xp = np.stack([np.ones_like(Bs), Bs / gt.soc.dram_bw,
                           (Bs / gt.soc.dram_bw) ** 2], axis=-1)
            self.phi_coef[sname] = np.linalg.lstsq(Xp, phis, rcond=None)[0]
        self._tiles = {pu.name: pu.tile for pu in gt.soc.pus}
        self._b0 = gt.soc.dram_bw
        # KV-migration grid, after every latency fit so the noise rng
        # stream is untouched: migration is a bulk copy, linear in bytes,
        # so the ctx-grid samples pin an exact (intercept, slope) line per
        # (decode stage, PU pair)
        for sname, stage in gt.stages.items():
            if stage.kind != "stream_decode":
                continue
            self.kv_bytes[sname] = stage.kv_bytes_per_token()
            pus = [p for p in gt.soc.pus if gt.supported(stage, p)]
            ctx = np.asarray(self.MIGRATE_CTX, dtype=np.float64)
            X = np.stack([np.ones_like(ctx), ctx], axis=-1)
            for src in pus:
                for dst in pus:
                    if src.name == dst.name:
                        continue
                    ys = [gt.migrate_cost(stage, src, dst, int(c))
                          for c in ctx]
                    a, b = np.linalg.lstsq(X, np.array(ys), rcond=None)[0]
                    self.migrate_coef[(sname, src.name, dst.name)] = (
                        float(a), float(b))
            # tier spill/fetch lines (paged KV): arena <-> dram/disk per
            # decode stage — sampled on the same ctx grid, after every
            # noisy fit so the rng stream stays byte-identical
            for p in pus:
                for tier in ("dram", "disk"):
                    for src, dst in ((p.name, tier), (tier, p.name)):
                        ys = [gt.tier_transfer_cost(stage, src, dst, int(c))
                              for c in ctx]
                        a, b = np.linalg.lstsq(X, np.array(ys),
                                               rcond=None)[0]
                        self.fetch_coef[(sname, src, dst)] = (float(a),
                                                              float(b))
        self.kv_tiers = {p.name: p.kv_arena for p in gt.soc.pus
                         if p.kind != "io"}
        self.kv_tiers["dram"] = gt.soc.kv_dram_pool
        self.kv_tiers["disk"] = 0.0
        # speculative-decoding grid, noiseless and LAST so the rng stream
        # of every fit above is byte-identical whether or not the stage set
        # includes draft companions: per verify stage with an in-tree
        # ``*_draft`` companion, sample one-sweep verify passes and the
        # coupled (draft, verify) per-pass pair over every supported PU
        # pair — what spec_throughput prices Eq. 3 candidates with
        from repro_torch.core.spec_decode import draft_stage_of
        for sname, stage in gt.stages.items():
            if stage.kind != "stream_decode":
                continue
            dname = draft_stage_of(sname)
            if dname is None or dname not in gt.stages:
                continue
            draft = gt.stages[dname]
            self.spec_accept0[(dname, sname)] = gt.spec_accept(draft, stage)
            vpus = [p for p in gt.soc.pus if gt.supported(stage, p)]
            dpus = [p for p in gt.soc.pus if gt.supported(draft, p)]
            for vp in vpus:
                vtab: Dict[Tuple[int, int], Tuple[float, float]] = {}
                for w in self.SPEC_WIDTHS:
                    for rw in self.SPEC_RES_WIDTHS:
                        tv = gt.spec_verify_p0(stage, vp, w, rw)
                        bv = (stage.params * stage.bytes_per_param
                              / max(tv, 1e-9))
                        vtab[(int(w), int(rw))] = (tv, bv)
                self.spec_table[(sname, vp.name)] = vtab
            for dp in dpus:
                for vp in vpus:
                    ptab: Dict[Tuple[int, int], Tuple[float, float]] = {}
                    for w in self.SPEC_WIDTHS:
                        for rw in self.SPEC_RES_WIDTHS:
                            td = gt.p0(draft, dp,
                                       Config(dp.name, int(w),
                                              width=int(rw)))
                            tv = self.spec_table[(sname, vp.name)][
                                (int(w), int(rw))][0]
                            ptab[(int(w), int(rw))] = (td, tv)
                    self.spec_pair[(dname, sname, dp.name, vp.name)] = ptab
        return self

    # context-length grid the migration-cost line is sampled on (tokens)
    MIGRATE_CTX = (256, 1024, 4096, 16384)

    # speculative-decoding grid: draft widths (candidate tokens per verify
    # pass) × resident widths the coupled pair is sampled on
    SPEC_WIDTHS = (1, 2, 3, 4, 6, 8)
    SPEC_RES_WIDTHS = (1, 2, 4, 8)

    def migrate_cost(self, stage: str, src_pu: str, dst_pu: str,
                     ctx_tokens: int) -> Optional[float]:
        """Modeled seconds to move a ``ctx_tokens``-context KV cache of
        ``stage`` from ``src_pu`` to ``dst_pu`` (the fitted footprint ÷
        link-bandwidth line).  ``None`` when this profile predates the
        migration grid or the pair was never profiled — callers fall back
        to ``SchedulerConfig.decode_migrate_cost``."""
        if src_pu == dst_pu:
            return 0.0
        co = self.migrate_coef.get((stage, src_pu, dst_pu))
        if co is None:
            return None
        return max(co[0] + co[1] * max(ctx_tokens, 0), 0.0)

    def fetch_cost(self, stage: str, src: str, dst: str,
                   tokens: int) -> Optional[float]:
        """Modeled seconds to move ``tokens`` of ``stage``'s KV pages
        between tiers.  PU↔PU pairs resolve through the migration lines;
        hops involving "dram"/"disk" through the tier-fetch lines.
        ``None`` for profiles that predate either grid."""
        if src == dst:
            return 0.0
        co = self.fetch_coef.get((stage, src, dst))
        if co is not None:
            return max(co[0] + co[1] * max(tokens, 0), 0.0)
        return self.migrate_cost(stage, src, dst, tokens)

    def kv_capacity(self, tier: str) -> float:
        """Profiled byte capacity of one KV tier (inf = unbounded)."""
        cap = self.kv_tiers.get(tier, 0.0)
        return cap or float("inf")

    def prefill_cost(self, stage: str, tokens: int) -> Optional[float]:
        """Modeled seconds to (re-)prefill ``tokens`` of ``stage`` on its
        best profiled PU — the alternative a prefix-cache hit on a demoted
        page must beat (the hit-or-recompute rule): fetching KV up from a
        cold tier only wins when the transfer is cheaper than simply
        recomputing the prefix.  First-order estimate (one pass at
        ``batch=tokens``); ``None`` when the stage was never profiled, in
        which case callers keep the legacy always-hit behaviour."""
        best: Optional[float] = None
        for (s, pu) in sorted(self.coef):
            if s != stage:
                continue
            c = self.p0(s, pu, max(int(tokens), 1))
            if best is None or c < best:
                best = c
        return best

    # decode-batching profile grid: widths × token groups (width 1 lives in
    # the ordinary table; the scheduler's group candidates are clipped to
    # the stream's remaining horizon, so off-grid shapes hit the regression)
    DECODE_WIDTHS = (2, 3, 4, 6, 8)
    DECODE_GROUPS = (4, 8, 16, 24, 32, 48, 64)

    def _fit_decode(self, gt: GroundTruthPerf, sname: str, stage, pu,
                    rng, noise: float) -> None:
        tab: Dict[Tuple[int, int], Tuple[float, float]] = {}
        ws, gs, ys, bs = [], [], [], []
        for w in self.DECODE_WIDTHS:
            for g in self.DECODE_GROUPS:
                c = Config(pu.name, int(g), width=int(w))
                y = gt.p0(stage, pu, c)
                b = gt.bandwidth(stage, pu, c)
                if noise:
                    y *= float(1 + rng.normal(0, noise))
                    b *= float(1 + rng.normal(0, noise))
                tab[(int(w), int(g))] = (y, b)
                ws.append(w)
                gs.append(g)
                ys.append(y)
                bs.append(b)
        self.decode_table[(sname, pu.name)] = tab
        X = self._dfeats(np.array(ws), np.array(gs), pu.tile)
        self.decode_coef[(sname, pu.name)] = np.linalg.lstsq(
            X, np.log(np.maximum(ys, 1e-9)), rcond=None)[0]
        self.decode_bw_coef[(sname, pu.name)] = np.linalg.lstsq(
            X, np.log(np.maximum(bs, 1e-3)), rcond=None)[0]

    def supported(self, stage: str, pu: str) -> bool:
        return (stage, pu) in self.coef

    # -- persistence (ship profiles with a deployment, paper §5) ----------
    def save(self, path: str) -> None:
        import json
        blob = {
            "coef": {f"{s}|{p}": c.tolist() for (s, p), c in
                     self.coef.items()},
            "bw_coef": {f"{s}|{p}": c.tolist() for (s, p), c in
                        self.bw_coef.items()},
            "phi_coef": {s: c.tolist() for s, c in self.phi_coef.items()},
            "table": {f"{s}|{p}": {str(n): v for n, v in tab.items()}
                      for (s, p), tab in self.table.items()},
            "decode_coef": {f"{s}|{p}": c.tolist() for (s, p), c in
                            self.decode_coef.items()},
            "decode_bw_coef": {f"{s}|{p}": c.tolist() for (s, p), c in
                               self.decode_bw_coef.items()},
            "decode_table": {f"{s}|{p}": {f"{w},{g}": v
                                          for (w, g), v in tab.items()}
                             for (s, p), tab in self.decode_table.items()},
            "migrate_coef": {f"{s}|{a}|{b}": list(v) for (s, a, b), v in
                             self.migrate_coef.items()},
            "kv_bytes": dict(self.kv_bytes),
            "fetch_coef": {f"{s}|{a}|{b}": list(v) for (s, a, b), v in
                           self.fetch_coef.items()},
            "kv_tiers": dict(self.kv_tiers),
            "spec_table": {f"{s}|{p}": {f"{w},{rw}": list(v)
                                        for (w, rw), v in tab.items()}
                           for (s, p), tab in self.spec_table.items()},
            "spec_pair": {f"{d}|{s}|{a}|{b}": {f"{w},{rw}": list(v)
                                               for (w, rw), v in
                                               tab.items()}
                          for (d, s, a, b), tab in self.spec_pair.items()},
            "spec_accept0": {f"{d}|{s}": v for (d, s), v in
                             self.spec_accept0.items()},
            "tiles": self._tiles, "b0": self._b0,
        }
        with open(path, "w") as f:
            json.dump(blob, f)

    @classmethod
    def load(cls, path: str) -> "LinearPerfModel":
        import json
        with open(path) as f:
            blob = json.load(f)
        m = cls()
        m.coef = {tuple(k.split("|")): np.array(v)
                  for k, v in blob["coef"].items()}
        m.bw_coef = {tuple(k.split("|")): np.array(v)
                     for k, v in blob["bw_coef"].items()}
        m.phi_coef = {k: np.array(v) for k, v in blob["phi_coef"].items()}
        m.table = {tuple(k.split("|")): {int(n): tuple(v)
                                         for n, v in tab.items()}
                   for k, tab in blob["table"].items()}
        # decode-batching profile (absent in pre-serving profile files)
        m.decode_coef = {tuple(k.split("|")): np.array(v)
                         for k, v in blob.get("decode_coef", {}).items()}
        m.decode_bw_coef = {tuple(k.split("|")): np.array(v)
                            for k, v in blob.get("decode_bw_coef",
                                                 {}).items()}
        m.decode_table = {
            tuple(k.split("|")): {tuple(int(x) for x in wg.split(",")):
                                  tuple(v) for wg, v in tab.items()}
            for k, tab in blob.get("decode_table", {}).items()}
        # KV-migration profile (absent in pre-residency profile files:
        # migrate_cost then returns None and callers keep the constant)
        m.migrate_coef = {tuple(k.split("|")): tuple(v)
                          for k, v in blob.get("migrate_coef", {}).items()}
        m.kv_bytes = dict(blob.get("kv_bytes", {}))
        # paged-KV tier profile (absent in pre-paging profile files:
        # fetch_cost falls back to migrate lines, capacities to unbounded)
        m.fetch_coef = {tuple(k.split("|")): tuple(v)
                        for k, v in blob.get("fetch_coef", {}).items()}
        m.kv_tiers = dict(blob.get("kv_tiers", {}))
        # speculative-decoding profile (absent in pre-spec profile files:
        # the spec queries return None/() and spec scoring is skipped)
        m.spec_table = {
            tuple(k.split("|")): {tuple(int(x) for x in wr.split(",")):
                                  tuple(v) for wr, v in tab.items()}
            for k, tab in blob.get("spec_table", {}).items()}
        m.spec_pair = {
            tuple(k.split("|")): {tuple(int(x) for x in wr.split(",")):
                                  tuple(v) for wr, v in tab.items()}
            for k, tab in blob.get("spec_pair", {}).items()}
        m.spec_accept0 = {tuple(k.split("|")): float(v)
                          for k, v in blob.get("spec_accept0", {}).items()}
        m._tiles = blob["tiles"]
        m._b0 = blob["b0"]
        return m

    def p0(self, stage: str, pu: str, batch: int) -> float:
        hit = self.table.get((stage, pu), {}).get(int(batch))
        if hit is not None:
            return hit[0]                    # profiled grid point: exact
        X = self._feats(np.array([batch]), self._tiles[pu])
        return float(np.exp((X @ self.coef[(stage, pu)])[0]))

    def bandwidth(self, stage: str, pu: str, batch: int) -> float:
        hit = self.table.get((stage, pu), {}).get(int(batch))
        if hit is not None:
            return hit[1]
        X = self._feats(np.array([batch]), self._tiles[pu])
        return float(np.exp((X @ self.bw_coef[(stage, pu)])[0]))

    def p0_decode(self, stage: str, pu: str, width: int, group: int) -> float:
        """Base latency of one token-group pass of a width-``width`` resident
        decode batch (continuous cross-query batching).  width 1 degrades to
        the ordinary stream profile."""
        if width <= 1:
            return self.p0(stage, pu, group)
        hit = self.decode_table.get((stage, pu), {}).get((int(width),
                                                          int(group)))
        if hit is not None:
            return hit[0]
        if (stage, pu) not in self.decode_coef:
            # profile saved before the decode-batching grid existed: decode
            # is memory-bound on the per-step weight sweep, so the
            # single-stream pass cost is the first-order width-w estimate
            return self.p0(stage, pu, group)
        X = self._dfeats(np.array([width]), np.array([group]),
                         self._tiles[pu])
        return float(np.exp((X @ self.decode_coef[(stage, pu)])[0]))

    def bandwidth_decode(self, stage: str, pu: str, width: int,
                         group: int) -> float:
        """Shared-domain demand of a batched decode pass: the weight sweep is
        read once per step regardless of width, so per-sequence pressure
        drops as the batch widens."""
        if width <= 1:
            return self.bandwidth(stage, pu, group)
        hit = self.decode_table.get((stage, pu), {}).get((int(width),
                                                          int(group)))
        if hit is not None:
            return hit[1]
        if (stage, pu) not in self.decode_bw_coef:
            return self.bandwidth(stage, pu, group)   # pre-serving profile
        X = self._dfeats(np.array([width]), np.array([group]),
                         self._tiles[pu])
        return float(np.exp((X @ self.decode_bw_coef[(stage, pu)])[0]))

    # -- profiled-grid queries (adaptive batching policy) -----------------
    # The batching policy enumerates these grids the way Eq. 3 enumerates
    # n*: caps and windows are *derived* from the profiled sweet spot per
    # (stage, PU) instead of hand-picked constants (ROADMAP item 1).

    def batch_grid(self, stage: str, pu: str) -> Tuple[int, ...]:
        """Profiled batch sizes for ``(stage, pu)`` (the measured table
        points — the only shapes the policy trusts for cap derivation)."""
        return tuple(sorted(self.table.get((stage, pu), {})))

    def decode_width_grid(self, stage: str, pu: str) -> Tuple[int, ...]:
        """Profiled resident widths of the decode ``(width, group)`` grid
        (empty for non-decode stages / pre-serving profile files)."""
        return tuple(sorted({w for (w, _g)
                             in self.decode_table.get((stage, pu), {})}))

    def decode_group_grid(self, stage: str, pu: str) -> Tuple[int, ...]:
        """Profiled token groups of the decode ``(width, group)`` grid."""
        return tuple(sorted({g for (_w, g)
                             in self.decode_table.get((stage, pu), {})}))

    # -- speculative-decoding queries (spec_decode subsystem) -------------

    @staticmethod
    def _spec_nearest(tab: Dict[Tuple[int, int], Tuple[float, float]],
                      w: int, rw: int) -> Optional[Tuple[float, float]]:
        """Exact grid hit, else the nearest profiled (draft_width, width)
        point — the policy only enumerates grid widths, so off-grid
        queries are rare corrective paths, not hot ones."""
        hit = tab.get((int(w), int(rw)))
        if hit is not None:
            return hit
        if not tab:
            return None
        key = min(tab, key=lambda k: (abs(k[0] - w) + abs(k[1] - rw),
                                      k[0], k[1]))
        return tab[key]

    def spec_verify_p0(self, stage: str, pu: str, draft_width: int,
                       width: int = 1) -> Optional[float]:
        """Modeled latency of one verify pass (one target sweep scoring
        ``draft_width + 1`` positions per resident).  ``None`` when this
        profile predates the spec grid or the stage has no companion."""
        hit = self._spec_nearest(self.spec_table.get((stage, pu), {}),
                                 draft_width, width)
        return None if hit is None else hit[0]

    def spec_bandwidth(self, stage: str, pu: str, draft_width: int,
                       width: int = 1) -> Optional[float]:
        """Shared-domain demand of one verify pass (one weight sweep over
        the pass time — speculation amortizes bytes over ~1+α·w tokens)."""
        hit = self._spec_nearest(self.spec_table.get((stage, pu), {}),
                                 draft_width, width)
        return None if hit is None else hit[1]

    def spec_pair_time(self, draft_stage: str, verify_stage: str,
                       draft_pu: str, verify_pu: str, draft_width: int,
                       width: int = 1
                       ) -> Optional[Tuple[float, float]]:
        """``(t_draft, t_verify)`` of one coupled pass on the PU pair
        (``None`` when the pair was never profiled)."""
        tab = self.spec_pair.get(
            (draft_stage, verify_stage, draft_pu, verify_pu))
        if tab is None:
            return None
        return self._spec_nearest(tab, draft_width, width)

    def spec_throughput(self, draft_stage: str, verify_stage: str,
                        draft_pu: str, verify_pu: str, draft_width: int,
                        alpha: float, width: int = 1) -> Optional[float]:
        """Accept-rate-aware effective token rate of the coupled pair:
        ``width * (1 + α·w) / cost`` tokens/s, where cost is the
        pipelined ``max(t_draft, t_verify)`` on distinct PUs (draft
        streams the next candidates while the target verifies the
        previous group) and the serial sum on a shared PU."""
        pair = self.spec_pair_time(draft_stage, verify_stage, draft_pu,
                                   verify_pu, draft_width, width)
        if pair is None:
            return None
        td, tv = pair
        cost = max(td, tv) if draft_pu != verify_pu else td + tv
        a = max(min(float(alpha), 1.0), 0.0)
        w = max(int(draft_width), 0)
        return max(width, 1) * (1.0 + a * w) / max(cost, 1e-9)

    def spec_width_grid(self, draft_stage: str, verify_stage: str,
                        draft_pu: str, verify_pu: str) -> Tuple[int, ...]:
        """Profiled draft widths of the coupled pair (empty when the pair
        was never profiled — spec scoring then falls back to plain
        decode)."""
        tab = self.spec_pair.get(
            (draft_stage, verify_stage, draft_pu, verify_pu))
        if not tab:
            return ()
        return tuple(sorted({w for (w, _rw) in tab}))

    def spec_accept_init(self, draft_stage: str,
                         verify_stage: str) -> Optional[float]:
        """Profiled accept-rate prior for the pair (EWMA init), ``None``
        for profiles that predate the spec grid."""
        return self.spec_accept0.get((draft_stage, verify_stage))

    def per_item(self, stage: str, pu: str, batch: int) -> float:
        """Per-member latency of one pass at ``batch`` — the curve whose
        knee the coalesce cap sits at (Fig. 2's "larger batches do not
        always yield better per-item efficiency")."""
        return self.p0(stage, pu, batch) / max(batch, 1)

    def per_member_decode(self, stage: str, pu: str, width: int,
                          group: int) -> float:
        """Per-resident latency of one width-``width`` token-group pass.
        Width 1 degrades to the ordinary single-stream profile."""
        return self.p0_decode(stage, pu, width, group) / max(width, 1)

    def decode_marginal_gains(self, stage: str, pu: str, group: int
                              ) -> List[Tuple[int, float]]:
        """``[(width, gain)]`` over the profiled width grid: ``gain`` is the
        drop in per-member latency when the resident batch widens from the
        previous grid width (positive while sharing the per-step weight
        sweep still pays, negative past the spill knee)."""
        widths = self.decode_width_grid(stage, pu)
        out: List[Tuple[int, float]] = []
        prev = self.p0(stage, pu, group)      # width-1 solo baseline
        for w in widths:
            cur = self.per_member_decode(stage, pu, w, group)
            out.append((w, prev - cur))
            prev = cur
        return out

    def batch_marginal_gains(self, stage: str, pu: str
                             ) -> List[Tuple[int, float]]:
        """``[(batch, gain)]`` over the profiled batch grid — the coalesce
        width profile for batchable stages (the dual of the decode grid)."""
        grid = self.batch_grid(stage, pu)
        out: List[Tuple[int, float]] = []
        prev = None
        for n in grid:
            cur = self.per_item(stage, pu, n)
            out.append((n, 0.0 if prev is None else prev - cur))
            prev = cur
        return out

    def dispatch_overhead(self, stage: str, pu: str) -> float:
        """Fitted per-dispatch overhead: extrapolate the profiled latency
        line to batch → 0 via the two smallest grid points (p0 ≈ o + c·n
        ⇒ o = 2·p0(n1) − p0(2·n1) when n2 = 2·n1; clamped ≥ 0).  This is
        the invocation cost one coalesced member *saves* by riding a fused
        dispatch instead of paying its own."""
        grid = self.batch_grid(stage, pu)
        if not grid:
            return 0.0
        if len(grid) == 1:
            return self.p0(stage, pu, grid[0])
        n1, n2 = grid[0], grid[1]
        p1, p2 = self.p0(stage, pu, n1), self.p0(stage, pu, n2)
        slope = (p2 - p1) / max(n2 - n1, 1)
        return max(p1 - slope * n1, 0.0)

    def phi(self, stage: str, B: float) -> float:
        """Monotone projection of the fitted quadratic: a convex parabola is
        flat at its minimum below the vertex (the ground truth is monotone;
        the raw fit may dip)."""
        c0, c1, c2 = self.phi_coef[stage]
        x = B / self._b0
        if c2 > 1e-12:
            x = max(x, -c1 / (2 * c2))
        val = c0 + c1 * x + c2 * x * x
        return float(max(1.0, val))
