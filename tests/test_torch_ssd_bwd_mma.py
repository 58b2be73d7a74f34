"""K5's backward on the tensor cores (``ssd_bwd_keys_mma`` and
``ssd_bwd_queries_mma``, the route ``ssd_bwd_mma``) on the CPU: the
route the plan picks, the Python mirrors of the kernels' shared-memory
layout and of their work (every 16 x 16 unit on or below the diagonal
once per role, every gradient row written by one block), and an
emulation of the kernels' arithmetic on one cell at the hybrid train
shape (Q 256, P = N = 64, zamba2's decays) against the plain version
evaluated in f64.

The emulation rounds as the kernels do: ``cvt.rna.tf32.f32`` (to
nearest, ties away from zero, on the f32 bits), each f32 operand split
into TF32 halves hi + lo, the products hi·hi + hi·lo + lo·hi where both
operands are f32 (Mᵀ·dy) and hi·b + lo·b where the other one is bf16,
exact in TF32 (dM = (dy·xᵀ) ⊙ dt_j, the state terms, dC, dB), bf16
scores with exact products, every mma.sync's sum of exact products
rounded once into its f32 accumulator, in the kernels' order of
k-steps.  Limits: ``chip_smoke.BWD_TOL`` — dx, dB and dC (bf16 outputs)
within 2e-3·max|want| + 1e-2·|want| of the f64 evaluation, ddt and ddA
(f32) within 2e-5·max|want| + 1e-4·|want|.
"""
import importlib.util
import itertools
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as k5  # noqa: E402
from repro_torch.kernels import ssd_chunk_bwd as k5b  # noqa: E402


def _chip_smoke():
    """chip_smoke.py as a module (its import defines only constants and
    functions), for the limits and peak rates the card run applies."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
H100_SMEM_SM = 228 * 1024     # an SM's shared memory; 1 KB of it a block
BWD_TOL = {"bf16": SMOKE.BWD_TOL[torch.bfloat16],
           "f32": SMOKE.BWD_TOL[torch.float32]}


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_plan_takes_the_mma_route_for_bf16_at_zamba2_widths():
    """bf16 at zamba2's widths (64 heads of P = N = 64) takes the tensor
    cores at every chunk length from 1 to 256, its shared memory the key
    role's block; f32 takes ssd_bwd_tiles."""
    for Q in range(1, 257):
        p = k5b.plan(4, 2, Q, 64, 64, 64, torch.bfloat16)
        assert p.kernel == "ssd_bwd_mma", Q
        assert p.tiles == (64, 8, 2 * -(-Q // 64)) and p.finish == (64, 8)
        assert p.smem == k5b.mma_smem(Q, "keys")
        assert k5b.plan(4, 2, Q, 64, 64, 64, torch.float32).kernel == \
            "ssd_bwd_tiles"


@pytest.mark.parametrize("P,N", [(60, 64), (64, 12), (4, 4), (1, 64)])
def test_plan_sends_widths_off_multiples_of_8_to_the_tiles(P, N):
    p = k5b.plan(1, 2, 77, 8, P, N, torch.bfloat16)
    assert p.kernel == "ssd_bwd_tiles" and p.smem == k5b.SMEM
    with pytest.raises(ValueError, match="ssd_bwd_mma takes bf16"):
        k5b.plan(1, 2, 77, 8, P, N, torch.bfloat16, kernel="ssd_bwd_mma")


@pytest.mark.parametrize("P,N", [(8, 8), (16, 32), (64, 64)])
def test_plan_forces_either_route(P, N):
    """A forced route: the tiles take bf16 too; the mma route refuses
    f32; a shape neither kernel takes raises whichever is asked."""
    assert k5b.plan(1, 1, 33, 4, P, N, torch.bfloat16,
                    kernel="ssd_bwd_tiles").kernel == "ssd_bwd_tiles"
    assert k5b.plan(1, 1, 33, 4, P, N, torch.bfloat16,
                    kernel="ssd_bwd_mma").kernel == "ssd_bwd_mma"
    with pytest.raises(ValueError, match="ssd_bwd_mma takes bf16"):
        k5b.plan(1, 1, 33, 4, P, N, torch.float32, kernel="ssd_bwd_mma")
    with pytest.raises(ValueError, match="no kernel"):
        k5b.plan(1, 1, 33, 4, P, N, torch.bfloat16, kernel="ssd_bwd_wgmma")
    for kernel in k5b.KERNEL_IDS:
        with pytest.raises(ValueError, match="chunk length 257"):
            k5b.plan(1, 1, 257, 4, P, N, torch.bfloat16, kernel=kernel)
        with pytest.raises(ValueError, match="head dim"):
            k5b.plan(1, 1, 33, 4, 72, N, torch.bfloat16, kernel=kernel)


# ---------------------------------------------------------------------------
# the mirrors of the kernels' layout and work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("role", k5b.ROLES)
def test_mma_shared_memory_fits_two_blocks_an_sm_at_every_q(role):
    """Each role's block fits an H100 block's limit (232,448 bytes) and
    two blocks an SM (the kernels' launch bounds) at every chunk length;
    at Q 256 the layout is the stages (C_i bf16 and dy_i f32, or B_j and
    x_j bf16, twice), the key role's buffer of dy's TF32 hi half, and cs,
    dt and the scan's totals."""
    for Q in range(1, 257):
        smem = k5b.mma_smem(Q, role)
        assert smem <= k5b.H100[1] and 2 * (smem + 1024) <= H100_SMEM_SM
    stage = 64 * 72 * 2 + (64 * 68 * 4 if role == "keys" else 64 * 72 * 2)
    hi = 64 * 68 * 4 if role == "keys" else 0
    assert k5b.mma_smem(256, role) == 2 * stage + hi + 2 * 256 * 4 + 40
    assert k5b.mma_smem(1, role) == k5b.mma_smem(256, role) - 2 * 192 * 4


def _visible_units(Q):
    n = -(-Q // 16)
    return sorted((i, j) for i in range(n) for j in range(i + 1))


@pytest.mark.parametrize("Q", [1, 15, 16, 17, 63, 64, 65, 77, 128, 200, 255,
                               256])
@pytest.mark.parametrize("role", k5b.ROLES)
def test_mma_units_visit_every_unit_on_or_below_the_diagonal_once(Q, role):
    """Over a role's blocks and warps, every 16 x 16 unit (I, J) with I >=
    J inside the chunk is computed exactly once, and none above it; each
    warp's units are its own stripe's, in the order of its walk."""
    units = k5b.mma_units(Q, role)
    seen = [u for us in units.values() for u in us]
    assert sorted(seen) == _visible_units(Q)
    for (tile, warp), us in units.items():
        own = 4 * tile + warp
        assert all((u[1] if role == "keys" else u[0]) == own for u in us)
        other = [u[0] if role == "keys" else u[1] for u in us]
        assert other == sorted(other)
    if Q == 256:     # 136 units: 34,816 pairs a cell, 32,896 visible
        assert len(seen) * 256 == 34816 and 256 * 257 // 2 == 32896


@pytest.mark.parametrize("Q,nc", [(1, 1), (77, 2), (256, 2), (130, 1)])
@pytest.mark.parametrize("kernel", sorted(k5b.KERNEL_IDS))
def test_every_gradient_row_is_written_by_one_block(Q, nc, kernel):
    """Each (b, chunk, head, row) of a role's gradients (keys: dx, ddt,
    dB, G's column sums and w terms; queries: dC, G's row sums) is
    written by exactly one block of the plan."""
    b, H = 2, 3
    p = k5b.plan(b, nc, Q, H, 64, 64, torch.bfloat16, kernel=kernel)
    rows = k5b.work(p, b, nc, Q, H)
    want = sorted(itertools.product(range(b), range(nc), range(H),
                                    range(Q)))
    for role in k5b.ROLES:
        assert sorted(rows[role]) == want, role


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------

f32, f64 = np.float32, np.float64


def _tf32(v):
    """cvt.rna.tf32.f32 on the f32 bits: round the 13 bits below TF32's
    10-bit mantissa to nearest, ties away from zero."""
    u = np.ascontiguousarray(v, f32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(f32)


def _split(v, lo=True):
    """split_tf32: v = hi + lo + O(2^-22 v), both TF32; with ``lo``
    False, one TF32 rounding (lo = 0)."""
    v = np.asarray(v, f32)
    hi = _tf32(v)
    return hi, _tf32(v - hi) if lo else np.zeros_like(hi)


def _mma(acc, pairs, k):
    """acc (f32) += sum of a @ b over ``pairs``, as mma.sync issues them:
    k columns a step, the pairs in turn within a step; each instruction's
    sum of exact products rounded once into the f32 accumulator."""
    acc = np.asarray(acc, f32)
    for k0 in range(0, pairs[0][0].shape[1], k):
        for a, b in pairs:
            acc = (acc + a[:, k0:k0 + k].astype(f64)
                   @ b[k0:k0 + k].astype(f64)).astype(f32)
    return acc


def _emulate(x, dt, B, C, dA, dy, dS, lo=True):
    """One cell's gradients (x, B, C bf16 values as f32; dt, dA, dy, dS
    f32; shapes (Q, P), (Q,), (Q, N)) the way ssd_bwd_keys_mma,
    ssd_bwd_queries_mma and ssd_bwd_finish compute them; dx, dB and dC
    rounded to bf16 as stored.  With ``lo`` False every f32 operand is
    rounded once to TF32 instead of split."""
    Q = x.shape[0]
    cs = np.cumsum(dA.astype(f64)).astype(f32)
    yh, yl = _split(dy, lo)
    # scores: bf16 products (exact), four k16 steps
    s = _mma(np.zeros((Q, Q), f32), [(C, B.T)], 16)           # s[i, j]
    # dM = (dy xᵀ) ⊙ dt_j: x is bf16, exact in TF32, so two products, hi·x
    # then lo·x into one accumulator
    dm = _mma(np.zeros((Q, Q), f32), [(yh, x.T), (yl, x.T)], 8)
    d = (dm * dt[None, :]).astype(f32)
    lower = np.tril(np.ones((Q, Q), bool))
    L = np.exp(np.where(lower, cs[:, None] - cs[None, :],
                        -np.inf).astype(f32)).astype(f32)
    M = (s * L).astype(f32)
    dsc = (d * L).astype(f32)
    G = np.where(np.tril(lower, -1), (d * M).astype(f32), 0).astype(f32)
    mh, ml = _split(M, lo)
    dh, dl = _split(dsc, lo)
    w = np.exp((cs[-1] - cs).astype(f32)).astype(f32)
    # key role: the state terms first (B dS, and u = dt_j ⊙ (x dSᵀ): two
    # products each), scaled by w, then the products over i
    sh, sl = _split(dS, lo)
    bds = _mma(np.zeros_like(x), [(B, sh), (B, sl)], 8)        # B_j dS
    u = (_mma(np.zeros_like(B), [(x, sh.T), (x, sl.T)], 8)
         * dt[:, None]).astype(f32)
    dw = (B * u).astype(f32).sum(1, dtype=f32)
    ddtx = _mma((w[:, None] * bds).astype(f32),
                [(mh.T, yh), (mh.T, yl), (ml.T, yh)], 8)
    dB = _mma((w[:, None] * u).astype(f32), [(dh.T, C), (dl.T, C)], 8)
    # query role
    dC = _mma(np.zeros_like(C), [(dh, B), (dl, B)], 8)
    # ssd_bwd_finish: the f64 scans
    rc = G.sum(1, dtype=f32).astype(f64) - G.sum(0, dtype=f32).astype(f64)
    wt = (dw * w).astype(f32).astype(f64)
    ddA = (np.cumsum(rc[::-1])[::-1] + np.cumsum(wt) - wt).astype(f32)
    ddt = (x * ddtx).astype(f32).sum(1, dtype=f32)
    bf = torch.bfloat16
    dx, dB, dC = (torch.from_numpy(np.asarray(a, f32)).to(bf).float().numpy()
                  for a in ((dt[:, None] * ddtx).astype(f32), dB, dC))
    return dx, ddt, dB, dC, ddA


def _train_cell(A, seed):
    """One (b, chunk, head) cell at the hybrid train shape: Q 256, P = N
    = 64, x, B, C bf16, dt = softplus(normal) and dA = dt·A (zamba2's
    decays run A from -1 to -16), f32 cotangents dy, dS."""
    rng = np.random.default_rng(seed)
    Q, Pd, N = 256, 64, 64

    def bf16(*shape):
        t = torch.from_numpy(rng.standard_normal(shape).astype(f32))
        return t.to(torch.bfloat16).float().numpy()
    x, B, C = bf16(Q, Pd), bf16(Q, N), bf16(Q, N)
    dt = np.log1p(np.exp(rng.standard_normal(Q))).astype(f32)
    dA = (dt * f32(A)).astype(f32)
    dy = rng.standard_normal((Q, Pd)).astype(f32)
    dS = rng.standard_normal((N, Pd)).astype(f32)
    return x, dt, B, C, dA, dy, dS


def _f64(x, dt, B, C, dA, dy, dS):
    """The plain version in f64 on the same cell (its cs is the f64 sum
    rounded once to f32, as every version's)."""
    def t(a, *shape):
        return torch.from_numpy(np.asarray(a, f64)).reshape(*shape)
    Q, Pd = x.shape
    N = B.shape[1]
    out = ref.ssd_chunk_bwd_ref(
        t(x, 1, 1, Q, 1, Pd), t(dt, 1, 1, Q, 1), t(B, 1, 1, Q, 1, N),
        t(C, 1, 1, Q, 1, N), torch.from_numpy(dA).reshape(1, 1, Q, 1),
        t(dy, 1, 1, Q, 1, Pd), t(dS, 1, 1, 1, N, Pd))
    return [o.numpy().reshape(o.shape[2], -1).squeeze(-1) if o.dim() == 4
            else o.numpy().reshape(Q, -1) for o in out]


def _within(got, want, tol):
    a, r = tol
    err = np.abs(np.asarray(got, f64) - want)
    return bool((err <= a * np.abs(want).max() + r * np.abs(want)).all())


NAMES = ("dx", "ddt", "dB", "dC", "ddA")
LIMIT = {"dx": "bf16", "dB": "bf16", "dC": "bf16", "ddt": "f32",
         "ddA": "f32"}


@pytest.mark.parametrize("A,seed", [(-1.0, 0), (-4.0, 1), (-16.0, 2)])
def test_emulated_split_products_hold_the_limits_at_the_train_shape(A,
                                                                    seed):
    """The kernels' arithmetic on one train-shape cell against the f64
    evaluation: dx, dB and dC within bf16's backward limit, ddt and ddA
    within f32's, every gradient finite."""
    cell = _train_cell(A, seed)
    got = _emulate(*cell)
    want = _f64(*cell)
    for name, g, w_ in zip(NAMES, got, want):
        assert g.shape == w_.shape, name
        assert np.isfinite(g).all(), name
        assert _within(g, w_, BWD_TOL[LIMIT[name]]), (
            name, float(np.abs(g - w_).max()), float(np.abs(w_).max()))


def test_one_tf32_rounding_would_not_hold_the_limits():
    """Why the split: the same arithmetic with every f32 operand rounded
    once to TF32 (no lo terms) moves ddt and ddA past f32's limit on the
    cell where the split products hold it."""
    cell = _train_cell(-1.0, 0)
    want = _f64(*cell)
    got = _emulate(*cell, lo=False)
    for name in ("ddt", "ddA"):
        i = NAMES.index(name)
        assert not _within(got[i], want[i], BWD_TOL["f32"]), name


# ---------------------------------------------------------------------------
# the bound and the build's ptxas report
# ---------------------------------------------------------------------------

def _train_inputs(dtype):
    x = torch.empty((4, 2, 256, 64, 64), dtype=dtype)
    dt = torch.empty((4, 2, 256, 64))
    B = torch.empty((4, 2, 256, 1, 64), dtype=dtype).expand(-1, -1, -1, 64,
                                                           -1)
    return x, dt, B


def test_bound_prices_each_product_at_its_operands_rate():
    """At the hybrid train shape the backward's floor is about 50 us in
    bf16: the scores on the bf16 tensor cores, Mᵀ·dy (both operands f32)
    at three TF32 products, every other product (one operand bf16, exact
    in TF32) at two.  f32 inputs price every product at three, as
    before; the forward's f32-factor products also take two in bf16."""
    x, dt, B = _train_inputs(torch.bfloat16)
    work = k5b.flops(x, B)
    assert [r for _, r in work] == [torch.bfloat16, "tf32x3", "tf32x2"]
    ms, by = SMOKE.bound_ms(k5b.bytes_moved(x, dt, B, B, dt), *work)
    assert by == "operations" and abs(ms - 0.0501) < 0.0005, ms
    xf, dtf, Bf = _train_inputs(torch.float32)
    assert {r for _, r in k5b.flops(xf, Bf)} == {"tf32x3"}
    assert sum(n for n, _ in k5b.flops(xf, Bf)) == sum(n for n, _ in work)
    assert [r for _, r in k5.flops(x, B)] == [torch.bfloat16, "tf32x2"]
    assert {r for _, r in k5.flops(xf, Bf)} == {"tf32x3"}


def test_ptxas_report_is_kept_beside_its_library(tmp_path, monkeypatch):
    """A library's ptxas report lives next to it, so a run that finds the
    library already built still reads it; a library without its report
    counts as missing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    lib, rep = _build.lib_path("ssd_chunk_bwd"), _build.report_path(
        "ssd_chunk_bwd")
    assert rep.parent == lib.parent and rep.name.startswith(lib.stem)
    with pytest.raises(RuntimeError, match="no ptxas report"):
        _build.report("ssd_chunk_bwd")
    rep.write_text("ssd_bwd_keys_mma: Used 227 registers\n")
    assert _build.report("ssd_chunk_bwd") == [
        "ssd_bwd_keys_mma: Used 227 registers"]
