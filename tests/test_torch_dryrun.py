"""The port's dry-run tooling against the JAX package's.

- ``launch/op_cost.py`` against ``launch/hlo_cost.py`` on the three
  programs of ``tests/test_hlo_cost.py`` (a product's FLOPs exact; an
  L-step loop counted L times; bytes between 2 and 20 times the
  operands), and on the step of reduced qwen1.5-0.5b (d_model 256, 2 x
  64 tokens) at train, prefill and decode: the port's count on the meta
  device within 10% of ``hlo_cost`` on the JAX lowering of the same cell
  on one CPU device (measured: 0.964, 0.959 and 0.921 of it; the port's
  eager ops spell some elementwise work otherwise than XLA's fusions).
- ``models/sharding.py``'s placements, leaf for leaf, against the
  reference's ``_param_rule`` / ``_cache_rule`` / batch rule for all ten
  archs on (16, 16) and (2, 16, 16) (the reference's rules need only
  ``mesh.shape``, so a stand-in serves; the port's run over a fake
  process group of 256 or 512 ranks).
- ``models.input_specs`` against the JAX ``input_specs`` for every arch x
  shape (cache leaves through ``bridge``'s map: the port's ``latent`` is
  the reference's ``ckv`` and ``krope`` side by side).
- ``launch/dryrun.run_cell`` ok for reduced qwen1.5 on a fake 2 x 2 mesh
  and on one device, its argument bytes rank 0's local shards.

Every test tears the fake process group down.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import SHAPES_BY_NAME as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch.hlo_cost import analyze as hlo_analyze  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import input_specs as jinput_specs  # noqa: E402
from repro.models import make_step_fn as jmake_step_fn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import sharding as jsharding  # noqa: E402
from repro_torch.configs import (SHAPES_BY_NAME, get_config,  # noqa: E402
                                 list_archs, reduced, shape_applicable)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, mesh as port_mesh  # noqa: E402
from repro_torch.launch.op_cost import OpCounter, analyze  # noqa: E402
from repro_torch.models import (build_model, input_specs,  # noqa: E402
                                lm, make_step_fn, sharding)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    port_mesh.destroy()
    sharding.set_activation_mesh(None)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# op_cost against hlo_cost
# ---------------------------------------------------------------------------

def _hlo(fn, *shapes):
    return hlo_analyze(jax.jit(fn).lower(*(
        jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)).compile()
        .as_text())


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_matmul_flops_exact_like_hlo_cost():
    M, K, N = 256, 128, 512
    r = analyze(lambda x, w: x @ w, _meta(M, K), _meta(K, N))
    want = 2 * M * K * N
    assert r["flops"] == want
    assert _hlo(lambda x, w: x @ w, (M, K), (K, N))["flops"] == \
        pytest.approx(want, rel=0.01)


def test_loop_counted_once_a_step_like_hlo_cost():
    """An L-step loop of tanh(c @ w): L products, as hlo_cost counts a
    scan's body by its trip count."""
    L, D = 12, 64

    def torch_loop(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    def jax_loop(x, ws):
        y, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)
        return y
    want = 2 * D * D * D * L
    got = analyze(torch_loop, _meta(D, D), _meta(L, D, D))["flops"]
    assert want <= got <= want * 1.1
    assert got == pytest.approx(_hlo(jax_loop, (D, D), (L, D, D))["flops"],
                                rel=0.01)


def test_bytes_positive_and_bounded_like_hlo_cost():
    M = 512
    r = analyze(lambda x, w: torch.relu(x @ w).sum(), _meta(M, M),
                _meta(M, M))
    assert 2 * M * M * 4 <= r["bytes"] <= 20 * M * M * 4
    j = _hlo(lambda x, w: jax.nn.relu(x @ w).sum(), (M, M), (M, M))
    assert 2 * M * M * 4 <= j["bytes"] <= 20 * M * M * 4


def test_kernel_call_counts_its_wrapper_formula_once():
    """K2 on meta: one operation with ``flash_attention.flops`` and
    ``bytes_moved``, and no score matrix formed."""
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ops
    q, k = _meta(2, 64, 4, 64), _meta(2, 64, 2, 64)
    with OpCounter() as c:
        out = ops.flash_attention(q, k, k, causal=True)
    assert out.shape == q.shape and out.is_meta
    assert dict(c.kernels) == {"flash_attention": 1}
    assert c.flops == k2.flops(q, 64, True, 0)
    assert c.bytes == k2.bytes_moved(q, k, 64, causal=True)
    assert c.peak_bytes == 2 * 64 * 4 * 64 * 4       # the output alone


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_step_flops_within_10pct_of_hlo_cost(kind):
    """Reduced qwen1.5-0.5b (d_model 256), 2 x 64 tokens: the port's step
    on meta against the JAX lowering's HLO on one CPU device."""
    B, S = 2, 64
    jc = jreduced(jget("qwen1.5-0.5b"), d_model=256)
    shape = JShape(kind, S, B, kind)
    specs = jinput_specs(jc, shape)
    p = jax.eval_shape(jbuild(jc).init, jax.random.key(0))
    step = jax.jit(jmake_step_fn(jc, shape))
    args = ((p, specs["tokens"], specs["cache"]) if kind == "decode"
            else (p, specs["batch"]))
    want = hlo_analyze(step.lower(*args).compile().as_text())["flops"]

    tc = reduced(get_config("qwen1.5-0.5b"), d_model=256)
    tshape = ShapeConfig(kind, S, B, kind)
    params = build_model(tc, "meta").init(0, trainable=kind == "train")
    tspecs = input_specs(tc, tshape)
    fn = make_step_fn(tc, tshape)
    with OpCounter() as c:
        if kind == "decode":
            fn(params, tspecs["tokens"], tspecs["cache"])
        else:
            fn(params, tspecs["batch"])
    assert c.flops == pytest.approx(want, rel=0.10)
    assert sum(c.kernels.values()) == 2 * (2 if kind == "train" else 1)


# ---------------------------------------------------------------------------
# the sharding plan against the reference's rules
# ---------------------------------------------------------------------------

class _StandIn:
    """What the reference's rules read of a mesh: ``shape``."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


def _want_placements(spec, axes, ndim):
    """A reference PartitionSpec (padded to the reference leaf's rank) ->
    placements of the port's leaf, its last ``ndim`` dims."""
    spec = list(spec)[len(spec) - ndim:] if ndim else []
    out = []
    for a in axes:
        dims = [d for d, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _ref_path(name, family):
    """A port parameter's dotted name -> its path in the reference tree."""
    keys = name.split(".")
    if family == "ssm" and keys[0] == "blocks":
        path = ["blocks_list", int(keys[1])] + keys[2:]
    else:
        path = [k for k in keys if not k.isdigit()]
    leaf = path[-1]
    if leaf in ("q_norm", "kv_norm"):
        path.append("scale")
    elif isinstance(leaf, str) and leaf.startswith("shared_"):
        path[-1:] = ["shared", leaf[len("shared_"):]]
    return path


def _ref_param_spec(path, shape, mesh):
    keys = [k for k in path if isinstance(k, str)]
    is_expert = "moe" in keys and "shared" not in keys
    spec, _ = jsharding._param_rule(keys[-1], shape, mesh, is_expert)
    pad = len(shape) - len(spec)
    if pad < 0:
        return [None] * len(shape)
    return [None] * pad + list(spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_placements_equal_reference_rules(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = port_mesh.make_fake_mesh(shape, axes)
    cfg = get_config(arch)
    model = build_model(cfg, "meta").init(0)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = sharding.param_shardings(model, mesh)
    ref = jax.eval_shape(jbuild(jget(arch)).init, jax.random.key(0))
    stand_in = _StandIn(shape, axes)
    visited = set()
    for name, pl in got.items():
        path = _ref_path(name, cfg.family)
        visited.add(tuple(path))
        leaf = ref
        for k in path:
            leaf = leaf[k]
        # the reference stacks layers (and groups) on leading dims
        assert tuple(leaf.shape[len(leaf.shape) - len(shapes[name]):]) \
            == shapes[name], (name, leaf.shape)
        want = _want_placements(_ref_param_spec(path, leaf.shape, stand_in),
                                axes, len(shapes[name]))
        assert pl == want, (name, path, pl, want)
    # every leaf of the reference is some parameter's
    assert visited == {tuple(getattr(k, "key", getattr(k, "idx", None))
                             for k in kp) for kp, _ in
                       jax.tree_util.tree_flatten_with_path(ref)[0]}


def _cache_cells(cfg):
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES_BY_NAME[name]
        if shape_applicable(cfg, shape)[0]:
            yield shape.global_batch, shape.seq_len


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_and_batch_placements_equal_reference_rules(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = port_mesh.make_fake_mesh(shape, axes)
    stand_in = _StandIn(shape, axes)
    cfg, jcfg = get_config(arch), jget(arch)
    for B, S in _cache_cells(cfg):
        cache = lm.init_cache(cfg, B, S, torch.device("meta"))
        got = sharding.cache_shardings(cache, cfg, mesh, B)
        ref = jax.eval_shape(lambda: jlm.init_cache(jcfg, B, S))
        for group, leaves in got.items():
            for name, pl in leaves.items():
                for rname in (("ckv", "krope") if name == "latent"
                              else (name,)):
                    rleaf = ref[group][rname]
                    spec = list(jsharding._cache_rule(
                        rname, rleaf.shape, stand_in, B))
                    n = len(rleaf.shape)
                    spec = spec[:n] + [None] * (n - len(spec))
                    want = _want_placements(spec, axes, n)
                    assert pl == want, (group, name, B, pl, want)
    for sname in ("train_4k", "prefill_32k"):
        batch = input_specs(cfg, SHAPES_BY_NAME[sname])["batch"]
        got = sharding.batch_shardings(batch, mesh)
        for k, t in batch.items():
            spec = [jsharding._batch_spec_dim(stand_in, t.shape[0])] + \
                [None] * (t.dim() - 1)
            assert got[k] == _want_placements(spec, axes, t.dim()), k


def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(4, 8)
    assert sharding.constrain(x, ("batch", None)) is x


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

# token ids are int64, the port's index type; cache leaves keep theirs
_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


@pytest.mark.parametrize("shape_name", list(SHAPES_BY_NAME))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES_BY_NAME[shape_name]
    got = input_specs(cfg, shape)
    want = jinput_specs(jget(arch), JSHAPES[shape_name])
    assert set(got) == set(want)

    def same(t, w, what, ids=False):
        assert t.is_meta, what
        assert tuple(t.shape) == tuple(w.shape), what
        assert t.dtype == (torch.int64 if ids else _DTYPES[str(w.dtype)]), \
            (what, t.dtype, w.dtype)
    for k, w in want.get("batch", {}).items():
        same(got["batch"][k], w, k, ids=k in ("tokens", "labels"))
    if "tokens" in want:
        same(got["tokens"], want["tokens"], "tokens", ids=True)
    if "cache" in want:
        cache, ref = got["cache"], want["cache"]
        assert set(cache) == set(ref) and cache["idx"] == 0
        for group, leaves in ref.items():
            if group == "idx":
                continue
            if "ckv" in leaves:
                lat = cache[group]["latent"]
                assert set(cache[group]) == {"latent"}
                r = leaves["ckv"].shape[-1]
                same(lat[..., :r], leaves["ckv"], "ckv")
                same(lat[..., r:], leaves["krope"], "krope")
                continue
            assert set(cache[group]) == set(leaves), group
            for name, w in leaves.items():
                same(cache[group][name], w, f"{group}.{name}")


# ---------------------------------------------------------------------------
# dry-run cells
# ---------------------------------------------------------------------------

def _reduced_overrides():
    rc = reduced(get_config("qwen1.5-0.5b"), d_model=256)
    return rc, {f.name: getattr(rc, f.name) for f in dataclasses.fields(rc)}


def _rank0_numel(shape, placements, mesh_shape):
    """Elements of rank 0's shard: each split dim's first chunk."""
    dims = list(shape)
    for size, pl in zip(mesh_shape, placements):
        if isinstance(pl, Shard):
            dims[pl.dim] = -(-dims[pl.dim] // size)
    n = 1
    for d in dims:
        n *= d
    return n


@pytest.mark.parametrize("mesh_name", ["1", "2x2"])
def test_run_cell_reduced_qwen_ok(mesh_name):
    """Train on a fake 2 x 2 mesh and on one device: ok, with argument
    bytes the sum of rank 0's local shards of the parameters, AdamW's f32
    moments and the batch."""
    cfg, over = _reduced_overrides()
    rec = dryrun.run_cell("qwen1.5-0.5b", "train_4k", mesh=mesh_name,
                          verbose=False, overrides=over)
    assert rec["status"] == "ok", rec.get("error")
    # K2's forward once a layer, again in the backward under remat
    fwd = cfg.num_layers * (1 if cfg.remat == "none" else 2)
    assert rec["kernels"] == {"flash_attention": fwd,
                              "flash_attention_bwd": cfg.num_layers}
    mesh_shape, axes = dryrun.MESHES[mesh_name]
    params = build_model(cfg, "meta").init(0)
    placed = ({} if mesh_name == "1" else sharding.param_shardings(
        params, port_mesh.make_fake_mesh(mesh_shape, axes)))
    want = 0
    for name, p in params.named_parameters():
        n = _rank0_numel(p.shape, placed.get(name, ()), mesh_shape)
        want += n * (p.element_size() + 2 * 4)      # + AdamW's m, v
    B, S = 256, 4096
    rows = B // (mesh_shape[0] if mesh_shape else 1)
    want += 2 * rows * S * 8                          # tokens, labels
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["peak_bytes"] == want + rec["memory"]["temp_bytes"]
    rf = rec["roofline"]
    assert rf["t_compute_s"] == rf["flops_per_device"] / 989e12
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    if mesh_name == "1":
        assert sum(rec["collectives"].values()) == 0
    else:
        assert rec["collectives"]["all-gather"] > 0


def test_mesh_one_runs_no_process_group():
    """Mesh "1" (one H100) builds no process group; qwen1.5's decode cell
    launches K1 once a layer and needs more than a card's memory."""
    rec = dryrun.run_cell("qwen1.5-0.5b", "decode_32k", mesh="1",
                          verbose=False)
    assert rec["status"] == "ok" and not dist.is_initialized()
    assert rec["kernels"] == {"decode_attention": 24}
    assert rec["fits_80gb_hbm"] is False      # a 413 GB cache at 128 x 32k


@pytest.mark.parametrize("arch", [
    a for a in list_archs()
    if not shape_applicable(get_config(a), SHAPES_BY_NAME["long_500k"])[0]])
def test_long_500k_skipped_where_shape_applicable_says(arch):
    _, why = shape_applicable(get_config(arch), SHAPES_BY_NAME["long_500k"])
    rec = dryrun.run_cell(arch, "long_500k", mesh="16x16", verbose=False)
    assert rec == {"arch": arch, "shape": "long_500k", "mesh": "16x16",
                   "status": "skipped", "reason": why}
    assert not dist.is_initialized()


def test_production_meshes():
    m = port_mesh.make_production_mesh(multi_pod=False)
    assert tuple(m.shape) == (16, 16) and m.mesh_dim_names == ("data",
                                                                "model")
    assert dist.get_world_size() == 256
    m = port_mesh.make_production_mesh(multi_pod=True)
    assert tuple(m.shape) == (2, 16, 16)
    assert m.mesh_dim_names == ("pod", "data", "model")
    assert dist.get_world_size() == 512


def test_host_mesh_over_one_process():
    """With no process group, the host mesh is this process alone: the
    axes cut to the one rank there is."""
    m = port_mesh.make_host_mesh(model=4, data=2)
    assert m.mesh_dim_names == ("data", "model")
    assert tuple(m.shape) == (1, 1) and dist.get_world_size() == 1
