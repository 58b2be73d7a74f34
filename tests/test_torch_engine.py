"""The port's ``ServingEngine`` (``repro_torch.serving``): the engine tests
of ``tests/test_serving.py`` on the port (reduced qwen1.5-0.5b, CPU), and
the same prompts through the JAX package's engine and the port's on
bridged weights, dense (qwen1.5-0.5b) and hybrid (zamba2-1.2b reduced to
7 layers), giving equal generated ids."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


@pytest.fixture(scope="module")
def engine():
    cfg = t_reduced(t_get_config("qwen1.5-0.5b"))
    params = t_build(cfg, "cpu").init(0)
    return ServingEngine(cfg, params, max_len=128, prefill_chunk=16,
                         token_group=4)


def test_engine_continuous_batching(engine):
    rids = [engine.submit([5 + i] * (10 + 7 * i), max_new=5)
            for i in range(3)]
    done = engine.run_to_completion()
    assert sorted(r.rid for r in done) == sorted(rids)
    for r in done:
        assert 1 <= len(r.generated) <= 5
        assert r.prefilled == len(r.prompt_ids)   # chunked prefill completed


def test_engine_chunked_prefill_bounded(engine):
    engine.submit(list(range(4, 64)), max_new=3)
    steps = 0
    while engine.queue or engine.active:
        engine.step()
        steps += 1
        assert steps < 100
    # 60 prompt tokens / 16-token chunks -> at least 4 prefill steps
    assert steps >= 4


def test_engine_admits_at_most_four_and_runs_on_the_params_device(engine):
    from repro_torch.serving.engine import MAX_SLOTS
    ops.reset_launch_counts()
    for i in range(6):
        engine.submit([7] * (5 + i), max_new=3)
    done = engine.step()
    assert len(engine.active) + len(done) == MAX_SLOTS
    assert len(engine.queue) == 2
    assert engine.device == torch.device("cpu")
    done += engine.run_to_completion()
    assert len(done) == 6 and not engine.active
    # the CPU path takes the plain versions: no kernel launched
    assert set(ops.launch_counts().values()) == {0}


ARCHS = {"qwen1.5-0.5b": 2, "zamba2-1.2b": 7}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_generates_the_jax_engines_ids(arch):
    jcfg = reduced(get_config(arch), layers=ARCHS[arch])
    tcfg = t_reduced(t_get_config(arch), layers=ARCHS[arch])
    jparams = j_build(jcfg).init(jax.random.PRNGKey(5))
    tparams = bridge.params_to_torch(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, tcfg.vocab_size, n).tolist()
               for n in (10, 23, 40)]
    kw = dict(max_len=64, prefill_chunk=16, token_group=4)
    jeng, teng = JEngine(jcfg, jparams, **kw), ServingEngine(tcfg, tparams,
                                                             **kw)
    for p in prompts:
        jeng.submit(p, max_new=6)
        teng.submit(p, max_new=6)
    jdone = {r.rid: r.generated for r in jeng.run_to_completion()}
    tdone = {r.rid: r.generated for r in teng.run_to_completion()}
    assert sorted(tdone) == [0, 1, 2]
    assert tdone == jdone


def test_profile_serve_engine_workload_runs_on_the_cpu():
    """The workload ``profile_serve --path zamba2-engine`` profiles (and
    ``chip_smoke.py`` serves) runs to completion, reduced to 7 layers on
    the CPU; it is the same on every call."""
    from repro_torch.launch import profile_serve
    run = profile_serve.engine_runner(torch.device("cpu"))
    first, second = run(), run()
    assert first["requests"] == len(profile_serve.ENGINE_PROMPTS)
    assert 0 < first["tokens"] <= (len(profile_serve.ENGINE_PROMPTS)
                                   * profile_serve.ENGINE_NEW_TOKENS)
    assert second["tokens"] == first["tokens"]
