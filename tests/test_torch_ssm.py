"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on bridged weights, at the reduced zamba2
widths (d 64, 8 heads of 16, state 16, chunk 32), in f32.

l = 40 with chunk 32 pads to two chunks, so the padding path (dt forced to
0 on the padded rows, the conv state taken from the real rows) runs.
Outputs and new states match to 1e-4."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def block():
    jcfg = reduced(get_config("zamba2-1.2b"))
    tcfg = t_reduced(t_get_config("zamba2-1.2b"))
    jp = jssm.init_mamba2(jax.random.PRNGKey(3), jcfg.d_model, jcfg.ssm,
                          jnp.float32)
    tp = {k: bridge.to_torch(np.asarray(v), "cpu") for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _state(rng, cfg, b):
    st = jssm.init_mamba2_state(b, cfg.d_model, cfg.ssm, jnp.float32)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in st.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_jax(block, with_state):
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(4)
    b, l = 2, 40
    assert l % tcfg.ssm.chunk_size != 0       # the padding path
    x = rng.standard_normal((b, l, tcfg.d_model)).astype(np.float32)
    st = _state(rng, tcfg, b) if with_state else None
    jout, jst = jssm.mamba2_forward(
        jp, jnp.asarray(x), jcfg.ssm, return_state=True,
        init_state=None if st is None else
        {k: jnp.asarray(v) for k, v in st.items()})
    tout, tst = tssm.mamba2_forward(
        tp, torch.from_numpy(x), tcfg.ssm, return_state=True,
        init_state=None if st is None else
        {k: torch.from_numpy(v) for k, v in st.items()})
    assert tout.shape == (b, l, tcfg.d_model)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert sorted(tst) == sorted(jst)
    for k in jst:
        assert tuple(tst[k].shape) == jst[k].shape, k
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   **TOL, err_msg=k)


def test_mamba2_steps_continue_the_forward(block):
    """A prefill of 37 tokens then three single-token steps give the full
    forward's last outputs (the reference's prefill/decode consistency)."""
    jcfg, tcfg, _, tp = block
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 40, tcfg.d_model)).astype(
        np.float32))
    full, _ = tssm.mamba2_forward(tp, x, tcfg.ssm)
    zero = tssm.init_mamba2_state(1, tcfg.d_model, tcfg.ssm, torch.float32,
                                  torch.device("cpu"))
    _, st = tssm.mamba2_forward(tp, x[:, :37], tcfg.ssm, init_state=zero,
                                return_state=True)
    for t in range(37, 40):
        y, st = tssm.mamba2_step(tp, x[:, t:t + 1], tcfg.ssm, st)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4)


def test_init_mamba2_follows_the_reference_distributions():
    tcfg = t_reduced(t_get_config("zamba2-1.2b"))
    s, d = tcfg.ssm, tcfg.d_model
    g = torch.Generator().manual_seed(0)
    p = tssm.init_mamba2(d, s, torch.float32, g, torch.device("cpu"))
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), d, s, jnp.float32)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in jp.items()}
    H = s.expand * d // s.head_dim
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-6)
    assert torch.equal(p["D"], torch.ones(H))
    assert torch.equal(p["dt_bias"], torch.zeros(H))
    di = s.expand * d
    z = p["w_out"] * di ** 0.5
    assert float(z.abs().max()) <= 2.0
    assert abs(float(z.std()) - 0.8796) < 0.03
