"""Retrieval stages and agents of the port against the JAX package on
bridged weights (reduced qwen3 family, f32): embeddings and rerank scores
to 2e-5, vector search values to 1e-4 with equal ids, and identical greedy
token ids from the agents."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_family, reduced  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.rag import VectorDB as JVectorDB  # noqa: E402
from repro.rag.agents import LMAgent as JAgent  # noqa: E402
from repro.rag.embedder import Embedder as JEmbedder  # noqa: E402
from repro.rag.embedder import Reranker as JReranker  # noqa: E402
from repro.rag.stages import DRAFT_MODELS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_family as t_get_family  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.rag import VectorDB as TVectorDB  # noqa: E402
from repro_torch.rag.agents import LMAgent as TAgent  # noqa: E402
from repro_torch.rag.embedder import Embedder as TEmbedder  # noqa: E402
from repro_torch.rag.embedder import Reranker as TReranker  # noqa: E402
from repro_torch.rag.stages import DRAFT_MODELS as T_DRAFT_MODELS  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)


def _pair(role, seed=0):
    """(jax cfg, jax params, port cfg, port params) for one stage model."""
    if role == "draft":
        jcfg = reduced(DRAFT_MODELS["qwen1p5_0p5b"])
        tcfg = t_reduced(T_DRAFT_MODELS["qwen1p5_0p5b"])
    else:
        jcfg = reduced(get_family("qwen3")[role])
        tcfg = t_reduced(t_get_family("qwen3")[role])
    jp = j_build(jcfg).init(jax.random.PRNGKey(seed))
    tp = bridge.params_to_torch(jax.tree.map(np.asarray, jp), tcfg,
                                device="cpu")
    return jcfg, jp, tcfg, tp


def _token_lists(rng, n, lo, hi, vocab):
    # includes ids >= vocab, which _pad_batch clips, and short rows that pad
    return [list(rng.integers(1, vocab + 40, rng.integers(lo, hi)))
            for _ in range(n)]


def test_embedder_matches():
    jcfg, jp, tcfg, tp = _pair("embed")
    lists = _token_lists(np.random.default_rng(0), 5, 3, 40, tcfg.vocab_size)
    je = JEmbedder(jcfg, jp, max_tokens=32).embed(lists)
    te = TEmbedder(tcfg, tp, max_tokens=32).embed(lists)
    assert te.shape == (5, tcfg.d_model) and te.dtype == torch.float32
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(te.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_reranker_matches():
    jcfg, jp, tcfg, tp = _pair("rerank")
    rng = np.random.default_rng(1)
    query = list(rng.integers(1, tcfg.vocab_size, 7))
    chunks = _token_lists(rng, 4, 5, 60, tcfg.vocab_size)
    js = JReranker(jcfg, jp, max_tokens=48).score(query, chunks)
    ts = TReranker(tcfg, tp, max_tokens=48).score(query, chunks)
    assert isinstance(ts, np.ndarray) and ts.shape == (4,)
    np.testing.assert_allclose(ts, js, **TOL)


@pytest.mark.parametrize("n,k", [(20, 4), (128, 5), (300, 16), (3, 8)])
def test_vectordb_search_matches(n, k):
    """Unaligned fills exercise the lane-aligned prefix, the over-fetch and
    the padding mask; k > n clips to n."""
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((n, 32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    queries = rng.standard_normal((3, 32)).astype(np.float32)
    ids = list(range(1000, 1000 + n))
    jdb, tdb = JVectorDB(dim=32, capacity=512), \
        TVectorDB(dim=32, capacity=512, device="cpu")
    half = n // 2
    for lo, hi in ((0, half), (half, n)):      # incremental adds
        if hi > lo:
            jdb.add(jnp.asarray(vecs[lo:hi]), ids[lo:hi])
            tdb.add(torch.from_numpy(vecs[lo:hi]), ids[lo:hi])
    assert len(tdb) == n
    jv, ji = jdb.search(jnp.asarray(queries), k=k)
    tv, ti = tdb.search(torch.from_numpy(queries), k=k)
    np.testing.assert_allclose(tv, jv, atol=1e-4)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("role", ["search", "chat", "draft"])
def test_agent_generate_identical_greedy_ids(role):
    jcfg, jp, tcfg, tp = _pair(role, seed=3)
    prompt = list(np.random.default_rng(4).integers(1, tcfg.vocab_size, 16))
    ja, ta = JAgent(jcfg, jp, max_len=64), TAgent(tcfg, tp, max_len=64)
    for stop in (False, True):
        jg = ja.generate(prompt, max_new=20, stop_at_eos=stop)
        tg = ta.generate(prompt, max_new=20, stop_at_eos=stop)
        assert tg.token_ids == jg.token_ids and tg.steps == jg.steps


@pytest.mark.parametrize("role", ["chat", "draft"])
def test_agent_generate_batch_identical_greedy_ids(role):
    """Ragged prompts are left-cropped to the shortest one."""
    jcfg, jp, tcfg, tp = _pair(role, seed=5)
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(1, tcfg.vocab_size, m)) for m in (16, 11, 14)]
    ja, ta = JAgent(jcfg, jp, max_len=64), TAgent(tcfg, tp, max_len=64)
    jg = ja.generate_batch(prompts, max_new=8)
    tg = ta.generate_batch(prompts, max_new=8)
    assert [g.token_ids for g in tg] == [g.token_ids for g in jg]
    assert [g.steps for g in tg] == [8, 8, 8]
