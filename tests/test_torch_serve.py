"""The port's live serving path end to end on the CPU (reduced models, the
kernels' plain versions): a W2 query through ``HeroSession(backend="live")``
over ``repro_torch.launch.serve.build_stage_fns`` completes every node with
no stage fn retried."""
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import HeroSession  # noqa: E402
from repro_torch.core.events import EV_RETRY, EV_STRAGGLER  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.rag import default_means, sample_traces  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def test_w2_query_live_session_completes_without_retries():
    counts = serve.StageCounts()
    traces = sample_traces("finqabench", 1, seed=1)
    sess = HeroSession(world="sd8gen4", family="qwen3", backend="live",
                       means=default_means(traces),
                       stage_fns=serve.build_stage_fns(device="cpu",
                                                       counts=counts))
    sess.submit(traces[0], wf=2)
    ops.reset_launch_counts()
    (res,) = sess.run(mode="isolated", timeout=300)
    assert res.n_nodes > 10 and res.makespan > 0
    assert not [e for e in sess.last_run.events if e[1] == EV_RETRY]
    assert counts.tokens > 0 and counts.errors == 0
    # a CPU run takes the plain versions: no kernel launched
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("overrides,delay_s,retries", [
    # the first rerank attempt overruns the 50 ms heartbeat floor, is
    # cancelled and re-dispatched, and raises afterwards: the runtime drops
    # that error unread and emits no EV_RETRY
    ({"straggler_factor": 1e-9}, 0.5, 0),
    # it raises at once with re-dispatch off: the runtime retries it
    (serve.NO_STRAGGLER_REDISPATCH, 0.0, 1),
], ids=["cancelled-straggler", "retried"])
def test_stage_counts_see_every_failed_attempt(monkeypatch, overrides,
                                               delay_s, retries):
    from repro_torch.api import SessionOptions
    from repro_torch.rag.embedder import Reranker
    calls, score = [], Reranker.score

    def flaky(self, *a, **kw):
        calls.append(None)
        if len(calls) == 1:
            time.sleep(delay_s)
            raise RuntimeError("injected fault in the first attempt")
        return score(self, *a, **kw)
    monkeypatch.setattr(Reranker, "score", flaky)
    counts = serve.StageCounts()
    traces = sample_traces("finqabench", 1, seed=1)
    sess = HeroSession(world="sd8gen4", family="qwen3", backend="live",
                       means=default_means(traces),
                       options=SessionOptions(cfg_overrides=overrides),
                       stage_fns=serve.build_stage_fns(device="cpu",
                                                       counts=counts))
    sess.submit(traces[0], wf=2)
    sess.run(mode="isolated", timeout=300)
    events = sess.last_run.events
    assert sum(e[1] == EV_RETRY for e in events) == retries
    if not retries:
        assert any(e[1] == EV_STRAGGLER and "rerank" in e[2] for e in events)
    assert counts.errors == 1


@pytest.mark.parametrize("argv", [
    ["--workflow", "2", "--queries", "1"],
    ["--workflow", "2", "--queries", "1", "--no-straggler-redispatch"],
    ["--serve", "--spec-decode", "--queries", "2", "--inter-arrival", "0.05"],
])
def test_serve_main_reports_every_node_done(argv, capsys):
    report = serve.main(["--device", "cpu", *argv])
    assert report.nodes > 10
    assert report.unfinished == []
    assert report.retries == 0 and report.stage_errors == 0
    assert report.tokens > 0
    assert len(report.results) == int(argv[argv.index("--queries") + 1])
    if "--no-straggler-redispatch" in argv:
        assert report.stragglers == 0
    assert "tokens generated" in capsys.readouterr().out


def _chat_weight_sum(hashseed: str) -> str:
    code = ("from repro_torch.launch.serve import build_pipeline\n"
            "chat = build_pipeline(device='cpu')[4]\n"
            "print(repr(float(chat.params.blocks[0].attn['wq'].sum())))\n")
    env = {**os.environ, "PYTHONHASHSEED": hashseed, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120, check=True)
    return out.stdout.strip()


def test_role_weights_do_not_depend_on_the_hash_salt():
    """Each role's weights come from a fixed seed, not ``hash(role)``,
    which Python salts per process."""
    assert _chat_weight_sum("1") == _chat_weight_sum("2")
