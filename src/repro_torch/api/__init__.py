# HeRo session API — the one way to run HeRo (simulated or live).
#
#   from repro_torch.api import HeroSession
#   sess = HeroSession(world="sd8gen4", family="qwen3", strategy="hero")
#   h = sess.submit(trace, wf=2)
#   [result] = sess.run()
#
# Low-level building blocks (Simulator, HeroScheduler, HeroRuntime, ...)
# stay importable from repro_torch.core / repro_torch.serving for the figure benchmarks.
from repro_torch.api.backends import (  # noqa: F401
    Backend, BackendRun, LiveBackend, SimBackend)
from repro_torch.api.options import SessionOptions  # noqa: F401
from repro_torch.api.results import QueryResult, collect_results  # noqa: F401
from repro_torch.api.session import HeroSession, QueryHandle, make_world  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    BranchGroup, BranchStage, CollectorSpec, DecodeSpec, StageSpec,
    WorkflowSpec, builtin_spec)
