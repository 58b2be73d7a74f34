# serving/engine.py (ServingEngine) is not ported yet: a later slice.
from repro_torch.serving.executor import HeroRuntime, PUExecutor  # noqa: F401
