from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.executor import HeroRuntime, PUExecutor  # noqa: F401
