# HeRo core: heterogeneous performance modeling + the adaptive online
# scheduler (paper §3-§4), plus the event-driven validation simulator.
from repro_torch.core.dag import DynamicDAG, Node, WorkflowTemplate  # noqa: F401
from repro_torch.core.perf_model import (  # noqa: F401
    PU, SoCSpec, StageModel, GroundTruthPerf, LinearPerfModel, Config,
    snapdragon_8gen3, snapdragon_8gen4, tpu_v5e_slices)
from repro_torch.core.batch_policy import (  # noqa: F401
    AdaptiveBatchPolicy, ArrivalTracker, FixedBatchPolicy, make_policy)
from repro_torch.core.kv_pages import (  # noqa: F401
    KVPage, PagedKVCache, PagedStream, page_keys)
from repro_torch.core.kv_residency import KVResidency, StreamKV  # noqa: F401
from repro_torch.core.scheduler import (  # noqa: F401
    HeroScheduler, SchedulerConfig, strategy_config)
from repro_torch.core.simulator import Simulator, SimResult  # noqa: F401
