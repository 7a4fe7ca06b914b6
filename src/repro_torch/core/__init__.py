"""The paper's contribution: flexible performance SLAs for serverless
query processing, with SOS (stage-oriented scaling) execution. The live
engine (``core.live``) imports torch and the model zoo, so it is imported
on its own."""
from .allocation import AllocationConfig, AllocationPoint, Allocator
from .clusters import (
    AutoscaleConfig,
    CostEfficientCluster,
    FaultModel,
    HighElasticCluster,
)
from .calibration import (
    CalibrationTable,
    LiveCalibrator,
    fit_dryruns,
    invalidate_default_calibration,
)
from .engine import ClusterExecutor, StageEvent
from .insights import CostExplorer, export_trace, price_menu
from .cost_model import CostModel, Stage, StagePlan
from .pools import PoolSpec, build_pool, default_pool_specs
from .query import Query, QueryWork
from .scheduler import (
    BoEScheduler,
    CrossPoolFusionIndex,
    PendingQueue,
    QueryCoordinator,
    RelaxedScheduler,
    ServiceLayer,
    fuse_queries,
    fusion_key,
    unpack_fused,
)
from .simulator import SimConfig, SimResult, Simulation, run_sim
from .sla import Policy, ServiceLevel, SLAConfig
from .workload import TABLE1, generate, scaled_patterns, stream_histogram
