"""repro_torch.serve — the annealing service (port of ``repro.serve``'s
one-shot service): shape-bucketed, batched, program-cached Max-Cut solving
over the plateau engine, the paper's own workload.  The streaming front
door (``repro.serve.stream``) waits for ROADMAP.md queue 1 step 7; the LM
serving stack for step 10."""
from .anneal_service import (  # noqa: F401
    AnnealProgress,
    AnnealRequest,
    AnnealResponse,
    AnnealService,
)
from .registry import (  # noqa: F401
    AlgoFamily,
    family_for,
    register_algo,
    registered_algos,
)
from .resilience import (  # noqa: F401
    STATUS_DEADLINE,
    STATUS_FAILED,
    STATUS_FALLBACK,
    STATUS_OK,
    STATUS_QUARANTINED,
    STATUS_SHED,
    AdmissionError,
    QuarantineFault,
    QueueFullError,
    ResiliencePolicy,
    ServiceEvent,
)
