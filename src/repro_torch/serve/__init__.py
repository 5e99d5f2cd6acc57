"""repro_torch.serve — the annealing service (port of ``repro.serve``'s
annealing half): shape-bucketed, batched, program-cached Max-Cut solving
over the plateau engine, the paper's own workload, as one-shot batches
(``AnnealService``) or a continuously batched stream
(``StreamingAnnealService``).  The LM prefill/decode serving path is
:mod:`repro_torch.serve.lm`."""
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
    group_fingerprint,
)
from .stream import StreamingAnnealService, StreamPolicy, StreamTicket  # noqa: F401
