"""``repro_torch.serve`` — the inference runtime over the compiled Myia
pipeline, the port of ``repro.serve``.

The same optimized graphs the trainer lowers are specialized per shape
*bucket* (bounded, not per-length), built once, persisted in the program
cache (``repro_torch.core.torch_backend.ProgramCache``), and replayed
across process restarts with zero programs built.
"""

from .engine import (  # noqa: F401
    DeadlineExceeded,
    NumericalFault,
    Request,
    RequestRejected,
    ServeEngine,
    ServeError,
    bucket_for,
    oracle_generate,
)
from .faults import (  # noqa: F401
    CacheFault,
    CompileFault,
    DecodeNaN,
    FaultPlan,
    StepDelay,
    inject_faults,
)
from .model import (  # noqa: F401
    ServeLMDims,
    build_decode_step,
    build_prefill,
    causal_mask,
    decode_masks,
    finite_lanes,
    init_serve_params,
)
