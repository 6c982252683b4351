"""``repro_torch.core`` — the Myia toolchain in PyTorch: a graph-based IR
with first-class functions/closures, closure-based source-transformation
AD, call-site-specializing type/shape inference, the worklist optimizer,
closure elimination, fusion and straight-line lowering (NeurIPS 2018,
"Automatic differentiation in ML: where we are and where we should be
going" — the Myia paper).

The port of ``repro.core``: graph-level artefacts (parsed, adjoint and
optimized encodings, structural hashes, optimizer rule hits, abstracts,
fusion plans) are equal to the reference's, and programs execute eagerly
in torch, with fused clusters as generated Triton kernels on the card.
Built programs persist in the two-tier program cache
(``torch_backend.ProgramCache``).  The SPMD tier (``spmd``,
``torch_backend.compile_graph_spmd``) runs per-shard programs on the ranks of a
``torch.distributed`` mesh; ``oo_tape`` is the paper's operator-overloading
baseline."""

from . import primitives as P  # noqa: F401
from .ad import J, build_grad_graph, build_value_and_grad_graph, build_vjp_graph  # noqa: F401
from .api import (  # noqa: F401
    CompileOptions,
    MyiaFunction,
    compile_pipeline,
    grad,
    myia,
    value_and_grad,
    vjp,
)
from .closure import FallbackReason, analyze_blockers, lower_loops  # noqa: F401
from .fusion import Cluster, FusionPlan, partition_graph  # noqa: F401
from .infer import InferenceError, infer  # noqa: F401
from .ir import Apply, Constant, Graph, Node, Parameter, clone_graph  # noqa: F401
from .lowering import LoweringError, lower_graph, lowering_blockers, try_lower  # noqa: F401
from .opt import OptStats, count_nodes, optimize  # noqa: F401
from .parser import MyiaSyntaxError, parse_function  # noqa: F401
from .serialize import (  # noqa: F401
    SerializeError,
    deserialize_graph,
    dumps,
    loads,
    serialize_graph,
    structural_hash,
)
from .torch_backend import (  # noqa: F401
    CacheStats,
    CompileFailed,
    ProgramCache,
    abstract_value_signature,
    compile_graph,
    compile_graph_spmd,
    trace_graph,
)
from .spmd import SpmdError, SpmdPlan, propagate, shard_graph  # noqa: F401
from .oo_tape import oo_grad, oo_value_and_grad  # noqa: F401
from .values import Closure, EnvInstance, SymbolicKey  # noqa: F401
from .vm import VM, run_graph  # noqa: F401
