"""rails_tpu: a low-rank Lyapunov solver framework in JAX.

A from-scratch reimplementation of the capabilities of Sbte/RAILS
(residual-approximation iterative Lyapunov solver) for the GPU:
JAX/XLA compute, static-shape masked state, sharded multi-device
execution over a jax.sharding.Mesh, and C++ host-side runtime pieces
(IO parsing, sparse LU) where the reference used native code.

Solves  A @ X @ M' + M @ X @ A' + B @ B' = 0  for X ~= V T V' low rank.
"""

__version__ = "0.1.0"

from rails_tpu.linalg.dense_lyap import lyap, lyap_residual  # noqa: F401
from rails_tpu.operators import (  # noqa: F401
    CallableOperator,
    DenseOperator,
    DiagonalOperator,
    IdentityOperator,
    LinearOperator,
    LowRankOperator,
    as_operator,
    operator_norm2,
)
from rails_tpu.core.options import (  # noqa: F401
    InvalidOption,
    InverseNotUsedWarning,
    ProjectedSolverPerformanceWarning,
    ProjectionMethodWarning,
    SingularMassMatrixWarning,
    SolverOptions,
)
from rails_tpu.core.solver import LyapunovSolver, SolveInfo, solve  # noqa: F401
from rails_tpu.eigs import eigs, eigs_general, EigsConvergenceWarning  # noqa: F401
from rails_tpu.refine import RefineInfo, solve_refined  # noqa: F401
from rails_tpu.schur import SchurReduction, schur_reduce  # noqa: F401
from rails_tpu.sparse.formats import (  # noqa: F401
    DiaMatrix,
    EllMatrix,
    HybMatrix,
    SparseOperator,
    sparse_from_csr,
    sparse_from_dense,
    sparse_from_scipy,
)
from rails_tpu.timer import (  # noqa: F401
    disable_profiling,
    enable_profiling,
    save_profiles,
    timer,
)
