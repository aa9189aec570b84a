"""Linear operator protocol - the JAX equivalent of the reference's
backend wrapper layer (L2).

The reference's core solver is a C++ template over duck-typed backend
wrappers (Solver<Matrix, MultiVector, DenseMatrix>,
/root/reference/src/LyapunovSolverDecl.hpp:9-51) with Stl/Epetra/Scalar
implementations.  The analogue here: multivectors are plain
(possibly sharded) jax.Arrays - JAX's sharding model already makes
V.T @ W work identically on one device or a mesh - so only the *operator*
(the sparse/structured/matrix-free A) needs an abstraction.

Every operator is a registered pytree, so operators can be passed through
``jax.jit`` boundaries and their arrays donated/sharded like any other
input.  Static *structure* (shape, symmetry tags) lives in the pytree aux
data; numeric payloads are leaves.

Operator tags (``is_symmetric``, ``is_spd``, ``is_hurwitz``) drive the
*static* selection of the projected dense solver (eigh vs schur vs sign)
- resolved at trace time, never data-dependent.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "DiagonalOperator",
    "IdentityOperator",
    "CallableOperator",
    "LowRankOperator",
    "as_operator",
    "operator_norm2",
]


class LinearOperator:
    """Base protocol.  Subclasses implement matmat/rmatmat.

    Attributes:
      shape: (m, n) global shape.
      is_symmetric: A == A' (enables eigh projected solves and symmetric
        Lanczos shortcuts).
      is_spd: symmetric positive definite (mass matrices).
      is_hurwitz: spectrum in the open left half-plane (enables the sign
        projected solver).
    """

    shape: Tuple[int, int]
    is_symmetric: bool = False
    is_spd: bool = False
    is_hurwitz: bool = False

    def matmat(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def rmatmat(self, x: jax.Array) -> jax.Array:
        """A' @ x."""
        raise NotImplementedError

    def __matmul__(self, x):
        if isinstance(x, jax.Array) or hasattr(x, "ndim"):
            return self.matmat(x)
        return NotImplemented

    @property
    def T(self) -> "LinearOperator":
        return _TransposedOperator(self)

    @property
    def payload_dtype(self):
        """dtype of the numeric payload, or None for matrix-free ops."""
        for attr in ("a", "d", "u"):
            x = getattr(self, attr, None)
            if x is not None and hasattr(x, "dtype"):
                return x.dtype
        return None

    def to_dense(self) -> jax.Array:
        eye = jnp.eye(self.shape[1])
        return self.matmat(eye)

    def astype(self, dtype) -> "LinearOperator":
        """Return this operator with numeric payloads cast to ``dtype``.

        Matrix-free operators (no payload) return themselves: their
        output dtype follows the operand.  Caveat: a CallableOperator
        whose closure captures constants of a *different* dtype will
        still promote the result (closed-over constants are not cast) -
        build the closure at the solve dtype.  Payload-carrying
        subclasses override so a float64-built operator can drive a
        float32 solve without mixed-dtype scatters.
        """
        return self


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class _TransposedOperator(LinearOperator):
    base: LinearOperator

    @property
    def shape(self):
        return (self.base.shape[1], self.base.shape[0])

    @property
    def is_symmetric(self):
        return self.base.is_symmetric

    @property
    def is_spd(self):
        return self.base.is_spd

    def matmat(self, x):
        return self.base.rmatmat(x)

    def rmatmat(self, x):
        return self.base.matmat(x)

    def astype(self, dtype):
        return _TransposedOperator(self.base.astype(dtype))

    def tree_flatten(self):
        return (self.base,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])


@jax.tree_util.register_pytree_node_class
class DenseOperator(LinearOperator):
    """A dense m-by-n matrix.  The right answer for m up to a few
    thousand: a dense m x m product at these sizes runs as one GEMM and
    beats any sparse format."""

    def __init__(self, a, *, is_symmetric=False, is_spd=False, is_hurwitz=False):
        self.a = jnp.asarray(a) if not isinstance(a, jax.core.Tracer) else a
        self.is_symmetric = is_symmetric
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz

    @property
    def shape(self):
        return self.a.shape

    def matmat(self, x):
        return self.a @ x

    def rmatmat(self, x):
        return self.a.T @ x

    def to_dense(self):
        return self.a

    def astype(self, dtype):
        if self.a.dtype == jnp.dtype(dtype):
            return self
        return DenseOperator(self.a.astype(dtype),
                             is_symmetric=self.is_symmetric,
                             is_spd=self.is_spd, is_hurwitz=self.is_hurwitz)

    def tree_flatten(self):
        return (self.a,), (self.is_symmetric, self.is_spd, self.is_hurwitz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.a = children[0]
        obj.is_symmetric, obj.is_spd, obj.is_hurwitz = aux
        return obj


@jax.tree_util.register_pytree_node_class
class DiagonalOperator(LinearOperator):
    """diag(d) - the common mass-matrix case (M = spdiags(rand(n,1)) in the
    reference tests, /root/reference/matlab/test/test_Laplace.m:37)."""

    is_symmetric = True

    def __init__(self, d, *, is_spd=None):
        self.d = jnp.asarray(d)
        # Diagonal SPD check is cheap and host-side when concrete.
        if is_spd is None:
            try:
                is_spd = bool(jnp.all(self.d > 0))
            except jax.errors.TracerBoolConversionError:
                is_spd = False
        self.is_spd = is_spd

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    def matmat(self, x):
        return self.d[:, None] * x

    def matmat2(self, x):
        """Error-free apply (hi, lo) for the refined driver."""
        from rails_tpu.utils.compensated import two_prod

        return two_prod(self.d[:, None], x)

    def rmatmat(self, x):
        return self.d[:, None] * x

    def to_dense(self):
        return jnp.diag(self.d)

    def astype(self, dtype):
        if self.d.dtype == jnp.dtype(dtype):
            return self
        return DiagonalOperator(self.d.astype(dtype), is_spd=self.is_spd)

    def tree_flatten(self):
        return (self.d,), (self.is_spd,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.d = children[0]
        (obj.is_spd,) = aux
        return obj


@jax.tree_util.register_pytree_node_class
class IdentityOperator(LinearOperator):
    is_symmetric = True
    is_spd = True

    def __init__(self, n: int):
        self.n = n

    @property
    def shape(self):
        return (self.n, self.n)

    def matmat(self, x):
        return x

    def matmat2(self, x):
        return x, jnp.zeros_like(x)

    def rmatmat(self, x):
        return x

    def to_dense(self):
        return jnp.eye(self.n)

    def tree_flatten(self):
        return (), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0])


@jax.tree_util.register_pytree_node_class
class CallableOperator(LinearOperator):
    """Matrix-free operator from jax-traceable callables.

    The analogue of the reference's Epetra_Operator-wrapped
    SchurOperator (matrix-free Schur complement,
    /root/reference/src/SchurOperator.cpp:201-233) and of MATLAB's
    function-handle A (/root/reference/matlab/RAILSsolver.m:259-270).
    """

    def __init__(self, fn, shape, rfn=None, *, is_symmetric=False,
                 is_spd=False, is_hurwitz=False):
        self.fn = fn
        self.rfn = rfn
        self._shape = tuple(shape)
        self.is_symmetric = is_symmetric
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz
        if rfn is None and not is_symmetric:
            raise ValueError(
                "CallableOperator needs rfn (transpose apply) unless symmetric")

    @property
    def shape(self):
        return self._shape

    def matmat(self, x):
        return self.fn(x)

    def rmatmat(self, x):
        if self.is_symmetric and self.rfn is None:
            return self.fn(x)
        return self.rfn(x)

    def tree_flatten(self):
        # callables are static; arrays they close over become constants
        return (), (self.fn, self.rfn, self._shape, self.is_symmetric,
                    self.is_spd, self.is_hurwitz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.fn, obj.rfn, obj._shape, obj.is_symmetric, obj.is_spd, \
            obj.is_hurwitz = aux
        return obj


@jax.tree_util.register_pytree_node_class
class LowRankOperator(LinearOperator):
    """U @ W' as an operator (solution operators V T V', B B', ...)."""

    def __init__(self, u, w=None):
        self.u = jnp.asarray(u)
        self.w = self.u if w is None else jnp.asarray(w)

    @property
    def shape(self):
        return (self.u.shape[0], self.w.shape[0])

    @property
    def is_symmetric(self):
        return self.u is self.w

    def matmat(self, x):
        return self.u @ (self.w.T @ x)

    def rmatmat(self, x):
        return self.w @ (self.u.T @ x)

    def astype(self, dtype):
        if self.u.dtype == jnp.dtype(dtype) and self.w.dtype == jnp.dtype(dtype):
            return self
        sym = self.u is self.w
        u = self.u.astype(dtype)
        return LowRankOperator(u, None if sym else self.w.astype(dtype))

    def tree_flatten(self):
        return (self.u, self.w), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = cls.__new__(cls)
        obj.u, obj.w = children
        return obj


def as_operator(a, **tags) -> LinearOperator:
    """Coerce an array / scipy sparse / BCOO / callable into an operator."""
    if isinstance(a, LinearOperator):
        return a
    try:
        import scipy.sparse as _sp

        if _sp.issparse(a):
            from rails_tpu.sparse.formats import sparse_from_scipy

            return sparse_from_scipy(a, **tags)
    except ImportError:
        pass
    try:
        from jax.experimental.sparse import BCOO

        if isinstance(a, BCOO):
            from rails_tpu.sparse.formats import sparse_from_scipy
            import scipy.sparse as _sp

            coo = _sp.coo_matrix(
                (np.asarray(a.data), np.asarray(a.indices).T), shape=a.shape)
            return sparse_from_scipy(coo.tocsr(), **tags)
    except ImportError:
        pass
    if callable(a) and not hasattr(a, "ndim"):
        raise TypeError("wrap callables explicitly with CallableOperator "
                        "(a shape is required)")
    arr = jnp.asarray(a)
    if arr.ndim == 1:
        return DiagonalOperator(arr, **tags)
    return DenseOperator(arr, **tags)


def operator_norm2(op: LinearOperator, iters: int = 30,
                   key: Optional[jax.Array] = None) -> jax.Array:
    """Spectral 2-norm via power iteration on A'A.

    The reference computes operator norms by explicit A'A SpGEMM + dense
    eigs (/root/reference/src/Epetra_OperatorWrapper.cpp:115-145) or Gram
    eigs (/root/reference/src/StlWrapper.cpp:265-289); matrix-free power
    iteration avoids materializing anything at scale.
    """
    m = op.shape[1]
    if key is None:
        key = jax.random.PRNGKey(0)
    v = jax.random.normal(key, (m, 1))
    v = v / jnp.linalg.norm(v)

    def body(_, v):
        w = op.rmatmat(op.matmat(v))
        return w / (jnp.linalg.norm(w) + 1e-300)

    v = jax.lax.fori_loop(0, iters, body, v)
    return jnp.sqrt(jnp.linalg.norm(op.rmatmat(op.matmat(v))))
