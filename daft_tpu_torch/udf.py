"""User-defined functions.

Reference: ``daft_tpu/udf.py`` (after ``daft/udf.py``): the ``@udf``
decorator builds a :class:`UDF` whose call makes a ``udf`` expression; the
evaluator runs it per batch through :func:`run_udf_batches` (batch
slicing, scalar broadcasting, output coercion). The SQL frontend's
scalar-cardinality checks (``logical/subquery.py``) are such UDFs. A UDF
runs on the host: the device compiler declines the ``udf`` op.

Stateful (class) UDFs (``init_args``, ``concurrency``) are planned into
``UDFProject`` nodes (``logical/builder._project_maybe_udf``) and run in
an actor pool (``actor_pool.py``): ``concurrency`` spawned processes, one
instance each. Two cases keep the one shared in-process instance, as in
the reference: a UDF that does not pickle (``actor_pool.try_make_pool``)
and a batch with a Python-object column or return type, which Arrow IPC
cannot carry. An error raised inside an actor is raised to the caller
(the reference re-runs the batch in-process instead).
"""

from __future__ import annotations

import functools
import inspect
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

from .datatype import DataType
from .expressions.expressions import Expression
from .series import Series


class UDF:
    def __init__(self, func: Callable, return_dtype: DataType,
                 num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 memory_bytes: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 concurrency: Optional[int] = None,
                 init_args: Optional[Tuple[tuple, dict]] = None):
        self.func = func
        self.return_dtype = return_dtype
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus
        self.memory_bytes = memory_bytes
        self.batch_size = batch_size
        self.concurrency = concurrency
        self.init_args = init_args
        self.is_stateful = inspect.isclass(func)
        self._instance = None
        self._pool: Any = "unset"
        self._instance_lock = threading.Lock()
        if not self.is_stateful:
            functools.update_wrapper(self, func)
        self.name = getattr(func, "__name__", type(func).__name__)

    def __call__(self, *args, **kwargs) -> Expression:
        exprs = []
        arg_spec: List[Tuple[str, Any]] = []  # ("expr", idx) | ("lit", value)
        for a in args:
            if isinstance(a, Expression):
                arg_spec.append(("expr", len(exprs)))
                exprs.append(a)
            else:
                arg_spec.append(("lit", a))
        kw_spec: Dict[str, Any] = {}
        for k, v in kwargs.items():
            if isinstance(v, Expression):
                kw_spec[k] = ("expr", len(exprs))
                exprs.append(v)
            else:
                kw_spec[k] = ("lit", v)
        return Expression("udf", tuple(exprs),
                          (self, tuple(arg_spec), tuple(sorted(kw_spec.items()))))

    def override_options(self, *, num_cpus=None, num_gpus=None,
                         memory_bytes=None, batch_size=None) -> "UDF":
        return UDF(self.func, self.return_dtype,
                   num_cpus if num_cpus is not None else self.num_cpus,
                   num_gpus if num_gpus is not None else self.num_gpus,
                   memory_bytes if memory_bytes is not None else self.memory_bytes,
                   batch_size if batch_size is not None else self.batch_size,
                   self.concurrency, self.init_args)

    def with_concurrency(self, concurrency: int) -> "UDF":
        return UDF(self.func, self.return_dtype, self.num_cpus, self.num_gpus,
                   self.memory_bytes, self.batch_size, concurrency,
                   self.init_args)

    def with_init_args(self, *args, **kwargs) -> "UDF":
        return UDF(self.func, self.return_dtype, self.num_cpus, self.num_gpus,
                   self.memory_bytes, self.batch_size, self.concurrency,
                   (args, kwargs))

    def _callable(self) -> Callable:
        """The function, or a stateful UDF's one in-process instance
        (built at first use)."""
        if not self.is_stateful:
            return self.func
        with self._instance_lock:
            if self._instance is None:
                a, kw = self.init_args or ((), {})
                # daft-lint: allow(blocking-under-lock) -- build once: a
                # second caller waits for the one instance
                self._instance = self.func(*a, **kw)
            return self._instance

    def _get_pool(self):
        """The actor pool of a stateful UDF, made at first use; None for
        the shared in-process instance (a stateless UDF, a UDF that does
        not pickle, or ``DAFT_TORCH_ACTOR_POOL=0``)."""
        if not self.is_stateful:
            return None
        with self._instance_lock:
            if self._pool == "unset":
                from . import actor_pool
                # daft-lint: allow(blocking-under-lock) -- spawn once: a
                # second caller waits for the one pool
                self._pool = actor_pool.try_make_pool(self)
            return self._pool

    def run(self, evaluated: List[Series], arg_spec, kw_spec,
            length: int) -> Series:
        """Called per batch by the evaluator. A stateful UDF's batch goes
        to its actor pool (``concurrency`` processes, one instance each),
        unless a column or the return type holds Python objects."""
        ipc_ok = self.return_dtype.kind != "python" \
            and not any(s.is_pyobject() for s in evaluated)
        # the pool starts at the first batch that can cross to it (the
        # reference starts it at the first batch of any kind)
        pool = self._get_pool() if ipc_ok else None
        if pool is not None:
            return pool.call(evaluated, arg_spec, kw_spec, length)
        return run_udf_batches(self._callable(), evaluated, arg_spec,
                               kw_spec, length, self.batch_size,
                               self.return_dtype, self.name)


def run_udf_batches(fn: Callable, evaluated: List[Series], arg_spec, kw_spec,
                    length: int, batch_size: Optional[int],
                    return_dtype: DataType, name: str) -> Series:
    """Slice the batch into ``batch_size`` chunks, broadcast literal
    arguments, call ``fn`` and coerce each chunk's output (in-process and
    in an actor, ``actor_pool._actor_main``)."""
    chunks: List[Series] = []
    bs = batch_size or length or 1
    for start in range(0, max(length, 1), bs):
        end = min(start + bs, length)

        def materialize(spec):
            kind, v = spec
            if kind == "expr":
                s = evaluated[v]
                return s.slice(start, end) if len(s) == length else s
            return v

        call_args = [materialize(s) for s in arg_spec]
        call_kwargs = {k: materialize(s) for k, s in kw_spec}
        out = fn(*call_args, **call_kwargs)
        chunks.append(coerce_udf_output(out, return_dtype, end - start))
    if not chunks:
        return Series.empty(name, return_dtype)
    return Series.concat(chunks) if len(chunks) > 1 else chunks[0]


def coerce_udf_output(out: Any, dtype: DataType, length: int) -> Series:
    if isinstance(out, Series):
        return out.cast(dtype)
    if isinstance(out, (pa.Array, pa.ChunkedArray)):
        return Series.from_arrow(out).cast(dtype)
    if isinstance(out, np.ndarray):
        return Series.from_numpy(out).cast(dtype)
    if isinstance(out, list):
        return Series.from_pylist(out, "udf", dtype=dtype)
    # scalar -> broadcast
    return Series.from_pylist([out] * length, "udf", dtype=dtype)


def udf(*, return_dtype: DataType, num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None, memory_bytes: Optional[int] = None,
        batch_size: Optional[int] = None,
        concurrency: Optional[int] = None) -> Callable[[Callable], UDF]:
    """``@daft_tpu_torch.udf(return_dtype=...)`` decorator."""

    def wrap(fn: Callable) -> UDF:
        return UDF(fn, return_dtype, num_cpus, num_gpus, memory_bytes,
                   batch_size, concurrency)
    return wrap


def expr_has_stateful_udf(e: Expression) -> bool:
    if e.op == "udf" and e.params[0].is_stateful:
        return True
    return any(expr_has_stateful_udf(c) for c in e.args)


def stateful_udf_concurrency(exprs) -> Optional[int]:
    """The ``concurrency`` of the first stateful UDF in ``exprs``."""
    for e in exprs:
        if e.op == "udf" and e.params[0].is_stateful:
            return e.params[0].concurrency
        for c in e.args:
            r = stateful_udf_concurrency([c])
            if r is not None:
                return r
    return None
