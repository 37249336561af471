"""Expression DSL.

Capability mirror of the reference's ``daft-dsl`` crate
(``src/daft-dsl/src/expr/mod.rs:213-292`` — the ``Expr`` enum with
Column/Alias/Agg/BinaryOp/Cast/Not/IsNull/FillNull/IsIn/Between/Literal/IfElse/
ScalarFunction variants) and the Python expression surface
(``daft/expressions/expressions.py:287`` and its 14 namespaces at ``:1877-5136``).

Designed fresh: expressions are immutable trees that know how to
(1) infer their output ``Field`` against a ``Schema``,
(2) evaluate on the host against a ``RecordBatch`` (Arrow C++ compute), and
(3) compile to a torch program for the device path
    (see ``daft_tpu_torch.device.compiler``).
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple

from ..datatype import DataType
from ..schema import Field, Schema

# ---------------------------------------------------------------------------
# node kinds


class Expression:
    """An expression over columns, evaluable to a Series."""

    __slots__ = ("op", "args", "params")

    def __init__(self, op: str, args: Tuple["Expression", ...] = (),
                 params: Tuple = ()):
        self.op = op          # node kind, e.g. "col", "lit", "add", "agg.sum"
        self.args = args      # child expressions
        self.params = params  # non-expression parameters (names, dtypes, fns)

    # -- constructors -----------------------------------------------------
    @staticmethod
    def _col(name: str) -> "Expression":
        return Expression("col", (), (name,))

    @staticmethod
    def _lit(value: Any) -> "Expression":
        return Expression("lit", (), (value,))

    @staticmethod
    def _to_expression(obj: Any) -> "Expression":
        if isinstance(obj, Expression):
            return obj
        return Expression._lit(obj)

    # -- naming / structure ------------------------------------------------
    def alias(self, name: str) -> "Expression":
        return Expression("alias", (self,), (name,))

    def name(self) -> str:
        """The output column name of this expression."""
        if self.op == "alias":
            return self.params[0]
        if self.op == "col":
            return self.params[0]
        if self.op == "lit":
            return "literal"
        if self.op == "list":
            return "list"
        if self.op == "if_else":
            # matches typing's infer_field: the value (THEN) branch names
            # the output, not the condition
            return self.args[1].name()
        if self.args:
            return self.args[0].name()
        return self.op

    def _unalias(self) -> "Expression":
        return self.args[0]._unalias() if self.op == "alias" else self

    def children(self) -> Tuple["Expression", ...]:
        return self.args

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        return Expression(self.op, tuple(children), self.params)

    def column_names(self) -> List[str]:
        """All input column names referenced (deduped, in order)."""
        out: List[str] = []

        def walk(e: "Expression"):
            if e.op == "col":
                if e.params[0] not in out:
                    out.append(e.params[0])
            for c in e.args:
                walk(c)
        walk(self)
        return out

    def has_agg(self) -> bool:
        if self.op.startswith("agg."):
            return True
        return any(c.has_agg() for c in self.args)

    def is_column(self) -> bool:
        return self.op == "col"

    def is_literal(self) -> bool:
        return self.op == "lit"

    def structurally_eq(self, other: "Expression") -> bool:
        return self._key() == other._key()

    def _key(self) -> Tuple:
        return (self.op, tuple(a._key() for a in self.args),
                tuple(_param_key(p) for p in self.params))

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        """NOTE: `==` builds an equality *expression* (like the reference).

        Use ``structurally_eq`` for structural comparison.
        """
        return Expression("eq", (self, Expression._to_expression(other)))

    def __ne__(self, other):
        return Expression("neq", (self, Expression._to_expression(other)))

    # -- operators ---------------------------------------------------------
    def __add__(self, other): return Expression("add", (self, Expression._to_expression(other)))
    def __radd__(self, other): return Expression("add", (Expression._to_expression(other), self))
    def __sub__(self, other): return Expression("sub", (self, Expression._to_expression(other)))
    def __rsub__(self, other): return Expression("sub", (Expression._to_expression(other), self))
    def __mul__(self, other): return Expression("mul", (self, Expression._to_expression(other)))
    def __rmul__(self, other): return Expression("mul", (Expression._to_expression(other), self))
    def __truediv__(self, other): return Expression("div", (self, Expression._to_expression(other)))
    def __rtruediv__(self, other): return Expression("div", (Expression._to_expression(other), self))
    def __floordiv__(self, other): return Expression("floordiv", (self, Expression._to_expression(other)))
    def __rfloordiv__(self, other): return Expression("floordiv", (Expression._to_expression(other), self))
    def __mod__(self, other): return Expression("mod", (self, Expression._to_expression(other)))
    def __rmod__(self, other): return Expression("mod", (Expression._to_expression(other), self))
    def __pow__(self, other): return Expression("pow", (self, Expression._to_expression(other)))
    def __lt__(self, other): return Expression("lt", (self, Expression._to_expression(other)))
    def __le__(self, other): return Expression("le", (self, Expression._to_expression(other)))
    def __gt__(self, other): return Expression("gt", (self, Expression._to_expression(other)))
    def __ge__(self, other): return Expression("ge", (self, Expression._to_expression(other)))
    def __and__(self, other): return Expression("and", (self, Expression._to_expression(other)))
    def __rand__(self, other): return Expression("and", (Expression._to_expression(other), self))
    def __or__(self, other): return Expression("or", (self, Expression._to_expression(other)))
    def __ror__(self, other): return Expression("or", (Expression._to_expression(other), self))
    def __xor__(self, other): return Expression("xor", (self, Expression._to_expression(other)))
    def __invert__(self): return Expression("not", (self,))
    def __neg__(self): return Expression("negate", (self,))
    def __abs__(self): return Expression("abs", (self,))

    def eq(self, other): return self == other
    def not_eq(self, other): return self != other

    def eq_null_safe(self, other):
        return Expression("eq_null_safe", (self, Expression._to_expression(other)))

    # -- null / conditional ------------------------------------------------
    def is_null(self) -> "Expression":
        return Expression("is_null", (self,))

    def not_null(self) -> "Expression":
        return Expression("not_null", (self,))

    def fill_null(self, fill_value) -> "Expression":
        return Expression("fill_null", (self, Expression._to_expression(fill_value)))

    def is_in(self, other: Iterable) -> "Expression":
        if isinstance(other, Expression):
            items: Tuple = (other,)
        else:
            items = tuple(Expression._to_expression(v) for v in other)
        return Expression("is_in", (self,) + items)

    def between(self, lower, upper) -> "Expression":
        return Expression("between", (self, Expression._to_expression(lower),
                                      Expression._to_expression(upper)))

    def if_else(self, if_true, if_false) -> "Expression":
        return Expression("if_else", (self, Expression._to_expression(if_true),
                                      Expression._to_expression(if_false)))

    # -- casting -----------------------------------------------------------
    def cast(self, dtype: DataType) -> "Expression":
        return Expression("cast", (self,), (dtype,))

    # -- aggregations ------------------------------------------------------
    def sum(self): return Expression("agg.sum", (self,))
    def mean(self): return Expression("agg.mean", (self,))
    def avg(self): return self.mean()
    def min(self): return Expression("agg.min", (self,))
    def max(self): return Expression("agg.max", (self,))
    def count(self, mode: str = "valid"): return Expression("agg.count", (self,), (mode,))
    def count_distinct(self): return Expression("agg.count_distinct", (self,))
    def any_value(self, ignore_nulls: bool = False):
        return Expression("agg.any_value", (self,), (ignore_nulls,))
    def agg_list(self): return Expression("agg.list", (self,))
    def agg_set(self): return Expression("agg.set", (self,))
    def agg_concat(self): return Expression("agg.concat", (self,))
    def stddev(self): return Expression("agg.stddev", (self,))
    def var(self): return Expression("agg.var", (self,))
    def skew(self): return Expression("agg.skew", (self,))
    def bool_and(self): return Expression("agg.bool_and", (self,))
    def bool_or(self): return Expression("agg.bool_or", (self,))
    def approx_count_distinct(self): return Expression("agg.approx_count_distinct", (self,))

    def approx_percentiles(self, percentiles):
        ps = tuple(percentiles) if isinstance(percentiles, (list, tuple)) else (percentiles,)
        return Expression("agg.approx_percentiles", (self,), (ps,))

    # -- scalar functions --------------------------------------------------
    def abs(self): return Expression("abs", (self,))
    def ceil(self): return Expression("ceil", (self,))
    def floor(self): return Expression("floor", (self,))
    def round(self, decimals: int = 0): return Expression("round", (self,), (decimals,))
    def sign(self): return Expression("sign", (self,))
    def sqrt(self): return Expression("sqrt", (self,))
    def cbrt(self): return Expression("cbrt", (self,))
    def exp(self): return Expression("exp", (self,))
    def log(self, base: float = 2.718281828459045): return Expression("log", (self,), (base,))
    def log2(self): return Expression("log2", (self,))
    def log10(self): return Expression("log10", (self,))
    def ln(self): return Expression("ln", (self,))
    def sin(self): return Expression("sin", (self,))
    def cos(self): return Expression("cos", (self,))
    def tan(self): return Expression("tan", (self,))
    def arcsin(self): return Expression("arcsin", (self,))
    def arccos(self): return Expression("arccos", (self,))
    def arctan(self): return Expression("arctan", (self,))
    def arctan2(self, other): return Expression("arctan2", (self, Expression._to_expression(other)))
    def sinh(self): return Expression("sinh", (self,))
    def cosh(self): return Expression("cosh", (self,))
    def tanh(self): return Expression("tanh", (self,))
    def arcsinh(self): return Expression("arcsinh", (self,))
    def arccosh(self): return Expression("arccosh", (self,))
    def arctanh(self): return Expression("arctanh", (self,))
    def cot(self): return Expression("cot", (self,))
    def csc(self): return Expression("csc", (self,))
    def sec(self): return Expression("sec", (self,))
    def expm1(self): return Expression("expm1", (self,))
    def log1p(self): return Expression("log1p", (self,))
    def signum(self): return Expression("sign", (self,))
    def negate(self): return -self
    def negative(self): return -self
    def degrees(self): return Expression("degrees", (self,))
    def radians(self): return Expression("radians", (self,))
    def bitwise_and(self, other):
        return Expression("bitwise_and", (self, Expression._to_expression(other)))
    def bitwise_or(self, other):
        return Expression("bitwise_or", (self, Expression._to_expression(other)))
    def bitwise_xor(self, other):
        return Expression("bitwise_xor", (self, Expression._to_expression(other)))

    def clip(self, min=None, max=None):
        return Expression("clip", (self, Expression._to_expression(min),
                                   Expression._to_expression(max)))

    def shift_left(self, other): return Expression("shift_left", (self, Expression._to_expression(other)))
    def shift_right(self, other): return Expression("shift_right", (self, Expression._to_expression(other)))

    # -- namespaces --------------------------------------------------------
    @property
    def dt(self) -> "ExpressionDatetimeNamespace":
        return ExpressionDatetimeNamespace(self)

    @property
    def float(self) -> "ExpressionFloatNamespace":
        return ExpressionFloatNamespace(self)

    # -- schema ------------------------------------------------------------
    def to_field(self, schema: Schema) -> Field:
        from .typing import infer_field
        return infer_field(self, schema)

    def __repr__(self):
        return _repr_expr(self)

    def __bool__(self):
        raise ValueError(
            "Expressions don't have a truth value; use & | ~ for boolean logic")


# ---------------------------------------------------------------------------
# namespaces


class _Ns:
    __slots__ = ("_e",)

    def __init__(self, e: Expression):
        self._e = e

    def _f(self, op: str, args: Tuple = (), params: Tuple = ()) -> Expression:
        return Expression(op, (self._e,) + tuple(
            Expression._to_expression(a) for a in args), params)


class ExpressionDatetimeNamespace(_Ns):
    """Reference surface: ``src/daft-functions-temporal``."""

    def date(self): return self._f("dt.date")
    def day(self): return self._f("dt.day")
    def hour(self): return self._f("dt.hour")
    def minute(self): return self._f("dt.minute")
    def second(self): return self._f("dt.second")
    def millisecond(self): return self._f("dt.millisecond")
    def microsecond(self): return self._f("dt.microsecond")
    def nanosecond(self): return self._f("dt.nanosecond")
    def time(self): return self._f("dt.time")
    def month(self): return self._f("dt.month")
    def quarter(self): return self._f("dt.quarter")
    def year(self): return self._f("dt.year")
    def day_of_week(self): return self._f("dt.day_of_week")
    def day_of_month(self): return self._f("dt.day")
    def day_of_year(self): return self._f("dt.day_of_year")
    def week_of_year(self): return self._f("dt.week_of_year")
    def truncate(self, interval: str, relative_to=None):
        return self._f("dt.truncate", (relative_to,) if relative_to is not None else (),
                       (interval,))
    def to_unix_epoch(self, timeunit: str = "s"):
        return self._f("dt.to_unix_epoch", (), (timeunit,))
    def strftime(self, format: Optional[str] = None):
        return self._f("dt.strftime", (), (format,))
    def total_seconds(self): return self._f("dt.total_seconds")


class ExpressionFloatNamespace(_Ns):
    def is_nan(self): return self._f("float.is_nan")
    def is_inf(self): return self._f("float.is_inf")
    def not_nan(self): return self._f("float.not_nan")
    def fill_nan(self, fill_value): return self._f("float.fill_nan", (fill_value,))


# ---------------------------------------------------------------------------
# free functions


def col(name: str) -> Expression:
    return Expression._col(name)


def lit(value: Any) -> Expression:
    return Expression._lit(value)


def coalesce(*exprs) -> Expression:
    return Expression("coalesce", tuple(Expression._to_expression(e) for e in exprs))


def interval(years=0, months=0, days=0, hours=0, minutes=0, seconds=0,
             millis=0, nanos=0) -> Expression:
    months_total = years * 12 + months
    nanos_total = (((hours * 60 + minutes) * 60 + seconds) * 1000 + millis) \
        * 1_000_000 + nanos
    return Expression("lit_interval", (), (months_total, days, nanos_total))


# ---------------------------------------------------------------------------
# projections


class ExpressionsProjection:
    """An ordered list of expressions with unique output names."""

    def __init__(self, exprs: List[Expression]):
        seen = set()
        for e in exprs:
            n = e.name()
            if n in seen:
                raise ValueError(f"duplicate output name in projection: {n}")
            seen.add(n)
        self._exprs = list(exprs)

    @classmethod
    def from_schema(cls, schema: Schema) -> "ExpressionsProjection":
        return cls([col(f.name) for f in schema])

    def __iter__(self):
        return iter(self._exprs)

    def __len__(self):
        return len(self._exprs)

    def to_name_set(self):
        return {e.name() for e in self._exprs}

    def input_mapping(self) -> "dict[str, str]":
        """output name -> input column name for passthrough (possibly aliased) cols."""
        out = {}
        for e in self._exprs:
            inner = e._unalias()
            if inner.op == "col":
                out[e.name()] = inner.params[0]
        return out

    def to_inner_py_exprs(self):
        return self._exprs


def _param_key(p):
    if callable(p) and not isinstance(p, (DataType,)):
        return ("callable", id(p))
    if isinstance(p, (list, dict, set)):
        return repr(p)
    return p


def _repr_expr(e: Expression) -> str:
    binops = {"add": "+", "sub": "-", "mul": "*", "div": "/", "floordiv": "//",
              "mod": "%", "lt": "<", "le": "<=", "gt": ">", "ge": ">=",
              "eq": "==", "neq": "!=", "and": "&", "or": "|", "xor": "^",
              "pow": "**"}
    if e.op == "col":
        return f"col({e.params[0]})"
    if e.op == "lit":
        return f"lit({e.params[0]!r})"
    if e.op == "alias":
        return f"{e.args[0]!r}.alias({e.params[0]!r})"
    if e.op in binops:
        return f"({e.args[0]!r} {binops[e.op]} {e.args[1]!r})"
    if e.op == "not":
        return f"~{e.args[0]!r}"
    inner = ", ".join(repr(a) for a in e.args)
    if e.params:
        inner += (", " if inner else "") + ", ".join(repr(p) for p in e.params)
    return f"{e.op}({inner})"
