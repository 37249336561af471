"""Expression → torch program compiler.

The torch rewrite of ``daft_tpu/device/compiler.py``: a projection or
predicate list compiles into one Python closure over the DeviceTable's
tensors (eager torch ops; the reference traced the same graph into one
fused XLA program).

String semantics ride on sorted-dictionary codes: comparisons against string
literals become integer comparisons against per-batch literal ranks, which
host-side "scalar specs" compute from each batch's dictionary.

Literals are one-element tensors, so type promotion follows the reference's
non-weak JAX scalars (``int32 column * int64 literal`` is int64). Date parts
come out int32 where the reference emits uint32 (torch's uint32 has few
ops); the decode casts them to the field's type.
"""

from __future__ import annotations

import datetime
import math
from typing import Callable, List

import numpy as np
import pyarrow as pa
import torch

from ..datatype import DataType
from ..expressions.expressions import Expression
from ..schema import Schema
from .column import device_np_dtype

# ops the device compiler understands ------------------------------------
_ARITH = {"add", "sub", "mul", "div", "floordiv", "mod", "pow"}
_CMP = {"lt", "le", "gt", "ge", "eq", "neq"}
_BOOL = {"and", "or", "xor"}
_UNARY_F = {"sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log,
            "log2": torch.log2, "log10": torch.log10, "sin": torch.sin,
            "cos": torch.cos, "tan": torch.tan, "arcsin": torch.arcsin,
            "arccos": torch.arccos, "arctan": torch.arctan,
            "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
            "degrees": torch.rad2deg, "radians": torch.deg2rad}
_F64 = torch.float64


class NotCompilable(Exception):
    pass


class ScalarSpec:
    """Host-side per-batch preparation: computes a scalar/array argument
    from a string column's sorted dictionary (e.g. the rank of a
    literal)."""

    def __init__(self, col: str, fn: Callable[[pa.Array], np.ndarray]):
        self.col = col
        self.fn = fn


def _dict_np(d: pa.Array) -> np.ndarray:
    return np.asarray(d.to_pylist(), dtype=object)


def _rank_spec(col: str, lit, side: str) -> ScalarSpec:
    def fn(d: pa.Array) -> np.ndarray:
        dn = _dict_np(d)
        if side == "eq":
            i = np.searchsorted(dn, lit)
            if i < len(dn) and dn[i] == lit:
                return np.int32(i)
            return np.int32(-1)
        return np.int32(np.searchsorted(dn, lit, side=side))
    return ScalarSpec(col, fn)


class Compiled:
    """A compiled projection: fn + per-batch scalar preparation."""

    def __init__(self, fn, scalar_specs: List[ScalarSpec],
                 out_fields, needs_cols: List[str]):
        self.fn = fn
        self.scalar_specs = scalar_specs
        self.out_fields = out_fields
        self.needs_cols = needs_cols


class _Ctx:
    def __init__(self, schema: Schema):
        self.schema = schema
        self.scalar_specs: List[ScalarSpec] = []
        self.needs: List[str] = []

    def add_scalar(self, spec: ScalarSpec) -> int:
        self.scalar_specs.append(spec)
        return len(self.scalar_specs) - 1

    def need(self, col: str):
        if col not in self.needs:
            self.needs.append(col)


def compile_projection(exprs: List[Expression], schema: Schema) -> Compiled:
    """Compile an expression list; raises NotCompilable on unsupported
    ops. ``fn(arrays, valids, row_mask, scalars)`` returns one
    ``(values, validity)`` pair of [capacity] tensors per expression."""
    ctx = _Ctx(schema)
    builders = [_build(e, ctx) for e in exprs]
    out_fields = [e.to_field(schema) for e in exprs]

    def run(arrays, valids, row_mask, scalars):
        env = (arrays, valids, row_mask, scalars)
        outs = []
        for b in builders:
            v, m = b(env)
            if v.shape != row_mask.shape:   # a literal: materialize it
                v = v.expand(row_mask.shape).contiguous()
            if m.shape != row_mask.shape:
                m = m.expand(row_mask.shape).contiguous()
            outs.append((v, m))
        return tuple(outs)

    return Compiled(run, ctx.scalar_specs, out_fields, ctx.needs)


def _dtype_of(e: Expression, ctx: _Ctx) -> DataType:
    return e.to_field(ctx.schema).dtype


def _is_str(e: Expression, ctx) -> bool:
    try:
        return _dtype_of(e, ctx).is_string()
    except Exception:
        return False


def _const(v, dtype: torch.dtype):
    """A literal: one-element tensor on the environment's device."""
    return lambda env: (torch.full((1,), v, dtype=dtype,
                                   device=env[2].device),
                        torch.ones(1, dtype=torch.bool,
                                   device=env[2].device))


def _unary(c, fn):
    def out(env):
        v, m = c(env)
        return fn(v), m
    return out


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def _build(e: Expression, ctx: _Ctx):
    """Returns closure env -> (value_tensor, valid_tensor)."""
    op = e.op

    if op == "col":
        name = e.params[0]
        if name not in ctx.schema:
            raise NotCompilable(f"unknown column {name}")
        dt = ctx.schema[name].dtype
        rep = dt.device_repr()
        if rep is None:
            raise NotCompilable(f"column {name}: {dt!r} not device-representable")
        if not (dt.is_string() or dt.is_binary()):
            try:
                device_np_dtype(rep)
            except ValueError as exc:
                raise NotCompilable(f"column {name}: {exc}")
        ctx.need(name)
        return lambda env: (env[0][name], env[1][name])

    if op == "alias":
        return _build(e.args[0], ctx)

    if op == "lit":
        v = e.params[0]
        if v is None:
            return lambda env: (
                torch.zeros(1, dtype=torch.int32, device=env[2].device),
                torch.zeros(1, dtype=torch.bool, device=env[2].device))
        if isinstance(v, bool):
            return _const(v, torch.bool)
        if isinstance(v, int):
            if not (-(2**63) <= v < 2**63):
                raise NotCompilable("int literal exceeds int64")
            return _const(v, torch.int64)
        if isinstance(v, float):
            return _const(v, _F64)
        if isinstance(v, datetime.datetime):
            return _const(int(v.timestamp() * 1_000_000), torch.int64)
        if isinstance(v, datetime.date):
            return _const((v - datetime.date(1970, 1, 1)).days, torch.int32)
        raise NotCompilable(f"literal {type(v)} not device-representable")

    if op == "cast":
        target = e.params[0]
        child_dt = _dtype_of(e.args[0], ctx)
        if child_dt.is_string() and not target.is_string():
            raise NotCompilable("string cast on device")
        rep = target.device_repr()
        if rep is None or target.is_string():
            raise NotCompilable(f"cast to {target!r} on device")
        try:
            tdt = _torch_dtype(device_np_dtype(rep))
        except ValueError as exc:
            raise NotCompilable(f"cast to {target!r}: {exc}")
        return _unary(_build(e.args[0], ctx), lambda v: v.to(tdt))

    # string comparisons against literals --------------------------------
    if op in _CMP:
        l, r = e.args
        if _is_str(l, ctx) or _is_str(r, ctx):
            return _build_str_cmp(e, ctx)

    if op in _ARITH or op in _CMP:
        cl = _build(e.args[0], ctx)
        cr = _build(e.args[1], ctx)
        ldt, rdt = _dtype_of(e.args[0], ctx), _dtype_of(e.args[1], ctx)
        if (ldt.is_temporal() or rdt.is_temporal()) and op in _ARITH \
                and op not in ("sub", "add"):
            raise NotCompilable("temporal arithmetic beyond add/sub")

        def fn(env, _op=op):
            lv, lm = cl(env)
            rv, rm = cr(env)
            m = lm & rm
            if _op == "add":
                v = lv + rv
            elif _op == "sub":
                v = lv - rv
            elif _op == "mul":
                v = lv * rv
            elif _op == "div":
                # IEEE semantics (matches the host tier): x/0 = ±inf
                v = lv.to(_F64) / rv.to(_F64)
            elif _op == "floordiv":
                v = torch.floor_divide(lv, torch.where(rv == 0, 1, rv))
            elif _op == "mod":
                v = torch.remainder(lv, torch.where(rv == 0, 1, rv))
            elif _op == "pow":
                v = torch.pow(lv.to(_F64), rv)
            elif _op == "lt":
                v = lv < rv
            elif _op == "le":
                v = lv <= rv
            elif _op == "gt":
                v = lv > rv
            elif _op == "ge":
                v = lv >= rv
            elif _op == "eq":
                v = lv == rv
            else:
                v = lv != rv
            return v, m
        return fn

    if op in _BOOL:
        cl = _build(e.args[0], ctx)
        cr = _build(e.args[1], ctx)
        if _dtype_of(e.args[0], ctx).is_integer():
            iop = {"and": torch.bitwise_and, "or": torch.bitwise_or,
                   "xor": torch.bitwise_xor}[op]

            def ifn(env):
                (a, am), (b, bm) = cl(env), cr(env)
                return iop(a, b), am & bm
            return ifn

        def bfn(env, _op=op):
            lv, lm = cl(env)
            rv, rm = cr(env)
            lv = lv.to(torch.bool)
            rv = rv.to(torch.bool)
            if _op == "and":
                # Kleene: F & x = F even if x null
                v = lv & rv
                m = (lm & rm) | (lm & ~lv) | (rm & ~rv)
            elif _op == "or":
                v = lv | rv
                m = (lm & rm) | (lm & lv) | (rm & rv)
            else:
                v = lv ^ rv
                m = lm & rm
            return v, m
        return bfn

    if op == "not":
        return _unary(_build(e.args[0], ctx), lambda v: ~v.to(torch.bool))
    if op == "negate":
        return _unary(_build(e.args[0], ctx), lambda v: -v)
    if op == "abs":
        return _unary(_build(e.args[0], ctx), torch.abs)
    if op in ("is_null", "not_null"):
        c = _build(e.args[0], ctx)
        want_valid = op == "not_null"

        def nfn(env):
            _, m = c(env)
            return (m if want_valid else ~m), torch.ones_like(m)
        return nfn
    if op == "fill_null":
        if _is_str(e.args[0], ctx):
            raise NotCompilable("fill_null on strings")
        c = _build(e.args[0], ctx)
        cf = _build(e.args[1], ctx)

        def ffn(env):
            v, m = c(env)
            fv, fm = cf(env)
            return torch.where(m, v, fv.to(v.dtype)), m | fm
        return ffn
    if op == "between":
        inner = Expression("and", (Expression("ge", (e.args[0], e.args[1])),
                                   Expression("le", (e.args[0], e.args[2]))))
        return _build(inner, ctx)
    if op == "is_in":
        return _build_is_in(e, ctx)
    if op == "if_else":
        if _is_str(e.args[1], ctx) or _is_str(e.args[2], ctx):
            raise NotCompilable("if_else over strings")
        cp = _build(e.args[0], ctx)
        ct = _build(e.args[1], ctx)
        cf2 = _build(e.args[2], ctx)

        def iefn(env):
            pv, pm = cp(env)
            tv, tm = ct(env)
            fv, fm = cf2(env)
            p = pv.to(torch.bool)
            return torch.where(p, tv, fv), torch.where(p, tm, fm) & pm
        return iefn
    if op in ("ceil", "floor", "sign"):
        fn = {"ceil": torch.ceil, "floor": torch.floor,
              "sign": torch.sign}[op]
        return _unary(_build(e.args[0], ctx), fn)
    if op == "round":
        nd = e.params[0]
        return _unary(_build(e.args[0], ctx),
                      lambda v: torch.round(v, decimals=nd))
    if op in _UNARY_F:
        fn = _UNARY_F[op]
        return _unary(_build(e.args[0], ctx), lambda v: fn(v.to(_F64)))
    if op == "log":
        base = math.log(e.params[0])
        return _unary(_build(e.args[0], ctx),
                      lambda v: torch.log(v.to(_F64)) / base)
    if op == "float.is_nan":
        return _unary(_build(e.args[0], ctx), torch.isnan)
    if op == "float.is_inf":
        return _unary(_build(e.args[0], ctx), torch.isinf)
    if op == "float.not_nan":
        return _unary(_build(e.args[0], ctx), lambda v: ~torch.isnan(v))

    if op in ("dt.year", "dt.month", "dt.day", "dt.day_of_week",
              "dt.quarter", "dt.hour", "dt.minute", "dt.second", "dt.date"):
        return _build_dt(e, ctx)

    raise NotCompilable(f"device compile for {op}")


def _build_is_in(e: Expression, ctx: _Ctx):
    target = e.args[0]
    items = e.args[1:]
    if not all(i.op == "lit" for i in items):
        raise NotCompilable("is_in with non-literal items")
    lits = [i.params[0] for i in items]
    if _is_str(target, ctx):
        src = target._unalias()
        if src.op != "col":
            raise NotCompilable("string is_in on computed values")
        name = src.params[0]
        ctx.need(name)

        def spec_fn(d: pa.Array) -> np.ndarray:
            dn = _dict_np(d)
            out = []
            for L in lits:
                i = np.searchsorted(dn, L)
                out.append(i if i < len(dn) and dn[i] == L else -1)
            return np.asarray(out, dtype=np.int32)
        si = ctx.add_scalar(ScalarSpec(name, spec_fn))
        return lambda env: (
            (env[0][name][:, None] == env[3][si][None, :]).any(dim=-1),
            env[1][name])
    if any(isinstance(x, (str, bytes)) or x is None for x in lits):
        raise NotCompilable("is_in with non-numeric items")
    c = _build(target, ctx)
    consts = np.asarray(lits)

    def ifn(env):
        v, m = c(env)
        k = torch.as_tensor(consts, device=v.device)
        return (v[:, None] == k[None, :]).any(dim=-1), m
    return ifn


def _build_str_cmp(e: Expression, ctx: _Ctx):
    op = e.op
    l, r = e.args
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
            "eq": "eq", "neq": "neq"}
    if l.op == "lit" and r.op != "lit":
        l, r = r, l
        op = flip[op]
    src = l._unalias()
    if src.op != "col" or r.op != "lit" or not isinstance(r.params[0], str):
        raise NotCompilable("string comparison requires col vs str literal")
    name = src.params[0]
    if name not in ctx.schema or not ctx.schema[name].dtype.is_string():
        raise NotCompilable("string cmp on non-string column")
    ctx.need(name)
    lit = r.params[0]
    # (rank side, comparison of the code against the rank)
    side, cmp = {"eq": ("eq", torch.eq), "neq": ("eq", torch.ne),
                 "lt": ("left", torch.lt), "ge": ("left", torch.ge),
                 "le": ("right", torch.lt), "gt": ("right", torch.ge)}[op]
    si = ctx.add_scalar(_rank_spec(name, lit, side))
    return lambda env: (cmp(env[0][name], env[3][si]), env[1][name])


def _build_dt(e: Expression, ctx: _Ctx):
    """Civil-calendar decomposition (days-from-epoch integer math)."""
    fn = e.op[3:]
    child = e.args[0]
    cdt = _dtype_of(child, ctx)
    c = _build(child, ctx)
    if cdt.kind == "timestamp":
        unit = cdt.timeunit.value
        per_day = {"s": 86_400, "ms": 86_400_000, "us": 86_400_000_000,
                   "ns": 86_400_000_000_000}[unit]
        per_sec = {"s": 1, "ms": 1_000, "us": 1_000_000,
                   "ns": 1_000_000_000}[unit]
    elif cdt.kind == "date":
        per_day, per_sec = 1, None
    else:
        raise NotCompilable(f"dt.{fn} on {cdt!r}")
    fd = torch.floor_divide

    def civil(z):
        z = z + 719468
        era = fd(z, 146097)
        doe = z - era * 146097
        yoe = fd(doe - fd(doe, 1460) + fd(doe, 36524) - fd(doe, 146096), 365)
        y = yoe + era * 400
        doy = doe - (365 * yoe + fd(yoe, 4) - fd(yoe, 100))
        mp = fd(5 * doy + 2, 153)
        d = doy - fd(153 * mp + 2, 5) + 1
        m = torch.where(mp < 10, mp + 3, mp - 9)
        y = torch.where(m <= 2, y + 1, y)
        return y, m, d

    i32 = torch.int32

    def out(env):
        v, mvalid = c(env)
        v64 = v.to(torch.int64)
        days = fd(v64, per_day) if per_day != 1 else v64
        if fn == "date":
            return days.to(i32), mvalid
        if fn in ("year", "month", "day", "quarter"):
            y, m, d = civil(days)
            if fn == "year":
                return y.to(i32), mvalid
            if fn == "month":
                return m.to(i32), mvalid
            if fn == "quarter":
                return (fd(m - 1, 3) + 1).to(i32), mvalid
            return d.to(i32), mvalid
        if fn == "day_of_week":
            return torch.remainder(days + 3, 7).to(i32), mvalid
        if per_sec is None:
            raise NotCompilable(f"dt.{fn} on a date")
        sod = fd(v64, per_sec) - days * 86400
        if fn == "hour":
            return fd(sod, 3600).to(i32), mvalid
        if fn == "minute":
            return torch.remainder(fd(sod, 60), 60).to(i32), mvalid
        return torch.remainder(sod, 60).to(i32), mvalid
    return out
