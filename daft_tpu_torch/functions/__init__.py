"""Free-function expression constructors (reference:
``daft_tpu/functions/__init__.py``): the window rank family, monotonic ids
and the row-wise ``columns_*`` helpers."""

from ..expressions.expressions import Expression, col, lit


def row_number() -> Expression:
    return Expression("winfn.row_number", ())


def rank() -> Expression:
    return Expression("winfn.rank", ())


def dense_rank() -> Expression:
    return Expression("winfn.dense_rank", ())


def monotonically_increasing_id() -> Expression:
    """Routed to a MonotonicallyIncreasingId plan node by the builder
    (reference: DetectMonotonicId rule)."""
    return Expression("monotonically_increasing_id", ())


def _cols(exprs):
    # reference accepts Expression | str column names
    return [col(e) if isinstance(e, str) else Expression._to_expression(e)
            for e in exprs]


def columns_sum(*exprs) -> Expression:
    """Row-wise sum skipping nulls (reference: list_(...).list.sum())."""
    from ..expressions.expressions import list_
    return list_(*_cols(exprs)).list.sum()


def columns_mean(*exprs) -> Expression:
    from ..expressions.expressions import list_
    return list_(*_cols(exprs)).list.mean()


def columns_min(*exprs) -> Expression:
    from ..expressions.expressions import list_
    return list_(*_cols(exprs)).list.min()


def columns_max(*exprs) -> Expression:
    from ..expressions.expressions import list_
    return list_(*_cols(exprs)).list.max()


def columns_avg(*exprs) -> Expression:
    return columns_mean(*exprs)


__all__ = ["row_number", "rank", "dense_rank", "monotonically_increasing_id",
           "columns_sum", "columns_mean", "columns_avg", "columns_min",
           "columns_max"]
