from .expressions import (
    Expression,
    ExpressionsProjection,
    col,
    lit,
    coalesce,
    interval,
)

__all__ = [
    "Expression", "ExpressionsProjection", "col", "lit", "coalesce",
    "interval",
]
