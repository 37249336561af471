from .expressions import (
    Expression,
    ExpressionsProjection,
    col,
    lit,
    element,
    coalesce,
    interval,
    list_,
    struct,
)

__all__ = [
    "Expression", "ExpressionsProjection", "col", "lit", "element",
    "coalesce", "interval", "list_", "struct",
]
