"""Free-function expression constructors (reference:
``daft_tpu/functions/__init__.py``): the window rank family. The
``columns_*`` helpers need the ``list`` namespace (ROADMAP A8)."""

from ..expressions.expressions import Expression


def row_number() -> Expression:
    return Expression("winfn.row_number", ())


def rank() -> Expression:
    return Expression("winfn.rank", ())


def dense_rank() -> Expression:
    return Expression("winfn.dense_rank", ())
