"""SQL → LogicalPlan frontend entry points.

The port's copy of ``daft_tpu/sql/sql.py`` (after the reference engine's
``daft/sql/sql.py``: binding against in-scope DataFrames via SQLCatalog)
over ``src/daft-sql``'s planner. The parser/planner itself lives in
``planner.py`` (hand-written recursive descent).
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional


class SQLCatalog:
    def __init__(self, tables: Dict[str, "object"]):
        self.tables = dict(tables)

    def register_table(self, name: str, df):
        self.tables[name] = df


def sql(query: str, catalog: Optional[SQLCatalog] = None, **kwargs):
    """Run SQL against DataFrames bound by name (caller locals or catalog)."""
    from .planner import SQLPlanner
    from ..dataframe import DataFrame
    tables = {}
    if catalog is None:
        frame = inspect.currentframe().f_back
        for scope in (frame.f_globals, frame.f_locals):
            for k, v in scope.items():
                if isinstance(v, DataFrame):
                    tables[k] = v
    else:
        tables.update(catalog.tables)
    tables.update({k: v for k, v in kwargs.items()
                   if isinstance(v, DataFrame)})
    from .. import session as _sess
    return SQLPlanner(tables, session=_sess._session()).plan_statement(query)


def sql_expr(expr: str):
    from .planner import SQLPlanner
    return SQLPlanner({}).plan_expression(expr)
