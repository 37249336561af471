from .sql import sql, sql_expr, SQLCatalog

__all__ = ["sql", "sql_expr", "SQLCatalog"]
