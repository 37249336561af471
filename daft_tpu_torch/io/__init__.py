from .read import read_parquet

__all__ = ["read_parquet"]
