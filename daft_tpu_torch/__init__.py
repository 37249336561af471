"""daft_tpu_torch: the PyTorch/CUDA port of the daft_tpu dataframe engine.

Arrow host columns and the daft_tpu planner, with the device tier rewritten
in torch and the hash grouped-aggregation build as a hand-written CUDA
kernel for Hopper (``csrc/hash_agg.cu``). Queries run on ``cuda`` unless the
caller asks for the CPU (``DAFT_TORCH_DEVICE=cpu`` or
``set_execution_config(device="cpu")``).
"""

# the runtime lock-order sanitizer must patch the lock factories BEFORE the
# engine modules below create their module-level locks: this block stays
# first (knobs and the sanitizers are import-light)
from . import knobs as _knobs
if _knobs.env_bool("DAFT_TORCH_SANITIZE"):
    from .analysis import lock_sanitizer as _lock_sanitizer
    _lock_sanitizer.enable()
    # ...and the retrace sanitizer reads the card's allocator at the
    # declared dispatch sites
    from .analysis import retrace_sanitizer as _retrace_sanitizer
    if _retrace_sanitizer.enabled_by_env():
        _retrace_sanitizer.enable()
# the plan sanitizer hooks the optimizer loop and the node streams (no
# factory patching), so it arms on its own knob
from .analysis import plan_sanitizer as _plan_sanitizer
if _plan_sanitizer.enabled_by_env():
    _plan_sanitizer.enable()

from .context import (execution_config_ctx, get_context,
                      set_execution_config, set_runner)
from .dataframe import (DataFrame, from_arrow, from_glob_path, from_pandas,
                        from_pydict, from_pylist)
from .datatype import DataType, TimeUnit
from .expressions import Expression, col, lit
from .io import (AzureConfig, GCSConfig, HTTPConfig, IOConfig, S3Config,
                 read_csv, read_json, read_parquet, read_sql, read_warc)
from .recordbatch import RecordBatch
from .schema import Field, Schema
from .series import Series
from .catalog import Catalog, Identifier, NotFoundError, Table
from .session import (
    Session, attach, attach_catalog, attach_function, attach_table,
    create_namespace, create_namespace_if_not_exists, create_table,
    create_table_if_not_exists, create_temp_table, current_catalog,
    current_namespace, current_session, detach_catalog, detach_function,
    detach_table, drop_namespace, drop_table, get_catalog, get_table,
    has_catalog, has_namespace, has_table, list_catalogs, list_namespaces,
    list_tables, read_table, set_catalog, set_namespace, use, write_table,
)
from .udf import udf
from .window import Window
from . import serving
# Last, and as a from-import: the import machinery binds the ``sql``
# submodule as a package attribute first, and this binding then replaces
# it, so ``daft_tpu_torch.sql`` is the function, not the module.
from .sql import sql, sql_expr

__version__ = "0.1.0"

__all__ = [
    "AzureConfig", "GCSConfig", "HTTPConfig", "IOConfig", "S3Config",
    "from_glob_path", "read_csv", "read_json", "read_sql", "read_warc",
    "Catalog", "DataFrame", "DataType", "Expression", "Field", "Identifier",
    "NotFoundError", "RecordBatch", "Schema", "Series", "Session", "Table",
    "TimeUnit", "Window", "attach", "attach_catalog", "attach_function",
    "attach_table", "col", "create_namespace",
    "create_namespace_if_not_exists", "create_table",
    "create_table_if_not_exists", "create_temp_table", "current_catalog",
    "current_namespace", "current_session", "detach_catalog",
    "detach_function", "detach_table", "drop_namespace", "drop_table",
    "execution_config_ctx", "from_arrow", "from_pandas", "from_pydict",
    "from_pylist", "get_catalog", "get_context", "get_table", "has_catalog",
    "has_namespace", "has_table", "list_catalogs", "list_namespaces",
    "list_tables", "lit", "read_parquet", "read_table", "set_catalog",
    "serving", "set_execution_config", "set_namespace", "set_runner", "sql",
    "sql_expr", "udf",
    "use", "write_table",
]
