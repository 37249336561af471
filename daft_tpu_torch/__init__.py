"""daft_tpu_torch: the PyTorch/CUDA port of the daft_tpu dataframe engine.

Arrow host columns and the daft_tpu planner, with the device tier rewritten
in torch and the hash grouped-aggregation build as a hand-written CUDA
kernel for Hopper (``csrc/hash_agg.cu``). Queries run on ``cuda`` unless the
caller asks for the CPU (``DAFT_TORCH_DEVICE=cpu`` or
``set_execution_config(device="cpu")``).
"""

from .context import execution_config_ctx, get_context, set_execution_config
from .dataframe import (DataFrame, from_arrow, from_pandas, from_pydict,
                        from_pylist)
from .datatype import DataType, TimeUnit
from .expressions import Expression, col, lit
from .io import read_parquet
from .recordbatch import RecordBatch
from .schema import Field, Schema
from .series import Series

__version__ = "0.1.0"

__all__ = [
    "DataFrame", "DataType", "Expression", "Field", "RecordBatch", "Schema",
    "Series", "TimeUnit", "col", "execution_config_ctx", "from_arrow",
    "from_pandas", "from_pydict", "from_pylist", "get_context", "lit",
    "read_parquet", "set_execution_config",
]
