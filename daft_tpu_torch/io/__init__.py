from .object_io import (AzureConfig, GCSConfig, HTTPConfig, IOConfig,
                        S3Config)
from .read import (read_csv, read_deltalake, read_hudi, read_iceberg,
                   read_json, read_lance, read_parquet, read_sql, read_warc)
from .scan import Pushdowns, ScanOperator, ScanTask
from .sink import DataSink, WriteResult

__all__ = ["AzureConfig", "DataSink", "GCSConfig", "HTTPConfig", "IOConfig",
           "Pushdowns", "S3Config", "ScanOperator", "ScanTask",
           "WriteResult", "read_csv", "read_deltalake", "read_hudi",
           "read_iceberg", "read_json", "read_lance", "read_parquet",
           "read_sql", "read_warc"]
