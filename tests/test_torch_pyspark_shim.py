"""The port's PySpark SparkSession shim (``daft_tpu_torch/pyspark.py``)
against the reference's (``tests/test_pyspark_shim.py``).

The reference's 3 cases through both packages: a fresh builder per
access, ``local()`` booting a live Spark Connect server that answers
``AnalyzePlan`` (the same Spark version before the engine suffix), and
``getOrCreate()`` without ``pyspark`` raising an actionable
``ImportError`` after the server stood up.
"""

import grpc
import pytest

import daft_tpu.pyspark as ref_shim
import daft_tpu_torch.pyspark as port_shim
import daft_tpu_torch.connect.spark_connect_subset_pb2 as pb

SHIMS = {"ref": ref_shim, "port": port_shim}


def test_builder_is_fresh_per_access():
    for shim in SHIMS.values():
        assert shim.SparkSession.builder is not shim.SparkSession.builder
        assert isinstance(shim.SparkSession.builder,
                          shim.SparkSessionBuilder)


def test_local_builder_boots_connect_server():
    versions = {}
    for side, shim in SHIMS.items():
        b = shim.SparkSession.builder.local()
        try:
            assert b._remote.startswith("sc://127.0.0.1:")
            ch = grpc.insecure_channel(b._remote[len("sc://"):])
            stub = ch.unary_unary(
                "/spark.connect.SparkConnectService/AnalyzePlan",
                request_serializer=pb.AnalyzePlanRequest.SerializeToString,
                response_deserializer=pb.AnalyzePlanResponse.FromString)
            versions[side] = stub(pb.AnalyzePlanRequest(
                session_id="s",
                spark_version=pb.AnalyzePlanRequest.SparkVersion())
            ).spark_version.version
            ch.close()
        finally:
            b._server.stop()
    assert "daft-tpu" in versions["ref"]
    assert "daft-torch" in versions["port"]
    assert versions["port"].split("+")[0] == versions["ref"].split("+")[0]


def test_get_or_create_without_pyspark_errors_actionably():
    try:
        import pyspark  # noqa: F401
        pytest.skip("pyspark installed; gate not reachable")
    except ImportError:
        pass
    for shim in SHIMS.values():
        b = shim.SparkSession.builder.local()
        try:
            with pytest.raises(ImportError, match="pyspark"):
                b.getOrCreate()
        finally:
            b._server.stop()
