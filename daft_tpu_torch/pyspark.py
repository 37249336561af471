"""PySpark front door: a SparkSession served by the embedded Spark Connect
server.

The port's copy of ``daft_tpu/pyspark.py`` (reference capability: the
``daft/pyspark`` SparkSession shim that boots the engine's Spark Connect
endpoint and points the pyspark client at it).
``SparkSession.builder.local().getOrCreate()`` starts
``daft_tpu_torch.connect``'s gRPC server and returns a real
``pyspark.sql.SparkSession`` wired to ``sc://127.0.0.1:<port>``. Gated on
pyspark being importable (an optional client-side dependency; without it
``getOrCreate`` raises an actionable ``ImportError`` after the server
stood up). The server needs ``grpcio`` and ``protobuf``.
"""

from __future__ import annotations

from typing import Optional


class SparkSessionBuilder:
    def __init__(self):
        self._remote: Optional[str] = None
        self._server = None

    def local(self) -> "SparkSessionBuilder":
        """Serve from an in-process daft_tpu_torch Spark Connect server."""
        from .connect import start_server
        if self._server is not None:
            self._server.stop()  # re-calling local() must not leak one
        self._server = start_server()
        self._remote = self._server.address
        return self

    def remote(self, address: str) -> "SparkSessionBuilder":
        """Point at an already-running daft_tpu_torch connect endpoint
        (``sc://host:port``)."""
        self._remote = address
        return self

    def getOrCreate(self):
        try:
            from pyspark.sql import SparkSession as _PySparkSession
        except ImportError as exc:
            raise ImportError(
                "daft_tpu_torch.pyspark needs the optional 'pyspark' client "
                "package; the server side (daft_tpu_torch.connect) works "
                "without it") from exc
        if self._remote is None:
            self.local()
        spark = _PySparkSession.builder.remote(self._remote).getOrCreate()
        if self._server is not None:
            # stop the embedded server when the client session closes
            orig_stop = spark.stop
            server = self._server

            def stop():
                try:
                    orig_stop()
                finally:
                    server.stop()

            spark.stop = stop
        return spark


class _SessionMeta(type):
    @property
    def builder(cls) -> SparkSessionBuilder:
        # a fresh builder per access, like pyspark's classproperty
        return SparkSessionBuilder()


class SparkSession(metaclass=_SessionMeta):
    """``SparkSession.builder.local().getOrCreate()`` → pyspark session
    against an embedded daft_tpu_torch Spark Connect server."""
