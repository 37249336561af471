"""Spark Connect frontend: daft_tpu_torch as a Spark Connect endpoint.

The port's copy of ``daft_tpu/connect/``: a Spark Connect service
translating Spark relation protos into the port's plans, over a
hand-written wire-compatible protocol subset
(``spark_connect_subset.proto``, its serialized descriptor byte-identical
to the reference's). Every query submits through the serving plane's
``shared_scheduler()`` (or an installed fleet router), so it runs on the
card unless the caller asks for the CPU.

Transports: :class:`SparkConnectServer` serves gRPC (needs ``grpcio`` and
``protobuf``); :class:`SparkConnectService` is the same handlers without a
transport (needs ``protobuf`` only), driven in-process through
:class:`InProcessContext` by the client's ``connect_in_process``.
"""

from .server import (ConnectAbort, InProcessContext, SparkConnectServer,
                     SparkConnectService, StatusCode, start_server)

__all__ = ["ConnectAbort", "InProcessContext", "SparkConnectServer",
           "SparkConnectService", "StatusCode", "start_server"]
