"""Generated protobuf message code for the fmaas API (a copy of the JAX
package's `pb/generation_pb2.py`, produced by `protoc --python_out` from
`proto/generation.proto`). gRPC service wiring is hand-written in
`server/grpc_server.py`."""

from . import generation_pb2  # noqa: F401
