"""Generated protobuf message code (copies of the JAX package's
`pb/generation_pb2.py` and `pb/generate_pb2.py`, produced by `protoc
--python_out` from `proto/generation.proto` and `proto/generate.proto`).
Both packages add the same serialized files to protobuf's default pool,
which accepts identical bytes twice, so the copies stay byte for byte.
gRPC service wiring is hand-written in `server/grpc_server.py` (fmaas) and
`server/internal_server.py` (generate.v1)."""

from . import generate_pb2, generation_pb2  # noqa: F401
