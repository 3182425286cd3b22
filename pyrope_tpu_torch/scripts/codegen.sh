#!/usr/bin/env bash
# Regenerate the protobuf message module from policy_service.proto: the
# port's twin of scripts/codegen.sh, writing into pyrope_tpu_torch/sidecar.
# Only *_pb2.py is generated (no grpc Python plugin); the service is
# registered by hand in pyrope_tpu_torch/sidecar/server.py.
# The result must stay a byte copy of the JAX package's policy_service_pb2.py:
# one descriptor, so both packages import in one process and speak one wire
# (tests/test_torch_control_plane_parity.py relies on it). After a change to
# the .proto, regenerate both packages' modules with the same protoc.
set -euo pipefail
cd "$(dirname "$0")/../sidecar"
protoc --python_out=. policy_service.proto
echo "regenerated pyrope_tpu_torch/sidecar/policy_service_pb2.py"
