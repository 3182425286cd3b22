#!/usr/bin/env bash
# AI model lifecycle verification: train -> canary deploy -> rollback, the
# port's twin of scripts/test_ai_lifecycle.sh; the steps run in
# pyrope_tpu_torch/scripts/ai_lifecycle.py (urllib in curl's place).
#
# Usage: start the port's stack first —
#   PYROPE_SIDECAR_PORT=50051 python -m pyrope_tpu_torch.sidecar.server &
#   PYROPE_ADMIN_API_KEY=adm python -m pyrope_tpu_torch.server --device cuda --http-port 8080 --sidecar 127.0.0.1:50051 &
# (--device cpu on a host without a GPU), then:
#   ADMIN_KEY=adm pyrope_tpu_torch/scripts/test_ai_lifecycle.sh
# Env: PYROPE_HTTP (default http://127.0.0.1:8080). Training needs
# scikit-learn in the sidecar's environment; without it nothing is staged
# and the script says so and exits 0, as for a fresh stack.
set -euo pipefail
: "${ADMIN_KEY:?set ADMIN_KEY to the admin API key}"
cd "$(dirname "$0")/../.."
exec python -m pyrope_tpu_torch.scripts.ai_lifecycle "$@"
