#!/usr/bin/env bash
# SLO compliance matrix: the port's twin of scripts/load_test.sh. Runs the
# load-test twin (pyrope_tpu_torch/scripts/load_test.py) on the card unless
# --device cpu is given.
# Env: SLO_P99_MS (default 50).
# Usage: pyrope_tpu_torch/scripts/load_test.sh [--n 5000] [--concurrency 1 4 16]
#            [--device cuda|cpu] [--out DIR] [...]
set -euo pipefail
cd "$(dirname "$0")/../.."
exec python -m pyrope_tpu_torch.scripts.load_test "$@"
