#!/usr/bin/env bash
# Bench CLI wrapper: the port's twin of scripts/bench_vectors.sh. Runs the
# bench twin (pyrope_tpu_torch/scripts/bench.py: bench.py's rows) on the card
# unless --device cpu is given.
# Usage: pyrope_tpu_torch/scripts/bench_vectors.sh [--configs ivf100k,flat1k]
#            [--device cuda|cpu] [--out DIR] [...]
set -euo pipefail
cd "$(dirname "$0")/../.."
exec python -m pyrope_tpu_torch.scripts.bench "$@"
