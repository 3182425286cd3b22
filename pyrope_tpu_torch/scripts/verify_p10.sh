#!/usr/bin/env bash
# Index-quality sweep: the port's twin of scripts/verify_p10.sh (IVF nlist
# sweep and HNSW comparison runs). Runs the sweep twin
# (pyrope_tpu_torch/scripts/sweep_indexes.py) on the card unless --device cpu
# is given.
# Usage: pyrope_tpu_torch/scripts/verify_p10.sh [--device cuda|cpu] [--out DIR] [...]
set -euo pipefail
cd "$(dirname "$0")/../.."
exec python -m pyrope_tpu_torch.scripts.sweep_indexes "$@"
