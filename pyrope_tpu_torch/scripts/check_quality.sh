#!/usr/bin/env bash
# Quality gate: the port's twin of scripts/check_quality.sh (byte-compile,
# import and native toolchain, lint, tests), over pyrope_tpu_torch,
# chip_smoke.py and the port's tests.
# Usage: pyrope_tpu_torch/scripts/check_quality.sh [STEP ...]
#   STEP is 1-4 (default: all four in order); "2" alone is the import and
#   native step, which needs no test dependency.
set -euo pipefail
cd "$(dirname "$0")/../.."
STEPS="${*:-1 2 3 4}"

for step in ${STEPS}; do
  case "${step}" in
    1)
      echo "== 1/4 byte-compile every module =="
      python -m compileall -q pyrope_tpu_torch chip_smoke.py tests/test_torch_*.py
      ;;
    2)
      echo "== 2/4 import + native toolchain check =="
      python - <<'PY'
import pyrope_tpu_torch
from pyrope_tpu_torch.native.build import native_available
ok = native_available()
print("package import ok; native builder:", "available" if ok else "UNAVAILABLE")
raise SystemExit(0 if ok else 1)
PY
      ;;
    3)
      echo "== 3/4 lint (pyflakes, where installed) =="
      if python -c "import pyflakes" 2>/dev/null; then
        python -m pyflakes pyrope_tpu_torch chip_smoke.py
      else
        echo "pyflakes not installed; skipping lint"
      fi
      ;;
    4)
      echo "== 4/4 the port's tests =="
      python -m pytest tests/test_torch_*.py -x -q
      ;;
    *)
      echo "unknown step ${step} (1-4)" >&2
      exit 2
      ;;
  esac
done

echo "QUALITY CHECKS PASSED (steps ${STEPS})"
