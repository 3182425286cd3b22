"""AI model lifecycle over the control plane: train -> staged -> canary
deploy -> evaluations -> rollback.

The steps of ``scripts/test_ai_lifecycle.sh`` in Python (``urllib``),
against a running app and sidecar (``python -m pyrope_tpu_torch.sidecar.server``
and ``python -m pyrope_tpu_torch.server --sidecar ...``), with the shell
script's exit rules: a failed request exits 1; no staged version after
training (a decision log too small to train on, or a sidecar without
scikit-learn) is fine for a fresh stack and exits 0; the last line is
``AI LIFECYCLE OK`` once every step has answered. Where the shell script
sleeps 3 s after the training request, this polls the model status for a
staged version for up to ``--wait`` seconds.

    ADMIN_KEY=adm python -m pyrope_tpu_torch.scripts.ai_lifecycle
        [--host http://127.0.0.1:8080] [--admin-key KEY] [--wait 10]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request

CANARY_TENANTS = ["canary-t"]
NO_STAGED = "no staged model produced (decision log may be too small) — OK for a fresh stack"


class LifecycleError(RuntimeError):
    """A request of the lifecycle failed (HTTP error or no connection)."""


def request(host: str, key: str, method: str, path: str, body=None):
    """One call with the admin key: the JSON reply, or LifecycleError."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(host.rstrip("/") + path, data=data, method=method,
                                 headers={"X-API-KEY": key,
                                          "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        raise LifecycleError(f"{method} {path}: HTTP {e.code} {e.read()[:200]!r}") from e
    except OSError as e:
        raise LifecycleError(f"{method} {path}: {e}") from e


def run(host: str, key: str, wait: float = 10.0, out=None) -> list[str]:
    """The lifecycle's steps in order; returns the steps taken ("status",
    "train", "staged", "deploy", "evaluations", "rollback"), stopping after
    "staged" when training staged nothing. Prints each reply to ``out``
    (standard output by default)."""
    out = out or sys.stdout

    steps: list[str] = []

    def step(name, title, method, path, body=None):
        print(f"== {title} ==", file=out)
        print(json.dumps(request(host, key, method, path, body)), file=out)
        steps.append(name)

    step("status", "model status", "GET", "/v1/ai/models")
    step("train", "trigger training", "POST", "/v1/ai/models/train")
    deadline = time.monotonic() + wait
    while True:
        status = request(host, key, "GET", "/v1/ai/models")
        if status.get("staged") or time.monotonic() >= deadline:
            break
        time.sleep(0.5)
    print("== staged versions ==", file=out)
    print(json.dumps(status), file=out)
    steps.append("staged")
    version = (status.get("staged") or [""])[-1]
    if not version:
        print(NO_STAGED, file=out)
        return steps
    step("deploy", f"canary deploy {version}", "POST", "/v1/ai/models/deploy",
         {"version": version, "canary_tenants": CANARY_TENANTS})
    step("evaluations", "evaluations", "GET", "/v1/ai/evaluations")
    step("rollback", "rollback", "POST", "/v1/ai/models/rollback")
    print("AI LIFECYCLE OK", file=out)
    return steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default=os.environ.get("PYROPE_HTTP", "http://127.0.0.1:8080"),
                    help="the app's HTTP address (default $PYROPE_HTTP or "
                         "http://127.0.0.1:8080)")
    ap.add_argument("--admin-key", default=os.environ.get("ADMIN_KEY"),
                    help="the admin API key (default $ADMIN_KEY)")
    ap.add_argument("--wait", type=float, default=10.0,
                    help="seconds to wait for training to stage a version")
    args = ap.parse_args(argv)
    if not args.admin_key:
        print("ai_lifecycle: set ADMIN_KEY (or --admin-key) to the admin API key",
              file=sys.stderr)
        return 1
    try:
        run(args.host, args.admin_key, args.wait)
    except LifecycleError as e:
        print(f"ai_lifecycle: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
