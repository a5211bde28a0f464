"""The one-JSON-verdict-line-to-stdout contract of the port's gate CLIs (the
port's own copy of mine_tpu/utils/verdict.py).

Human progress goes to stderr; stdout carries exactly one JSON object line,
the verdict, and the exit code follows its `ok` field. The quality harnesses
(mine_tpu_torch/tools/) end through it, so a run that crashes on the card
still leaves one well-formed last line for its caller to read.

Stdlib only.
"""

from __future__ import annotations

import json
import sys
import traceback
from typing import Any


def emit(verdict: dict[str, Any]) -> int:
    """Print the verdict as one JSON line on stdout; return the exit code
    (0 iff verdict["ok"] is truthy) for the caller to raise SystemExit
    with. Flushes, so the line survives an os._exit watchdog."""
    sys.stdout.write(json.dumps(verdict) + "\n")
    sys.stdout.flush()
    return 0 if verdict.get("ok") else 1


def emit_failure(metric: str, exc: BaseException, **extra: Any) -> int:
    """The verdict of a crashed gate: the traceback to stderr, a well-formed
    failing verdict line to stdout."""
    traceback.print_exc(file=sys.stderr)
    return emit({
        "metric": metric, "value": None, "ok": False,
        "error": f"{type(exc).__name__}: {exc}"[:2000], **extra,
    })
