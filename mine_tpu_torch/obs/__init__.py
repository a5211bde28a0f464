"""Observability (counterpart of part of mine_tpu/obs): request spans
(trace.py), device-memory telemetry (memlog.py) and the build-identity
gauge (ledger.py)."""
