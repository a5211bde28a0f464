"""Observability (counterpart of mine_tpu/obs, but the training timeline of
collect.py and the perf ledger): request and training spans (trace.py),
device-memory telemetry (memlog.py), the build-identity gauge (ledger.py),
FLOPs and MFU (cost.py), per-component time attribution and the component
scopes (attrib.py), the flight recorder (flight.py), the SLO tracker
(slo.py) and the fleet's trace collector (collect.py)."""
