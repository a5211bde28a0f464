"""Perf-ledger CLI: the regression gate over perf_ledger.jsonl (counterpart
of tools/perf_ledger.py; the ledger itself is mine_tpu_torch/obs/ledger.py).

  check   compare the newest row of every comparable stream (metric,
          config digest, device, backend class, mesh shape) against the
          median of its prior rows; exit 1 when any checked field (value,
          p95_ms, peak_hbm_bytes, cache_entries_per_gib, cache_hit_rate)
          regressed beyond --threshold. Streams with fewer than
          --min-history prior rows are skipped, not failed. Ends in one JSON
          verdict line (utils/verdict.py).
  show    print the rows (optionally --metric filtered), one per line.
  append  append a row from --json '{"metric": ..., "value": ...,
          "workload": {...}}', for wiring in outside measurements.

    python -m mine_tpu_torch.tools.perf_ledger check --ledger perf_ledger.jsonl
    python -m mine_tpu_torch.tools.perf_ledger check --threshold 0.05 --window 8
    python -m mine_tpu_torch.tools.perf_ledger show --metric <metric>

The ledger defaults to $MINE_TPU_PERF_LEDGER, else ./perf_ledger.jsonl: the
resolution the writers use ("off" disables both). No subcommand needs a
device.
"""

from __future__ import annotations

import argparse
import json
import sys

from mine_tpu_torch.obs import ledger
from mine_tpu_torch.utils.verdict import emit


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("check", help="gate on the rolling baseline")
    pc.add_argument("--ledger", default=None,
                    help=f"defaults to ${ledger.LEDGER_ENV}, else ./{ledger.DEFAULT_LEDGER}: "
                         "the resolution the writers use")
    pc.add_argument("--threshold", type=float, default=0.10,
                    help="relative regression beyond this fails (0.10 = 10%%)")
    pc.add_argument("--window", type=int, default=5,
                    help="rolling-baseline window (median of the last N)")
    pc.add_argument("--min-history", type=int, default=2,
                    help="prior comparable rows required before a stream is checked")

    ps = sub.add_parser("show", help="print ledger rows")
    ps.add_argument("--ledger", default=None)
    ps.add_argument("--metric", default=None)

    pa = sub.add_parser("append", help="append one row")
    pa.add_argument("--ledger", default=None)
    pa.add_argument("--json", required=True,
                    help='row fields, e.g. \'{"metric": "m", "value": 1.0, '
                         '"workload": {"h": 128}}\'')

    args = ap.parse_args(argv)
    if args.ledger is None:
        # the writers' resolution: a gate reading another file than they
        # append to would pass on an empty ledger
        args.ledger = ledger.ledger_path()
        if args.ledger is None:
            return emit({"ok": True, "note": f"perf ledger disabled via ${ledger.LEDGER_ENV}: "
                                             f"nothing to {args.cmd}"})

    if args.cmd == "check":
        return emit(ledger.check(args.ledger, threshold=args.threshold, window=args.window,
                                 min_history=args.min_history))

    if args.cmd == "show":
        rows, bad = ledger.read(args.ledger)
        for row in rows:
            if args.metric is None or row.get("metric") == args.metric:
                print(json.dumps(row, sort_keys=True))
        if bad:
            print(f"# {bad} malformed line(s) skipped", file=sys.stderr)
        return 0

    fields = json.loads(args.json)
    workload = fields.pop("workload", {})
    metric = fields.pop("metric")
    value = fields.pop("value", None)
    row = ledger.append(args.ledger, ledger.make_row(metric, value, workload, **fields))
    print(json.dumps(row, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
