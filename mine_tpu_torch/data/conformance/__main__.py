"""Dataset-conformance CLI (the port's counterpart of tools/conformance_run.py):
sweep the shipped config matrix through the conformance runner and print ONE
JSON verdict line; `--out DIR` also writes each config's verdict to
`<config>.json`.

  python -m mine_tpu_torch.data.conformance                  # all, every stage
  python -m mine_tpu_torch.data.conformance --stages contract
  python -m mine_tpu_torch.data.conformance --configs llff --device cpu

Stages: `contract` (in-process batch/geometry/host-slice checks), then
`train`, `eval` and `serve`: the config through the port's CLIs
(`mine_tpu_torch.train`, `mine_tpu_torch.evaluate`, `mine_tpu_torch.serving`)
against its fixture, each a subprocess on the CUDA device unless `--device
cpu`. Exit code 0 iff every selected config passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from mine_tpu_torch.data.conformance.contract import all_config_names
from mine_tpu_torch.data.conformance.runner import STAGES, run_matrix


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--configs", default=None,
                        help="comma-separated shipped config names (default: all)")
    parser.add_argument("--stages", default=",".join(STAGES),
                        help="comma-separated stage subset")
    parser.add_argument("--workdir", default=None,
                        help="fixtures and per-config workspaces (default: a fresh temp dir)")
    parser.add_argument("--out", default=None, help="directory for per-config verdict JSON")
    parser.add_argument("--timeout-s", type=float, default=900.0,
                        help="per-CLI-subprocess timeout")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    names = (tuple(n for n in args.configs.split(",") if n) if args.configs
             else all_config_names())
    stages = tuple(s for s in args.stages.split(",") if s)
    unknown = set(stages) - set(STAGES)
    if unknown:
        parser.error(f"unknown stages {sorted(unknown)}; choose from {STAGES}")
    workdir = args.workdir or tempfile.mkdtemp(prefix="mine_conformance_")
    summary = run_matrix(workdir, config_names=names, stages=stages,
                         timeout_s=args.timeout_s, device=args.device)
    for verdict in summary["results"]:
        bits = " ".join(f"{s}={'ok' if r.get('ok') else 'FAIL'}"
                        for s, r in verdict["stages"].items())
        print(f"# {verdict['config']}: {bits}", file=sys.stderr)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, verdict["config"] + ".json"), "w") as fh:
                json.dump(verdict, fh, indent=2)
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
