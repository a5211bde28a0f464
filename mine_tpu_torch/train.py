"""Training CLI: `python -m mine_tpu_torch.train --extra_config
'{"data.name": "synthetic"}'`.

Config layers are the JAX package's flat dot-key YAML files (e.g.
mine_tpu/configs/llff.yaml) over the defaults, then the --extra_config JSON.
The run is on the CUDA device unless --device cpu is given. It trains on the
train split and evaluates on the val split every training.eval_interval
steps; the merged config lands in <workspace>/params.yaml, the loss dict of
every logged step in <workspace>/train_log.jsonl, each eval in
<workspace>/eval_log.jsonl, the metric stream in <workspace>/metrics.jsonl,
the log in <workspace>/train.log and checkpoints under
<workspace>/checkpoints/. Run it again on the same workspace and it resumes
(training.resume_from: latest, or last_good for the sentinel-vetted step).
SIGTERM or SIGUSR2 saves the last completed step first
(resilience.preempt_save); with obs.enabled the run also writes host spans,
MFU and a flight recorder's dumps (<workspace>/flight); MINE_TPU_FAULTS
injects the chaos seams' faults (resilience/chaos.py).
"""

from __future__ import annotations

import argparse
import logging

from mine_tpu_torch.config import load_config
from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.training.loop import Trainer


def main(argv: list[str] | None = None) -> dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", action="append", default=[],
                        help="YAML config layer(s), later override earlier; the "
                             "defaults are always implied first")
    parser.add_argument("--extra_config", default=None,
                        help="JSON dict of final dot-key overrides")
    parser.add_argument("--workspace", default="workspace/run")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after this many updates in all (default: all epochs)")
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="trace this many steps with torch.profiler into "
                             "<workspace>/profile/train_steps.trace.json")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    cfg = load_config(*args.config, overrides=args.extra_config)
    trainer = Trainer(cfg, args.workspace, device=args.device,
                      profile_steps=args.profile_steps)
    train_ds = build_dataset(cfg, "train", trainer.batch_size)
    val_ds = build_dataset(cfg, "val", trainer.batch_size)
    return trainer.fit(train_ds, val_ds, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
