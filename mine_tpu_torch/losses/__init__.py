"""Training losses and metrics (counterpart of mine_tpu/losses; LPIPS is
eval-only and not ported yet)."""
