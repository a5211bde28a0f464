"""Training losses and metrics (counterpart of mine_tpu/losses; LPIPS in
lpips.py is eval-only)."""
