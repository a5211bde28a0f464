"""Training data (counterpart of mine_tpu/data; only the synthetic scene is
ported yet)."""
