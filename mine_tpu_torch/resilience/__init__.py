"""Training resilience (counterpart of the sentinel part of
mine_tpu/resilience)."""
