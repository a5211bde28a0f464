"""Resilience (counterpart of mine_tpu/resilience): the training sentinel
(sentinel.py) and the serving engine's circuit breaker (breaker.py)."""

from mine_tpu_torch.resilience.breaker import BreakerOpen, CircuitBreaker
