"""Resilience (counterpart of mine_tpu/resilience): the training sentinel
(sentinel.py), the serving engine's circuit breaker (breaker.py), the
preemption guard (preempt.py), the chaos fault seams (chaos.py) and
multi-process survival (multihost.py)."""

from mine_tpu_torch.resilience.breaker import BreakerOpen, CircuitBreaker
