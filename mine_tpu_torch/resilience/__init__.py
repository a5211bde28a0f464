"""Resilience (counterpart of mine_tpu/resilience, but multihost.py): the
training sentinel (sentinel.py), the serving engine's circuit breaker
(breaker.py), the preemption guard (preempt.py) and the chaos fault seams
(chaos.py)."""

from mine_tpu_torch.resilience.breaker import BreakerOpen, CircuitBreaker
