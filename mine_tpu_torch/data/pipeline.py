"""Host-side input-pipeline overlap (the port's own copy of
mine_tpu/data/pipeline.py, without its chaos seam).

A daemon thread keeps up to `depth` items ready ahead of the consumer, each
produced (and passed through the optional `transfer` callable) on that
thread, so building the next batch overlaps the current step. depth <= 0 is
fully synchronous.

Transient-fault containment (`data.loader_retries`): a flaky network
filesystem should cost one retried batch, not the whole epoch. Two stages
are covered, both with exponential backoff + jitter on transient errors
(TransientLoaderError, OSError, TimeoutError), re-raising only after
`retries` retries, with `on_retry` ticking the caller's counter per attempt:

  * the per-item stage (the `transfer` callable), always;
  * the source-iterator PULL (`next()`), only when the iterable declares
    `retry_safe_iter = True`. A Python generator closes on raise, so
    re-pulling a dead generator returns StopIteration and would silently
    TRUNCATE the epoch; only loaders whose `__next__` does independent
    per-batch work may claim the flag. A generator's exception relays to
    the consumer on the first failure.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from typing import Any, Callable, Iterable, Iterator


class TransientLoaderError(RuntimeError):
    """A loader error worth retrying (the pipeline's opt-in marker)."""


class LoaderRetriesExhausted(RuntimeError):
    """Bounded retries ran out (`data.loader_retries`): carries the attempt
    count and chains the last underlying error. Raised only when retries
    were configured; `retries=0` relays the original error untouched."""

    def __init__(self, attempts: int, cause: BaseException):
        super().__init__(
            f"loader retries exhausted after {attempts} attempt(s); last "
            f"error: {type(cause).__name__}: {cause}"
        )
        self.attempts = attempts
        self.cause = cause


# what the bounded retry treats as transient; anything else re-raises at
# the consumer at once (a shape bug retried 3 times is 3x the noise)
_RETRYABLE = (TransientLoaderError, OSError, TimeoutError)


class _End:
    pass


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _retrying(
    fn: Callable[[], Any],
    retries: int,
    retry_base_delay_s: float,
    on_retry: Callable[[int, BaseException], None] | None,
) -> Any:
    """Call fn() with bounded transient-error retry + backoff/jitter."""
    attempt = 0
    while True:
        try:
            return fn()
        except _RETRYABLE as exc:
            if attempt >= retries:
                if retries > 0:
                    raise LoaderRetriesExhausted(attempt + 1, exc) from exc
                raise
            # exponential backoff with jitter: correlated retries from many
            # processes must not re-stampede the storage that just buckled
            delay = retry_base_delay_s * (2.0 ** attempt)
            delay *= 1.0 + 0.25 * random.random()
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, exc)
            time.sleep(delay)


def prefetch(
    iterable: Iterable[Any],
    depth: int,
    transfer: Callable[[Any], Any] | None = None,
    retries: int = 0,
    retry_base_delay_s: float = 0.05,
    on_retry: Callable[[int, BaseException], None] | None = None,
) -> Iterator[Any]:
    """Yield the items of `iterable`, produced (and `transfer`ed) up to
    `depth` items ahead on a background thread. An exception from the
    producer re-raises at the consumer's next pull, after `retries` bounded
    retries of a transient error (module docstring). If the consumer
    abandons the generator early (close, or garbage collection), the
    producer thread is told to stop and exits at its next put."""

    def produce(item: Any) -> Any:
        if transfer is None:
            return item
        return _retrying(lambda: transfer(item), retries, retry_base_delay_s, on_retry)

    # pull-retry only for iterables that declare their __next__ re-callable
    # after a failure (module docstring: a dead generator would truncate)
    pull_retries = retries if getattr(iterable, "retry_safe_iter", False) else 0
    src = iter(iterable)
    end_pull = object()

    def pull() -> Any:
        def one():
            try:
                return next(src)
            except StopIteration:
                return end_pull

        return _retrying(one, pull_retries, retry_base_delay_s, on_retry)

    if depth <= 0:
        while True:
            item = pull()
            if item is end_pull:
                return
            yield produce(item)

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put_or_stop(item: Any) -> bool:
        """Blocking put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            while True:
                item = pull()
                if item is end_pull:
                    put_or_stop(_End())
                    return
                if not put_or_stop(produce(item)):
                    return
        except BaseException as exc:  # noqa: BLE001 - relayed to the consumer
            put_or_stop(_Raised(exc))

    thread = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _End):
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item
    finally:
        stop.set()
