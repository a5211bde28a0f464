"""The input pipeline (mine_tpu_torch/data/pipeline.py) and its place in the
training loop.

`prefetch`: the five behaviours tests/test_prefetch.py pins for the JAX
package's (order, transfer, a producer's error at the consumer, the producer
running ahead, an abandoned consumer stopping the producer thread), plus the
bounded retries: a transient error retried until it passes, then
LoaderRetriesExhausted naming the attempts; retries=0 relaying the raw
error; no retry of a non-transient error; the source pull retried only for a
`retry_safe_iter` source; twelve chained pipelines at once, the interpreter
switching threads as often as it can, each delivering its items in order.

The loop, on the CPU at a tiny size (the LLFF fixture, 128x128, ResNet-18,
S=2, B=2, fp32): `data.num_workers` 4 and 0 give bit-equal losses over 4
steps; a run stopped at step 3 and resumed to step 4 trains on the same
batches as the uninterrupted run; a sentinel rollback re-runs the same
batches from the last-good step; the loader's retries take effect.
"""

import hashlib
import logging
import sys
import threading

import numpy as np
import pytest
import torch

from mine_tpu_torch.config import Config
from mine_tpu_torch.data.conformance.fixtures import write_fixture
from mine_tpu_torch.data.pipeline import LoaderRetriesExhausted, TransientLoaderError, prefetch
from mine_tpu_torch.data.registry import build_dataset
from mine_tpu_torch.training.loop import Trainer, staged_batches
from torch_threads import one_torch_thread  # noqa: F401


def test_order_and_completeness():
    items = list(range(17))
    for depth in (0, 1, 4):
        assert list(prefetch(iter(items), depth)) == items


def test_many_pipelines_under_fast_thread_switching_lose_nothing():
    """More producer threads than cores, each pipeline two stages deep,
    with the interpreter switching threads as often as it can: every
    consumer still gets exactly its items, in order."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        results = [None] * 12

        def consume(i):
            src = ((i, n) for n in range(400))
            results[i] = list(prefetch(prefetch(src, 2), 1, transfer=lambda x: x))

        threads = [threading.Thread(target=consume, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert results == [[(i, n) for n in range(400)] for i in range(12)]


def test_transfer_applied_in_order():
    assert list(prefetch(iter([1, 2, 3]), 2, transfer=lambda x: x * 10)) == [10, 20, 30]


def test_producer_exception_propagates():
    def gen():
        yield 1
        raise RuntimeError("loader blew up")

    it = prefetch(gen(), 2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="loader blew up"):
        list(it)


def test_producer_runs_ahead_of_consumer():
    produced = []
    ready = threading.Event()

    def gen():
        for i in range(3):
            produced.append(i)
            if i == 2:
                ready.set()
            yield i

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    # without touching the iterator again, the producer reaches item 2
    assert ready.wait(timeout=5.0), f"producer stalled; produced={produced}"
    assert list(it) == [1, 2]


def _prefetch_threads() -> list[threading.Thread]:
    return [t for t in threading.enumerate() if t.name == "batch-prefetch"]


def test_abandoned_consumer_stops_the_producer():
    before = set(_prefetch_threads())
    it = prefetch(iter(range(1000)), depth=1)
    assert next(it) == 0
    (worker,) = set(_prefetch_threads()) - before
    it.close()  # abandon early: the worker must not hang on a full queue
    worker.join(timeout=5.0)
    assert not worker.is_alive()
    assert list(prefetch(iter([7, 8]), depth=1)) == [7, 8]


class _Flaky:
    """Fails `fails` times with `exc` before each item passes."""

    def __init__(self, fails: int, exc: type[BaseException] = TransientLoaderError):
        self.fails, self.exc, self.calls = fails, exc, 0

    def __call__(self, x):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc(f"flake {self.calls}")
        return x


@pytest.mark.parametrize("depth", [0, 2])
def test_transient_errors_retry_then_exhaust(depth):
    seen = []
    flaky = _Flaky(fails=2)
    got = list(prefetch(iter([5]), depth, transfer=flaky, retries=2, retry_base_delay_s=0.001,
                        on_retry=lambda n, e: seen.append((n, str(e)))))
    assert got == [5] and seen == [(1, "flake 1"), (2, "flake 2")]
    with pytest.raises(LoaderRetriesExhausted, match="after 3 attempt") as exc:
        list(prefetch(iter([5]), depth, transfer=_Flaky(fails=9, exc=OSError), retries=2,
                      retry_base_delay_s=0.001))
    assert exc.value.attempts == 3 and isinstance(exc.value.cause, OSError)
    with pytest.raises(TimeoutError, match="flake 1"):  # retries=0 relays the raw error
        list(prefetch(iter([5]), depth, transfer=_Flaky(fails=1, exc=TimeoutError)))
    once = _Flaky(fails=1, exc=ValueError)  # not transient: no retry
    with pytest.raises(ValueError, match="flake 1"):
        list(prefetch(iter([5]), depth, transfer=once, retries=3, retry_base_delay_s=0.001))
    assert once.calls == 1


class _FlakySource:
    """An iterator whose __next__ does independent work per item and fails
    once before item 1 (`retry_safe_iter` declares it re-callable)."""

    def __init__(self, safe: bool):
        self.retry_safe_iter = safe
        self.i, self.failed = 0, False

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == 1 and not self.failed:
            self.failed = True
            raise OSError("mount hiccup")
        if self.i == 3:
            raise StopIteration
        self.i += 1
        return self.i - 1


def test_pull_retried_only_for_retry_safe_sources():
    assert list(prefetch(_FlakySource(safe=True), 2, retries=1, retry_base_delay_s=0.001)) \
        == [0, 1, 2]
    with pytest.raises(OSError, match="mount hiccup"):
        list(prefetch(_FlakySource(safe=False), 2, retries=1, retry_base_delay_s=0.001))


def test_staged_batches_on_the_cpu_pass_host_batches_through():
    """Nothing is pinned for a CPU device: the batches come out as built."""
    import torch

    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    for workers in (0, 1, 4):
        got = list(staged_batches(iter(batches), torch.device("cpu"), workers))
        assert all(g is b for g, b in zip(got, batches)) and len(got) == 5


# -- the training loop -------------------------------------------------------


def _digest(batch) -> str:
    return hashlib.sha1(np.asarray(batch["tgt_img"]).tobytes()
                        + np.asarray(batch["g_tgt_src"]).tobytes()).hexdigest()


class _Recording(Trainer):
    """A Trainer that records what each step trained on and its loss."""

    def step(self, batch):
        out = super().step(batch)
        self.seen.append(_digest(batch))
        self.losses.append(float(out["loss"]))
        return out


def _trainer(cfg, ws=None) -> _Recording:
    trainer = _Recording(cfg, None if ws is None else str(ws), device="cpu")
    trainer.seen, trainer.losses = [], []
    return trainer


@pytest.fixture(scope="module")
def llff_cfg(tmp_path_factory):
    path = write_fixture("llff", str(tmp_path_factory.mktemp("llff")), n_views=8)
    return Config().replace(**{
        "data.name": "llff", "data.training_set_path": path, "data.img_h": 128,
        "data.img_w": 128, "data.img_pre_downsample_ratio": 1.0,
        "data.per_gpu_batch_size": 2, "data.visible_point_count": 16,
        "model.num_layers": 18, "model.dtype": "float32", "mpi.num_bins_coarse": 2,
        "training.log_interval": 1, "training.checkpoint_interval": 2,
    })


@pytest.fixture(scope="module")
def straight(llff_cfg):
    """4 uninterrupted steps with data.num_workers 4 (the default)."""
    assert llff_cfg.data.num_workers == 4
    trainer = _trainer(llff_cfg)
    trainer.fit(build_dataset(llff_cfg, "train", 2), max_steps=4)
    assert len(set(trainer.seen)) == 4 and len(build_dataset(llff_cfg, "train", 2)) == 4
    return trainer


def test_workers_4_and_0_train_bit_equal(llff_cfg, straight):
    cfg = llff_cfg.replace(**{"data.num_workers": 0})
    trainer = _trainer(cfg)
    trainer.fit(build_dataset(cfg, "train", 2), max_steps=4)
    assert trainer.seen == straight.seen
    assert trainer.losses == straight.losses and all(np.isfinite(straight.losses))


def test_mid_epoch_resume_sees_the_same_batches(llff_cfg, straight, tmp_path):
    first = _trainer(llff_cfg, tmp_path)
    first.fit(build_dataset(llff_cfg, "train", 2), max_steps=3)
    resumed = _trainer(llff_cfg, tmp_path)  # resumes at step 3, mid-epoch 1
    resumed.fit(build_dataset(llff_cfg, "train", 2), max_steps=4)
    assert resumed.global_step == 4
    assert first.seen + resumed.seen == straight.seen
    assert first.losses + resumed.losses == straight.losses


class _PoisonOnce:
    """The train split with NaN pixels in the batch at global position `bad`
    (from 1) the first time it is built."""

    def __init__(self, ds, bad: int):
        self.ds, self.bad, self.used = ds, bad, set()

    def __len__(self):
        return len(self.ds)

    def epoch(self, n):
        for i, batch in enumerate(self.ds.epoch(n), start=1 + (n - 1) * len(self.ds)):
            if i == self.bad and "bad" not in self.used:
                self.used.add("bad")
                batch = dict(batch, src_img=batch["src_img"] * np.float32("nan"))
            yield batch


def test_rollback_reruns_the_same_batches(llff_cfg, straight, tmp_path):
    cfg = llff_cfg.replace(**{"resilience.sentinel_policy": "rollback"})
    trainer = _trainer(cfg, tmp_path)
    trainer.fit(_PoisonOnce(build_dataset(cfg, "train", 2), bad=3), max_steps=4)
    assert trainer.sentinel.rollbacks == 1 and trainer.global_step == 4
    # steps 1-3 (the third NaN), then back to the last-good step 2: 3 and 4 again
    assert trainer.seen == straight.seen[:3] + straight.seen[2:]
    assert trainer.losses[:2] + trainer.losses[3:] == straight.losses
    assert np.isnan(trainer.losses[2])


class _FlakyOpen:
    """A loader whose batches are each built by an independent call (so that
    its pull may be retried), failing with OSError once before batch 2."""

    def __init__(self, ds):
        self.ds, self.failed = ds, False

    def __len__(self):
        return len(self.ds)

    def epoch(self, n):
        owner, batches = self, list(self.ds.epoch(n))

        class _It:
            retry_safe_iter = True
            pulled = 0

            def __iter__(self):
                return self

            def __next__(self):
                if self.pulled == len(batches):
                    raise StopIteration
                if self.pulled == 1 and not owner.failed:
                    owner.failed = True
                    raise OSError("stale NFS handle")
                self.pulled += 1
                return batches[self.pulled - 1]

        return _It()


def test_loader_retries_take_effect(llff_cfg, straight, caplog):
    def retries_logged():
        return sum("loader retry" in r.getMessage() for r in caplog.records)

    caplog.set_level(logging.WARNING, logger="mine_tpu_torch")
    for retries, raises in ((1, False), (0, True)):
        caplog.clear()
        cfg = llff_cfg.replace(**{"data.loader_retries": retries})
        trainer = _trainer(cfg)
        ds = _FlakyOpen(build_dataset(cfg, "train", 2))
        if raises:
            with pytest.raises(OSError, match="stale NFS handle"):
                trainer.fit(ds, max_steps=2)
            assert retries_logged() == 0
        else:
            trainer.fit(ds, max_steps=2)
            assert retries_logged() == 1 and trainer.seen == straight.seen[:2]
