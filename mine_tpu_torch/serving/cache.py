"""Byte-budgeted LRU cache of predicted MPIs (the port's own copy of
mine_tpu/serving/cache.py).

An S=32 MPI at 384x512 holds rgb (S,H,W,3) + sigma (S,H,W,1) fp32, about
100 MB of device memory, so the budget and the eviction accounting are in
BYTES, not entries. Keys are (image_digest, checkpoint_step, H, W, S, tier):
the same image under a newer checkpoint, at another bucket or at another
compression tier is a different MPI. The digest is of the uploaded bytes,
computed by the server before any decode.

Values are anything with `.nbytes` (the compressed byte count for quantized
or pruned entries, serving/compress.py) and `.bucket`: the cache accounts
what is resident, so the same budget holds a tier-ratio more scenes.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any

import torch

# (image_digest, checkpoint_step, H, W, S, tier): S is the engine bucket's
# coarse plane count (a coarse-to-fine entry holds S + S_fine planes), tier
# the compression tier the entry is stored at ("fp32"|"bf16"|"int8")
CacheKey = tuple[str, int, int, int, int, str]


def mpi_key(
    image_digest: str, checkpoint_step: int, bucket: tuple[int, int, int],
    tier: str = "fp32",
) -> CacheKey:
    h, w, s = bucket
    return (image_digest, int(checkpoint_step), int(h), int(w), int(s),
            str(tier))


def key_to_str(key: CacheKey) -> str:
    """Wire encoding of a cache key (the `mpi_key` field in HTTP responses)."""
    return ":".join(str(part) for part in key)


def key_from_str(s: str) -> CacheKey:
    parts = s.split(":")
    if len(parts) == 5:
        # 5-part wire keys, from before keys carried a tier, name fp32
        digest, step, h, w, planes = parts
        tier = "fp32"
    elif len(parts) == 6:
        digest, step, h, w, planes, tier = parts
    else:
        raise ValueError(f"malformed mpi_key {s!r}")
    return (digest, int(step), int(h), int(w), int(planes), tier)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of one tensor."""
    return int(t.numel()) * int(t.element_size())


@dataclass
class MPIEntry:
    """One cached prediction: everything render-many needs, device-resident.
    The disparities travel with the planes they were predicted at: a
    coarse-to-fine predict renders at its own merged list."""

    mpi_rgb: torch.Tensor  # (1, S, H, W, 3)
    mpi_sigma: torch.Tensor  # (1, S, H, W, 1)
    disparity: torch.Tensor  # (1, S)
    k: torch.Tensor  # (1, 3, 3) shared src/tgt intrinsics (single-image serving)
    bucket: tuple[int, int, int]  # (H, W, S) engine shape bucket
    nbytes: int = field(default=0)

    def __post_init__(self) -> None:
        if not self.nbytes:
            self.nbytes = sum(
                _nbytes(a)
                for a in (self.mpi_rgb, self.mpi_sigma, self.disparity, self.k)
            )


class MPICache:
    """Thread-safe LRU over MPIEntry/CompressedMPI values with
    byte-accounted eviction (bytes = each value's own `.nbytes`, i.e. the
    compressed size for quantized tiers).

    `get` refreshes recency; `put` evicts least-recently-used entries until
    the resident total fits the budget. A single entry larger than the whole
    budget is still admitted (after evicting everything else): refusing it
    would make oversized requests uncacheable and re-run the encoder on
    every render — strictly worse than a temporarily overshot budget. The
    overshoot is visible in the bytes-resident gauge.
    """

    def __init__(self, byte_budget: int, metrics: Any | None = None):
        if byte_budget <= 0:
            raise ValueError(f"byte_budget must be positive, got {byte_budget}")
        self.byte_budget = int(byte_budget)
        self._lock = threading.Lock()
        self._entries: OrderedDict[CacheKey, Any] = OrderedDict()
        self._bytes = 0
        self._metrics = metrics

    @property
    def bytes_resident(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> list[CacheKey]:
        with self._lock:
            return list(self._entries)

    def hot_keys(self, n: int) -> list[tuple[str, int]]:
        """The up-to-n most recently used entries as (wire key, nbytes),
        hottest first: the reverse of eviction order, so a pre-warm that
        fetches the list front to back moves first what eviction would take
        last (the autoscale join and drain, GET /debug/hot_keys)."""
        if n <= 0:
            return []
        out: list[tuple[str, int]] = []
        with self._lock:
            for key in reversed(self._entries):
                out.append((key_to_str(key), int(self._entries[key].nbytes)))
                if len(out) >= n:
                    break
        return out

    def stale_key(self, key: CacheKey) -> CacheKey | None:
        """Stale-while-revalidate (serving/degrade.py L2): the resident key
        of the same scene and shape bucket, at any tier, with the newest
        checkpoint step older than `key`'s; None when there is none."""
        digest, step, h, w, s, _ = key
        best: CacheKey | None = None
        with self._lock:
            for cand in self._entries:
                if (cand[0] == digest and cand[2:5] == (h, w, s) and cand[1] < step
                        and (best is None or cand[1] > best[1])):
                    best = cand
        return best

    def get(self, key: CacheKey, record: bool = True) -> Any | None:
        """Lookup + LRU touch. record=False skips the hit/miss counters, for
        internal re-checks (the predict singleflight's under-lock peek) that
        would otherwise count one request twice."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if record and self._metrics is not None:
            if entry is not None:
                self._metrics.cache_hits.inc()
            else:
                self._metrics.cache_misses.inc()
        return entry

    def put(self, key: CacheKey, entry: Any) -> list[CacheKey]:
        """Insert (or refresh) an entry; returns the keys evicted for it."""
        evicted: list[CacheKey] = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._bytes += entry.nbytes
            # evict from the LRU end, never the entry just inserted
            while self._bytes > self.byte_budget and len(self._entries) > 1:
                victim_key, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                evicted.append(victim_key)
            self._update_gauges_locked()
        if self._metrics is not None and evicted:
            self._metrics.cache_evictions.inc(len(evicted))
        return evicted

    def _update_gauges_locked(self) -> None:
        if self._metrics is not None:
            self._metrics.cache_bytes_resident.set(self._bytes)
            self._metrics.cache_entries.set(len(self._entries))
