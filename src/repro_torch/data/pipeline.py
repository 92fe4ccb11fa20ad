"""Deterministic host-sharded data pipeline with background prefetch (a
stdlib copy of ``repro/data/pipeline.py``).

Every batch is a pure function of (seed, step, host_id), so:
  * restart-from-checkpoint replays the identical stream (fault tolerance),
  * each host generates only its slice of the global batch (no host-side
    all-to-all), as multi-host input pipelines do,
  * elastic rescale (n_hosts changes) re-slices the same global stream.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class ShardedLoader:
    def __init__(self, gen: Callable[..., dict], *, global_batch: int,
                 n_hosts: int = 1, host_id: int = 0, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2, **gen_kwargs):
        assert global_batch % n_hosts == 0
        self.gen = gen
        self.local_batch = global_batch // n_hosts
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.seed = seed
        self.step = start_step
        self.gen_kwargs = gen_kwargs
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _make(self, step: int) -> dict:
        # host slice: independent substream per (host, step)
        return self.gen(batch=self.local_batch,
                        seed=self.seed * 1_000_003 + self.host_id,
                        step=step, **self.gen_kwargs)

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self._stop.set()

    def take(self, n: int) -> list[tuple[int, dict]]:
        """Synchronous helper (tests/benches): n batches without the thread."""
        return [(s, self._make(s)) for s in range(self.step, self.step + n)]
