"""Prefetching data loader (``repro.data.loader.ShardedLoader`` on one
device): a background thread builds batch ``step`` from the position-keyed
dataset and puts it on ``device`` while the previous step runs (a depth-2
queue). On a GPU each batch goes through pinned host memory with a
non-blocking copy on the default stream, so the copy is ordered before
the step that reads it. There is no sharding: the port trains on one
card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import torch

from repro_torch.device import resolve_device

PREFETCH = 2    # batches built ahead of the step that reads them


class PrefetchLoader:
    def __init__(self, dataset, device=None):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.step = 0
        self._q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _build(self, step: int) -> dict:
        out = {}
        for k, v in self.dataset.batch(step).items():
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _worker(self, step: int, stop: threading.Event, q: queue.Queue):
        while not stop.is_set():
            batch = self._build(step)
            while not stop.is_set():
                try:
                    q.put((step, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, args=(self.step, self._stop, self._q),
                daemon=True)
            self._thread.start()
        return self

    def __iter__(self) -> Iterator:
        self.start()
        while True:
            step, batch = self._q.get()
            self.step = step + 1
            yield step, batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def seek(self, step: int):
        """Restart-safe repositioning (checkpoint restore)."""
        self.stop()
        self._q = queue.Queue(maxsize=PREFETCH)
        self._stop = threading.Event()
        self.step = step
        return self
