"""Background batch prefetch with a bounded queue — port of
``gs_init_tpu/datasets/prefetch.py``.

One daemon thread builds whole device-ready batches (decode, undistort,
stack, copy to the device) ``depth`` steps ahead of the train loop. The
Runner's ``build`` stages host arrays in pinned memory and copies them with
``non_blocking=True``, so the copy overlaps the step that runs meanwhile;
the copies go on the device's current stream, ahead of the step that reads
them. Threads, not processes: decoding and the copies release the GIL.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, Optional

import numpy as np


class BatchPrefetcher:
    """Builds batches on a daemon thread, ``depth`` ahead of the consumer.

    ``build(ids)`` may read immutable runner state (datasets, the fixed pose
    perturbation) but not the training state. Epoch permutations come from
    this object's own ``np.random.default_rng(seed)``, so the order is the
    JAX package's for the same seed. A worker exception is raised again in
    ``get()``."""

    _SENTINEL = object()

    def __init__(
        self,
        build: Callable[[List[int]], object],
        n_items: int,
        batch_size: int,
        depth: int = 2,
        seed: int = 0,
    ):
        if n_items <= 0:
            raise ValueError("empty dataset")
        self._build = build
        self._n = n_items
        self._bs = batch_size
        self._rng = np.random.default_rng(seed)
        self._perm: List[int] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, name="batch-prefetch", daemon=True)
        self._thread.start()

    def _next_ids(self) -> List[int]:
        ids = []
        for _ in range(self._bs):
            if not self._perm:
                self._perm = list(self._rng.permutation(self._n))
            ids.append(int(self._perm.pop()))
        return ids

    def _put(self, item) -> None:
        """A bounded put that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return
            except queue.Full:
                continue

    def _worker(self):
        try:
            while not self._stop.is_set():
                self._put(self._build(self._next_ids()))
        except BaseException as e:  # handed to the consumer by get()
            self._exc = e
            self._put(self._SENTINEL)

    def get(self):
        """The next prefetched batch; raises the worker's exception."""
        item = self._q.get()
        if item is self._SENTINEL:
            raise RuntimeError("batch prefetch worker died") from self._exc
        return item

    def close(self):
        """Stop the worker and join it."""
        self._stop.set()
        # Drain so that a blocked put() wakes up promptly.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
