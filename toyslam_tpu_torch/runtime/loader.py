"""Host-side scan loading: directory listing and watching, packing into
padded stacks, and a prefetching feed to the device (the port of
``toyslam_tpu/runtime/loader.py``).

The reference's host IO layer: PCD directory watching
(``ndt_omp_mapping_node.cpp:72-136``, hot-reload of new ``cloud_N.pcd``
files), sequential replay (``ndt_rosbag_mapping_node.cpp:27-78``) and
scan persistence (``lidar_subscriber_node.cpp:35-54``). Many scans are
parsed at once by the C pthread packer of ``csrc/host/scanpack.c``
(``native=True``) or by ``core/pcd_io`` on a thread pool (``native=False``);
the two give byte-equal stacks. ``ScanStream`` decodes scans on a
producer thread into pinned host buffers and copies each to the card on a
side stream while the consumer computes on the one before.
"""

from __future__ import annotations

import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from queue import Full, Queue
from typing import Iterator

import numpy as np
import torch

from toyslam_tpu_torch.core import pcd_io
from toyslam_tpu_torch.core.pointcloud import PAD_COORD


def _numeric_key(path: Path):
    m = re.findall(r"\d+", path.stem)
    return (int(m[-1]) if m else 0, path.stem)


def list_scan_files(directory: str | Path, pattern: str = "*.pcd"):
    """Scan files sorted by the last number in their names (``cloud_N``)."""
    return sorted(Path(directory).glob(pattern), key=_numeric_key)


def pack_scan(points: np.ndarray, capacity: int):
    """[n, 4] -> padded (xyzi [capacity, 4] f32, mask [capacity] bool);
    non-finite points are masked."""
    xyzi = np.full((capacity, 4), PAD_COORD, np.float32)
    xyzi[:, 3] = 0.0
    k = min(len(points), capacity)
    xyzi[:k] = points[:k]
    mask = np.zeros((capacity,), bool)
    mask[:k] = np.isfinite(points[:k, :3]).all(axis=1)
    return xyzi, mask


def load_scan_stack(paths, capacity: int, workers: int = 8,
                    native: bool = True):
    """Decode many PCDs into one [S, capacity, 4] f32 stack and its [S,
    capacity] mask: with the C pthread packer (``native=True``; raises
    naming any file that fails) or with ``pcd_io.read_pcd`` on a thread
    pool (``native=False``)."""
    paths = list(paths)
    if native:
        from toyslam_tpu_torch.runtime import native as host

        return host.pack_scans(paths, capacity, workers)
    xyzi = np.full((len(paths), capacity, 4), PAD_COORD, np.float32)
    xyzi[..., 3] = 0.0
    mask = np.zeros((len(paths), capacity), bool)

    def one(i_path):
        i, path = i_path
        xyzi[i], mask[i] = pack_scan(pcd_io.read_pcd(path, native=False),
                                     capacity)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(one, enumerate(paths)))
    return xyzi, mask


class ScanStream:
    """Prefetching scan feed: iterates (xyzi [capacity, 4] f32, mask
    [capacity] bool) tensors on ``device``, one a path in order.

    A producer thread decodes up to ``prefetch`` scans ahead. On a CUDA
    device it decodes each into a pinned host buffer (a ring of
    ``prefetch + 2``), copies it to the card with ``non_blocking=True`` on
    a side stream and records an event; the consumer's current stream
    waits on that event before the tensors are handed out, and
    ``record_stream`` keeps the allocator from giving their memory to
    another tensor while that stream may still read them. A pinned buffer
    is rewritten only after its copy has finished. On ``device="cpu"`` the
    tensors are plain copies. ``wait_s`` accumulates the host time the
    consumer spent waiting on the queue. A decode error is raised in the
    consumer.
    """

    def __init__(self, paths, capacity: int, device="cuda",
                 prefetch: int = 2, native: bool = True):
        self.paths = list(paths)
        self.capacity = capacity
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.native = native
        self.wait_s = 0.0
        self.queue: Queue = Queue(maxsize=prefetch)
        self._ring = prefetch + 2
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._producer, daemon=True)
        self.thread.start()

    def _decode(self, path, xyzi: np.ndarray, mask: np.ndarray) -> None:
        """One scan into the given host arrays."""
        if self.native:
            from toyslam_tpu_torch.runtime import native as host

            host.pack_scans([path], self.capacity, 1,
                            out=(xyzi[None], mask[None]))
        else:
            xyzi[...], mask[...] = pack_scan(
                pcd_io.read_pcd(path, native=False), self.capacity)

    def _put(self, item) -> bool:
        """Queue ``item`` unless the consumer has gone; False if it has."""
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def _producer(self):
        try:
            if self.device.type == "cuda":
                self._produce_cuda()
            else:
                for path in self.paths:
                    xyzi = np.empty((self.capacity, 4), np.float32)
                    mask = np.empty((self.capacity,), bool)
                    self._decode(path, xyzi, mask)
                    if not self._put((torch.from_numpy(xyzi).to(self.device),
                                      torch.from_numpy(mask).to(self.device),
                                      None)):
                        return
        except Exception as e:  # raised again in the consumer
            self._put(e)
            return
        self._put(None)

    def _produce_cuda(self):
        dev = self.device
        side = torch.cuda.Stream(dev)
        pinned = [(torch.empty((self.capacity, 4), dtype=torch.float32,
                               pin_memory=True),
                   torch.empty((self.capacity,), dtype=torch.bool,
                               pin_memory=True))
                  for _ in range(self._ring)]
        copied = [None] * self._ring  # each buffer's copy-done event
        for i, path in enumerate(self.paths):
            b = i % self._ring
            if copied[b] is not None:
                copied[b].synchronize()  # its last copy has finished
            px, pm = pinned[b]
            self._decode(path, px.numpy(), pm.numpy())
            with torch.cuda.stream(side):
                dx = px.to(dev, non_blocking=True)
                dm = pm.to(dev, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(side)
            copied[b] = ready
            if not self._put((dx, dm, ready)):
                return

    def __iter__(self) -> Iterator:
        try:
            while True:
                t0 = time.perf_counter()
                item = self.queue.get()
                self.wait_s += time.perf_counter() - t0
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                xyzi, mask, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    xyzi.record_stream(consumer)
                    mask.record_stream(consumer)
                yield xyzi, mask
        finally:
            self._stop.set()


class DirectoryWatcher:
    """Poll a directory for new scans (ndt_omp_mapping_node's 1 Hz tick,
    ``:72-108``): each call to ``poll()`` returns the files that appeared
    since the last."""

    def __init__(self, directory: str | Path, pattern: str = "*.pcd"):
        self.directory = Path(directory)
        self.pattern = pattern
        self.seen: set = set()

    def poll(self):
        fresh = []
        for p in list_scan_files(self.directory, self.pattern):
            if p not in self.seen:
                self.seen.add(p)
                fresh.append(p)
        return fresh
