"""Host-side scan loading (the directory part of
``toyslam_tpu/runtime/loader.py``).

Numerically sorted ``cloud_N.pcd`` listing, padding of one scan to a fixed
capacity, and a thread-pool decode of many scans into one ``[S, capacity,
4]`` stack. The reference's native pthread pack, its double-buffered device
feed (``ScanStream``) and its directory watcher are not ported.
"""

from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

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


def load_scan_stack(paths, capacity: int, workers: int = 8):
    """Decode many PCDs on a thread pool into one [S, capacity, 4] stack
    and its [S, capacity] mask."""
    paths = list(paths)
    xyzi = np.full((len(paths), capacity, 4), PAD_COORD, np.float32)
    xyzi[..., 3] = 0.0
    mask = np.zeros((len(paths), capacity), bool)

    def one(i_path):
        i, path = i_path
        xyzi[i], mask[i] = pack_scan(pcd_io.read_pcd(path), capacity)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(one, enumerate(paths)))
    return xyzi, mask
