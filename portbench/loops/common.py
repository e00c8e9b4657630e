"""What the loops share: seeded draws and the comparisons of the
check."""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` (any whole number)."""
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> list:
    """``n`` draws from U(lo, hi) as Python floats."""
    u = torch.rand(n, generator=gen, dtype=torch.float64,
                   device=gen.device)
    return (lo + (hi - lo) * u).tolist()


def transform_gaps(A: torch.Tensor, B: torch.Tensor):
    """The largest translation gap (m) and rotation gap (rad) between
    transforms ``A [k, 4, 4]`` and ``B [k, 4, 4]``."""
    t, r = transform_gap_rows(A, B)
    return float(t.max()), float(r.max())


def transform_gap_rows(A: torch.Tensor, B: torch.Tensor):
    """Translation gaps (m) and rotation gaps (rad) ``[k]`` of each pair of
    transforms."""
    A, B = A.double(), B.double()
    t = torch.linalg.vector_norm(A[:, :3, 3] - B[:, :3, 3], dim=1)
    M = A[:, :3, :3].transpose(1, 2) @ B[:, :3, :3]
    v = torch.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0],
                     M[:, 1, 0] - M[:, 0, 1]], 1) / 2
    c = (M[:, 0, 0] + M[:, 1, 1] + M[:, 2, 2] - 1) / 2
    return t, torch.atan2(torch.linalg.vector_norm(v, dim=1), c)


def _keys(xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    ijk = torch.floor(xyz / leaf).to(torch.int64) + (1 << 20)
    return (ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2]


def map_mismatch(got: torch.Tensor, ref: torch.Tensor, leaf: float,
                 match_m: float) -> float:
    """Share of the voxels of two maps (centroids ``[n, 3]``) that do not
    match: a centroid matches when the other map has one in the same voxel
    of ``leaf`` within ``match_m``. Counted over both maps."""
    ref = ref.to(got.device)
    kg, kr = _keys(got, leaf), _keys(ref, leaf)
    order = torch.argsort(kr)
    kr = kr[order]
    if len(kr) == 0 or len(kg) == 0:
        return 1.0 if len(kr) + len(kg) else 0.0
    idx = torch.searchsorted(kr, kg).clamp(max=len(kr) - 1)
    gap = torch.linalg.vector_norm(got - ref[order][idx], dim=1)
    ok = int(((kr[idx] == kg) & (gap <= match_m)).sum())
    return (len(kg) + len(kr) - 2 * ok) / (len(kg) + len(kr))


def cloud_gap(got: torch.Tensor, ref: torch.Tensor):
    """Count gap of two downsampled clouds ``[n, 3]`` (both in ascending
    voxel id) and the largest distance between their rows of one index,
    over the rows both have."""
    n = min(len(got), len(ref))
    if n == 0:
        return abs(len(got) - len(ref)), 0.0
    d = torch.linalg.vector_norm(
        got[:n].double() - ref[:n].to(got.device).double(), dim=1)
    return abs(len(got) - len(ref)), float(d.max())
