"""Whether an odometry align that the kernels and the plain versions end
apart sits on an edge of the data or on a fault of the kernels.

    python -m toyslam_tpu_torch.diag.ndt_odometry_edge

On the card, over the odometry scans of ``chip_smoke.py`` (16 generated
64 x 4096-ray scans, seed 0, the shipped ``OdometryConfig``):

- the odometry through the kernels, through the plain versions in f32 and
  through the plain versions in f64: iterations per scan and each route's
  largest distance from the f64 poses;
- every K1 and K3 evaluation of the plain f32 route, the kernel run on the
  same inputs: the largest error of its sums against the plain sums, per
  scan, relative to the largest sum of each group (as ``chip_smoke.py``
  checks it) and relative to the magnitudes of each sum's terms (which
  cancellation near an optimum does not inflate; ``plain_route``);
- the align of scan 10 alone (where kernels summing in other orders have
  ended 0.127 m from the plain route), from the plain route's warm start
  and from that warm start moved by 1e-6 to 1e-3 along each axis of the
  pose chart, through each route: where each ends, measured from the
  plain f64 align from the unmoved warm start. If the plain f64 align
  itself ends on both sides under moves far below the f32 routes'
  differences, the edge is the data's.

Prints one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from toyslam_tpu_torch.ops import ndt_kernels

NDT_GROUPS = (slice(0, 1), slice(1, 7), slice(7, 28))  # score, grad, Hess
MOVES = (1e-6, 1e-5, 1e-4, 1e-3)  # of the warm start's pose6, each axis
SPLIT_M = 0.01  # an end this far from the reference is the other branch
N_SCANS, SCAN = 16, 10


def terms_rel_err(got, want):
    """Largest error of the 28 sums, each relative to the largest of its
    group (score, gradient, Hessian)."""
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    return max(float(np.abs(got[sl] - want[sl]).max()
                     / max(np.abs(want[sl]).max(), 1e-30))
               for sl in NDT_GROUPS)


def _pair_terms(name, args):
    """The plain per-pair terms [28, K*N] behind one K1 or K3 call."""
    if name == "ndt_terms_packed":
        return ndt_kernels.ndt_pair_terms_plain(*args)
    params, xyz, mask, table, min_b, div, inv_leaf, offsets = args
    hashed = ndt_kernels.ndt_neighbor_hash_plain(
        params, xyz, mask, min_b, div, table.shape[0], inv_leaf, offsets)
    return ndt_kernels.ndt_pair_terms_plain(
        params, xyz, ndt_kernels.ndt_gather_repack_plain(table, *hashed))


def magnitude_err(got, want, terms):
    """Largest error of the 28 sums, each relative to the sum of the
    magnitudes of its terms: what a rounding of each addition can give,
    whatever the terms cancel to."""
    scale = terms.double().abs().sum(1).cpu()
    diff = (got.double().cpu() - want.double().cpu()).abs()
    return float((diff / scale.clamp_min(1e-300)).max())


def lane_row_args(name, args, y, b=None):
    """The one-lane arguments behind row y of a K1 or K3 lane call
    (``ndt_terms_{gathered,packed}_lanes``): its params row and lane
    ``b``'s operands (``b`` read from the call's lanes unless given)."""
    if b is None:
        b = ndt_kernels.lane_list(args[1], args[-1])[y]
    if name == "ndt_terms_packed":
        params, xyz, stats10, _ = args
        return params[y], xyz[b], stats10[b]
    params, xyz, mask, table, min_b, div, inv_leaf, offsets, _ = args
    return (params[y], xyz[b], mask[b], table[b], min_b[b], div[b], inv_leaf,
            offsets)


@contextlib.contextmanager
def plain_route(errors=None, magnitudes=False):
    """K1-K3's wrappers in ``ops.ndt_kernels``, one-lane and lane (the
    odometry's aligns are lockstep aligns), replaced by their plain
    versions while the block runs. With ``errors`` (a list), every K1 and
    K3 evaluation (a row of a lane call is one) also runs the kernel on the
    same inputs and appends ``(name, relative error of the kernel's sums,
    error relative to the terms' magnitudes or None)``: the kernels held to
    the plain versions along the plain route's own path. ``magnitudes``
    computes the last, at the cost of a second plain evaluation."""
    names = ("ndt_terms_gathered", "ndt_gather_repack", "ndt_terms_packed",
             "ndt_terms_gathered_lanes", "ndt_terms_packed_lanes")
    kernel = {name: getattr(ndt_kernels, name) for name in names}
    plain = {name: getattr(ndt_kernels, name + "_plain") for name in names}

    def checked(name):
        one = name.removesuffix("_lanes")

        def run(*args):
            want = plain[name](*args)
            got = kernel[name](*args)
            rows = ([(args, got, want)] if one == name else
                    [(lane_row_args(one, args, y), got[y], want[y])
                     for y in range(len(want))])
            for a, g, w in rows:
                mag = (magnitude_err(g, w, _pair_terms(one, a))
                       if magnitudes else None)
                errors.append((one, terms_rel_err(g, w), mag))
            return want
        return run

    patched = dict(plain)
    if errors is not None:
        for name in names:
            if name != "ndt_gather_repack":
                patched[name] = checked(name)
    try:
        for name, fn in patched.items():
            setattr(ndt_kernels, name, fn)
        yield
    finally:
        for name, fn in kernel.items():
            setattr(ndt_kernels, name, fn)


def _moved(guess, axis, delta):
    """The f64 transform ``guess`` with pose6 coordinate ``axis`` moved."""
    from toyslam_tpu_torch.core import se3

    p = se3.matrix_to_pose6(guess).numpy().copy()
    p[axis] += delta
    return se3.pose6_to_matrix(torch.from_numpy(p))


def _route(name, errors=None):
    """The context a route's calls run in."""
    if name == "kernels":
        return contextlib.nullcontext()
    return plain_route(errors if name == "plain" else None, magnitudes=True)


ROUTES = {"kernels": torch.float32, "plain": torch.float32,
          "plain_f64": torch.float64}


def run():
    from toyslam_tpu_torch.pipelines import odometry
    from toyslam_tpu_torch.registration import ndt
    from toyslam_tpu_torch.sim.urban_scans import spinning_lidar_scans

    if not torch.cuda.is_available():
        raise RuntimeError("ndt_odometry_edge needs a CUDA device")
    dev = torch.device("cuda:0")
    xyzi, mask, _ = spinning_lidar_scans(0, N_SCANS)
    scan = SCAN
    scans = torch.from_numpy(xyzi).to(dev)
    scan_mask = torch.from_numpy(mask).to(dev)
    cfg = odometry.OdometryConfig()

    out, along = {}, []
    for name, dtype in ROUTES.items():
        with _route(name, along):
            out[name] = odometry.ndt_odometry(scans.to(dtype), scan_mask, cfg)
    ref = out["plain_f64"].poses.numpy()
    odo = {name: {"iterations": o.iterations.tolist(),
                  "max_m_from_f64": float(np.abs(
                      o.poses.double().numpy()[:, :3, 3]
                      - ref[:, :3, 3]).max())}
           for name, o in out.items()}
    evals = out["plain"].evaluations.tolist()  # one K1 or K3 call each
    if len(along) != sum(evals):
        raise RuntimeError(f"{len(along)} sums for {sum(evals)} evaluations")
    per_scan = [[max((e[i] for e in along[b - n:b]), default=0.0)
                 for i in (1, 2)]
                for n, b in zip(evals, np.cumsum(evals))]

    # The align of one scan, from the plain route's warm start and moved.
    warm = out["plain"].pairwise[scan - 1].double()
    problems = {}
    for name, dtype in ROUTES.items():
        s = scans.to(dtype)
        problems[name] = (
            ndt.build_ndt_map(odometry._downsample(
                s[scan - 1], scan_mask[scan - 1], cfg), cfg.ndt),
            odometry._downsample(s[scan], scan_mask[scan], cfg))

    def align(name, guess, errors=None):
        m, src = problems[name]
        with _route(name, errors):
            return ndt.ndt_align(m, src, guess.to(ROUTES[name]), cfg.ndt)

    ref_align = align("plain_f64", warm)
    ref_t = ref_align.transform.numpy()[:3, 3]

    def dist(r):
        return float(np.linalg.norm(r.transform.double().numpy()[:3, 3]
                                    - ref_t))

    scan_along, unmoved, moved = [], {}, {}
    for name in ROUTES:
        r = align(name, warm, scan_along)
        unmoved[name] = {"iterations": int(r.iterations),
                         "evaluations": int(r.evaluations),
                         "m_from_ref": dist(r)}
        rows = {}
        for delta in MOVES:
            ends = [align(name, _moved(warm, axis, sign * delta))
                    for axis in range(6) for sign in (1.0, -1.0)]
            d = [dist(r) for r in ends]
            rows[f"{delta:g}"] = {
                "other_branch": sum(x > SPLIT_M for x in d), "of": len(d),
                "max_m": max(d),
                "iterations": sorted({int(r.iterations) for r in ends})}
        moved[name] = rows
    return {"device": torch.cuda.get_device_name(0), "scan": scan,
            "odometry": odo,
            "plain_route_evaluations": len(along),
            "kernel_vs_plain_along_plain_max_rel_err": max(
                e[1] for e in along),
            "kernel_vs_plain_along_plain_max_magnitude_err": max(
                e[2] for e in along),
            "kernel_vs_plain_per_scan_rel_and_magnitude_err": per_scan,
            "align": {"reference": "plain_f64 from the plain warm start",
                      "ref_iterations": int(ref_align.iterations),
                      "unmoved": unmoved,
                      "kernel_vs_plain_along_plain_rel_and_magnitude_err": [
                          [float(f"{x:.3g}") for x in e[1:]]
                          for e in scan_along],
                      "moved_warm_start": moved}}


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
