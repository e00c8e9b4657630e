"""Faults planted under the timed path, to show that the check catches
them: by the check's tests on the CPU (``tests/test_pb_checks.py``) and
on the card at a cell's own size (``python3 -m portbench.calibrate
--fault <name>``).

- ``state_unchanged``: a step that returns its state unchanged (the
  mapping step keeps the previous map and pose; an align returns its
  guess);
- ``half_batch``: half of the batch left out, the mean taken over the
  rest (every other ray of each scan before the downsample; every other
  correspondence of GICP's sums, which are doubled);
- ``answer_altered``: a pairwise transform moved by 2 cm where it is
  produced;
- ``pose_order`` (mapping): the pose chain composed in the wrong order,
  ``T @ pose`` for ``pose @ T``, and the map merged at those poses.

The cells run on one card each, so no exchange between chips can be left
out.
"""

from __future__ import annotations

import torch

FAULTS = {
    "mapping": ("state_unchanged", "half_batch", "answer_altered",
                "pose_order"),
    "pairwise": ("state_unchanged", "half_batch", "answer_altered"),
}


def plant(loop: str, fault: str, setattr_) -> None:
    """Plants ``fault`` under the loop ``loop`` (a module name of
    ``portbench.loops``) by ``setattr_(module, name, value)``: pytest's
    ``monkeypatch.setattr``, or ``setattr`` in a process of its own."""
    if fault not in FAULTS[loop]:
        raise ValueError(f"no fault {fault!r} for the {loop} loop")
    (_mapping if loop == "mapping" else _pairwise)(fault, setattr_)


def _mapping(fault, setattr_):
    from toyslam_tpu_torch.pipelines import odometry

    step = odometry.mapping_step
    if fault == "state_unchanged":
        setattr_(odometry, "mapping_step",
                 lambda state, *a: (state, step(state, *a)[1]))
    elif fault == "half_batch":
        ds = odometry.voxel_downsample_lanes

        def half(xyzi, mask, *a, **k):
            keep = torch.arange(mask.shape[-1], device=mask.device) % 2 == 0
            return ds(xyzi, mask & keep, *a, **k)

        setattr_(odometry, "voxel_downsample_lanes", half)
    elif fault == "answer_altered":
        def altered(*a):
            state, out = step(*a)
            T = out[1].clone()
            T[0, 3] += 0.02
            return state, (out[0], T, *out[2:])

        setattr_(odometry, "mapping_step", altered)
    else:
        odo_step = odometry.odometry_step

        def wrong_order(state, *a, **k):
            new, out = odo_step(state, *a, **k)
            pose = out[1] @ state.pose
            return new._replace(pose=pose), (pose, *out[1:])

        setattr_(odometry, "odometry_step", wrong_order)


def _pairwise(fault, setattr_):
    from toyslam_tpu_torch.ops import gicp_kernels
    from toyslam_tpu_torch.registration import gicp

    align = gicp.gicp_align
    if fault == "state_unchanged":
        def unchanged(source, target, guess=None, config=None):
            res = align(source, target, guess, config)
            return res._replace(transform=torch.as_tensor(guess).clone())

        setattr_(gicp, "gicp_align", unchanged)
    elif fault == "half_batch":
        terms = gicp_kernels.gicp_terms

        def half(params, xyz, q, m6, w):
            keep = torch.arange(w.shape[0], device=w.device) % 2 == 0
            return 2.0 * terms(params, xyz, q, m6, w * keep)

        setattr_(gicp_kernels, "gicp_terms", half)
    else:
        def altered(*a, **k):
            res = align(*a, **k)
            T = res.transform.clone()
            T[0, 3] += 0.02
            return res._replace(transform=T)

        setattr_(gicp, "gicp_align", altered)
