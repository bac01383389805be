"""Geometric training augmentation (JAX ``data/augment.py``): Kinect
sensor noise on the view cloud and one rigid jitter per scene, numpy on
the host, applied to a `SceneBatch` from either loader (the train CLI's
``--geom-aug``).  The same `RandomState` gives the same batch as the JAX
package, bit for bit.

* Kinect noise (Nguyen, Izadi, Lovell 2012): range-dependent axial sigma,
  lateral jitter linear in range, depth re-quantization and dropout with
  resampling, in the view's camera frame; the per-point companions
  (colors, score and label GT) follow the resampled points.
* Rigid jitter: a rotation about z through the view cloud's xy centroid
  and a translation; the view and the GT grasp frames move together.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kinect_corrupt", "rigid_jitter", "augment_batch"]


def kinect_corrupt(view: np.ndarray, cam: np.ndarray,
                   rng: np.random.RandomState, *, axial: float = 0.0,
                   lateral: float = 0.0, quant: float = 0.0,
                   dropout: float = 0.0, return_index: bool = False):
    """Kinect-style noise on a view cloud [N, 3] seen from `cam` [3]; the
    magnitudes scale the published Kinect v1 numbers.  Returns a new
    [N, 3] f32 array, and with ``return_index`` the [N] resample index
    (the identity without dropout)."""
    pts = np.asarray(view, np.float64)
    cam = np.asarray(cam, np.float64)
    d = pts - cam
    r = np.linalg.norm(d, axis=1, keepdims=True)
    ray = d / np.maximum(r, 1e-9)
    rr = r[:, 0]
    if axial:
        # sigma_z = 1.2 mm + 1.9 mm * (r - 0.4)^2
        sigma_z = (0.0012 + 0.0019 * (rr - 0.4) ** 2) * axial
        pts = pts + ray * (rng.randn(len(pts), 1) * sigma_z[:, None])
    if lateral:
        # about 0.815 mm at 1 m, linear in range, isotropic across the ray
        sigma_l = 0.000815 * rr * lateral
        t1 = np.cross(ray, np.array([0.0, 0.0, 1.0]))
        n1 = np.linalg.norm(t1, axis=1, keepdims=True)
        # rays along z: cross with x instead
        t1_alt = np.cross(ray, np.array([1.0, 0.0, 0.0]))
        t1 = np.where(n1 < 1e-6, t1_alt, t1)
        t1 /= np.maximum(np.linalg.norm(t1, axis=1, keepdims=True), 1e-9)
        t2 = np.cross(ray, t1)
        t2 /= np.maximum(np.linalg.norm(t2, axis=1, keepdims=True), 1e-9)
        pts = pts + t1 * (rng.randn(len(pts), 1) * sigma_l[:, None]) \
                  + t2 * (rng.randn(len(pts), 1) * sigma_l[:, None])
    if quant:
        # depth resolution about 2.73e-3 * r^2: snap the range to it
        d2 = pts - cam
        r2 = np.linalg.norm(d2, axis=1, keepdims=True)
        step = np.maximum(2.73e-3 * r2 ** 2 * quant, 1e-6)
        snapped = np.round(r2 / step) * step
        pts = cam + d2 / np.maximum(r2, 1e-9) * snapped
    sel = np.arange(len(pts))
    if dropout:
        keep = rng.rand(len(pts)) >= dropout
        idx = np.flatnonzero(keep)
        if len(idx) == 0:
            idx = np.arange(len(pts))
        sel = rng.choice(idx, len(pts), replace=True)
        pts = pts[sel]
    pts = pts.astype(np.float32)
    return (pts, sel) if return_index else pts


def rigid_jitter(rng: np.random.RandomState, severity: float = 1.0):
    """One rigid transform (R [3, 3], t [3]): a rotation about +z by
    U(0, 2 pi) (whatever the severity, where it is positive), and a
    translation x, y ~ U(-0.05, 0.05), z ~ U(-0.06, 0.03), scaled by
    min(severity, 1)."""
    s = min(float(severity), 1.0)
    ang = rng.uniform(0.0, 2.0 * np.pi) if severity > 0 else 0.0
    c, sn = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]],
                   np.float64)
    t = np.array([rng.uniform(-0.05, 0.05) * s,
                  rng.uniform(-0.05, 0.05) * s,
                  rng.uniform(-0.06, 0.03) * s], np.float64)
    return rot, t


def _transform_scene(view: np.ndarray, frames: np.ndarray,
                     rot: np.ndarray, t: np.ndarray):
    """Rotate about the vertical axis through the view cloud's xy
    centroid, then translate; frames [G, 3, 4] (axes as columns, then the
    base)."""
    pivot = view.mean(0)
    pivot[2] = 0.0
    new_view = (view - pivot) @ rot.T + pivot + t
    new_frames = frames.copy()
    new_frames[:, :, :3] = np.einsum("ij,gjk->gik", rot, frames[:, :, :3])
    new_frames[:, :, 3] = (frames[:, :, 3] - pivot) @ rot.T + pivot + t
    return new_view.astype(np.float32), new_frames.astype(np.float32)


def augment_batch(batch, rng: np.random.RandomState, severity: float,
                  cameras: np.ndarray):
    """The augmented copy of a `SceneBatch` (the batch itself where
    ``severity <= 0``): per scene, Kinect noise at `severity` with dropout
    0.1 * min(severity, 1), seen from ``cameras[b]`` ([B, 3]), then a
    rigid jitter; widths and paths are shared."""
    if severity <= 0.0:
        return batch
    s = float(severity)
    pc = batch.pc.copy()
    score = batch.score.copy()
    label = batch.label.copy()
    frames = batch.gt_frames.copy()
    for b in range(pc.shape[0]):
        view, sel = kinect_corrupt(
            pc[b, :, :3], cameras[b], rng, axial=s, lateral=s, quant=s,
            dropout=0.1 * min(s, 1.0), return_index=True)
        rot, t = rigid_jitter(rng, s)
        view, frames[b] = _transform_scene(view, frames[b], rot, t)
        pc[b, :, :3] = view
        pc[b, :, 3:] = pc[b, sel, 3:]
        score[b] = score[b, sel]
        label[b] = label[b, sel]
    return batch._replace(pc=pc, score=score, label=label,
                          gt_frames=frames)
