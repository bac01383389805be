"""Frozen copy of the port's ``data/synthetic.py`` (the training scenes
the benchmark writes), with its own gripper and evaluator constants.

Synthetic tabletop grasp scenes.

The reference trains on a private pickle dataset (scoredataset.py:60-81 keys:
view_cloud / view_cloud_color / view_cloud_score / view_cloud_label +
select_frame / select_*_score label arrays + scene_cloud for the evaluator).
That data is not shipped, so this module generates physically-plausible
scenes in exactly that schema.

Scene model (round 2 — clutter/occlusion upgrade):

  * objects: spheres, boxes and vertical cylinders, placed in 1-2 clusters
    with near-contact gaps (clutter), on a table plane;
  * the VIEW cloud is visibility-filtered from one of the evaluator's four
    CAMERA_POSEs (evaluation_data_generator.py:34-39) with an angular
    z-buffer, so self- and inter-object occlusion make the view cloud a
    strict subset of the scene — predictions can pass the view collision
    check yet hit hidden scene geometry (nocoll_view != nocoll_scene);
  * the SCENE cloud stays dense and unoccluded, with exact analytic
    surface normals;
  * GT grasps: top-down pinches on every object plus horizontal side
    grasps on boxes/cylinders.  Every candidate is validated at generation
    time with a numpy re-statement of the geometric evaluator's rules
    (same GripperConfig/EvalConfig constants) — back/finger collision
    against the full scene, >=16 close-plane and closing-region points,
    visible closing region in the view cloud — and labelled with its
    measured antipodal score, so the labels are consistent with what
    eval/collision.py will report;
  * per-point graspability score: distance falloff to the nearest valid
    GT grasp's closing-region centroid (raw score in [0, 2], the dataset
    tanh-squashes it like scoredataset.py:80).
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np


# the port's gripper and evaluator constants, frozen with the generator
@dataclasses.dataclass(frozen=True)
class GripperConfig:
    """Two-finger parallel gripper geometry (meters)."""

    width: float = 0.08    # max opening between fingers (y extent)
    height: float = 0.010  # hand thickness (z extent)
    depth: float = 0.06    # finger length along approach axis (x extent)
    # evaluator-side geometry, read by the synthetic scene generator
    finger_width: float = 0.01
    half_hand_thickness: float = 0.005
    finger_length: float = 0.06
    bottom_length: float = 0.06
    table_height: float = 0.75

    @property
    def hand_half_bottom_width(self) -> float:
        return self.width / 2 + self.finger_width

    @property
    def hand_half_bottom_space(self) -> float:
        return self.width / 2


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Constants of the geometric evaluator (``eval/``), which the
    synthetic scene generator's grasp labelling also reads."""

    num_points_threshold: int = 16
    close_region_min_points: int = 16
    back_collision_threshold: int = 0
    finger_collision_threshold: int = 0
    back_collision_margin: float = 0.0
    neighbor_depth: float = 0.005
    normal_radius: float = 0.01
    normal_max_nn: int = 30
    table_offset: float = 0.005
    max_grasps: int = 512


TABLE_HEIGHT = 0.75

# evaluator camera positions per view index (eval/evaluator.py:30-36)
_CAMERA_POSE = np.array([
    [0.8, 0.0, 1.7],
    [-0.8, 0.0, 1.6],
    [0.0, 0.75, 1.7],
    [0.0, -0.75, 1.6],
], np.float32)


# --------------------------------------------------------------------------
# surface samplers (points + exact outward normals)

def _sample_sphere(rng, center, radius, n):
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return center + radius * v, v      # outward normal = radial


def _sample_box(rng, center, size, n):
    pts = rng.uniform(-0.5, 0.5, (n, 3)) * size
    # push points to a random face to make it a surface sample
    face = rng.randint(0, 3, n)
    sign = rng.choice([-0.5, 0.5], n)
    pts[np.arange(n), face] = sign * size[face]
    normals = np.zeros((n, 3))
    normals[np.arange(n), face] = np.sign(sign)
    return center + pts, normals


def _sample_cylinder(rng, center, radius, height, n):
    """Vertical cylinder: curved side + flat top cap."""
    n_top = max(n // 6, 1)
    n_side = n - n_top
    phi = rng.uniform(0, 2 * np.pi, n_side)
    z = rng.uniform(-height / 2, height / 2, n_side)
    side = np.c_[radius * np.cos(phi), radius * np.sin(phi), z]
    side_n = np.c_[np.cos(phi), np.sin(phi), np.zeros(n_side)]
    rr = radius * np.sqrt(rng.uniform(0, 1, n_top))
    tphi = rng.uniform(0, 2 * np.pi, n_top)
    top = np.c_[rr * np.cos(tphi), rr * np.sin(tphi),
                np.full(n_top, height / 2)]
    top_n = np.tile([0.0, 0.0, 1.0], (n_top, 1))
    return (center + np.concatenate([side, top]),
            np.concatenate([side_n, top_n]))


# --------------------------------------------------------------------------
# object placement (clusters with near-contact gaps)

def _rich_object(rng):
    """Draw one descriptor from the extended shape library (round 5):
    ellipsoids, two-box L-shapes and mug-like cylinder+handle composites
    join the primitives.  Real objects are composite and curved; a model
    trained only on spheres/boxes/upright cylinders places fingers into
    unseen geometry (the dominant real-cloud failure is the finger-
    collision check, docs/evidence/real_data_r4_retrained.json)."""
    kind = rng.choice(["sphere", "box", "cylinder", "ellipsoid",
                       "lbox", "mug"])
    if kind == "sphere":
        r = rng.uniform(0.02, 0.035)
        return r, TABLE_HEIGHT + r, {"kind": kind, "radius": r}
    if kind == "box":
        size = rng.uniform(0.03, 0.06, 3)
        return (float(np.linalg.norm(size[:2]) / 2),
                TABLE_HEIGHT + size[2] / 2, {"kind": kind, "size": size})
    if kind == "cylinder":
        r = rng.uniform(0.015, 0.03)
        h = rng.uniform(0.05, 0.12)
        return r, TABLE_HEIGHT + h / 2, {"kind": kind, "radius": r,
                                         "height": h}
    if kind == "ellipsoid":
        axes = np.array([rng.uniform(0.015, 0.05),
                         rng.uniform(0.015, 0.05),
                         rng.uniform(0.02, 0.055)])
        return (float(np.hypot(axes[0], axes[1])),
                TABLE_HEIGHT + axes[2], {"kind": kind, "axes": axes})
    if kind == "lbox":
        # two boxes on the table forming an L in plan view
        s1 = rng.uniform(0.03, 0.07, 3)
        s2 = np.array([rng.uniform(0.025, 0.05),
                       rng.uniform(0.025, 0.05),
                       rng.uniform(0.02, min(0.06, s1[2]))])
        off = np.array([(s1[0] + s2[0]) / 2 - 0.004,
                        (s1[1] - s2[1]) / 2 * rng.choice([-1.0, 1.0]),
                        0.0])
        parts = [
            {"shape": "box", "size": s1,
             "offset": np.array([0.0, 0.0, s1[2] / 2])},
            {"shape": "box", "size": s2,
             "offset": off + [0.0, 0.0, s2[2] / 2]},
        ]
        bound = float(np.linalg.norm(s1[:2]) / 2 + s2[0])
        return bound, TABLE_HEIGHT, {"kind": kind, "parts": parts}
    # mug: vertical cylinder body + thin handle box sticking out
    rb = rng.uniform(0.025, 0.042)
    h = rng.uniform(0.06, 0.11)
    hx = 0.018
    parts = [
        {"shape": "cyl", "radius": rb, "height": h,
         "offset": np.array([0.0, 0.0, h / 2])},
        {"shape": "box",
         "size": np.array([hx, 0.012, 0.5 * h]),
         "offset": np.array([rb + hx / 2 - 0.004, 0.0, h * 0.55])},
    ]
    return rb + hx, TABLE_HEIGHT, {"kind": "mug", "parts": parts}


def _place_objects(rng, num_objects, distractors=0, shape_lib="basic"):
    """Sample object descriptors; clustered placement allows contact.

    `distractors` appends that many UNGRASPABLE objects (boxes/spheres
    wider than the gripper opening on every axis) — the candidate
    generator skips them automatically, so their points carry score 0.
    Real scenes contain plenty of too-big objects; a score head that has
    never seen one rates any raised surface as graspable.

    `shape_lib="rich"` draws from the extended library (_rich_object);
    "basic" keeps the r1-r4 primitives and RNG stream (fingerprinted)."""
    objs = []
    n_clusters = 1 if num_objects <= 3 else rng.randint(1, 3)
    anchors = rng.uniform(-0.18, 0.18, (n_clusters, 2))
    placed = []   # (xy, bound_radius)
    for i in range(num_objects + distractors):
        big = i >= num_objects
        if not big and shape_lib == "rich":
            bound, cz, desc = _rich_object(rng)
            anchor = anchors[i % n_clusters]
            for _ in range(40):
                if not placed:
                    xy = anchor + rng.uniform(-0.04, 0.04, 2)
                else:
                    nb_xy, nb_bound = placed[rng.randint(len(placed))]
                    ang = rng.uniform(0, 2 * np.pi)
                    dist = nb_bound + bound + rng.uniform(0.0, 0.03)
                    xy = nb_xy + dist * np.array([np.cos(ang),
                                                  np.sin(ang)])
                if all(np.linalg.norm(xy - p) >= b + bound - 0.005
                       for p, b in placed) and np.all(np.abs(xy) < 0.3):
                    break
            placed.append((xy, bound))
            desc["center"] = np.array([xy[0], xy[1], cz])
            objs.append(desc)
            continue
        if big:
            if rng.rand() < 0.5:
                size = rng.uniform(0.09, 0.20, 3)
                size[2] = rng.uniform(0.04, 0.22)
                bound = float(np.linalg.norm(size[:2]) / 2)
                kind, cz = "box", TABLE_HEIGHT + size[2] / 2
                desc = {"size": size}
            else:
                r = rng.uniform(0.05, 0.09)
                kind, bound, cz = "sphere", r, TABLE_HEIGHT + r
                desc = {"radius": r}
            anchor = rng.uniform(-0.22, 0.22, 2)
            for _ in range(40):
                xy = anchor + rng.uniform(-0.1, 0.1, 2)
                if all(np.linalg.norm(xy - p) >= b + bound - 0.005
                       for p, b in placed) and np.all(np.abs(xy) < 0.34):
                    break
            placed.append((xy, bound))
            desc.update(kind=kind, center=np.array([xy[0], xy[1], cz]))
            objs.append(desc)
            continue
        kind = rng.choice(["sphere", "box", "cylinder"])
        if kind == "sphere":
            r = rng.uniform(0.02, 0.035)
            bound, cz, desc = r, TABLE_HEIGHT + r, {"radius": r}
        elif kind == "box":
            size = rng.uniform(0.03, 0.06, 3)
            bound = float(np.linalg.norm(size[:2]) / 2)
            cz = TABLE_HEIGHT + size[2] / 2
            desc = {"size": size}
        else:
            r = rng.uniform(0.015, 0.03)
            h = rng.uniform(0.05, 0.12)
            bound, cz = r, TABLE_HEIGHT + h / 2
            desc = {"radius": r, "height": h}

        anchor = anchors[i % n_clusters]
        for _ in range(40):
            if not placed:
                xy = anchor + rng.uniform(-0.04, 0.04, 2)
            else:
                # lean toward an already-placed neighbour: gap in [0, 3cm]
                nb_xy, nb_bound = placed[rng.randint(len(placed))]
                ang = rng.uniform(0, 2 * np.pi)
                dist = nb_bound + bound + rng.uniform(0.0, 0.03)
                xy = nb_xy + dist * np.array([np.cos(ang), np.sin(ang)])
            ok = all(np.linalg.norm(xy - p) >= b + bound - 0.005
                     for p, b in placed)
            if ok and np.all(np.abs(xy) < 0.3):
                break
        placed.append((xy, bound))
        desc.update(kind=kind, center=np.array([xy[0], xy[1], cz]))
        objs.append(desc)
    return objs


def _sample_ellipsoid(rng, center, axes, n):
    """Axis-aligned ellipsoid: x = center + dir*axes, normal ~ dir/axes."""
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = center + d * axes
    nrm = d / np.asarray(axes)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


def _part_area(part) -> float:
    if part["shape"] == "box":
        a, b, c = part["size"]
        return float(2 * (a * b + b * c + c * a))
    r, h = part["radius"], part["height"]
    return float(2 * np.pi * r * h + np.pi * r ** 2)


def _object_area(obj) -> float:
    """Approximate surface area, for area-proportional point budgets."""
    if obj["kind"] == "sphere":
        return float(4 * np.pi * obj["radius"] ** 2)
    if obj["kind"] == "box":
        a, b, c = obj["size"]
        return float(2 * (a * b + b * c + c * a))
    if obj["kind"] == "ellipsoid":
        a, b, c = obj["axes"]
        # Knud Thomsen approximation
        p = 1.6075
        return float(4 * np.pi * ((a**p * b**p + a**p * c**p
                                   + b**p * c**p) / 3) ** (1 / p))
    if obj["kind"] in ("lbox", "mug"):
        return sum(_part_area(p) for p in obj["parts"])
    r, h = obj["radius"], obj["height"]
    return float(2 * np.pi * r * h + np.pi * r ** 2)


def _object_points(rng, obj, n):
    if obj["kind"] == "sphere":
        pts, nrm = _sample_sphere(rng, obj["center"], obj["radius"], n)
    elif obj["kind"] == "box":
        pts, nrm = _sample_box(rng, obj["center"], obj["size"], n)
    elif obj["kind"] == "ellipsoid":
        pts, nrm = _sample_ellipsoid(rng, obj["center"], obj["axes"], n)
    elif obj["kind"] in ("lbox", "mug"):
        areas = np.array([_part_area(p) for p in obj["parts"]])
        shares = np.maximum((areas / areas.sum() * n).astype(int), 8)
        ps, ns = [], []
        for part, k in zip(obj["parts"], shares):
            pc = np.asarray(obj["center"], np.float64) + part["offset"]
            if part["shape"] == "box":
                p_, n_ = _sample_box(rng, pc, part["size"], int(k))
            else:
                p_, n_ = _sample_cylinder(rng, pc, part["radius"],
                                          part["height"], int(k))
            ps.append(p_)
            ns.append(n_)
        pts, nrm = np.concatenate(ps), np.concatenate(ns)
    else:
        pts, nrm = _sample_cylinder(rng, obj["center"], obj["radius"],
                                    obj["height"], n)
    keep = pts[:, 2] >= TABLE_HEIGHT - 1e-4
    return pts[keep], nrm[keep]


# --------------------------------------------------------------------------
# candidate GT grasps

def _canon_y(y):
    """Reference y-flip canonicalization (get_regiondataset.py:160-169)."""
    y = np.asarray(y, np.float64)
    if y[0] < 0 or (y[0] == 0 and y[1] < 0):
        y = -y
    return y


def _frame(approach, y, base):
    z = np.cross(approach, y)
    return np.c_[approach, y, z, base].astype(np.float32)


def _box_cands(rng, cands, c, size, gripper, dense_top: bool = False):
    """Top-down + side grasp candidates for an axis-aligned box at
    center `c`.  Draw order matches the original inline branch exactly
    (origin-layout RNG stream must stay byte-stable; the dense_top
    extras are gated and draw from the stream only when enabled)."""
    depth = gripper.depth
    open_w = gripper.width - 0.005
    down = np.array([0.0, 0.0, -1.0])
    top = c[2] + size[2] / 2
    grab = min(size[2] * 0.8, 0.045)
    for ax in (0, 1):
        if size[ax] < open_w:
            y = np.zeros(3)
            y[ax] = 1.0
            offs = (0.0,) if not dense_top else (0.0, -0.22, 0.22)
            for off in offs:
                jitter = rng.uniform(-0.1, 0.1) + off
                yj = _canon_y(
                    [np.cos(jitter) * y[0] - np.sin(jitter) * y[1],
                     np.sin(jitter) * y[0] + np.cos(jitter) * y[1],
                     0.0])
                cands.append(_frame(
                    down, yj,
                    np.array([c[0], c[1], top + depth - grab])))
    # side grasps: approach along -u into the +-u faces, close along
    # the other horizontal axis
    for ax in (0, 1):
        other = 1 - ax
        if size[other] >= open_w:
            continue
        zg = min(c[2], TABLE_HEIGHT + size[2] - 0.012)
        zg = max(zg, TABLE_HEIGHT + gripper.half_hand_thickness + 0.004)
        if zg > c[2] + size[2] / 2 - 0.004:
            continue
        grab = min(size[ax] * 0.8, 0.045)
        for sign in (+1.0, -1.0):
            a = np.zeros(3)
            a[ax] = -sign
            y = np.zeros(3)
            y[other] = 1.0
            face = np.asarray(c, np.float64).copy()
            face[ax] += sign * size[ax] / 2
            base = np.array([face[0], face[1], zg]) - (depth - grab) * a
            cands.append(_frame(a, _canon_y(y), base))


def _cyl_cands(rng, cands, top_down, c, r, h, gripper):
    """Top-down + side grasp candidates for a vertical cylinder (draw
    order identical to the original inline branch)."""
    depth = gripper.depth
    open_w = gripper.width - 0.005
    top = c[2] + h / 2
    if 2 * r < open_w:
        top_down(top, c, min(h * 0.8, 0.045),
                 np.linspace(-np.pi / 2, np.pi / 2, 3))
        # side grasps at 4 azimuths, 1-2 heights
        zlo = TABLE_HEIGHT + gripper.half_hand_thickness + 0.004
        zhi = top - 0.008
        if zhi > zlo:
            grab = min(r + 0.02, 0.05)
            for phi in rng.uniform(0, 2 * np.pi) \
                    + np.linspace(0, 2 * np.pi, 4, endpoint=False):
                a = np.array([-np.cos(phi), -np.sin(phi), 0.0])
                y = np.array([-np.sin(phi), np.cos(phi), 0.0])
                for zg in np.linspace(zlo, zhi,
                                      2 if zhi - zlo > 0.03 else 1):
                    near = np.array([c[0] + r * np.cos(phi),
                                     c[1] + r * np.sin(phi), zg])
                    base = near - (depth - grab) * a
                    cands.append(_frame(a, _canon_y(y), base))


def _candidate_grasps(rng, objs, gripper: GripperConfig,
                      dense_top: bool = False):
    """Analytic grasp proposals; validated geometrically afterwards.

    ``dense_top`` (gated on gt_robust so the frozen-suite fingerprints
    stay byte-stable) doubles the top-down theta sampling: pose-robust
    validation thins the side-grasp pool, and the denser top-down grid
    both restores GT count and supervises the theta head across its
    range instead of at 3 canonical values."""
    depth = gripper.depth
    open_w = gripper.width - 0.005     # keep clear of the finger sweep
    down = np.array([0.0, 0.0, -1.0])
    cands = []

    def top_down(top_z, cxy, grab, thetas):
        thetas = np.asarray(thetas, np.float64)
        if dense_top and len(thetas) > 1:
            mid = (thetas[:-1] + thetas[1:]) / 2.0
            thetas = np.sort(np.concatenate([thetas, mid]))
        base = np.array([cxy[0], cxy[1], top_z + depth - grab])
        for t in thetas:
            y = _canon_y([np.cos(t), np.sin(t), 0.0])
            cands.append(_frame(down, y, base))

    for obj in objs:
        c = obj["center"]
        if obj["kind"] == "sphere":
            r = obj["radius"]
            if 2 * r < open_w:
                top_down(c[2] + r, c, min(1.6 * r, 0.045),
                         np.linspace(-np.pi / 2, np.pi / 2, 5))
        elif obj["kind"] == "box":
            _box_cands(rng, cands, c, obj["size"], gripper,
                       dense_top=dense_top)
        elif obj["kind"] == "ellipsoid":
            a, b, cv = obj["axes"]
            if 2 * min(a, b) < open_w:
                # close across the minor horizontal axis
                theta0 = 0.0 if a <= b else np.pi / 2
                top_down(c[2] + cv, c, min(1.2 * cv, 0.04),
                         theta0 + np.linspace(-0.4, 0.4, 3))
        elif obj["kind"] in ("lbox", "mug"):
            for part in obj["parts"]:
                pc = np.asarray(c, np.float64) + part["offset"]
                if part["shape"] == "box":
                    _box_cands(rng, cands, pc, part["size"],
                               gripper, dense_top=dense_top)
                else:
                    _cyl_cands(rng, cands, top_down, pc, part["radius"],
                               part["height"], gripper)
        else:   # cylinder
            _cyl_cands(rng, cands, top_down, c, obj["radius"],
                       obj["height"], gripper)
    return cands


# --------------------------------------------------------------------------
# generation-time geometric validation (numpy restatement of
# eval/collision.py's masks; same EvalConfig / GripperConfig constants)

def _validate_grasps(frames, scene_pts, scene_normals, view_pts,
                     gripper: GripperConfig, ecfg: EvalConfig):
    """Return (keep_mask, antipodal_score) for candidate frames [K,3,4]."""
    keep = np.zeros(len(frames), bool)
    anti = np.zeros(len(frames), np.float32)
    hw = gripper.hand_half_bottom_width
    hs = gripper.hand_half_bottom_space
    depth = gripper.depth

    for i, fr in enumerate(frames):
        axes, base = fr[:, :3], fr[:, 3]
        tip_z = base[2] + axes[2, 0] * depth
        if tip_z < TABLE_HEIGHT - ecfg.table_offset:
            continue

        local = (scene_pts - base) @ axes            # [N, 3] gripper frame
        x, y, z = local[:, 0], local[:, 1], local[:, 2]
        close_plane = (x > -gripper.bottom_length) & (x < depth)
        slab = np.abs(z) < gripper.half_hand_thickness
        back = close_plane & slab & (np.abs(y) < hw) & (x < 0)
        finger = close_plane & slab & (np.abs(y) > hs) & (np.abs(y) < hw)
        close_region = close_plane & slab & (np.abs(y) < hs)
        if (back.sum() > ecfg.back_collision_threshold
                or finger.sum() > ecfg.finger_collision_threshold
                or close_plane.sum() < ecfg.num_points_threshold
                or close_region.sum() < ecfg.close_region_min_points):
            continue

        # the closing region must be (mostly) visible in the view cloud
        vlocal = (view_pts - base) @ axes
        v_close = ((vlocal[:, 0] > -gripper.bottom_length)
                   & (vlocal[:, 0] < depth)
                   & (np.abs(vlocal[:, 2]) < gripper.half_hand_thickness)
                   & (np.abs(vlocal[:, 1]) < hs))
        if v_close.sum() < ecfg.close_region_min_points:
            continue

        # antipodal score (evaluation_data_generator.py:397-418)
        yc = y[close_region]
        ny = np.abs((scene_normals[close_region] @ axes)[:, 1])
        nsd = min((yc.max() - yc.min()) / 3.0, ecfg.neighbor_depth)
        left = yc > yc.max() - nsd
        right = yc < yc.min() + nsd
        if not left.any() or not right.any():
            continue
        score = float(ny[left].mean() * ny[right].mean())
        if score < 0.3:
            continue
        keep[i] = True
        anti[i] = score
    return keep, anti


def _validate_grasps_robust(frames, scene_pts, scene_normals, view_pts,
                            gripper: GripperConfig, ecfg: EvalConfig,
                            jitters: int, rng,
                            sigma_t: float = 0.006,
                            sigma_r: float = 0.12,
                            min_pass: float = 0.75):
    """Pose-robust GT labeling (round 5): a candidate keeps its label
    only if the nominal pose AND >= ``min_pass`` of ``jitters`` randomly
    perturbed poses (translation sigma ``sigma_t`` m, rotation sigma
    ``sigma_r`` rad about a random axis) pass the full collision /
    closing-region test.

    Why: the committed real Kinect clouds showed the served model
    collapsing to the *marginal* part of the GT distribution — side
    grasps whose back hand skims the table pass the exact collision test
    in analytic scenes but fail under the pose/geometry noise of real
    sensors (docs/evidence/real_data_r5.json: back_ok 5/4000).  Real
    grasp datasets label robustness, not tangency (the reference's GT
    comes from physics-checked labels); inflating the test with pose
    jitter recovers that property without touching the evaluator.
    The jitter RNG stream is independent of the scene stream, so
    enabling this does not disturb layout/point draws."""
    keep, anti = _validate_grasps(frames, scene_pts, scene_normals,
                                  view_pts, gripper, ecfg)
    if not keep.any() or jitters <= 0:
        return keep, anti
    votes = np.zeros(len(frames), np.int32)
    live = np.flatnonzero(keep)
    for _ in range(jitters):
        jf = frames.copy()
        for i in live:
            axis = rng.randn(3)
            axis /= max(np.linalg.norm(axis), 1e-9)
            ang = rng.randn() * sigma_r
            kx, ky, kz = axis
            kcross = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
            rot = (np.eye(3) + np.sin(ang) * kcross
                   + (1 - np.cos(ang)) * (kcross @ kcross))
            jf[i, :, :3] = rot @ frames[i, :, :3]
            jf[i, :, 3] = frames[i, :, 3] + rng.randn(3) * sigma_t
        jk, _ = _validate_grasps(jf[live], scene_pts, scene_normals,
                                 view_pts, gripper, ecfg)
        votes[live] += jk.astype(np.int32)
    robust = votes >= int(np.ceil(min_pass * jitters))
    return keep & robust, anti


# --------------------------------------------------------------------------
# visibility (angular z-buffer from the camera)

def _visible_mask(points, cam, bins=768, tol=0.01):
    """Keep points within `tol` of the nearest return in their angular bin."""
    d = points - cam
    r = np.linalg.norm(d, axis=1)
    az = np.arctan2(d[:, 1], d[:, 0])
    el = np.arcsin(np.clip(d[:, 2] / np.maximum(r, 1e-9), -1, 1))

    def to_bin(v):
        lo, hi = v.min(), v.max() + 1e-9
        return np.minimum(((v - lo) / (hi - lo) * bins).astype(np.int64),
                          bins - 1)
    cell = to_bin(az) * bins + to_bin(el)
    nearest = np.full(bins * bins, np.inf)
    np.minimum.at(nearest, cell, r)
    return r <= nearest[cell] + tol


# --------------------------------------------------------------------------

def make_synthetic_scene(seed: int, num_view: int = 12000,
                         num_objects: int | None = None,
                         scene_multiple: int = 4,
                         view_index: int | None = None,
                         color_mode: str = "iid",
                         layout: str = "origin",
                         obj_frac: float | None = None,
                         table_extent=None,
                         table_z: float | None = None,
                         xy_offset=None,
                         yaw: float | None = None,
                         floor_frac: float | None = None,
                         floor_drop: float | None = None,
                         distractors: int | None = None,
                         gt_robust: int = 0) -> dict:
    """Build one scene dict in the reference pickle schema.

    color_mode:
      * "iid" — per-point uniform random rgb (the v1 suite / r1-r3
        training distribution; kept so the v1 fingerprints stay valid).
      * "coherent" — one base color per object / the table + per-point
        texture noise + a per-scene lighting level.  Real clouds are
        spatially coherent and brighter than iid-uniform; a score head
        trained on iid colors collapses to a constant on the reference's
        committed real Kinect clouds (+0.23 global brightness alone is
        enough — docs/evidence/real_data_r4.json diagnosis), so training
        data uses this mode from round 4 on.

    layout (round 5 — the real-data layout gap):
      * "origin" — the r1-r4 distribution: table plane exactly at
        z=0.75 spanning ±0.35 centered on the origin, ~50% of view
        points on objects, no floor.  Byte-identical to earlier rounds
        for default kwargs (the frozen-suite fingerprints pin it).
      * "randomized" — matches the committed real Kinect clouds and the
        reference's own virtual scenes, which this distribution was far
        from: real/reference clouds are 82-94% TABLE points (ours ~50%),
        tables sit at z 0.49-0.76 (ours: exactly 0.75), workspaces are
        offset from the origin by up to half a meter (test.py:114-118
        crops to x[-0.4,0.26] y[0.2,0.65]; ours: centered), and real
        scenes carry below-table background returns (5% of 0000_cloud)
        plus ungraspable objects.  PointNet++ consumes ABSOLUTE xyz, so
        none of that is invariant.  Draws per-scene: object point share
        U[0.08,0.45], table half-extents U[0.30,0.55]², table z
        U[0.45,0.80], workspace offset U[-0.35,0.35]², yaw U[0,2π),
        floor points at table-U[0.25,0.9] for 50% of scenes, 0-2
        distractor objects.  Geometry/GT are generated in the canonical
        origin frame (validation math untouched) then rigid-transformed;
        the scene dict gains a "table_height" key consumed by the
        trainer's evaluator.

    Explicit layout kwargs (obj_frac, table_extent, table_z, xy_offset,
    yaw, floor_frac, floor_drop, distractors) override the draw — used
    by tools/probe_layout.py for single-factor attribution.
    """
    rng = np.random.RandomState(seed)
    if num_objects is None:
        num_objects = rng.randint(4, 8)
    if view_index is None:
        view_index = seed % len(_CAMERA_POSE)
    cam = _CAMERA_POSE[view_index]
    gripper, ecfg = GripperConfig(), EvalConfig()

    if layout == "randomized":
        draw = {
            "obj_frac": float(rng.uniform(0.08, 0.55)),
            "table_extent": rng.uniform(0.30, 0.55, 2),
            "table_z": float(rng.uniform(0.45, 0.80)),
            "xy_offset": rng.uniform(-0.35, 0.35, 2),
            "yaw": float(rng.uniform(0.0, 2 * np.pi)),
            "floor_frac": (float(rng.uniform(0.02, 0.08))
                           if rng.rand() < 0.5 else 0.0),
            "floor_drop": float(rng.uniform(0.25, 0.9)),
            "distractors": int(rng.randint(0, 3)),
        }
    else:
        draw = {}
    if obj_frac is None:
        obj_frac = draw.get("obj_frac", 0.6)
    if table_extent is None:
        table_extent = draw.get("table_extent", (0.35, 0.35))
    if table_z is None:
        table_z = draw.get("table_z", TABLE_HEIGHT)
    if xy_offset is None:
        xy_offset = draw.get("xy_offset", (0.0, 0.0))
    if yaw is None:
        yaw = draw.get("yaw", 0.0)
    if floor_frac is None:
        floor_frac = draw.get("floor_frac", 0.0)
    if floor_drop is None:
        floor_drop = draw.get("floor_drop", 0.45)
    if distractors is None:
        distractors = draw.get("distractors", 0)
    ext_x, ext_y = float(table_extent[0]), float(table_extent[1])
    n_floor = int(num_view * floor_frac)

    shape_lib = "rich" if layout == "randomized" else "basic"

    # rich scenes get two extra attempts that fall back to the basic
    # library (composites cull more candidates; a scene must still end
    # with >= 4 valid GT grasps)
    attempts = 6 if shape_lib == "rich" else 4
    for attempt in range(attempts):
        lib = shape_lib if attempt < 4 else "basic"
        objs = _place_objects(rng, max(num_objects - attempt, 2),
                              distractors=distractors if attempt < 4
                              else 0,
                              shape_lib=lib)

        # dense surface samples (2x the view budget; occlusion culls ~40%)
        n_raw = num_view * 2
        n_obj_total = int(n_raw * obj_frac)
        if distractors or layout == "randomized":
            # allocate per-object points ~ surface area (a 20 cm
            # distractor box must not be sampled as sparsely as a 3 cm
            # sphere); the origin layout keeps the legacy equal split so
            # the frozen-suite fingerprints stay valid
            areas = np.array([_object_area(o) for o in objs])
            shares = np.maximum((areas / areas.sum()) * n_obj_total, 32)
            n_obj_pts_list = shares.astype(int)
        else:
            n_obj_pts_list = np.full(len(objs),
                                     n_obj_total // len(objs))
        pts_list, nrm_list, lbl_list = [], [], []
        for i, obj in enumerate(objs):
            p, nv = _object_points(rng, obj, int(n_obj_pts_list[i]))
            pts_list.append(p)
            nrm_list.append(nv)
            lbl_list.append(np.full(len(p), i + 1))
        n_table = n_raw - sum(len(p) for p in pts_list)
        if (ext_x, ext_y) == (0.35, 0.35):
            # legacy call kept bit-exact for the frozen-suite fingerprints
            table_xy = rng.uniform(-0.35, 0.35, (n_table, 2))
        else:
            table_xy = rng.uniform(0.0, 1.0, (n_table, 2)) \
                * np.array([2 * ext_x, 2 * ext_y]) \
                - np.array([ext_x, ext_y])
        table = np.c_[table_xy, np.full(n_table, TABLE_HEIGHT)]
        pts_list.append(table)
        nrm_list.append(np.tile([0.0, 0.0, 1.0], (n_table, 1)))
        lbl_list.append(np.zeros(n_table))

        all_pts = np.concatenate(pts_list).astype(np.float32)
        all_nrm = np.concatenate(nrm_list).astype(np.float32)
        all_lbl = np.concatenate(lbl_list).astype(np.float32)

        vis = _visible_mask(all_pts, cam)
        sel = np.flatnonzero(vis)
        n_sel = num_view - n_floor
        if layout == "randomized":
            # Kinect-like return density: returns per unit surface area
            # scale as cos(incidence)/range^2 — real clouds are dense on
            # near, camera-facing surfaces and sparse at grazing angles,
            # while raw surface samples are uniform.  The score net
            # consumes local neighborhoods, so the density pattern is
            # part of the input distribution.
            d = all_pts[sel] - cam
            r2 = (d ** 2).sum(1)
            ray = d / np.sqrt(np.maximum(r2, 1e-12))[:, None]
            cos_inc = np.abs((ray * all_nrm[sel]).sum(1))
            w = np.maximum(cos_inc, 0.15) / np.maximum(r2, 1e-6)
            p = w / w.sum()
            sel = rng.choice(sel, n_sel, replace=len(sel) < n_sel, p=p)
        else:
            sel = rng.choice(sel, n_sel, replace=len(sel) < n_sel)
        view, view_nrm = all_pts[sel], all_nrm[sel]
        label = all_lbl[sel]

        frames = _candidate_grasps(rng, objs, gripper,
                                   dense_top=gt_robust > 0)
        if frames:
            frames = np.stack(frames)
            if gt_robust:
                # independent jitter stream: enabling robustness must
                # not shift the scene/layout RNG draws
                jrng = np.random.RandomState((seed * 1000003 + attempt)
                                             & 0x7FFFFFFF)
                keep, anti = _validate_grasps_robust(
                    frames, all_pts, all_nrm, view, gripper, ecfg,
                    jitters=gt_robust, rng=jrng)
            else:
                keep, anti = _validate_grasps(
                    frames, all_pts, all_nrm, view, gripper, ecfg)
            frames, anti = frames[keep], anti[keep]
        else:
            frames = np.zeros((0, 3, 4), np.float32)
            anti = np.zeros(0, np.float32)
        if len(frames) >= 4:
            break
        # over-cluttered scene: retry with fewer objects

    # below-table background returns (floor / clutter beyond the table
    # edge — 5% of the reference's real 0000_cloud sits 0.85 m below the
    # table plane); label 0, graspability 0
    if n_floor:
        fxy = np.empty((0, 2))
        while len(fxy) < n_floor:
            cand = rng.uniform(-1.0, 1.0, (n_floor * 3, 2)) \
                * np.array([ext_x + 0.35, ext_y + 0.35])
            outside = (np.abs(cand[:, 0]) > ext_x * 0.9) \
                | (np.abs(cand[:, 1]) > ext_y * 0.9)
            fxy = np.concatenate([fxy, cand[outside]])
        fxy = fxy[:n_floor]
        fz = TABLE_HEIGHT - floor_drop + rng.randn(n_floor) * 0.01
        floor_pts = np.c_[fxy, fz].astype(np.float32)
        view = np.concatenate([view, floor_pts])
        view_nrm = np.concatenate(
            [view_nrm, np.tile([0.0, 0.0, 1.0], (n_floor, 1))])
        label = np.concatenate([label, np.zeros(n_floor, np.float32)])

    # graspability: falloff to the nearest GT closing-region centroid
    # (raw range [0, 2]; the dataset applies tanh like scoredataset.py:80)
    if len(frames):
        # centroid = base + approach * (depth - grab/2) ~ base + 0.75*depth
        cc = frames[:, :, 3] + frames[:, :, 0] * (0.75 * gripper.depth)
        d2 = ((view[:, None, :] - cc[None, :, :]) ** 2).sum(-1).min(1)
        score = 2.0 * np.exp(-d2 / (2 * 0.02 ** 2))
        score = np.where(label > 0, score, 0.0).astype(np.float32)
    else:
        score = np.zeros(num_view, np.float32)
    if color_mode == "coherent":
        if layout == "randomized":
            # real indoor surfaces are bright and weakly saturated (the
            # committed Kinect clouds: channel means 0.71-0.82 with
            # near-equal r/g/b); uniform-random rgb base colors are far
            # more saturated than anything the sensor sees.  Draw
            # value/saturation explicitly: base = v*(1-s) + s*hue.
            n_base = int(label.max()) + 1
            v = rng.uniform(0.25, 1.0, (n_base, 1)).astype(np.float32)
            s = rng.uniform(0.1, 0.8, (n_base, 1)).astype(np.float32)
            hue = rng.rand(n_base, 3).astype(np.float32)
            base = v * ((1 - s) + s * hue)
        else:
            base = rng.rand(int(label.max()) + 1, 3).astype(np.float32)
        color = base[label.astype(np.int64)]
        color = color + rng.randn(num_view, 3).astype(np.float32) * 0.06
        light = np.float32(rng.uniform(-0.15, 0.35))
        color = color + light
        color = np.clip(color, 0.0, 1.0)
        if n_floor:
            fb = rng.rand(3).astype(np.float32)
            color[-n_floor:] = np.clip(
                fb + rng.randn(n_floor, 3).astype(np.float32) * 0.06
                + light, 0.0, 1.0)
    else:
        color = rng.rand(num_view, 3).astype(np.float32)

    n_scene = num_view * scene_multiple
    idx = np.random.RandomState(seed + 1).randint(0, len(all_pts), n_scene)
    scene = all_pts[idx] + rng.randn(n_scene, 3).astype(np.float32) * 1e-4
    normal = all_nrm[idx]    # exact analytic surface normals

    # rigid re-staging: rotate about z then translate; generated in the
    # canonical origin frame so the GT validation math above is
    # layout-independent
    if yaw != 0.0 or tuple(xy_offset) != (0.0, 0.0) \
            or table_z != TABLE_HEIGHT:
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]],
                      np.float32)
        t = np.float32([xy_offset[0], xy_offset[1],
                        table_z - TABLE_HEIGHT])
        view = view @ Rz.T + t
        scene = scene @ Rz.T + t
        normal = normal @ Rz.T
        if len(frames):
            frames = np.einsum("ij,kjl->kil", Rz, frames)
            frames[:, :, 3] += t

    return {
        "table_height": float(table_z),
        "view_cloud": view,
        "view_cloud_color": color,
        "view_cloud_score": score,
        "view_cloud_label": label,
        "select_frame": frames.astype(np.float32),
        "select_antipodal_score": anti,
        "select_center_score": anti,
        "select_vertical_score": anti,
        "select_frame_label": np.ones(len(frames), np.float32),
        "scene_cloud": scene,
        "scene_normal": normal,
    }


def write_synthetic_dataset(path: str, num_scenes: int = 8,
                            num_view: int = 12000, seed: int = 0,
                            color_mode: str = "coherent",
                            layout: str = "origin",
                            gt_robust: int = 0) -> list:
    """Write `num_scenes` scene pickles named like the reference data
    (``{scene}_view_{view}.p``) under ``path/training_data``.

    Training data defaults to coherent colors (make_synthetic_scene
    docstring — iid-uniform colors train a color-brittle score head).
    Round-5 training data uses ``layout="randomized"`` (see
    make_synthetic_scene — the origin layout is half a meter and a
    50-percentage-point table fraction away from the real clouds)."""
    out_dir = os.path.join(path, "training_data")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(num_scenes):
        view_index = i % len(_CAMERA_POSE)
        scene = make_synthetic_scene(seed + i, num_view=num_view,
                                     view_index=view_index,
                                     color_mode=color_mode,
                                     layout=layout,
                                     gt_robust=gt_robust)
        p = os.path.join(out_dir, f"{i:04d}_view_{view_index}.p")
        with open(p, "wb") as f:
            pickle.dump(scene, f)
        paths.append(p)
    return paths
