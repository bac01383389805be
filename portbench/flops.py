"""The dense layers' multiply-adds of one REGNet forward, from a
configuration file's own numbers (the arithmetic of the repository's
``tools/flops.py``, which reads the JAX package's configuration, rewritten
over the benchmark's configuration dict).

Counted: every Dense (the 1x1 convolutions of the backbone's SA and FP
MLPs, the seg head, the proposal and refine heads), as ``in x out`` MACs a
row; not counted: geometry, selection, BatchNorm, pools.  A training step
is three times its forward (forward, and the backward's two products).
"""

from __future__ import annotations

import dataclasses


def _mlp(c: int, chans) -> int:
    macs = 0
    for ch in chans:
        macs += c * ch
        c = ch
    return macs


def backbone_macs(cfg: dict) -> dict:
    """Per cloud: {layer: MACs} of the SA layers, the FP layers and the seg
    head (with its one-channel score layer)."""
    m, n = cfg["model"], cfg["region"]["num_points"]
    out = {}
    cin = m["input_channels"] - 3
    for i, (s, k, chans) in enumerate(zip(m["num_centroids"],
                                          m["num_neighbours"],
                                          m["sa_channels"])):
        out[f"sa{i + 1}"] = s * k * _mlp(cin + 3, chans)
        cin = chans[-1]
    sa_out = [m["input_channels"] - 3] + [c[-1] for c in m["sa_channels"]]
    dense_ns = [n] + list(m["num_centroids"])
    sparse_c = sa_out[-1]
    for i, chans in enumerate(m["fp_channels"]):
        out[f"fp{i + 1}"] = dense_ns[-2 - i] * _mlp(sparse_c + sa_out[-2 - i],
                                                    chans)
        sparse_c = chans[-1]
    out["seg_head"] = n * (_mlp(sparse_c, m["seg_channels"])
                           + m["seg_channels"][-1])
    return out


def head_macs(cfg: dict) -> dict:
    """Per cloud: {head: MACs} of the proposal (GRN) head over the centers
    and the refine head over their closing regions (one refine round)."""
    m, r = cfg["model"], cfg["region"]
    A, R, C = m["num_anchors"], m["reg_channels"], m["feature_channels"]
    grn = (C * 1024 + 1024 * 256 + 256 * 128 + 128 * A
           + 1024 * 256 + 256 * 128 + 128 * A * R)
    ref = ((C + m["refine_group_channels"]) * 1024 + 1024 * 128 + 128 * 2
           + 1024 * 128 + 128 * R)
    return {"grn_head": r["center_num"] * grn,
            "refine_head": r["center_num"] * ref * max(r["refine_iters"], 1)}


def forward_macs(cfg: dict) -> int:
    """One cloud's forward."""
    return sum(backbone_macs(cfg).values()) + sum(head_macs(cfg).values())


def step_flops(cfg, clouds: int, train: bool) -> float:
    """FLOPs (2 a MAC) of a forward over `clouds` clouds, three times that
    for a training step; `cfg` a configuration dict or dataclass."""
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    return 2.0 * forward_macs(cfg) * clouds * (3 if train else 1)
