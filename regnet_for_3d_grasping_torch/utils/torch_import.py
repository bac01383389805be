"""Import reference PyTorch checkpoints into the port (JAX
``utils/torch_import.py``).

The reference distributes whole-module ``torch.save`` checkpoints
(``score_{N}.model`` / ``region_{N}.model``).  Their state_dicts map onto
the port's module names block for block: a 1x1 conv weight [Cout, Cin,
1(,1)] becomes the Dense weight [Cout, Cin] (PyTorch's layout: no
transpose), a BatchNorm's weight, bias and running statistics the port
BatchNorm's.  Conv biases are not imported: every reference conv with one
feeds a BatchNorm, which absorbs it.  The reference's unused heads have
no counterpart and are skipped.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# the port's ConvBN block -> the reference's (conv, bn) prefix, per model
_SCORE_MAP = {}
for _i in range(3):          # SA modules (pointnet2.py:53-62)
    for _j in range(3):
        _SCORE_MAP[f"backbone.sa{_i}.mlp.layer{_j}"] = \
            f"extrat_featurePN2.sa_modules.{_i}.mlp.{_j}"
for _i, _n in enumerate((2, 2, 3)):    # FP modules (pointnet2.py:67-74)
    for _j in range(_n):
        _SCORE_MAP[f"backbone.fp{_i}.mlp.layer{_j}"] = \
            f"extrat_featurePN2.fp_modules.{_i}.mlp.{_j}"
for _j in range(4):          # the seg head's SharedMLP (pointnet2.py:78)
    _SCORE_MAP[f"backbone.seg_mlp.layer{_j}"] = f"extrat_featurePN2.mlp.{_j}"

_REGION_MAP = {              # PointNet2TwoStage (pointnet2.py:123-197)
    "grn_head.stem": ("extrat_feature_region.conv",
                      "extrat_feature_region.bn"),
    "grn_head.cls1": ("extrat_feature_region.conv_cls2",
                      "extrat_feature_region.bn_cls2"),
    "grn_head.cls2": ("extrat_feature_region.conv_cls3",
                      "extrat_feature_region.bn_cls3"),
    "grn_head.cls3": ("extrat_feature_region.conv_cls4",
                      "extrat_feature_region.bn_cls4"),
    "grn_head.reg1": ("extrat_feature_region.conv_reg2",
                      "extrat_feature_region.bn_reg2"),
    "grn_head.reg2": ("extrat_feature_region.conv_reg3",
                      "extrat_feature_region.bn_reg3"),
    "grn_head.reg3": ("extrat_feature_region.conv_reg4",
                      "extrat_feature_region.bn_reg4"),
    # PointNet2Refine (pointnet2.py:199-254)
    "refine_head.stem": ("extrat_feature_refine.conv_formal",
                         "extrat_feature_refine.bn_formal"),
    "refine_head.cls1": ("extrat_feature_refine.conv_formal_cls2",
                         "extrat_feature_refine.bn_formal_cls2"),
    "refine_head.cls2": ("extrat_feature_refine.conv_formal_cls3",
                         "extrat_feature_refine.bn_formal_cls3"),
    "refine_head.reg1": ("extrat_feature_refine.conv_formal_reg2",
                         "extrat_feature_refine.bn_formal_reg2"),
    "refine_head.reg2": ("extrat_feature_refine.conv_formal_reg3",
                         "extrat_feature_refine.bn_formal_reg3"),
}


def block_map() -> Dict[str, Tuple[str | None, str | None]]:
    """{the port's block name: (reference conv prefix, reference bn
    prefix)}; the score layer's Dense and BatchNorm are bare."""
    out = {f"score_net.{ours}": (f"{ref}.conv", f"{ref}.bn")
           for ours, ref in _SCORE_MAP.items()}
    out["score_net.backbone.score_dense"] = (
        "extrat_featurePN2.conv_score", None)          # pointnet2.py:82-83
    out["score_net.backbone.score_bn"] = (None, "extrat_featurePN2.bn_score")
    out.update(_REGION_MAP)
    return out


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.asarray(v))


def convert_torch_state_dicts(score_sd: dict | None, region_sd: dict | None,
                              model: torch.nn.Module) -> list:
    """Copy the reference state_dicts' values into `model` in place (a
    REGNet, or any module whose state names are REGNet's: ``score_net.``,
    ``grn_head.``, ``refine_head.``).  ``module.`` prefixes are stripped.
    Returns the port state names set; raises ValueError on a shape
    mismatch and KeyError where `model` lacks a mapped name."""
    merged = {}
    for sd in (score_sd, region_sd):
        for k, v in (sd or {}).items():
            merged[k.replace("module.", "")] = _tensor(v)
    state = model.state_dict()
    report = []

    def put(name: str, value: torch.Tensor) -> None:
        old = state[name]
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"{name}: shape {tuple(old.shape)} != "
                             f"{tuple(value.shape)}")
        with torch.no_grad():
            old.copy_(value.to(old.dtype))
        report.append(name)

    for ours, (conv, bn) in block_map().items():
        if conv is not None and f"{conv}.weight" in merged:
            w = merged[f"{conv}.weight"]
            put(f"{ours}.dense.weight" if bn is not None
                else f"{ours}.weight", w.reshape(w.shape[0], w.shape[1]))
        if bn is not None and f"{bn}.weight" in merged:
            at = ours if conv is None else f"{ours}.bn"
            for src, dst in (("weight", "weight"), ("bias", "bias"),
                             ("running_mean", "running_mean"),
                             ("running_var", "running_var")):
                put(f"{at}.{dst}", merged[f"{bn}.{src}"])
    return report
