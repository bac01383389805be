"""Write the Orbax checkpoint fixture that the PyTorch port's reader is held
to: ``tests/data/orbax_tiny/ckpt_0/``, the JAX package's TrainState of
``tiny_config()`` after one ``score`` training step (batch 2 of synthetic
scenes, key 0), saved by its ``save_checkpoint``, and beside it
``tests/data/orbax_tiny/expected.json``: each leaf of JAX's
``restore_checkpoint(target=None)`` of that directory with its path,
dtype, shape and SHA-256 of its bytes (None leaves as ``"none": true``).

The PyTorch port reads the directory without JAX or orbax
(``regnet_for_3d_grasping_torch/utils/checkpoint.restore_orbax``); this
script needs the JAX package, orbax and tensorstore.

A REGNet TrainState cannot be made smaller than about 4 MB: the heads'
widths (1024, 256, 128) are fixed at every configuration and hold 0.9M
parameters.  A score step keeps the region group's Adam moments at zero,
which compress to almost nothing.

Usage: python tools/make_orbax_fixture.py [--out tests/data/orbax_tiny]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def leaf_records(tree) -> list:
    """[{"path", "dtype", "shape", "sha256"} or {"path", "none"}] of every
    leaf of a restored tree, in JAX's flattening order."""
    import jax

    out = []
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)[0]
    for path, leaf in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if leaf is None:
            out.append({"path": keys, "none": True})
            continue
        a = np.asarray(leaf)
        out.append({"path": keys, "dtype": str(a.dtype),
                    "shape": list(a.shape),
                    "sha256": hashlib.sha256(
                        np.ascontiguousarray(a).tobytes()).hexdigest()})
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join("tests", "data",
                                                  "orbax_tiny"))
    args = p.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from regnet_for_3d_grasping_tpu.data import (GraspDataset,
                                                 write_synthetic_dataset)
    from regnet_for_3d_grasping_tpu.models import REGNet
    from regnet_for_3d_grasping_tpu.train import trainer
    from regnet_for_3d_grasping_tpu.utils import checkpoint as ckpt
    from regnet_for_3d_grasping_tpu.utils.config import tiny_config

    cfg = tiny_config()
    with tempfile.TemporaryDirectory() as data:
        write_synthetic_dataset(data, num_scenes=4,
                                num_view=cfg.region.num_points)
        ds = GraspDataset(data, "train", num_points=cfg.region.num_points,
                          max_gt_grasps=cfg.region.max_gt_grasps)
        batch = trainer.device_batch(next(ds.batches(2, seed=0)))
    model = REGNet(cfg)
    optimizer = trainer.make_optimizer(cfg, steps_per_epoch=4)
    state = trainer.init_state(model, cfg, optimizer, batch.pc)
    step = trainer.make_train_step(model, optimizer, cfg, stage="score")
    state, _ = step(state, batch, jax.random.PRNGKey(0))

    if os.path.exists(args.out):
        shutil.rmtree(args.out)
    os.makedirs(args.out)
    ckpt.save_checkpoint(args.out, 0, state._asdict())
    restored, _ = ckpt.restore_checkpoint(args.out)
    leaves = ",\n".join(json.dumps(r) for r in leaf_records(restored))
    with open(os.path.join(args.out, "expected.json"), "w") as f:
        f.write(f'{{"epoch": 0, "leaves": [\n{leaves}]}}\n')
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(args.out) for n in names)
    print(f"wrote {args.out}: {size} bytes")


if __name__ == "__main__":
    main()
