"""Time the PyTorch port's Orbax reader against orbax's own restore, on the
host CPU, at full width: ``weights/r5_real_e100.npz`` (165 arrays,
7,086,692 f32 values) saved as an Orbax checkpoint by the JAX package's
``save_checkpoint`` in a temporary directory, then read by the JAX
package's ``restore_checkpoint(target=None)`` and by the port's
``utils/checkpoint.restore_orbax`` in turns (orbax, port, port, orbax, ...)
with the results held equal; also the port's zstd decoder alone over the
directory's zarr chunks.  Prints one JSON line of medians.

Needs the JAX package, orbax and tensorstore (the port's side needs none).

Usage: python tools/time_orbax_read.py [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from regnet_for_3d_grasping_tpu.utils import checkpoint as jckpt
    from regnet_for_3d_grasping_torch.utils import checkpoint, ocdbt, zstd

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    variables, epoch = jckpt.load_weights_npz(
        os.path.join(root, "weights", "r5_real_e100.npz"))
    zstd.build_library()
    times = {"orbax_s": [], "port_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        jckpt.save_checkpoint(tmp, epoch, variables)
        readers = {"orbax_s": lambda: jckpt.restore_checkpoint(tmp)[0],
                   "port_s": lambda: checkpoint.restore_orbax(tmp)[0]}
        for rep in range(args.reps):
            order = ("orbax_s", "port_s") if rep % 2 == 0 else \
                ("port_s", "orbax_s")
            got = {}
            for key in order:
                t0 = time.perf_counter()
                got[key] = readers[key]()
                times[key].append(time.perf_counter() - t0)
        a = jax.tree.leaves(got["orbax_s"])
        b = jax.tree.leaves(got["port_s"])
        if len(a) != len(b) or not all(
                x.dtype == y.dtype and np.array_equal(x, y)
                for x, y in zip(a, b)):
            raise SystemExit("the port's restore differs from orbax's")
        store = ocdbt.KvStore(os.path.join(tmp, f"ckpt_{epoch}"))
        frames = [store.read(k) for k in store.keys()
                  if not k.endswith(b"/.zarray")]
        decode = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = sum(len(zstd.decompress(f)) for f in frames)
            decode.append(time.perf_counter() - t0)
    print(json.dumps({
        "arrays": len(a), "values": int(sum(x.size for x in a)),
        "orbax_s": statistics.median(times["orbax_s"]),
        "port_s": statistics.median(times["port_s"]),
        "decoder_mb_s": out / statistics.median(decode) / 1e6,
        "frames": len(frames), "frame_bytes": sum(len(f) for f in frames),
        "decoded_bytes": out, "reps": args.reps, "device": "host CPU"}))


if __name__ == "__main__":
    main()
