"""Where one inference forward spends its time on the card.

    python -m regnet_for_3d_grasping_torch.cli.profile [--clouds 3]
        [--slab-cell 0.04 --fps-groups 8]

Runs the inference preset (25,600 points, 4,000 centers, the trained
weights; with the two flags, the sorted-slab serving configuration) on
synthetic tabletop clouds, two warm-up forwards first, then runs the
next `--clouds` forwards untraced and once more under ``torch.profiler``,
and prints: the host-clock latency of each forward both ways, the device
busy share (summed kernel time over wall time, against the traced and the
untraced forwards; overlapping kernels would count twice), the
device-to-host copies per forward (in slab mode one of them is the read of
the 3-NN certificate), the forwards that fell back to the full-scan 3-NN,
and the device time per forward of the ten costliest kernels and of every
kernel of ``csrc/``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

WEIGHTS = Path(__file__).resolve().parents[2] / "weights" / "r5_real_e100.npz"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clouds", type=int, default=3)
    p.add_argument("--weights", default=str(WEIGHTS))
    p.add_argument("--slab-cell", type=float, default=0.0)
    p.add_argument("--fps-groups", type=int, default=1)
    args = p.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud

    from regnet_for_3d_grasping_torch.ops import _cuda

    cfg = infer_config(**{"region.slab_cell": args.slab_cell,
                          "model.fps_groups": args.fps_groups,
                          "region.center_fps_groups": args.fps_groups})
    model = build_regnet(cfg, args.weights, "cuda")
    gen = torch.Generator().manual_seed(0)
    clouds = []
    for i in range(args.clouds + 2):
        # the scene's objects round their share of the points: make a few
        # more and keep exactly 25,600, as the infer CLI resamples a cloud
        rng = np.random.RandomState(200 + i)
        xyz, rgb = tabletop_cloud(rng, 25600 + 64)
        keep = rng.choice(len(xyz), 25600, replace=False)
        clouds.append(torch.tensor(np.c_[xyz, rgb][keep], dtype=torch.float32,
                                   device="cuda")[None])
    for pc in clouds[:2]:
        model(pc, generator=gen)
    torch.cuda.synchronize()

    def serve() -> list:
        lat = []
        for pc in clouds[2:]:
            t0 = time.perf_counter()
            model(pc, generator=gen)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return lat

    untraced = serve()
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_all = time.perf_counter()
        lat = serve()
        wall = (time.perf_counter() - t_all) * 1e3
    n = args.clouds
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"forward latency (host clock) ms: profiler off "
          f"{[round(x, 3) for x in untraced]}, profiler on "
          f"{[round(x, 3) for x in lat]}")
    print(f"device busy {busy / n:.3f} ms per forward of {wall / n:.3f} ms "
          f"wall: busy share {busy / wall:.3f} with the profiler on, "
          f"{busy / sum(untraced):.3f} of the untraced forwards")
    d2h = [e for e in prof.key_averages() if "Memcpy DtoH" in e.key]
    print(f"device-to-host copies per forward: "
          f"{sum(e.count for e in d2h) / n:.1f}, "
          f"{sum(e.self_device_time_total for e in d2h) / 1e3 / n:.3f} ms; "
          f"3-NN fallbacks: {_cuda.fallbacks['fp3_slab']} of {n} forwards; "
          f"launches per forward: "
          f"{ {k: v // n for k, v in _cuda.launches.items() if v} }")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    # the kernels of csrc/ live in anonymous namespaces at global scope
    # (so do a few of PyTorch's, which name at:: in their arguments)
    own = [e for e in kernels if e.key.removeprefix("void ").startswith(
        "(anonymous namespace)::") and "at::" not in e.key]
    for title, rows in (("top kernels", kernels[:10]),
                        ("the port's own kernels", own)):
        print(f"{title}, device ms per forward:")
        for e in rows:
            print(f"  {e.self_device_time_total / 1e3 / n:9.3f} "
                  f"x{e.count // n:<5d} {e.key[:90]}")
    own_ms = sum(e.self_device_time_total for e in own) / 1e3 / n
    print(f"the port's own kernels {own_ms:.3f} ms, library and elementwise "
          f"kernels {busy / n - own_ms:.3f} ms per forward, "
          f"{sum(e.count for e in kernels) // n} kernel launches per forward")


if __name__ == "__main__":
    main()
