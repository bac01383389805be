"""Where one inference forward spends its time on the card.

    python -m regnet_for_3d_grasping_torch.cli.profile [--clouds 3]

Runs the inference preset (25,600 points, 4,000 centers, the trained
weights) on synthetic tabletop clouds, two warm-up forwards first, then
traces the next `--clouds` forwards with ``torch.profiler`` and prints:
the host-clock latency of each forward, the device time per forward of
the ten costliest kernels by name, and the device busy share (summed
kernel time over wall time; overlapping kernels would count twice).
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
    args = p.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from regnet_for_3d_grasping_torch.config import infer_config
    from regnet_for_3d_grasping_torch.models.regnet import build_regnet
    from regnet_for_3d_grasping_torch.utils.scene import tabletop_cloud

    model = build_regnet(infer_config(), args.weights, "cuda")
    gen = torch.Generator().manual_seed(0)
    clouds = []
    for i in range(args.clouds + 2):
        xyz, rgb = tabletop_cloud(np.random.RandomState(200 + i), 25600)
        clouds.append(torch.tensor(np.c_[xyz, rgb], dtype=torch.float32,
                                   device="cuda")[None])
    for pc in clouds[:2]:
        model(pc, generator=gen)
    torch.cuda.synchronize()

    lat = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_all = time.perf_counter()
        for pc in clouds[2:]:
            t0 = time.perf_counter()
            model(pc, generator=gen)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        wall = (time.perf_counter() - t_all) * 1e3
    n = args.clouds
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"forward latency (host clock, profiler on) ms: "
          f"{[round(x, 3) for x in lat]}")
    print(f"device busy {busy / n:.3f} ms per forward of {wall / n:.3f} ms "
          f"wall: busy share {busy / wall:.3f}")
    print("top kernels, device ms per forward:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} "
              f"x{e.count // n:<5d} {e.key[:90]}")


if __name__ == "__main__":
    main()
