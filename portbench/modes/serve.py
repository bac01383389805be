"""Serving: a closed loop of one client, each request `clouds` clouds of a
pool made from the seed, through the infer CLI's path without its files or
its evaluation: the upload, ``REGNet.forward`` under ``inference_mode``
with the request's own seeded generator, and ``utils/export.
extract_grasp_sets`` on the host.

Traffic parameters (the workload file's ``traffic``): ``pool_clouds``
distinct tabletop clouds of the configuration's point count, made in
set-up; ``clouds`` a request (its batch); ``warmup`` requests before the
window.  Check parameters (``check``): ``sample`` requests of the window
compared: the slowest, and the others drawn from the seed among the
first ``sample_from`` (their outputs are kept on the card through the
window); ``grasp_tol``; ``limits``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import flops, harness
from portbench.modes import Run as _Run, sub_seed
from portbench.reference import checks
from portbench.traffic.scene import tabletop_cloud


def make_pool(seed: int, count: int, points: int) -> list:
    """`count` clouds [points, 6] f32 (xyz, rgb), each from its own draw
    of the seed: the scene's objects round their share of the points, so
    a few more are made and exactly `points` kept, as the infer CLI
    resamples a cloud."""
    pool = []
    for i in range(count):
        rng = np.random.RandomState(sub_seed(seed, 1, i))
        xyz, rgb = tabletop_cloud(rng, points + 64)
        keep = rng.choice(len(xyz), points, replace=False)
        pool.append(np.ascontiguousarray(np.c_[xyz, rgb][keep], np.float32))
    return pool


class Run(_Run):
    def execute(self) -> dict:
        from regnet_for_3d_grasping_torch import config as port_config
        from regnet_for_3d_grasping_torch.utils.cache import (
            enable_compilation_cache)
        from regnet_for_3d_grasping_torch.utils.export import (
            extract_grasp_sets)
        enable_compilation_cache()
        seed, t = self.args.seed, self.traffic
        cfg = self.config(port_config)
        per = int(t["clouds"])
        self.phase("imports")
        pool = make_pool(seed, int(t["pool_clouds"]), cfg.region.num_points)
        self.phase("clouds")
        model = self.program(cfg)
        self.phase("model")

        def clouds(r):
            return [(r * per + j) % len(pool) for j in range(per)]

        # the sample's outputs are kept from the window: requests drawn
        # from the seed among the first `sample_from`, and the slowest
        rng = np.random.RandomState(sub_seed(seed, 3))
        drawn = set(rng.permutation(int(self.check["sample_from"]))[
            :int(self.check["sample"]) - 1].tolist())
        outs, latency, slowest = {}, [], {}

        def request(r, keep=True):
            gen = torch.Generator().manual_seed(sub_seed(seed, 2, r))
            t0 = time.perf_counter()
            with self.spans.span("request"):
                with self.spans.span("upload"):
                    x = torch.from_numpy(np.stack(
                        [pool[i] for i in clouds(r)])).to(self.device)
                with torch.inference_mode():
                    with self.spans.span("forward"):
                        out = model(x, generator=gen)
                with self.spans.span("extract"):
                    extract_grasp_sets(out)
            if not keep:
                return
            latency.append(time.perf_counter() - t0)
            if r in drawn:
                outs[r] = checks.served(out)
            if latency[-1] >= max(latency):
                slowest.clear()
                slowest[r] = checks.served(out)

        for w in range(int(t["warmup"])):
            request(-1 - w, keep=False)
        self.sync()
        self.phase("warm-up")
        self.spans.seconds.clear()
        setup_s = self.setup_seconds()
        win = self.measure(request, lambda n: n)
        self.read_memory()
        n = win["n"]
        end_to_end = {
            "latency_p50_ms": 1e3 * harness.quantile(latency, 0.5),
            "latency_p95_ms": 1e3 * harness.quantile(latency, 0.95),
            "clouds_per_s": n * per / win["window_s"],
            "setup_s": setup_s}
        ctx = {"mode": "serve", "spans": self.spans, "per_unit": n,
               "flops": flops.step_flops(cfg, n * per, False),
               "peak_flops": harness.PEAK_FLOPS[cfg.model.compute_dtype],
               "memory_peak": self.memory_peak}

        # the check, against the reference once the program's state is
        # freed
        kept = {**outs, **slowest}
        del model, outs, slowest
        self.free()
        t_ref = time.perf_counter()
        numbers = self.compare(kept, clouds, pool, seed)
        print(f"reference: {time.perf_counter() - t_ref!r} s",
              file=sys.stderr)
        return self.result(end_to_end, ctx,
                           checks.with_limits(numbers,
                                              self.check["limits"]),
                           attempted=n, failed=0)

    def program(self, cfg):
        """The served model: the port's `build_regnet` with the
        configuration's weights, or with `--control` the reference at the
        control precision in its place."""
        if self.args.control:
            return self.reference(self.cell["control"])
        from regnet_for_3d_grasping_torch.models.regnet import (REGNet,
                                                                build_regnet)
        weights = self.weights_path()
        if weights is None:
            build_regnet(cfg, None, "cpu")       # the entry's own checks
            return fresh_model(REGNet, cfg, self.device,
                               self.args.seed).eval()
        return build_regnet(cfg, weights, self.device)

    def weights_path(self):
        w = self.cell["config_file"].get("weights")
        if w is None or self.patch.get("fresh_weights"):
            return None
        return str(harness.ROOT / w)

    def reference(self, control=None):
        """The plain reference model on the device, at the configuration's
        precision or the `control`'s."""
        from portbench.reference.regnet_ref import config as ref_config
        from portbench.reference.regnet_ref.models.regnet import REGNet
        from portbench.reference.regnet_ref.nn import layers
        from portbench.reference.regnet_ref.weights import load_into
        layers.CONTROL = control
        cfg = self.config(ref_config)
        weights = self.weights_path()
        if weights is None:
            return fresh_model(REGNet, cfg, self.device,
                               self.args.seed).eval()
        model = REGNet(cfg)
        load_into(model, weights)
        return model.to(self.device).eval()

    def compare(self, kept, clouds, pool, seed) -> dict:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = self.reference()
        worst = {"score_gap": 0.0, "grasp_mismatch": 0.0}
        for r, prog in kept.items():
            gen = torch.Generator().manual_seed(sub_seed(seed, 2, r))
            x = torch.from_numpy(np.stack(
                [pool[i] for i in clouds(r)])).to(self.device)
            with torch.inference_mode():
                out = checks.served(ref(x, generator=gen))
            nums = checks.serving_numbers(prog, out,
                                          float(self.check["grasp_tol"]))
            for k, v in nums.items():
                worst[k] = v if v != v else max(worst[k], v)
        return worst


def fresh_model(cls, cfg, device, seed: int):
    """A model of class `cls` (the port's REGNet or the reference's) built
    without its own initialisation (on the meta device, then given empty
    storage on `device`) and filled from the seed on `device`: the Dense
    kernels in one draw from a normal clamped at two standard deviations
    with variance 1 / fan_in (the port's initial distribution, near
    enough), BatchNorm's scale 1, bias 0 and running statistics 0 and 1.
    The program and the reference take the same values by name and
    shape."""
    with torch.device("meta"):
        model = cls(cfg)
    model = model.to_empty(device=device)
    params = [p for _, p in sorted(model.named_parameters())
              if p.dim() == 2]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    total = sum(p.numel() for p in params)
    z = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    with torch.no_grad():
        for p, part in zip(params, z.split([p.numel() for p in params])):
            p.copy_(part.view_as(p) * (p.shape[1] ** -0.5))
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if t.dim() == 1:
                last = name.rsplit(".", 1)[-1]
                t.fill_(1.0 if last in ("weight", "running_var") else 0.0)
    return model
