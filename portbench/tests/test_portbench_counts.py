"""The FLOP counter and the roofline files on the CPU: what the benchmark
computes from shapes."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from portbench import flops, harness


@pytest.mark.parametrize("overrides", [{}, {"region.refine_iters": 2}])
def test_flop_counter_equals_the_dense_layers_of_a_forward(monkeypatch,
                                                           overrides):
    """Every F.linear of a tiny forward, counted by hand as rows x in x
    out, equals the counter's multiply-adds."""
    from regnet_for_3d_grasping_torch.config import tiny_config
    from regnet_for_3d_grasping_torch.models.regnet import REGNet
    from regnet_for_3d_grasping_torch.nn import layers
    cfg = tiny_config(**overrides)
    torch.manual_seed(0)
    model = REGNet(cfg).eval()
    macs = []
    linear = F.linear

    def counted(x, w, b=None):
        macs.append(x.numel() // x.shape[-1] * w.shape[0] * w.shape[1])
        return linear(x, w, b)
    monkeypatch.setattr(layers.F, "linear", counted)
    with torch.inference_mode():
        model(torch.rand(2, cfg.region.num_points, 6),
              generator=torch.Generator().manual_seed(1))
    assert sum(macs) == 2 * flops.forward_macs(dataclasses.asdict(cfg))


def test_flop_counter_at_the_served_configuration():
    cfg = harness.read_json(harness.BENCH / "configs" / "regnet-infer.json")
    assert flops.forward_macs(cfg) == 80_194_273_280
    assert flops.step_flops(cfg, 2, True) == 6 * 2 * 80_194_273_280


def _roof(name):
    return harness._load(harness.BENCH / "rooflines" / f"{name}.py",
                         f"test_roofline_{name}")


def test_fps_bytes_and_operations():
    fps = _roof("fps")
    xyz, dist = torch.zeros(2, 100, 3), torch.zeros(2, 100)
    out = torch.zeros(2, 10, dtype=torch.int32)
    assert fps.cost((xyz, dist, 10), {}, out) == [
        (2 * 100 * 16 + 2 * 10 * 4, 10 * 2 * 10 * 100, "float32")]
    assert fps.cost((xyz, dist, 10, 5), {}, out) == [
        (2 * 100 * 16 + 2 * 10 * 4, 10 * 2 * 10 * 20, "float32")]


def test_batch_norm_bytes():
    bn = _roof("batch_norm")
    x = torch.zeros(6, 4, 8, dtype=torch.bfloat16)
    w = torch.ones(8)
    assert bn.cost((x, w), {}, torch.zeros_like(x)) == [
        (2 * 192 * 2, 5 * 192, "bfloat16")]
    xg = x.clone().requires_grad_()
    m = torch.zeros(6, 8, dtype=torch.bfloat16)
    assert bn.cost((xg, w), {}, m) == [
        (192 * 2 + 48 * 2 + 8 * 48, 5 * 192, "bfloat16"),
        (48 * 2 + 8 * 48 + 2 * 192 * 2, 8 * 192, "bfloat16")]


def test_pool_bytes():
    gm = _roof("gather_max")
    feature = torch.zeros(2, 50, 8)
    index = torch.zeros(2, 5, 4, dtype=torch.int32)
    out = torch.zeros(2, 5, 8)
    assert gm.cost((feature, index), {}, out) == [(80 * 4, 80, "float32")]
    fg = feature.clone().requires_grad_()
    assert gm.cost((fg, index), {}, out) == [
        (80 * 4, 80, "float32"), (80 * 4 + 80 * 4 + 800 * 4, 80, "float32")]


def test_bound_is_the_larger_of_bytes_and_operations():
    r = harness.Rooflines()
    r.calls = {"fps": [[(3.35e12, 0, "float32")]],
               "batch_norm": [[(0, 67e12 * 2, "float32")]],
               "gather_max": []}
    assert r.bound_s("fps") == pytest.approx(1.0)
    assert r.bound_s("batch_norm") == pytest.approx(2.0)
    assert r.bound_s("gather_max") == 0.0
