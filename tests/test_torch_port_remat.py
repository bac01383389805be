"""``--remat`` (``model.remat_backbone``): the backbone's SA and FP layers
recomputed in the backward (`nn.layers.remat`), on the CPU.  A training
step with it gives the same loss, the same gradients and the same
BatchNorm running statistics as the step without it, bit for bit (the
recompute runs the same ops on the same inputs; the sampling and
neighbour indices are kept from the forward, and BatchNorm updates its
statistics once, as flax's remat never writes them in the backward)."""

import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_torch.cli import train as train_cli
from regnet_for_3d_grasping_torch.config import tiny_config
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.nn import layers
from regnet_for_3d_grasping_torch.train import trainer

from test_torch_port_model import tiny_cloud


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's threaded CPU reductions (BatchNorm's sums, the weight
    gradients) are not reproducible from run to run at more than one
    thread, with remat or without; on one thread two steps are."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def step(remat, over, seed=5):
    """One training step at tiny_config -> (model, loss, gradients)."""
    cfg = tiny_config(**over, **{"model.remat_backbone": remat})
    torch.manual_seed(0)
    model = REGNet(cfg).train()
    pc = torch.from_numpy(tiny_cloud(B=2, extent=0.12))
    out = model(pc, generator=torch.Generator().manual_seed(seed),
                dropout_generator=torch.Generator().manual_seed(seed))
    loss = (out.score.square().mean() + out.cls_logits.float().mean()
            + out.reg.float().square().mean()
            + out.refine_logits.float().mean())
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return model, loss.detach(), grads


@pytest.mark.parametrize("over", [
    {}, {"region.slab_cell": 0.04, "model.fps_groups": 2},
    {"model.compute_dtype": "bfloat16"}], ids=["full", "slab", "bf16"])
def test_remat_step_equals_the_step_without(over, monkeypatch):
    recomputed = []

    def counting(fn, *args):
        recomputed.append(fn.__self__)
        return remat(fn, *args)

    remat = layers.remat
    from regnet_for_3d_grasping_torch.models import backbone
    monkeypatch.setattr(backbone, "remat", counting)
    plain, loss0, g0 = step(False, over)
    assert not recomputed
    ckpt, loss1, g1 = step(True, over)
    assert len(recomputed) == 6            # SA1-3 and FP1-3
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys() and any("backbone.sa0" in n for n in g0)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    s0, s1 = plain.state_dict(), ckpt.state_dict()
    for n in s0:                           # running statistics included
        assert torch.equal(s0[n], s1[n]), n
    moved = REGNet(tiny_config(**over)).state_dict()
    assert any(not torch.equal(moved[n], s0[n]) for n in s0
               if n.endswith("running_mean"))


def test_remat_does_nothing_without_gradients(monkeypatch):
    model = REGNet(tiny_config(**{"model.remat_backbone": True})).eval()
    calls = []
    ckpt = torch.utils.checkpoint.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return ckpt(*a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    with torch.no_grad():
        model(torch.from_numpy(tiny_cloud(B=1)),
              generator=torch.Generator().manual_seed(1))
    assert calls == []


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from regnet_for_3d_grasping_torch.data import write_synthetic_dataset
    d = tmp_path_factory.mktemp("scenes")
    write_synthetic_dataset(str(d), 6, num_view=512)
    return str(d)


def test_remat_flag_trains_bit_equal(tmp_path, data_dir):
    """The train CLI with --remat: the configuration carries it into every
    SA and FP layer, and two steps leave the same parameters, statistics
    and losses as without it."""
    runs = []
    for flags in ([], ["--remat"]):
        runs.append(train_cli.main([
            "--tiny", "--device", "cpu", "--data-path", data_dir,
            "--model-path", str(tmp_path / "m"), "--log-path",
            str(tmp_path / "l"), "--tag", "remat" if flags else "plain",
            "--batch-size", "2", "--mode", "train", "--epoch", "1",
            *flags]))
    plain, ckpt = runs
    assert ckpt["cfg"].model.remat_backbone
    bb = ckpt["model"].score_net.backbone
    assert all(getattr(bb, f"{k}{i}").remat for k in ("sa", "fp")
               for i in range(3))
    assert [s["loss"] for s in plain["steps"]] == [
        s["loss"] for s in ckpt["steps"]]
    s0, s1 = plain["model"].state_dict(), ckpt["model"].state_dict()
    assert all(torch.equal(s0[n], s1[n]) for n in s0)
    assert np.isfinite([v["loss_total"] for v in ckpt["validation"]]).all()
