"""Data parallelism of the PyTorch port against the JAX package, on the
CPU: the shard and seed rules of ``parallel/mesh.py``, data-parallel
serving (``parallel/infer.py``), the sharded grasp evaluation and the two
CLIs' data-parallel paths.  The train step is in
``tests/test_torch_port_parallel_train.py``.

The port's workers and ranks are spawned processes (gloo on the CPU), one
torch thread each; JAX runs on a mesh of the first 2 of conftest's 8
virtual CPU devices, under ``jit``, as its data-parallel functions are
written.  The seeds JAX draws inside ``shard_map`` are read there with
``jax.debug.callback``, keyed by the shard's ``axis_index``
(`SeedSpies`), and handed to the port's shards.  Both sides run the plain
(non-kernel) selections at these shapes.

Tolerances: shard and seed rules, selections, masks and record counts
exact; a serving shard bit-equal to the port's solo forward under its
folded seed; serving against JAX within the whole-slice tolerance of
``tests/test_torch_port_model.py`` (rtol 1e-4, atol 1e-5); antipodal sums
of the sharded evaluation rtol 1e-6, as JAX's own test holds them.
"""

import functools
import importlib
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from regnet_for_3d_grasping_tpu.models import REGNet as JREGNet
from regnet_for_3d_grasping_tpu.parallel import infer as jpinfer
from regnet_for_3d_grasping_tpu.parallel import mesh as jmesh
from regnet_for_3d_grasping_tpu.train import trainer as jtrainer
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import config as pconfig
from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.cli import infer, train as train_cli
from regnet_for_3d_grasping_torch.eval import parallel_eval
from regnet_for_3d_grasping_torch.eval.evaluator import (
    eval_test, evaluate_scene_grasps)
from regnet_for_3d_grasping_torch.geometry import region
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.ops.sampling import hash_uniform
from regnet_for_3d_grasping_torch.parallel import mesh as pmesh
from regnet_for_3d_grasping_torch.parallel.infer import make_dp_inference
from regnet_for_3d_grasping_torch.train import trainer
from regnet_for_3d_grasping_torch.utils.export import extract_grasp_sets

from test_torch_port_eval import DEPTH, GRIP, TABLE, scene_grasps
from test_torch_port_model import TOL, tiny_cloud

jregnet = importlib.import_module("regnet_for_3d_grasping_tpu.models.regnet")
jregion = importlib.import_module("regnet_for_3d_grasping_tpu.geometry.region")

SEED = 3
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The ranks and workers run one torch thread, and torch's threaded
    CPU reductions round by thread count: this process runs one too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jmesh_of(shape, names):
    return JMesh(np.array(jax.devices()[:int(np.prod(shape))])
                 .reshape(shape), names)


def nested(flat_arrays: dict) -> dict:
    """{'a/b/c': array} -> {'a': {'b': {'c': array}}}."""
    out = {}
    for k, v in flat_arrays.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


# --- shard index, shards and folded seeds -----------------------------------

@pytest.mark.parametrize("shape", [(2,), (2, 2)])
def test_shard_index_is_the_jax_trainers_rule(shape):
    """The JAX trainer's flattening of `axis_index` over the mesh axes
    (``trainer.py:109-115``), read on each device, against the port's rule
    on the coordinates of each rank (row-major, so the rank itself)."""
    names = ("data",) if len(shape) == 1 else ("dcn", "data")
    jm = jmesh_of(shape, names)

    def body(x):
        shard = jnp.int32(0)
        for ax in names:
            shard = shard * jax.lax.psum(1, ax) + jax.lax.axis_index(ax)
        return x * 0 + shard

    n = int(np.prod(shape))
    got = jax.jit(jax.shard_map(body, mesh=jm, in_specs=P(names),
                                out_specs=P(names)))(jnp.zeros(n, jnp.int32))
    by_device = {s.device: int(np.asarray(s.data)[0])
                 for s in got.addressable_shards}
    for rank, dev in enumerate(jm.devices.flat):
        coords = np.unravel_index(rank, shape)
        assert pmesh.shard_index(coords, shape) == by_device[dev] == rank


@pytest.mark.parametrize("shape", [(2,), (2, 2)])
def test_shard_batch_is_jax_batch_sharding(shape):
    """Rank r's rows of a batch are the rows JAX puts on the mesh's r-th
    device (``batch_sharding`` / ``shard_batch`` over every axis)."""
    names = ("data",) if len(shape) == 1 else ("dcn", "data")
    jm = jmesh_of(shape, names)
    rng = np.random.RandomState(0)
    n = int(np.prod(shape))
    batch = jtrainer.DeviceBatch(*(rng.rand(4 * n, *s).astype(np.float32)
                                   for s in ((6, 3), (6,), (2, 3, 4),
                                             (2, 3), (2,))))
    spread = jmesh.shard_batch(batch, jm)
    for rank, dev in enumerate(jm.devices.flat):
        mine = pmesh.shard_batch(batch, n, rank)
        for got, field in zip(mine, spread):
            (want,) = [s.data for s in field.addressable_shards
                       if s.device == dev]
            np.testing.assert_array_equal(got, np.asarray(want))
    if len(shape) == 1:
        assert jmesh.batch_sharding(jm).spec == P("data")
    with pytest.raises(ValueError):
        pmesh.shard_batch(batch, 3, 0)


def test_fold_seed_is_the_counter_hash_of_the_shard():
    """``fold_seed(seed, i)`` is the u32 behind ``hash_uniform(seed)`` at
    linear index i + 1; every shard's seed differs, shard 0's from the
    seed."""
    for seed in (0, 1, 3, 131071 * 7 + 2, 2**32 + 5):
        u = hash_uniform(seed, (7,)).numpy()[1:]
        folds = [pmesh.fold_seed(seed, i) for i in range(6)]
        assert all(0 <= f < 2**32 for f in folds)
        np.testing.assert_array_equal(
            np.float32(folds) * np.float32(2.0**-32), u)
        assert len(set(folds)) == 6 and folds[0] != seed
    assert pmesh.fold_seed(2**32 + 5, 1) == pmesh.fold_seed(5, 1)


# --- serving ----------------------------------------------------------------

def port_variables(cfg, pc, seed=0) -> dict:
    """A fresh tiny port model's weights as nested JAX variables (numpy),
    its score logits spread over a range of 2 around score_thre's.  The
    model tests spread them over 16, which takes a gain of about 600 on
    this model's logits: JAX's jitted forward rounds the logit some 7e-7
    away from its eager one (XLA fuses; the model tests run JAX eagerly),
    and that gain would carry it to 1e-4 in the score, past the
    whole-slice tolerance, while every other output agrees to 1e-6."""
    torch.manual_seed(seed)
    model = REGNet(cfg).eval()
    sd = model.state_dict()
    k = sd["score_net.backbone.score_dense.weight"]
    sd["score_net.backbone.score_dense.weight"] = k.abs()
    model.load_state_dict(sd)
    with torch.no_grad():
        _, s = model.score_net(torch.from_numpy(pc))
    s = s.double().numpy()
    logit = np.log(s / (1.0 - s))
    scale = 2.0 / np.ptp(logit)
    sd["score_net.backbone.score_bn.weight"] *= scale
    sd["score_net.backbone.score_bn.bias"] -= scale * float(np.median(logit))
    return nested(weights.state_dict_to_jax(sd))


class SeedSpies:
    """Within the block, the JAX model's selection seeds by shard: inside
    ``shard_map`` each spy reads its shard's ``axis_index`` and the u32
    seeds its key yields (the plain paths split the key into one key a
    chunk, ``region.py:216``, ``:422``) through ``jax.debug.callback``."""

    def __init__(self, mp, cfg):
        self.seen = {}
        reg = cfg.region
        counts = {
            "group": region.group_seed_count(reg.center_num, reg.num_points,
                                             reg.group_num),
            "crop": region.crop_seed_count(reg.center_num, reg.num_points,
                                           reg.gripper_num)}
        orig = {"group": jregion.group_regions,
                "crop": jregion.closing_region_crop_dense}

        def spy(kind, key, *a, **kw):
            def keep(shard, kd):
                seen = self.seen.setdefault(int(shard), {})
                seen[kind] = [int(x) for x in np.asarray(kd)[:, -1]]
            jax.debug.callback(keep, jax.lax.axis_index("data"),
                               jax.random.key_data(
                                   jax.random.split(key, counts[kind])))
            return orig[kind](key, *a, **kw)

        mp.setattr(jregnet, "group_regions", functools.partial(spy, "group"))
        mp.setattr(jregnet, "closing_region_crop_dense",
                   functools.partial(spy, "crop"))

    def forward_kws(self, n: int) -> list:
        return [{"group_seeds": self.seen[i]["group"],
                 **({"crop_seeds": [self.seen[i]["crop"]]}
                    if "crop" in self.seen[i] else {})}
                for i in range(n)]


@pytest.fixture(scope="module")
def serving():
    """2 tiny clouds served by the port over 2 CPU workers, with folded
    seeds and with the seeds of JAX's `make_dp_inference` on 2 devices,
    which runs beside it; the port's solo forwards of each cloud under its
    folded seed."""
    cfg, jcfg = pconfig.tiny_config(), jtiny()
    pc = tiny_cloud()
    variables = port_variables(cfg, pc)
    mp = pytest.MonkeyPatch()
    # the workers start while JAX compiles
    with ThreadPoolExecutor(1) as pool:
        starting = pool.submit(make_dp_inference, cfg, variables, CPU2)
        try:
            spies = SeedSpies(mp, jcfg)
            ref = jpinfer.make_dp_inference(JREGNet(jcfg), jmesh_of((2,), (
                "data",)))(variables, jnp.asarray(pc),
                           jax.random.PRNGKey(SEED))
            ref = jax.tree.map(np.asarray, ref)
            jax.effects_barrier()
        finally:
            mp.undo()
            fwd = starting.result()
    with fwd:
        folded = fwd(pc, SEED)
        given = fwd(pc, SEED, forward_kws=spies.forward_kws(2))
        with pytest.raises(ValueError, match="split"):
            fwd(pc[:1], SEED)
    model = REGNet(cfg)
    weights.load_into(model, variables)
    model.eval()
    with torch.no_grad():
        solo = [model(torch.from_numpy(pc[i:i + 1]),
                      generator=torch.Generator().manual_seed(
                          pmesh.fold_seed(SEED, i)))
                for i in range(2)]
    return ref, folded, given, solo


def test_dp_serving_shard_is_the_solo_forward_with_its_folded_seed(serving):
    _, folded, _, solo = serving
    assert len(folded) == 2
    for shard, want in zip(folded, solo):
        for field, got, ref in zip(want._fields, shard["out"], want):
            if ref is None:
                assert got is None
            else:
                assert torch.equal(got, ref), field
        assert shard["forward_s"] > 0
        assert set(shard["launches"].values()) == {0}   # CPU: plain versions
    # the shards' selections are not clones of each other (seeds folded)
    assert not torch.equal(folded[0]["out"].center_index,
                           folded[1]["out"].center_index) or not torch.equal(
        folded[0]["out"].region_valid, folded[1]["out"].region_valid)


@pytest.mark.parametrize("field", ["center_index", "region_valid",
                                   "anchor_index", "crop_valid",
                                   "refine_accept", "score_accept"])
def test_dp_serving_selections_equal_jax_make_dp_inference(serving, field):
    ref, _, given, _ = serving
    got = np.concatenate([getattr(s["out"], field).numpy() for s in given])
    np.testing.assert_array_equal(got, getattr(ref, field))


@pytest.mark.parametrize("field", ["score", "cls_logits", "proposals",
                                   "refine_logits", "final_grasps"])
def test_dp_serving_values_close_to_jax_make_dp_inference(serving, field):
    ref, _, given, _ = serving
    got = np.concatenate([getattr(s["out"], field).numpy() for s in given])
    np.testing.assert_allclose(got, getattr(ref, field), **TOL)


def test_dp_serving_fails_where_a_worker_fails_to_start():
    cfg = pconfig.tiny_config()
    with pytest.raises(RuntimeError, match="failed"):
        # a worker that cannot build its model ends the start
        make_dp_inference(cfg, {"params": {}}, CPU2)


# --- the sharded evaluation ----------------------------------------------

def test_sharded_evaluation_over_two_devices_equals_scene_by_scene():
    """5 scenes of ragged grasp counts over 2 CPU devices (padded to 6 by
    repeating the last): records equal `evaluate_scene_grasps`."""
    rng = np.random.RandomState(7)
    from regnet_for_3d_grasping_torch.data import make_synthetic_scene
    scenes, grasps, depths, views = [], [], [], []
    for i, n in enumerate([40, 7, 120, 15, 60]):
        s = make_synthetic_scene(60 + i, num_view=1024)
        scenes.append(s)
        grasps.append(scene_grasps(s, rng, n))
        depths.append(np.full(n, DEPTH, np.float32))
        views.append(i % 4)
    heights = [TABLE] * 4 + [TABLE + 0.01]
    got = parallel_eval.evaluate_scenes_sharded(
        CPU2, scenes, grasps, views, heights, depths, GRIP.width, GRIP)
    want = [evaluate_scene_grasps(s, g, v, h, d, GRIP.width, GRIP,
                                  device="cpu")
            for s, g, v, h, d in zip(scenes, grasps, views, heights, depths)]
    assert len(got) == 5 and sum(w.vgr_count for w in want) > 5
    for a, b in zip(got, want):
        assert (a.vgr_count, a.nocoll_view, a.formal) == (
            b.vgr_count, b.nocoll_view, b.formal)
        # the padded shapes reorder the f32 antipodal sums (JAX's own
        # test holds its sharded sums at 1e-6)
        np.testing.assert_allclose(a.score_sum, b.score_sum, rtol=1e-6)


# --- the CLIs -------------------------------------------------------------

def test_infer_cli_dp_serves_chunks_of_the_visible_devices(
        tmp_path, monkeypatch, capsys):
    """``--dp`` over 2 listed CPU devices on 3 clouds: a chunk of 2 and a
    padded chunk of 1, each cloud the solo forward of its chunk position's
    folded seed, each pickle its cloud's view-filtered sets."""
    cfg = pconfig.tiny_config(**{"region.center_num": 16})
    monkeypatch.setattr(pmesh, "visible_devices", lambda device: CPU2)
    monkeypatch.setattr(infer, "config_from_args", lambda args: cfg)
    folder = tmp_path / "scene_data"
    folder.mkdir()
    pcs = tiny_cloud(B=3, extent=0.12)
    for i, pc in enumerate(pcs):
        with open(folder / f"{i:04d}.p", "wb") as f:
            pickle.dump({"view_cloud": pc[:, :3].astype(np.float64),
                         "view_cloud_color": pc[:, 3:]}, f)
    argv = ["--folder-name", str(folder), "--device", "cpu", "--seed", "2",
            "--all-points-num", "512", "--dp"]
    recs = infer.main(argv)
    text = capsys.readouterr().out
    assert "data-parallel serving over 2 device(s)" in text
    assert text.count("(2 clouds)") == 2 and text.count("(1 clouds)") == 1
    torch.manual_seed(2)
    model = REGNet(cfg).eval()
    rng = np.random.RandomState(2)
    for j, r in enumerate(recs):
        pc, back, _, _ = infer.load_cloud(r["path"], 512, rng)
        with torch.no_grad():
            want = model(torch.from_numpy(pc)[None],
                         generator=torch.Generator().manual_seed(
                             pmesh.fold_seed(2, j % 2)))
        for got, ref in zip(r["out"], want):
            assert (got is None and ref is None) or torch.equal(got, ref)
        raw = extract_grasp_sets(want)[0]
        g = cfg.gripper
        with open(tmp_path / "scene_data_predict" / f"{j:04d}.p", "rb") as f:
            pred = pickle.load(f)
        for k, v in raw.items():
            np.testing.assert_array_equal(pred[k], eval_test(
                back, v, None, g.table_height, g.depth, g.width, g, cfg.eval,
                device="cpu"), err_msg=k)
    assert len(recs) == 3 and [r["chunk"] for r in recs] == [2, 2, 1]


def test_infer_cli_flags_equal_the_jax_clis_but_device(tmp_path):
    jparser = importlib.import_module(
        "regnet_for_3d_grasping_tpu.cli.infer").build_parser()
    ours = {a for act in infer.build_parser()._actions
            for a in act.option_strings}
    theirs = {a for act in jparser._actions for a in act.option_strings}
    assert ours - theirs == {"--device"} and theirs <= ours
    assert infer.build_parser().parse_args(["--dp"]).dp
    if not torch.cuda.is_available():
        # --dp on the cards, none here: an error, not the CPU instead
        (tmp_path / "0000.p").write_bytes(b"")
        with pytest.raises(RuntimeError, match="CUDA"):
            infer.main(["--folder-name", str(tmp_path), "--dp"])


def test_train_cli_trains_data_parallel_over_the_visible_devices(
        tmp_path, monkeypatch, capsys):
    """Two listed CPU devices and a batch of 2: two spawned gloo ranks, the
    same losses as the emulation of the CLI's steps, rank 0's checkpoint,
    its validation forwards and its sharded grasp evaluation."""
    monkeypatch.setattr(pmesh, "visible_devices", lambda device: CPU2)
    data = tmp_path / "scenes"
    argv = ["--mode", "train", "--tiny", "--device", "cpu", "--data-path",
            str(data), "--model-path", str(tmp_path / "m"), "--log-path",
            str(tmp_path / "l"), "--batch-size", "2", "--epoch", "1",
            "--synthetic-scenes", "6", "--eval-grasps", "--seed", "4"]
    res = train_cli.main(argv)
    assert "data-parallel over 2 devices" in capsys.readouterr().out
    assert len(res["steps"]) == 2 and len(res["ranks"]) == 2
    assert [r["device"] for r in res["ranks"]] == CPU2
    assert (tmp_path / "m" / "default" / "ckpt_0" / "_METADATA").exists()
    assert len(res["validation"]) == 2 and res["grasp_records"]
    assert [e["epoch"] for e in res["epochs"]] == [0]
    assert 0 < res["epochs"][0]["validate_seconds"] < res["epochs"][0][
        "seconds"]
    # the emulation of the same two steps on one device
    from regnet_for_3d_grasping_torch.data import GraspDataset
    cfg = res["cfg"]
    ds = GraspDataset(str(data), "train", cfg.region.num_points,
                      cfg.region.max_gt_grasps, 4)
    model = train_cli.build_model(cfg, 4, "cpu")
    opt = trainer.make_optimizer(model, cfg, len(ds) // 2)
    losses = []
    for nb, batch in enumerate(ds.batches(2, seed=0)):
        shards, kws = [], []
        for i in range(2):
            seed = pmesh.fold_seed(nb, i)
            shards.append(trainer.device_batch(
                pmesh.shard_batch(batch, 2, i), "cpu"))
            kws.append({"generator": torch.Generator().manual_seed(seed),
                        "dropout_generator":
                            torch.Generator().manual_seed(seed)})
        losses.append(float(trainer.train_step_emulated(
            model, opt, shards, kws)["loss_total"]))
    assert [s["loss"] for s in res["steps"]] == losses
    for k, v in model.state_dict().items():
        assert torch.equal(res["model"].state_dict()[k], v), k


def test_train_cli_keeps_one_device_where_the_batch_does_not_split(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(pmesh, "visible_devices",
                        lambda device: ["cpu"] * 3)
    res = train_cli.main(["--mode", "train", "--tiny", "--device", "cpu",
                          "--data-path", str(tmp_path / "s"),
                          "--model-path", str(tmp_path / "m"),
                          "--log-path", str(tmp_path / "l"),
                          "--batch-size", "2", "--epoch", "1",
                          "--synthetic-scenes", "5"])
    assert "data-parallel" not in capsys.readouterr().out
    assert "ranks" not in res and len(res["steps"]) == 2


def test_train_cli_data_parallel_takes_every_training_flag(
        tmp_path, monkeypatch):
    """Two CPU ranks in `pretrain_region` with the training flags at once:
    bf16 slab steps, the native loader, augmentation, remat, the profiler
    trace (rank 0's alone), center jitter and the grasp evaluation."""
    monkeypatch.setattr(pmesh, "visible_devices", lambda device: CPU2)
    trace = tmp_path / "trace"
    res = train_cli.main([
        "--mode", "pretrain_region", "--tiny", "--device", "cpu",
        "--data-path", str(tmp_path / "s"), "--model-path",
        str(tmp_path / "m"), "--log-path", str(tmp_path / "l"),
        "--batch-size", "2", "--epoch", "1", "--synthetic-scenes", "10",
        "--bf16", "--slab-cell", "0.04", "--fps-groups", "2",
        "--native-loader", "--geom-aug", "1.0", "--remat",
        "--profile-dir", str(trace), "--center-jitter", "16,32",
        "--eval-grasps"])
    assert len(res["ranks"]) == 2 and len(res["steps"]) == 4
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    assert res["cfg"].model.compute_dtype == "bfloat16"
    assert [p.name for p in trace.iterdir()] == ["trace_epoch0.json"]
    assert res["trace"] == str(trace / "trace_epoch0.json")
    assert res["grasp_records"] and len(res["validation"]) == 2
