"""The data-parallel train step of the PyTorch port (`train.trainer` with a
`parallel.mesh.Mesh`) against its one-process emulation and the JAX
package's ``make_train_step(mesh=...)``, on the CPU, in f64.

The port's ranks are spawned gloo processes, one torch thread each
(``tests/torch_port_dp_ranks.py``); JAX runs on a mesh of conftest's
virtual CPU devices with x64.  The seeds JAX draws inside ``shard_map`` are
read there (`test_torch_port_parallel.SeedSpies`) and handed to the port's
shards.

Tolerances: at 2 ranks the step is bit-equal to its emulation (a sum of
two is order-free); on the 2 x 2 mesh within 1e-12 (the mean sums within a
slice first); against JAX's jitted step as
`test_dp_step_matches_jax_make_train_step_on_a_mesh` says.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.models import REGNet as JREGNet
from regnet_for_3d_grasping_tpu.train import trainer as jtrainer
from regnet_for_3d_grasping_tpu.utils.config import tiny_config as jtiny

from regnet_for_3d_grasping_torch import config as pconfig
from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.geometry import codec, region
from regnet_for_3d_grasping_torch.models.regnet import REGNet
from regnet_for_3d_grasping_torch.parallel import launch
from regnet_for_3d_grasping_torch.parallel import mesh as pmesh
from regnet_for_3d_grasping_torch.train import trainer

import torch_port_dp_ranks as ranks
from test_torch_port_parallel import (SEED, CPU2, SeedSpies, jmesh_of,
                                      nested, one_thread)  # noqa: F401
from test_torch_port_train import (TINY, flat, scene_cloud,
                                   spread_scores_and_shrink_residuals)


# --- the data-parallel train step --------------------------------------------

def dp_scenario(B: int, seed: int = 0):
    """The tiny model at f32 from a port init (scores spread, residuals
    shrunk), B scenes, GT built from its own train-mode proposals as
    ``test_torch_port_train.build_scenario`` builds it, one scene a
    forward (a rank's BatchNorm statistics are its shard's): stage 3 has
    positives and negatives on each shard."""
    jcfg, cfg = jtiny(**TINY), pconfig.tiny_config(**TINY)
    pc = scene_cloud(B, cfg.region.num_points, seed)
    torch.manual_seed(seed)
    variables = nested(weights.state_dict_to_jax(REGNet(cfg).state_dict()))
    spread_scores_and_shrink_residuals(variables)
    model = REGNet(cfg)
    weights.load_into(model, variables)
    n_group = region.group_seed_count(cfg.region.center_num, pc.shape[1],
                                      cfg.region.group_num)
    n_crop = region.crop_seed_count(cfg.region.center_num, pc.shape[1],
                                    cfg.region.gripper_num)
    # each scene's train-mode forward alone, with its own BatchNorm
    # statistics, as a rank of one scene computes them
    with torch.no_grad():
        outs = [model.train()(torch.from_numpy(pc[b:b + 1]),
                              group_seeds=list(range(1, n_group + 1)),
                              crop_seeds=[list(range(1, n_crop + 1))])
                for b in range(B)]
    out0 = type(outs[0])(*(None if v[0] is None else torch.cat(v)
                           for v in zip(*outs)))
    NC = out0.centers.shape[1]
    MG = cfg.region.max_gt_grasps
    grasp = out0.proposals[..., :7].clone()
    grasp[..., :3] = out0.centers[..., :3]
    grasp[:, 1::2, 6] += 2.0
    frame, center = codec.grasps_to_frames(grasp)
    gt_frames = np.zeros((B, MG, 3, 4), np.float32)
    gt_frames[:, :NC, :, :3] = frame.numpy()
    gt_frames[:, :NC, :, 3] = center.numpy()
    gt_valid = np.zeros((B, MG), bool)
    gt_valid[:, :NC] = True
    rng = np.random.RandomState(15 + seed)
    batch = jtrainer.DeviceBatch(
        pc=pc, score=np.tanh(rng.rand(B, pc.shape[1]) * 2).astype(np.float32),
        gt_frames=gt_frames,
        gt_scores=rng.rand(B, MG, 3).astype(np.float32), gt_valid=gt_valid)
    return jcfg, cfg, variables, batch


def jax_adam_moments(opt_state) -> dict:
    """optax ``multi_transform``'s Adam moments -> {'exp_avg' |
    'exp_avg_sq': {'params/...': array}} (each label's masked half)."""
    out = {"exp_avg": {}, "exp_avg_sq": {}}
    for inner in opt_state.inner_states.values():
        for st in jax.tree.leaves(
                inner, is_leaf=lambda x: hasattr(x, "mu")):
            if hasattr(st, "mu"):
                for name, tree in (("exp_avg", st.mu),
                                   ("exp_avg_sq", st.nu)):
                    out[name].update({
                        k: v for k, v in flat(jax.tree.map(
                            np.asarray, tree), "params").items()
                        if v.size > 0})
    return out


def port_moments(state: dict, kind: str) -> dict:
    return weights.state_dict_to_jax({k: v for k, v in state[kind].items()})


@pytest.fixture(scope="module")
def multislice():
    """The 2 x 2 multi-slice step's 4 gloo ranks, started in a thread of
    their own, so that they run while the next fixture traces JAX; its
    scenario and the future of the ranks' results."""
    jcfg, cfg, variables, batch = dp_scenario(4, seed=1)
    with ThreadPoolExecutor(1) as pool:
        yield (cfg, variables, batch), pool.submit(
            launch.run_ranks, ranks.multislice_step, ["cpu"] * 4, cfg,
            variables, tuple(batch), SEED)


@pytest.fixture(scope="module")
def dp_steps(multislice):
    """One f64 step in each stage on 2 scenes: JAX's ``make_train_step``
    over a 2-device mesh (x64), the port at world 2 in gloo with each
    shard given the seeds JAX drew there, and the port's emulation.  The
    ranks start first and wait for the seeds; the three JAX steps are
    traced one after another (each with its own seed spies) and compiled
    side by side; the emulation runs while the ranks step."""
    jcfg, cfg, variables, batch = dp_scenario(2)
    with ThreadPoolExecutor(1) as pool:
        given = torch.multiprocessing.get_context("spawn").SimpleQueue()
        # a plain tuple: the ranks import no JAX
        dp = pool.submit(launch.run_ranks, ranks.stage_steps, CPU2, cfg,
                         variables, tuple(batch), given)
        seeds = None
        try:
            refs, seeds = jax_dp_steps(jcfg, variables, batch)
        finally:
            for _ in CPU2:
                given.put(seeds)
        emulated = {}
        for stage, kws in seeds.items():
            model = ranks.f64_model(cfg, variables)
            opt = trainer.make_optimizer(model, cfg, ranks.STEPS_PER_EPOCH)
            full = ranks.f64_batch(batch)
            metrics = trainer.train_step_emulated(
                model, opt, [pmesh.shard_batch(full, 2, i) for i in range(2)],
                kws, stage)
            emulated[stage] = ranks.step_state(model, opt, metrics)
        dp = dp.result()
    return refs, dp, emulated


def jax_dp_steps(jcfg, variables, batch) -> tuple:
    """JAX's f64 step in each stage on a 2-device mesh -> (the new state
    and metrics by stage, the seeds each shard drew by stage)."""
    jm = jmesh_of((2,), ("data",))
    up = functools.partial(jax.tree.map, lambda a: jnp.asarray(
        a, jnp.float64 if np.issubdtype(np.asarray(a).dtype, np.floating)
        else None))
    stages = ("score", "region", "refine")
    lowered, spies = {}, {}
    with jax.enable_x64(True):
        v = up(variables)
        opt = jtrainer.make_optimizer(jcfg, ranks.STEPS_PER_EPOCH)
        state = jtrainer.TrainState(v["params"], v["batch_stats"],
                                    opt.init(v["params"]),
                                    jnp.zeros((), jnp.int32))
        args = (state, jtrainer.DeviceBatch(*up(tuple(batch))),
                jax.random.PRNGKey(SEED))
        for stage in stages:
            mp = pytest.MonkeyPatch()
            try:
                # the spies' callbacks are traced into this stage's step
                spies[stage] = SeedSpies(mp, jcfg)
                lowered[stage] = jtrainer.make_train_step(
                    JREGNet(jcfg), opt, jcfg, stage, jm).lower(*args)
            finally:
                mp.undo()
        with ThreadPoolExecutor(len(stages)) as pool:
            compiled = dict(zip(stages, pool.map(
                lambda lo: lo.compile(), lowered.values())))
        refs = {}
        for stage in stages:
            new, metrics = compiled[stage](*args)
            jax.block_until_ready(new)
            jax.effects_barrier()
            refs[stage] = {
                "params": flat(jax.tree.map(np.asarray, new.params),
                               "params"),
                "stats": flat(jax.tree.map(np.asarray, new.batch_stats),
                              "batch_stats"),
                **jax_adam_moments(new.opt_state),
                "metrics": {k: float(x) for k, x in metrics.items()}}
    return refs, {stage: spies[stage].forward_kws(2) for stage in stages}


STAGES = ["score", "region", "refine"]


@pytest.mark.parametrize("stage", STAGES)
def test_dp_step_equals_its_one_process_emulation(dp_steps, stage):
    """Parameters, running statistics, Adam's moments and metrics, on both
    ranks, bit for bit."""
    _, dp, emulated = dp_steps
    want = emulated[stage]
    for r, got in enumerate(dp):
        assert got["shard"] == r and got["coords"] == (r,)
        got = got[stage]
        assert got["metrics"] == want["metrics"]
        for kind in ("state", "exp_avg", "exp_avg_sq"):
            for k, v in want[kind].items():
                assert torch.equal(got[kind][k], v), (r, kind, k)


@pytest.mark.parametrize("stage", STAGES)
def test_dp_step_matches_jax_make_train_step_on_a_mesh(dp_steps, stage):
    """JAX's ``make_train_step(mesh=...)`` on 2 devices in f64 (x64).

    JAX's gradient there is the SUM over the shards, not the mean its
    ``pmean`` (``trainer.py:136``) asks for: ``shard_map`` transposes the
    broadcast of the replicated parameters into a ``psum``, and the
    ``pmean`` of that already-summed value returns it unchanged.  The port
    averages, as the trainer's ``pmean`` says; Adam's update hardly sees
    the factor (its ``eps`` aside), so the gradients (Adam's first moment)
    compare as JAX's over W (ROADMAP.md C).

    The jitted step is not JAX's formulas to f64 precision: XLA contracts
    the f32 geometry (``bpdist2``, the crop's box test) into fused
    multiply-adds, which moves radius picks, and fuses the f32 score.  Run
    against JAX's own ``_step_body`` op by op on each shard with the mean
    (``test_torch_port_train.jax_step``; about 110 s, too slow for the
    suite), the jitted step is up to 1.1e-4 off in a metric, 1.35 times
    (rtol 1e-4, atol 1e-6) in running statistics and 8.9e-2 of a block's
    largest entry in gradients (the port's step: 4.4e-8, 2e-10 and 7e-8
    off that op-by-op mean).  These tolerances are of that drift's size;
    the port's step is held to JAX's formulas tightly by its emulation
    (above), whose shards are the solo steps
    ``tests/test_torch_port_train_step.py`` holds at F64_TOL.  In stages
    `score` and `region` the heads left out of the loss keep a zero
    gradient on both sides."""
    refs, dp, _ = dp_steps
    ref, got = refs[stage], dp[0][stage]
    assert got["metrics"].keys() == ref["metrics"].keys()
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, ref["metrics"][k], err_msg=k,
                                   rtol=3e-4, atol=1e-6)
    port = weights.state_dict_to_jax(got["state"])
    for k, v in ref["stats"].items():
        np.testing.assert_allclose(port[k], v, err_msg=k, rtol=2e-4,
                                   atol=2e-6)
    mu = port_moments(got, "exp_avg")
    jmu = {k: v / 2 for k, v in ref["exp_avg"].items()}     # sum -> mean
    assert mu.keys() == jmu.keys()
    scale = {}
    for k, v in jmu.items():
        block = k.rsplit("/", 2)[0]
        scale[block] = max(scale.get(block, 0.0), float(np.abs(v).max()))
    for k, v in jmu.items():
        np.testing.assert_allclose(
            mu[k], v, rtol=0, err_msg=k,
            atol=0.15 * scale[k.rsplit("/", 2)[0]] + 1e-12)
    if stage == "refine":
        assert ref["metrics"]["stage3_positives"] > 0
        assert ref["metrics"]["stage3_loss"] > 0
    live = {k.split("/")[1] for k, v in mu.items() if np.abs(v).max() > 0}
    assert live == {k.split("/")[1] for k, v in jmu.items()
                    if np.abs(v).max() > 0}
    assert live == {"score": {"score_net"},
                    "region": {"score_net", "grn_head"},
                    "refine": {"score_net", "grn_head",
                               "refine_head"}}[stage]


def test_multislice_2x2_step_equals_the_emulation(multislice):
    """A 2 x 2 (dcn x data) mesh of 4 gloo ranks: coordinates and shards
    row-major; one refine step, finite, within 1e-12 of the emulation of 4
    shards (the mean sums within each slice first)."""
    (cfg, variables, batch), ranks_run = multislice
    dp = ranks_run.result()
    model = ranks.f64_model(cfg, variables)
    opt = trainer.make_optimizer(model, cfg, ranks.STEPS_PER_EPOCH)
    full = ranks.f64_batch(batch)
    metrics = trainer.train_step_emulated(
        model, opt, [pmesh.shard_batch(full, 4, i) for i in range(4)],
        [{"generator": torch.Generator().manual_seed(
            pmesh.fold_seed(SEED, i))} for i in range(4)])
    want = ranks.step_state(model, opt, metrics)
    for r, got in enumerate(dp):
        assert got["axes"] == ("dcn", "data")
        assert got["coords"] == (r // 2, r % 2) and got["shard"] == r
        assert np.isfinite(got["metrics"]["loss_total"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-12,
                                       atol=1e-12, err_msg=k)
        for kind in ("state", "exp_avg", "exp_avg_sq"):
            for k, v in want[kind].items():
                np.testing.assert_allclose(got[kind][k].numpy(), v.numpy(),
                                           rtol=1e-12, atol=1e-15,
                                           err_msg=f"{kind} {k}")
        for k, v in dp[0]["state"].items():       # replicas equal
            assert torch.equal(got["state"][k], v)


