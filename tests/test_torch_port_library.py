"""The PointNet++ library layers no model path builds (JAX
``models/backbone.py:115-175`` and ``models/edge.py``), on the CPU:
`SetAbstractionMSG`, `SetAbstractionAvg`, `EdgeSetAbstraction` (bucket
and exact ball query) and `EdgeFeaturePropagation`, against flax with the
variables carried by `weights.load_into`.

The JAX side runs compiled (`jax.jit`), as the JAX package runs its
models (op by op it compiles each operation apart, several times slower
here), but for the edge FP: compiled, XLA contracts the 3-NN's
distances into fused multiply-adds, which the port and JAX op by op do
not, and moves its values by more than the tolerance.

Tolerances: sampled and neighbour indices exact; f32 forward rtol 1e-5,
atol 1e-5 (the same f32 layers, products summed in another order); bf16
forward as `test_torch_port_bf16.assert_bf16_close` (one-ulp roundings,
bf16 compute dtype on both sides).  The f64 gradients are in
``tests/test_torch_port_library_grad.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_tpu.models.backbone import (
    SetAbstractionAvg as JAvg, SetAbstractionMSG as JMSG)
from regnet_for_3d_grasping_tpu.models.edge import (
    EdgeFeaturePropagation as JEdgeFP, EdgeSetAbstraction as JEdgeSA)

import regnet_for_3d_grasping_torch.models as pmodels
from regnet_for_3d_grasping_torch import weights
from regnet_for_3d_grasping_torch.models.backbone import (SetAbstractionAvg,
                                                          SetAbstractionMSG)
from regnet_for_3d_grasping_torch.models.edge import (EdgeFeaturePropagation,
                                                      EdgeSetAbstraction)

from test_torch_port_bf16 import BF, JBF, assert_bf16_close, with_stats

TOL = dict(rtol=1e-5, atol=1e-5)
C_IN = 12


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.RandomState(4)
    xyz = (rng.rand(2, 600, 3) * 0.1).astype(np.float32)
    feat = rng.randn(2, 600, C_IN).astype(np.float32)
    return xyz, feat


def sa_cases():
    """(flax module, port module at `dtype`, torch dtype)."""
    return {
        "msg": (lambda d: JMSG(num_centroids=64, radii=(0.015, 0.03),
                               num_neighbours=(8, 16),
                               mlp_channels=((16, 24), (16, 32)), dtype=d),
                lambda d: SetAbstractionMSG(C_IN, 64, (0.015, 0.03), (8, 16),
                                            ((16, 24), (16, 32)), d)),
        "avg": (lambda d: JAvg(num_centroids=64, radius=0.03,
                               num_neighbours=16, mlp_channels=(16, 24),
                               dtype=d),
                lambda d: SetAbstractionAvg(C_IN, 64, 0.03, 16, (16, 24), d)),
        "edge": (lambda d: JEdgeSA(num_centroids=64, radius=0.03,
                                   num_neighbours=16, mlp_channels=(16, 24),
                                   dtype=d),
                 lambda d: EdgeSetAbstraction(C_IN, 64, 0.03, 16, (16, 24),
                                              d)),
        "edge_exact": (lambda d: JEdgeSA(num_centroids=64, radius=0.03,
                                         num_neighbours=16,
                                         mlp_channels=(16, 24), dtype=d,
                                         ball_query_method="exact"),
                       lambda d: EdgeSetAbstraction(
                           C_IN, 64, 0.03, 16, (16, 24), d,
                           ball_query_method="exact")),
    }


def fp_case(d):
    return (JEdgeFP(mlp_channels=(32, 16), dtype=d),
            EdgeFeaturePropagation(2 * 24 + 8, (32, 16), 3,
                                   torch.float32 if d is None else BF))


@pytest.fixture(scope="module")
def fp_inputs():
    rng = np.random.RandomState(6)
    dense = (rng.rand(2, 600, 3) * 0.1).astype(np.float32)
    sparse = dense[:, rng.choice(600, 64, replace=False)].copy()
    return (dense, sparse, rng.randn(2, 600, 8).astype(np.float32),
            rng.randn(2, 64, 24).astype(np.float32))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", ["msg", "avg", "edge", "edge_exact"])
def test_library_sa_forward_matches_flax(cloud, name, bf16):
    xyz, feat = cloud
    jmake, make = sa_cases()[name]
    jm = jmake(JBF if bf16 else None)
    jfeat = jnp.asarray(feat).astype(JBF) if bf16 else jnp.asarray(feat)
    variables = with_stats(jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                                   jfeat), 7)
    ref_xyz, ref = jax.jit(jm.apply)(variables, jnp.asarray(xyz), jfeat)
    m = make(BF if bf16 else torch.float32)
    weights.load_into(m, variables)
    m.eval()
    with torch.no_grad():
        new_xyz, got = m(t(xyz), t(feat).to(BF) if bf16 else t(feat))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(ref_xyz))
    if bf16:
        assert got.dtype == BF and ref.dtype == JBF
        assert_bf16_close(got, ref)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert float(np.asarray(ref, np.float32).std()) > 1e-2


@pytest.mark.parametrize("bf16", [False, True])
def test_edge_fp_forward_matches_flax(fp_inputs, bf16):
    dense, sparse, dfeat, sfeat = fp_inputs
    jm, m = fp_case(JBF if bf16 else None)
    cast = (lambda a: jnp.asarray(a).astype(JBF)) if bf16 else jnp.asarray
    args = (jnp.asarray(dense), jnp.asarray(sparse), cast(dfeat),
            cast(sfeat))
    variables = with_stats(jm.init(jax.random.PRNGKey(1), *args), 8)
    ref = jm.apply(variables, *args)
    weights.load_into(m, variables)
    m.eval()
    to = (lambda a: t(a).to(BF)) if bf16 else t
    with torch.no_grad():
        got = m(t(dense), t(sparse), to(dfeat), to(sfeat))
    if bf16:
        assert got.dtype == BF
        assert_bf16_close(got, ref)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_models_export_as_the_jax_package():
    import regnet_for_3d_grasping_tpu.models as jmodels
    jnames = {n for n in dir(jmodels) if not n.startswith("_")
              and isinstance(getattr(jmodels, n), type)}
    pnames = {n for n in dir(pmodels) if not n.startswith("_")
              and isinstance(getattr(pmodels, n), type)}
    assert jnames == pnames
