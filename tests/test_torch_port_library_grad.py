"""The f64 gradients of the PointNet++ library layers no model path builds
(JAX ``models/backbone.py:115-175`` and ``models/edge.py``), on the CPU:
training mode, both sides in f64 (geometry f32), the JAX side compiled
but for the edge FP (see ``tests/test_torch_port_library.py``, whose
layers and inputs these are).

Tolerances: outputs rtol 1e-9; parameter and input gradients rtol 1e-6,
atol 1e-6 of their block's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regnet_for_3d_grasping_torch import weights

from test_torch_port_bf16 import with_stats
from test_torch_port_library import cloud, fp_case, fp_inputs, sa_cases, t

__all__ = ["cloud", "fp_inputs"]     # the fixtures, used by name


def f64_grads(jm, variables, m, points, feats, pick=lambda out: out,
              compiled=True):
    """Training-mode output and gradients (the parameters and `feats`) of
    sum(output * a fixed weight), both sides in f64: the layers take
    `points` (f32 geometry) then `feats`; `pick` takes the output from a
    layer's return value; the JAX side `compiled` or op by op."""
    with jax.enable_x64(True):
        up = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss(params, *fs):
            out, _ = jm.apply({"params": params,
                               "batch_stats": up["batch_stats"]},
                              *map(jnp.asarray, points), *fs, train=True,
                              mutable=["batch_stats"])
            out = pick(out)
            w = jnp.cos(jnp.arange(out.size, dtype=jnp.float64)).reshape(
                out.shape)
            return jnp.sum(out * w), out

        grad_fn = jax.value_and_grad(
            loss, argnums=tuple(range(len(feats) + 1)), has_aux=True)
        (_, ref), grads = (jax.jit(grad_fn) if compiled else grad_fn)(
            up["params"], *(jnp.asarray(f, jnp.float64) for f in feats))
        ref = np.asarray(ref)
        gp = jax.tree.map(np.asarray, grads[0])
        gx = [np.asarray(g) for g in grads[1:]]
    weights.load_into(m, variables)
    m.double().train()
    fs = [t(f).double().requires_grad_() for f in feats]
    out = pick(m(*map(t, points), *fs))
    w = torch.cos(torch.arange(out.numel(), dtype=torch.float64)).reshape(
        out.shape)
    (out * w).sum().backward()
    got = weights.state_dict_to_jax(
        {k: p.grad for k, p in m.named_parameters()})
    return (out.detach().numpy(), ref), (got, gp), \
        ([f.grad.numpy() for f in fs], gx)


def assert_grads_close(pair, prefix="params"):
    got, ref = pair

    def walk(tree, path):
        for k, v in tree.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                yield from walk(v, p)
            else:
                yield p, v
    n = 0
    for k, v in walk(ref, prefix):
        scale = float(np.abs(v).max())
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=k)
        n += 1
    assert n == len(got)


@pytest.mark.parametrize("name", ["msg", "avg", "edge", "edge_exact"])
def test_library_sa_f64_gradients_match_flax(cloud, name):
    xyz, feat = cloud
    jmake, make = sa_cases()[name]
    jm = jmake(None)
    variables = with_stats(jm.init(jax.random.PRNGKey(2), jnp.asarray(xyz),
                                   jnp.asarray(feat)), 9)
    (out, ref), params, feats = f64_grads(
        jm, variables, make(torch.float32), [xyz], [feat],
        pick=lambda out: out[1])
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)
    assert_grads_close(params)
    for g, r in zip(*feats):
        np.testing.assert_allclose(g, r, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r).max()))


def test_edge_fp_f64_gradients_match_flax(fp_inputs):
    dense, sparse, dfeat, sfeat = fp_inputs
    jm, m = fp_case(None)
    args = (jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(dfeat),
            jnp.asarray(sfeat))
    variables = with_stats(jm.init(jax.random.PRNGKey(3), *args), 10)
    (out, ref), params, feats = f64_grads(
        jm, variables, m, [dense, sparse], [dfeat, sfeat], compiled=False)
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)
    assert_grads_close(params)
    for g, r in zip(*feats):
        np.testing.assert_allclose(g, r, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(r).max()))


