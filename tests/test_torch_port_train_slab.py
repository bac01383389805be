"""One refine-stage training step of the PyTorch port through the slab
kernels against the JAX package (Pallas in interpret mode), on the CPU:
the f64 port against the f64 JAX package, the f32 port against the f64
port.  The helpers, and the reason for f64, are in
``tests/test_torch_port_train.py``.
"""

import numpy as np
import pytest

from test_torch_port_train import (F64_TOL, SELECTIONS, assert_selections,
                                   assert_step_close, run_slab_step)


@pytest.fixture(scope="module")
def slab_step_run():
    return run_slab_step()


def test_slab_step_selections_exact(slab_step_run):
    (rout, *_), (out64, *_), (out32, *_) = slab_step_run
    fields = ("point_order",) + SELECTIONS
    assert_selections(out64, rout, fields)
    assert_selections(out32, rout, fields)
    assert rout.region_valid.any() and rout.crop_valid.any()


def test_slab_step_f64_port_is_the_jax_formulas(slab_step_run):
    ref, got64, _ = slab_step_run
    assert_step_close(got64, ref, F64_TOL, 1e-5, F64_TOL)
    assert got64[1]["stage2_matched"] > 0
    assert np.abs(got64[2]["params/grn_head/stem/dense/kernel"]).max() > 0


def test_slab_step_f32_port_is_close_to_f64(slab_step_run):
    """As for the tiny steps, but gradients within 2e-2 of their block's
    largest entry: on this single scene the seg head's first layer has
    channels that hardly vary, and its f32 gradient is 7e-3 off the f64
    one."""
    _, got64, got32 = slab_step_run
    assert_step_close(got32, got64, dict(rtol=1e-4, atol=1e-6), 2e-2,
                      dict(rtol=1e-4, atol=1e-6))
