"""One bf16 training step of the port on slab + G = 8 (the run of record's
``--bf16 --slab-cell 0.04 --fps-groups 8``) against the JAX package's,
on the CPU: the tests, helpers and tolerances of
``tests/test_torch_port_train_bf16.py`` on the slab step's shapes
(``tests/test_torch_port_train.py``), 4,096 points and 64 centers on one
synthetic scene, with SA1's FPS in 8 groups.
"""

import pytest

from test_torch_port_train_bf16 import (  # noqa: F401  (run here too)
    bf16_steps, slab_scenario, test_bf16_step_loss_and_gradients_match_jax,
    test_bf16_step_running_statistics_match_jax,
    test_bf16_step_selections_equal)


@pytest.fixture(scope="module")
def bf16_step():
    jcfg, cfg, variables, batch, key, patch = slab_scenario()
    assert jcfg.region.slab_cell > 0 and cfg.model.fps_groups == 8
    return "slab", bf16_steps(jcfg, cfg, variables, batch, key, "refine",
                              patch)
