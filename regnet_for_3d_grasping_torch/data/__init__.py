"""Host data pipeline (numpy only): the port's own copies of the JAX
package's ``data/dataset.py`` and ``data/synthetic.py``."""

from regnet_for_3d_grasping_torch.data.dataset import (  # noqa: F401
    GraspDataset,
    SceneBatch,
    load_scene,
    pad_gt_grasps,
    width_from_path,
)
from regnet_for_3d_grasping_torch.data.synthetic import (  # noqa: F401
    make_synthetic_scene,
    write_synthetic_dataset,
)
