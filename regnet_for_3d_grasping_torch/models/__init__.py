"""The port's models, exported as the JAX package's ``models`` exports
them."""

from regnet_for_3d_grasping_torch.models.backbone import (  # noqa: F401
    FeaturePropagation,
    PointNet2Seg,
    SetAbstraction,
)
from regnet_for_3d_grasping_torch.models.edge import (  # noqa: F401
    EdgeFeaturePropagation,
    EdgeSetAbstraction,
)
from regnet_for_3d_grasping_torch.models.heads import (  # noqa: F401
    RefineHead,
    TwoStageHead,
)
from regnet_for_3d_grasping_torch.models.score_net import (  # noqa: F401
    ScoreNet,
)
from regnet_for_3d_grasping_torch.models.regnet import REGNet  # noqa: F401
