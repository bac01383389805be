"""Where the kernels' build lands (the counterpart of the JAX package's
persistent compilation cache, its ``utils/cache.py``).

``ops/_cuda`` builds every CUDA source into ``csrc/build/`` at first use,
named by a hash of sources and flags, so a later process reuses it.
`enable_compilation_cache` points it elsewhere: at `path`, or at the
directory that ``REGNET_TORCH_CACHE`` names.  With neither, the build stays
in ``csrc/build/``.  The CLIs call it where the JAX package's call theirs.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "REGNET_TORCH_CACHE"


def enable_compilation_cache(path: str | None = None) -> Path:
    """Point the kernels' build directory at `path` or ``$REGNET_TORCH_CACHE``
    (before the first launch); returns the directory in use."""
    from regnet_for_3d_grasping_torch.ops import _cuda
    path = path or os.environ.get(ENV)
    if path:
        _cuda.BUILD_DIR = Path(path).resolve()
    return _cuda.BUILD_DIR
