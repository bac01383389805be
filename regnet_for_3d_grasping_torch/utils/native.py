"""Build one C++ source of ``native/`` into a shared library with ``g++``
at first use (the native loader, ``data/native_loader.py``, and the zstd
decoder, ``utils/zstd.py``).  A failed build raises; no caller falls back
to another implementation."""

from __future__ import annotations

import os
import subprocess
import tempfile

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "native")


def build_shared(source: str, library: str, compiler: str, flags: list,
                 what: str, force: bool = False) -> str:
    """Compile `source` into `library` where it is missing or older than
    the source; returns the library's path, or raises RuntimeError with the
    compiler's output (`what` names the library in it)."""
    if (os.path.exists(library) and not force
            and os.path.getmtime(library) >= os.path.getmtime(source)):
        return library
    build_dir = os.path.dirname(library)
    os.makedirs(build_dir, exist_ok=True)
    # build beside the target and rename, so that concurrent builders
    # never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    cmd = [compiler, "-O3", "-shared", "-fPIC", "-std=c++17", *flags, source,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, OSError) as e:
        os.unlink(tmp)
        detail = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(f"{what} did not build ({' '.join(cmd)}): "
                           f"{detail}") from e
    os.replace(tmp, library)
    return library
