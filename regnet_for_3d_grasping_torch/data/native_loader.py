"""The native C++ scene loader (JAX ``data/native_loader.py``): scene
pickles converted once to flat ``.rsc`` files (`convert_dataset`), and a
C++ thread pool (``native/loader.cc``, the port's own copy) that resamples,
jitters and pads whole batches while the device steps, double-buffered.

The library is built with ``g++`` at first use into ``native/build/``.
One departure from JAX, on purpose: JAX falls back quietly to the Python
loader when the library does not build; here `build_library` raises with
the compiler's message, so ``--native-loader`` never runs another loader
than the one it names.
"""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

from regnet_for_3d_grasping_torch.data.dataset import (SceneBatch,
                                                       load_scene,
                                                       pad_gt_grasps)
from regnet_for_3d_grasping_torch.utils.native import (NATIVE_DIR,
                                                       build_shared)

SOURCE = os.path.join(NATIVE_DIR, "loader.cc")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
COMPILER = "g++"


def build_library(force: bool = False) -> str:
    """Compile ``native/loader.cc`` with `COMPILER` where the library is
    missing or older than the source; returns the library's path, or
    raises RuntimeError with the compiler's output."""
    return build_shared(SOURCE, os.path.join(BUILD_DIR, "librsc_loader.so"),
                        COMPILER, ["-pthread"], "the native loader", force)


def scene_to_rsc(scene: dict, out_path: str) -> None:
    """Write one scene dict as a flat .rsc file (unpadded GT arrays)."""
    view = np.ascontiguousarray(scene["view_cloud"], np.float32)
    color = np.ascontiguousarray(scene["view_cloud_color"], np.float32)
    score = np.ascontiguousarray(scene["view_cloud_score"], np.float32)
    label = np.ascontiguousarray(
        scene.get("view_cloud_label", np.zeros(len(view))), np.float32)
    g = _num_grasps(scene)
    frames, gscores, _ = pad_gt_grasps(scene, max_grasps=max(g, 1))
    with open(out_path, "wb") as f:
        f.write(b"RSC1")
        f.write(np.array([len(view), g], np.int32).tobytes())
        for a in (view, color, score, label):
            f.write(a.tobytes())
        f.write(np.ascontiguousarray(frames[:g], np.float32).tobytes())
        f.write(np.ascontiguousarray(gscores[:g], np.float32).tobytes())


def _num_grasps(scene: dict) -> int:
    for key in ("frame", "select_frame"):
        if key in scene:
            return len(scene[key])
    return 0


def convert_dataset(paths: List[str], cache_dir: str) -> List[str]:
    """Convert scene pickles to .rsc files, skipping up-to-date ones."""
    os.makedirs(cache_dir, exist_ok=True)
    out = []
    for p in paths:
        dst = os.path.join(cache_dir,
                           os.path.basename(p).replace(".p", ".rsc"))
        if (not os.path.exists(dst)
                or os.path.getmtime(dst) < os.path.getmtime(p)):
            scene_to_rsc(load_scene(p), dst)
        out.append(dst)
    return out


class NativeLoader:
    """Double-buffered native batch loader; `next_batch` gives a
    `SceneBatch` whose ``paths`` are the .rsc files'."""

    def __init__(self, rsc_paths: List[str], batch_size: int,
                 num_points: int, max_grasps: int, seed: int = 0,
                 n_threads: int = 8, augment: bool = True,
                 width: float = 0.08):
        lib = ctypes.CDLL(build_library())
        lib.rsc_loader_create.restype = ctypes.c_void_p
        lib.rsc_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int]
        lib.rsc_loader_next.restype = ctypes.c_int
        lib.rsc_loader_next.argtypes = [ctypes.c_void_p] + [
            np.ctypeslib.ndpointer(dtype=d, flags="C_CONTIGUOUS")
            for d in (np.float32, np.float32, np.float32, np.float32,
                      np.float32, np.uint8, np.int32)]
        lib.rsc_loader_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self.paths = rsc_paths
        self.batch_size = batch_size
        self.num_points = num_points
        self.max_grasps = max_grasps
        self.width = np.float32(width)
        arr = (ctypes.c_char_p * len(rsc_paths))(
            *[p.encode() for p in rsc_paths])
        self._handle = lib.rsc_loader_create(
            arr, len(rsc_paths), batch_size, num_points, max_grasps, seed,
            n_threads, int(augment))
        if not self._handle:
            raise RuntimeError("rsc_loader_create failed")

    def __len__(self):
        return len(self.paths)

    def next_batch(self) -> SceneBatch:
        B, N, MG = self.batch_size, self.num_points, self.max_grasps
        pc = np.empty((B, N, 6), np.float32)
        score = np.empty((B, N), np.float32)
        label = np.empty((B, N), np.float32)
        frames = np.empty((B, MG, 3, 4), np.float32)
        gscores = np.empty((B, MG, 3), np.float32)
        valid = np.empty((B, MG), np.uint8)
        ids = np.empty((B,), np.int32)
        if self._lib.rsc_loader_next(self._handle, pc, score, label,
                                     frames.reshape(B, MG, 12), gscores,
                                     valid, ids) != 0:
            raise RuntimeError("rsc_loader_next failed")
        return SceneBatch(
            pc=pc, score=score, label=label, gt_frames=frames,
            gt_scores=gscores, gt_valid=valid.astype(bool),
            paths=[self.paths[i] for i in ids],
            width=np.full(B, self.width, np.float32))

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.rsc_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
