"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<source>.cu`` has a plain C interface with one entry point per
kernel (headers ``csrc/*.cuh`` hold what several share).  On first use all
of them are compiled together, one ``nvcc`` process per source, into
``csrc/build/`` (named by a hash of source, headers and flags, so an edit
rebuilds), and loaded with ``ctypes``.  Nothing is built or imported at
module import time: this module is imported on machines without a card.

Every launch goes through `launch`, which adds one to ``launches[name]``
and raises if the C entry point reports a CUDA error.  ``fallbacks`` counts
the calls in which the slab 3-NN's certificate failed and the full scan
ran instead: on the card K8 adds to a device count, which is read (and
synchronized) only where ``fallbacks["fp3_slab"]`` is read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
# -fmad=false: no FMA contraction, so every distance is rounded exactly as
# the JAX reference rounds it (the selections compare those distances)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_P, _I, _F, _U, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint32, ctypes.c_longlong)
# kernel name -> (source, C entry point, argtypes); every entry point
# returns the cudaGetLastError() after its launch, and takes the stream last
SIGNATURES = {
    "fps": ("fps", "regnet_fps", (_P, _P, _P, _I, _I, _I, _I, _P)),
    "fps_grouped": ("fps", "regnet_fps_grouped",
                    (_P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "ball_query": ("ball_query", "regnet_ball_query",
                   (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P)),
    "three_nn": ("three_nn", "regnet_three_nn",
                 (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "gather_max": ("gather_max", "regnet_gather_max",
                   (_P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "crop": ("crop", "regnet_crop", (_P, _P, _P, _U, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _I, _I, _F, _F, _F, _F, _P)),
    "group_slab": ("slab_select", "regnet_group_slab",
                   (_P, _P, _P, _U, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _I, _I, _I, _F, _F, _F, _P)),
    "crop_slab": ("slab_select", "regnet_crop_slab",
                  (_P, _P, _P, _P, _U, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _I, _F, _F, _F, _F, _F, _F, _P)),
    "three_nn_slab": ("three_nn_slab", "regnet_three_nn_slab",
                      (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _F, _I, _I, _I, _P)),
    "three_nn_slab_flat": ("three_nn_slab", "regnet_three_nn_slab_flat",
                           (_P,) * 14 + (_I, _I, _I, _F, _I, _I, _I, _I,
                                         _P)),
    "gather_max_slab": ("gather_max_slab", "regnet_gather_max_slab",
                        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "group_regions": ("group", "regnet_group_regions",
                      (_P, _P, _U, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _F, _P)),
    "group_regions_chunked": ("grid_group", "regnet_group_regions_chunked",
                              (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _F, _P)),
    "gather_max_argmax": ("gather_max", "regnet_gather_max_argmax",
                          (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "gather_max_backward": ("gather_max", "regnet_gather_max_backward",
                            (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "gather_max_slab_argmax": (
        "gather_max_slab", "regnet_gather_max_slab_argmax",
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    "gather_max_bf16": ("gather_max", "regnet_gather_max_bf16",
                        (_P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "gather_max_slab_bf16": ("gather_max_slab", "regnet_gather_max_slab_bf16",
                             (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P)),
    "gather_max_argmax_bf16": ("gather_max", "regnet_gather_max_argmax_bf16",
                               (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "gather_max_backward_bf16": ("gather_max",
                                 "regnet_gather_max_backward_bf16",
                                 (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "gather_max_slab_argmax_bf16": (
        "gather_max_slab", "regnet_gather_max_slab_argmax_bf16",
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    # K13a-d, BatchNorm (+ ReLU): f32 or bf16 x by their `bf16` argument
    "bn_stats": ("batch_norm", "regnet_bn_stats",
                 (_P,) * 6 + (_L, _I, _I, _I, _I, _I, _F, _F, _I, _P)),
    "bn_apply": ("batch_norm", "regnet_bn_apply",
                 (_P,) * 6 + (_L, _I, _I, _I, _I, _I, _F, _I, _P)),
    "bn_backward_reduce": ("batch_norm", "regnet_bn_backward_reduce",
                           (_P,) * 9 + (_L, _I, _I, _I, _I, _I, _I, _F, _I,
                                        _P)),
    "bn_backward_apply": ("batch_norm", "regnet_bn_backward_apply",
                          (_P,) * 8 + (_L, _I, _I, _I, _I, _I, _F, _I, _P)),
    # K13e-f, the set-abstraction layers' max over neighbours
    "bn_apply_max": ("batch_norm", "regnet_bn_apply_max",
                     (_P,) * 7 + (_L, _I, _I, _I, _I, _F, _I, _P)),
    "bn_max_backward": ("batch_norm", "regnet_bn_max_backward",
                        (_P,) * 3 + (_L, _I, _I, _I, _I, _P)),
}
# C entry points that launch nothing (an occupancy query, the compile-time
# constants of the bucket scan and of K3's grid), not counted; each returns
# its answer, or minus the CUDA error
QUERIES = {
    "fps_max_clusters": ("fps", "regnet_fps_max_clusters", (_I, _I)),
    "ball_query_per_warp": ("ball_query", "regnet_ball_query_per_warp", ()),
    "ball_query_stage_cols": ("ball_query", "regnet_ball_query_stage_cols",
                              ()),
    "three_nn_threads": ("three_nn", "regnet_three_nn_threads", ()),
    "three_nn_max_per_thread": ("three_nn", "regnet_three_nn_max_per_thread",
                                ()),
    "group_regions_per_warp": ("group", "regnet_group_regions_per_warp", ()),
    "group_regions_stage_cols": ("group", "regnet_group_regions_stage_cols",
                                 ()),
    "crop_per_warp": ("crop", "regnet_crop_per_warp", ()),
    "crop_stage_cols": ("crop", "regnet_crop_stage_cols", ()),
}
KERNELS = tuple(SIGNATURES)
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))


class Counts:
    """Named counts kept on the host (`add`) and, where a kernel counts on
    the card, in an int64 on each card that the kernel adds to (`on`).
    Reading a count (``counts[name]``) sums both and synchronizes with the
    cards that hold it."""

    def __init__(self, *names: str):
        self._host = dict.fromkeys(names, 0)
        self._dev: dict = {}

    def add(self, name: str, n: int = 1) -> None:
        self._host[name] += n

    def on(self, name: str, device: torch.device) -> torch.Tensor:
        """The device count `name` of `device` (int64 [1]), made at 0."""
        key = (name, device_index(device))
        if key not in self._dev:
            # a normal tensor even under inference mode: `reset` zeroes it
            # in place outside it
            with torch.inference_mode(False):
                self._dev[key] = torch.zeros(
                    1, dtype=torch.int64, device=torch.device("cuda", key[1]))
        return self._dev[key]

    def __getitem__(self, name: str) -> int:
        return self._host[name] + sum(int(t.item()) for (n, _), t
                                      in self._dev.items() if n == name)

    def reset(self) -> None:
        for k in self._host:
            self._host[k] = 0
        for t in self._dev.values():
            t.zero_()


launches = dict.fromkeys(KERNELS, 0)
fallbacks = Counts("fp3_slab")

_fns: dict = {}
_constants: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    fallbacks.reset()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _lib_path(source: str) -> Path:
    # the headers count for every source: an edit of one rebuilds them all
    h = hashlib.sha256(b"".join(
        p.read_bytes() for p in [CSRC / f"{source}.cu",
                                 *sorted(CSRC.glob("*.cuh"))])
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source}-{h}.so"


def build() -> dict:
    """Compile the sources that are not built yet, all in parallel.
    Returns {source: seconds spent}, empty when everything was built."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    t0 = time.perf_counter()
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    spent, errors = {}, []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        spent[n] = time.perf_counter() - t0
        if p.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n}.cu:\n{out.decode()}")
        else:
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return spent


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        with _lock:
            build()
            libs = {src: ctypes.CDLL(str(_lib_path(src))) for src in SOURCES}
            for n, (src, sym, argtypes) in (SIGNATURES | QUERIES).items():
                f = getattr(libs[src], sym)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
                _fns[n] = f
        fn = _fns[name]
    return fn


def raw_stream(index: int) -> int:
    """The handle of the current stream of card `index`.  torch's private
    ``_cuda_getCurrentRawStream`` (checked against torch 2.11+cu128, and
    against the public ``current_stream().cuda_stream`` by
    ``chip_smoke.py``) builds no Stream object, which costs the host more
    than many of these kernels take on the card."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel `name` on `device`'s current stream with `args`
    (tensors are passed as device pointers)."""
    fn = _fn(name)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    cargs.append(raw_stream(index))
    # a device context only when `device` is not the current one
    if index == current:
        rc = fn(*cargs)
    else:
        with torch.cuda.device(index):
            rc = fn(*cargs)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    launches[name] += 1


def query(name: str, device: torch.device, *args) -> int:
    """The answer of the query `name` on `device` for int `args` (minus
    the CUDA error where there is none)."""
    fn = _fn(name)
    with torch.cuda.device(device):
        return fn(*args)


def device_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def constant(name: str, device: torch.device) -> int:
    """The compile-time constant that the argument-less query `name`
    returns, cached per card."""
    key = (name, device_index(device))
    if key not in _constants:
        _constants[key] = query(name, device)
    return _constants[key]


def sm_count(device: torch.device) -> int:
    index = device_index(device)
    if ("sms", index) not in _constants:
        _constants["sms", index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _constants["sms", index]


def check(t: torch.Tensor, what: str, dtype: torch.dtype,
          shape: tuple) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and
    `shape` (None in `shape` matches any size)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{what}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
