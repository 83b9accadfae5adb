"""Build the hand-written CUDA kernels of ``mridc_tpu_torch/csrc`` with nvcc and
bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared library
``_build/lib<name>-<hash>.so``, the hash taken over the sources it is built
from, so an edited source is rebuilt on its next use and an unchanged one is
loaded as it is. The build runs at first use (or all at once through
:func:`build`, one nvcc per source started together) and reads nothing but the
sources in this package. Every entry point returns its ``cudaError_t``;
:func:`launch` raises on a nonzero one and counts the launches that succeed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "QUERIES", "LAUNCHES", "build", "library", "launch", "query",
           "reset_launch_counts"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# library -> {entry point: argtypes without the trailing stream}
SOURCES: Dict[str, Dict[str, tuple]] = {
    "psf1d_dc": {
        # eta, sens, mats, z0, out, B, C, H, W, inv_sigma2
        "k1_psf1d_dc_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F),
        "k1_psf1d_dc_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F),
        # g, sens, mats, out, B, C, H, W, inv_sigma2
        "k1_psf1d_dc_bwd_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _F),
        "k1_psf1d_dc_bwd_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _F),
    },
    "full_dc": {
        # eta, sens, X, B, C, H, W, shift_h, shift_w, eta_stride (float2s a pixel)
        "k2_expand": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I),
        # K, y, mask, B, C, H, W, shift_h, shift_w
        "k2_residual": (_P, _P, _P, _I, _I, _I, _I, _I, _I),
        # y, mask (or null), Q, B, C, H, W, shift_h, shift_w
        "k2_load": (_P, _P, _P, _I, _I, _I, _I, _I, _I),
        # P, sens, eta (or null), out, B, C, H, W, shift_h, shift_w, inv_sigma2
        "k2_reduce": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F),
        # K, mask, B, C, H, W, shift_h, shift_w
        "k2_mask": (_P, _P, _I, _I, _I, _I, _I, _I),
        # P, sens, g, out, B, C, H, W, shift_h, shift_w, inv_sigma2
        "k2_reduce_acc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F),
    },
    "indrnn": {
        # x, h, w, bias (or null), u, out, P, CI, F, device index (keys the cached launch setup)
        "k3_indrnn_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I),
        "k3_indrnn_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I),
    },
    "indrnn_bwd": {
        # x, h, h', g, w, u, dx (or null), dh (or null), partials, sums, P, CI, F, blocks (from
        # k3_indrnn_bwd_setup), device index
        "k3_indrnn_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I),
        "k3_indrnn_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I),
    },
}

# library -> {launch-setup query: argtypes}; a query launches nothing, takes no
# stream and is not counted
QUERIES: Dict[str, Dict[str, tuple]] = {
    "psf1d_dc": {
        # bwd (0 or 1), B, H, W, device index, out: int[7] (blocks, shared memory bytes, blocks per SM,
        # threads, tile rows, tile columns, route: 0 on chip, 1 wide)
        "k1_psf1d_dc_bf16_setup": (_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)),
        "k1_psf1d_dc_f32_setup": (_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)),
    },
    "indrnn_bwd": {
        # bf16 (0 or 1), P, CI, F, device index, out: int[7] (blocks of the grid, shared memory bytes,
        # blocks per SM, threads, tile pixels, stages, route: 0 tensor cores, 1 the float32 wide route;
        # all 0: widths not taken)
        "k3_indrnn_bwd_setup": (_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)),
    },
}

LAUNCHES: Dict[str, int] = {sym: 0 for syms in SOURCES.values() for sym in syms}

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, Callable[..., int]] = {}  # entry point -> its bound function


def reset_launch_counts() -> None:
    for sym in LAUNCHES:
        LAUNCHES[sym] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc") if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet, one
    nvcc each, all started together. Returns {name: seconds} of the builds run;
    the compiler's register/spill report goes to ``_build/<name>.log``."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _target(n).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    seconds, failed = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for sym, argtypes in SOURCES[name].items():
            fn = getattr(lib, sym)
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for sym, argtypes in QUERIES.get(name, {}).items():
            fn = getattr(lib, sym)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.mridc_error_string.argtypes = [ctypes.c_int]
        lib.mridc_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(name: str, symbol: str, device: torch.device, *args) -> None:
    """Launch ``symbol`` of library ``name`` on the current stream of
    ``device``; raise if the launch was refused, count it if it was not.

    A launch sits on the host's path between two kernels, so it reads the raw
    stream handle and switches the current device only when ``device`` is
    not the current one: a ``Stream`` object and a device guard cost more host
    time than the ctypes call itself."""
    fn = _ENTRIES.get(symbol)
    if fn is None:
        fn = _ENTRIES[symbol] = getattr(library(name), symbol)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err} ({library(name).mridc_error_string(err).decode()})")
    LAUNCHES[symbol] += 1


def query(name: str, symbol: str, device: torch.device, *args) -> None:
    """Call the launch-setup query ``symbol`` of library ``name`` with
    ``device`` current; raise on a nonzero error."""
    lib = library(name)
    with torch.cuda.device(device):
        err = getattr(lib, symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err} ({lib.mridc_error_string(err).decode()})")
