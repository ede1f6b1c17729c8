"""Build the port's CUDA kernels and bind them with ctypes.

At first use, ``library()`` compiles every ``csrc/*.cu`` of this package
into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/threedhumangan_tpu_torch/libkernels_<hash>.so csrc/*.cu

and loads it with ``ctypes`` (pointers and the stream as ``c_void_p``).  The
library name carries a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the existing build.  The build directory
lies in the checkout (``build/`` is git-ignored).  Nothing here runs at
import: a CPU-only host never calls nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "threedhumangan_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: argument types; every one returns cudaGetLastError()
SIGNATURES = {
    # pts, verts, vfeat, skel, out, idx, B, P, V, J, legacy, stream
    "thgt_geo": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # packed, z, w_first, b_first, w_net0, w_net_stk, b_net, w_color_x,
    # w_color_d, b_color, w_sigma, b_sigma, w_head, b_head, out, depth,
    # B, R, S, n_cols, n_in, k0p, n0p, hp, n_blocks, out_width, head_np,
    # white_back, last_back, exact_sin, stream
    "thgt_raymarch": [_P] * 16 + [_I] * 14 + [_P],
    # style, fixed, gab, in_w, in_b, conv_w, conv_b, sh_w, sh_b, g_w, g_b,
    # bt_w, bt_b, rgb_w, rgb_b, rgb_out,
    # B, H, W, F, fp, hp, num_blocks, n_gab, add_fixed, mod_mask, stream
    "thgt_synthesis": [_P] * 16 + [_I] * 10 + [_P],
}

_LIB = None
BUILD_INFO: dict = {}  # path of the loaded library; log of the build that made it


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile (if needed) and return the path of the shared library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libkernels_{_source_hash()}.so")
    if os.path.exists(lib_path):
        BUILD_INFO.update(path=lib_path)
        return lib_path
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log_path = os.path.join(BUILD_DIR, "build.log")
    with open(log_path, "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(path=lib_path, log=log_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
