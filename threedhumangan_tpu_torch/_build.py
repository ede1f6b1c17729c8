"""Build the port's CUDA kernels and bind them with ctypes.

At first use, ``library()`` compiles every ``csrc/*.cu`` of this package,
one nvcc process per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o build/threedhumangan_tpu_torch/<hash>/<name>.o csrc/<name>.cu

and links the objects into one shared library with a plain C interface
(``nvcc -shared -o libkernels_<hash>.so *.o``)

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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types; every one returns cudaGetLastError()
SIGNATURES = {
    # pts, verts, vfeat, skel, out, idx, B, P, V, J, legacy, stream
    "thgt_geo": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # packed, z, w_first, b_first, w_net0, w_net_stk, b_net, w_color_x,
    # w_color_d, b_color, w_sigma, b_sigma, w_head, b_head, out, depth,
    # B, R, S, n_cols, n_in, k0p, n0p, hp, n_blocks, out_width, head_np,
    # white_back, last_back, exact_sin, stream
    "thgt_raymarch": [_P] * 16 + [_I] * 14 + [_P],
    # pts, verts, dist, idx, B, P, V, stream
    "thgt_nn": [_P] * 4 + [_I] * 3 + [_P],
    # packed (f32), z, the 14 tables of thgt_field_stats, out, depth, B, R, S,
    # n_cols, n_in, k0p, n0p, hp, n_blocks, out_width, headp, white_back,
    # last_back, exact_sin, stream
    "thgt_raymarch_unfolded": [_P] * 18 + [_I] * 14 + [_P],
    # packed (raw f32), z, verts, vfeat, skel, idx_out (or null), the 14
    # tables, out, depth, B, R, S, n_cols, V, J, legacy, scaler, k0p, n0p,
    # hp, n_blocks, out_width, headp, white_back, last_back, exact_sin, stream
    "thgt_raymarch_geo": [_P] * 22 + [_I] * 7 + [_F] + [_I] * 9 + [_P],
    # style, fixed, gab, in_w, in_b, weight stream, conv_b, sh_b, g_b, bt_b,
    # rgb_w, rgb_b, rgb_out, B, H, W, F, fp, hp, num_blocks, n_gab,
    # add_fixed, mod_mask, stream bytes, stream
    "thgt_synthesis": [_P] * 13 + [_I] * 10 + [ctypes.c_longlong, _P],
    # packed, go, w_first, b_first, w_net0, w_net_stk, b_net, freq, phase,
    # w_color_x, w_color_d, b_color, w_sigma, b_sigma, w_head, b_head, sigma,
    # gdot, B, P, S, n_cols, n_in, k0p, n0p, hp, n_blocks, width, headp,
    # exact_sin, stream
    "thgt_field_stats": [_P] * 18 + [_I] * 12 + [_P],
    # packed, go, coef, dsig, the 14 tables of thgt_field_stats, wT_head,
    # wT_color_x, wT_net_stk, wT_net0, x0, xs0, xsk, xcol, xc, du, dv, dcol,
    # dyh, U, V, VC, part, then the ints of thgt_field_stats, stream
    "thgt_field_bwd": [_P] * 35 + [_I] * 12 + [_P],
    # X, Y, part, K, N, rows, chunk_rows, n_chunks, stream
    "thgt_wgrad": [_P] * 3 + [_I] * 5 + [_P],
    # tri, face, bary, zbuf, B, T, K, tiles_x, tile, x_step, y_step, span, stream
    "thgt_rasterize": [_P] * 4 + [_I] * 5 + [_F] * 3 + [_P],
    # h, style, fixed, gam, bet, m, r, a, b, sh_w, sh_b, g_w, g_b, bt_w, bt_b,
    # w, c, out, B, HW, ci, cs, co, cip, csp, cop, hidp, spatial, add_fixed,
    # stream
    "thgt_half_block_fwd": [_P] * 18 + [_I] * 11 + [_P],
    # h, style, fixed, gam, bet, m, r, a, b, sh_b, g_b, bt_b, weight stream,
    # g, dh, dsty, xt, yg, xst, xact, ygb, ydact, part, the ints of
    # thgt_half_block_fwd, stream bytes, stream
    "thgt_half_block_bwd": [_P] * 23 + [_I] * 11 + [ctypes.c_longlong, _P],
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
    obj_dir = os.path.join(BUILD_DIR, f"obj_{_source_hash()}_{os.getpid()}")
    os.makedirs(obj_dir, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (rc {proc.returncode}):\n{out[-4000:]}")
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    log_path = os.path.join(BUILD_DIR, "build.log")
    with open(log_path, "w") as f:
        f.write("\n".join(log))
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
