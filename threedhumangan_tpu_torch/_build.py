"""Build the port's CUDA kernels and bind them with ctypes.

At first use, ``library()`` compiles every ``csrc/*.cu`` of this package,
one nvcc process per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o build/threedhumangan_tpu_torch/<hash>/<name>.o csrc/<name>.cu

and links the objects into one shared library with a plain C interface
(``nvcc -shared -o libkernels_<hash>.so *.o``)

and loads it with ``ctypes`` (pointers and the stream as ``c_void_p``), each
entry called inside a ``launch.<entry>`` span (``bind``).  The
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

from threedhumangan_tpu_torch.utils import trace

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "threedhumangan_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: argument types; every one returns cudaGetLastError()
SIGNATURES = {
    # pts, table, boxes, vfeat, skel, out, idx, pairs (or null), B, P, V,
    # n_clusters, J, legacy, row_len, steps, stream
    "thgt_geo": [_P] * 8 + [_I] * 8 + [_P],
    # verts, table, boxes, B, V, n_clusters, stream
    "thgt_nn_clusters": [_P] * 3 + [_I] * 3 + [_P],
    # packed, z, weight stream, b_first, b_net, w_color_d, b_color, b_sigma,
    # b_head, out, depth, B, R, S, n_cols, n_in, H, k0p, n0p, hp, nc, headp,
    # n_blocks, out_width, white_back, last_back, exact_sin, stream bytes,
    # stream
    "thgt_raymarch": [_P] * 11 + [_I] * 16 + [ctypes.c_longlong, _P],
    # k0p, n0p, hp, nc, headp, ring (2 ints out); returns K2's shared memory
    "thgt_raymarch_smem": [_I] * 5 + [_P],
    # pts, table, boxes, dist, idx, pairs (or null), B, P, V, n_clusters,
    # row_len, steps, stream
    "thgt_nn": [_P] * 6 + [_I] * 6 + [_P],
    # packed (f32), z, weight stream (its forward half), b_first, b_net,
    # freq, phase, w_color_d, w_sigma, b_color, b_sigma, b_head, out, depth,
    # the 14 ints of thgt_field_stats, white_back, last_back, stream bytes,
    # stream
    "thgt_raymarch_unfolded": [_P] * 14 + [_I] * 16 + [ctypes.c_longlong, _P],
    # packed (raw f32), z, verts, vfeat, skel, idx_out (or null), weight
    # stream (its forward half), the 9 tables and the outputs of
    # thgt_raymarch_unfolded, its 16 ints, V, J, legacy, scaler, stream
    # bytes, stream
    "thgt_raymarch_geo": [_P] * 18 + [_I] * 19 + [_F, ctypes.c_longlong, _P],
    # style, fixed, gab, in_w, in_b, weight stream, conv_b, sh_b, g_b, bt_b,
    # rgb_w, rgb_b, rgb_out, B, H, W, F, fp, hp, num_blocks, n_gab,
    # add_fixed, mod_mask, stream bytes, stream
    "thgt_synthesis": [_P] * 13 + [_I] * 10 + [ctypes.c_longlong, _P],
    # packed, go, weight stream (its forward half), b_first, b_net, freq,
    # phase, w_color_d, w_sigma, b_color, b_sigma, b_head, sigma, gdot, B, P,
    # S, n_cols, n_in, H, k0p, n0p, hp, nc, headp, n_blocks, width,
    # exact_sin, stream bytes, stream
    "thgt_field_stats": [_P] * 14 + [_I] * 14 + [ctypes.c_longlong, _P],
    # packed, go, coef, dsig, weight stream, the 9 tables of
    # thgt_field_stats, x0, xs0, xsk, xcol, xc, du, dv, dcol, dyh, U, V, VC,
    # part, hsum, then the ints of thgt_field_stats, stream bytes, stream
    "thgt_field_bwd": [_P] * 28 + [_I] * 14 + [ctypes.c_longlong, _P],
    # k0p, n0p, hp, nc, headp, ring (2 ints out); returns the shared memory
    # of K4, K5, K8 and K9 (one layout)
    "thgt_field_bwd_smem": [_I] * 5 + [_P],
    # X, Y, part, K, N, rows, chunk_rows, n_chunks, stream
    "thgt_wgrad": [_P] * 3 + [_I] * 5 + [_P],
    # verts, faces (int64), tile edges, bins, face, bary, zbuf, pairs (or null),
    # B, V, F, T, K, tiles_x, tile, H, W, x_step, y_step, span, mx, my, stream
    "thgt_rasterize": [_P] * 8 + [_I] * 9 + [_F] * 5 + [_P],
    # h, style, fixed, gam, bet, m, r, a, b, sh_b, g_b, bt_b, c, weight
    # stream, out, B, HW, ci, cs, co, cip, csp, cop, hidp, spatial,
    # add_fixed, stream bytes, stream
    "thgt_half_block_fwd": [_P] * 15 + [_I] * 11 + [ctypes.c_longlong, _P],
    # cip, csp, cop, hidp, spatial, ring (2 ints out); returns K10's shared memory
    "thgt_half_block_fwd_smem": [_I] * 5 + [_P],
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
    key = _source_hash()
    lib_path = os.path.join(BUILD_DIR, f"libkernels_{key}.so")
    log_path = os.path.join(BUILD_DIR, f"build_{key}.log")
    if os.path.exists(lib_path):
        BUILD_INFO.update(path=lib_path)
        if os.path.exists(log_path):
            BUILD_INFO.update(log=log_path)
        return lib_path
    obj_dir = os.path.join(BUILD_DIR, f"obj_{key}_{os.getpid()}")
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
        _LIB = bind(ctypes.CDLL(build()))
    return _LIB


def bind(lib):
    """``lib`` with each entry of ``SIGNATURES`` typed and replaced by a call
    inside the span ``launch.<entry>`` (``utils.trace``): a host range open
    at each of the port's launches."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        setattr(lib, name, _spanned(fn, "launch." + name))
    return lib


def _spanned(fn, span_name: str):
    def call(*args):
        with trace.span(span_name):
            return fn(*args)

    return call


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
