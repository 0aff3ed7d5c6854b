"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by a plain ``nvcc -c`` of its own,
all started together, and one more ``nvcc`` links the objects into one
shared library with a C interface (no PyTorch headers, so it builds in
seconds). The library goes to ``_build/`` inside the package (git-ignored),
under a name that carries a hash of the sources and flags. It is compiled to
a temporary name and moved into place with ``os.replace``, so there is no
lock file and an interrupted build leaves nothing that blocks the next one.
Nothing is built at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# one nvcc -c a source, side by side (-Xptxas -v: registers, shared memory
# and spills of every kernel), then one link
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
NVCC_FLAGS = COMPILE_FLAGS + LINK_FLAGS

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures of csrc/*.cu: every pointer and the stream as void*, ints as
# int; (argument types, return type)
_SIGNATURES = {
    # x, out, gamma, beta, scale, shift, stats, B, N, C, G, k, tokens, resident,
    # smem, vec, eps, bf16, stream
    "pidm_gn_film_silu": ([_P] * 7 + [_I] * 9 + [_F, _I, _P], _I),
    # x, dy, gamma, beta, scale, shift, stats, dx, dgamma, dbeta, dscale, dshift,
    # sums, B, N, C, G, k, tokens, resident, smem, vec, bf16, stream
    "pidm_gn_film_silu_bwd": ([_P] * 13 + [_I] * 10 + [_P], _I),
    # k, smem, vec, bf16 -> clusters the card holds at once (K2 fwd, bwd)
    "pidm_gn_film_silu_max_clusters": ([_I] * 4, _I),
    "pidm_gn_film_silu_bwd_max_clusters": ([_I] * 4, _I),
    # x, out, gamma, w_qkv, w_out, b_out, M, stats, work, B, N, C, eps, bf16, stream
    "pidm_linear_attention_block": ([_P] * 9 + [_I] * 3 + [_F, _I, _P], _I),
    # B, N, C -> floats of scratch (K1's and K3's forward)
    "pidm_linear_attention_block_fwd_workspace": ([_I] * 3, _L),
    # x, dy, gamma, w_qkv, w_out, M, stats, dx, dgamma, dw_qkv, dw_out, db_out,
    # work, B, N, C, eps, bf16, stream
    "pidm_linear_attention_block_bwd": ([_P] * 13 + [_I] * 3 + [_F, _I, _P], _I),
    # B, N, C -> floats of workspace (K1's and K3's backward)
    "pidm_linear_attention_block_bwd_workspace": ([_I] * 3, _L),
    # x, out, w_qkv, w_out, M, stats, work, B, N, C, bf16, stream
    "pidm_linear_attention": ([_P] * 7 + [_I] * 4 + [_P], _I),
    # x, dy, w_qkv, w_out, M, stats, dx, dw_qkv, dw_out, work, B, N, C, bf16, stream
    "pidm_linear_attention_bwd": ([_P] * 10 + [_I] * 4 + [_P], _I),
    # x, out, gamma, beta, scale, shift, B, N, C, G, k, tokens, resident, smem, eps,
    # stream (K5)
    "pidm_gn_film_silu_packed": ([_P] * 6 + [_I] * 8 + [_F, _P], _I),
    # k, smem -> clusters the card holds at once (K5)
    "pidm_gn_film_silu_packed_max_clusters": ([_I] * 2, _I),
    # cudaGraph_t, int* kernel nodes -> nodes
    "pidm_graph_nodes": ([_P, _P], _I),
    # x, w, bias, gamma, beta, scale, shift, out, z, stats, B, Ci, Co, P, G, eps, k, smem,
    # bf16, stream (K4)
    "pidm_conv_gn_film_silu": ([_P] * 10 + [_I] * 5 + [_F] + [_I] * 3 + [_P], _I),
    # x, wdx, gamma, beta, scale, shift, dy, z, stats, dx, dw, dbias, dgamma, dbeta,
    # dscale, dshift, dz, work, B, Ci, Co, P, G, k, splits, smem_dz, smem_dw, smem_dx,
    # bf16, stream
    "pidm_conv_gn_film_silu_bwd": ([_P] * 18 + [_I] * 11 + [_P], _I),
    # B, P, Ci, Co, G, bf16 -> floats of workspace
    "pidm_conv_gn_film_silu_bwd_workspace": ([_I] * 6, _L),
    # k, smem, bf16 -> clusters the card holds at once (K4 fwd, bwd dz)
    "pidm_conv_gn_film_silu_max_clusters": ([_I] * 3, _I),
    "pidm_conv_gn_film_silu_bwd_max_clusters": ([_I] * 3, _I),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and Path(c).is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpidm_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> tuple[Path, str, float]:
    """Compile the library if it is not there yet. Returns (path, compiler
    output, seconds spent compiling; 0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return out, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = BUILD_DIR / f"{out.stem}.{os.getpid()}.objs"
    objs.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    nvcc, procs, log = _nvcc(), [], []
    t0 = time.perf_counter()
    try:
        for src in _sources():
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(objs / f"{src.stem}.o")]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        for cmd, proc in procs:
            text, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{text}")
            log.append(text)
        link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(objs / f"{src.stem}.o")
                                                      for src in _sources())]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}")
        log.append(proc.stdout)
    except BaseException:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.unlink(missing_ok=True)
        raise
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out, "".join(log), seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def check_param(t: torch.Tensor, name: str, shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on ``device``."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 tensor of shape {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
