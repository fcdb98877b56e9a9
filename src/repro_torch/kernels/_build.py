"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` and linked into one shared library,
``build/kernels/libreprotorch.so`` at the repository root, which is
loaded with `ctypes`.  The sources have a plain C interface — pointers,
ints and the CUDA stream — so no PyTorch header is compiled and a build
takes seconds.  The library is keyed by a hash of the sources and the
flags: an unchanged tree loads the existing library without rebuilding.

Nothing here runs at import time; the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch.kernels import KernelError

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libreprotorch.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name → argtypes (every pointer and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints and cut them)
SIGNATURES = {
    # starts, lens, extra, ids_flat, exclude, out, B, I, X, E, C, cap, Wp,
    # n_flat, stream
    "lsh_retrieve_topc_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _L, _P],
    # row, mu, col, users, cand, scores, items, B, C, Fp1, topn, M, N,
    # stream
    "candidate_score_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _L, _L, _P],
    # &CulshArgs, start, k (the batch's row of the valid masks)
    "culsh_sgd_launch": [_P, _L, _L],
    # F, K, bce → blocks the card holds at once (< 0: an error)
    "culsh_sgd_capacity": [_I, _I, _I],
    # &MfArgs, start, k (the batch's row of the valid masks)
    "mf_sgd_launch": [_P, _L, _L],
    # psi, phi, out, N, deg, bits, stream
    "simlsh_encode_launch": [_P, _P, _P, _L, _I, _I, _P],
    # u, v, w, c, resid, impl, bbar, sR, sN, out, B, F, K, stream
    "neighbor_predict_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _P],
    # &GroupJob[count], count, long_run, stream
    "segment_group_launch": [_P, _I, _I, _P],
    # sorted, order, n, long_run, plan, scratch, stream
    "segment_runs_launch": [_P, _P, _L, _I, _P, _P, _P],
    # dst, ld, rows, src, n, width, plan, stream
    "segment_add_launch": [_P, _L, _L, _P, _L, _I, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc/ptxas output of this process's build


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: the CUDA kernels are built on "
                         "first use and need the CUDA toolkit")
    return found


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all, raise on any failure;
    returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, errors = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        outs.append(out)
        if p.returncode:
            errors.append(f"{' '.join(cmd)}\n{out}")
    if errors:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(errors))
    return "".join(outs)


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless an up-to-date
    one exists; returns its path."""
    global build_log
    srcs = sources()
    digest = _digest(srcs)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if (lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / (s.stem + ".o") for s in srcs]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                    for s, o in zip(srcs, objs)])
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
               str(tmp)]])
    os.replace(tmp, lib)
    stamp.write_text(digest + "\n")
    build_log = log
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except OSError as e:
                raise KernelError(f"cannot load the kernel library: {e}") \
                    from e
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def loaded() -> bool:
    """Whether this process has loaded the kernel library already."""
    return _lib is not None


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (its `cudaGetLastError`)."""
    if err != 0:
        raise KernelError(f"{what}: CUDA launch failed with error {err}")
