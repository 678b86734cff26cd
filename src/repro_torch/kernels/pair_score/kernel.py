"""Build, load and launch the hand-written CUDA ``pair_score`` kernel.

The source is ``csrc/pair_score.cu`` (a plain C entry,
``pair_score_launch``).  At first use it is compiled with ``nvcc`` for
``sm_90a`` into ``build/repro_torch/`` at the root of the checkout, keyed
on a hash of the source so that an edit rebuilds, and loaded with
``ctypes``.  Nothing is built or imported from the GPU toolchain when this
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "pair_score.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Launches of the CUDA kernel in this process; :func:`pair_score_cuda`
#: adds one per launch and nothing else touches it.
LAUNCHES = 0
#: The compiler's report (``-Xptxas -v``: registers, shared memory,
#: spills) of the build this process loaded, or "" when it found a cached
#: library.
BUILD_LOG = ""

_FN = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"pair_score_{digest}.so"


def load() -> float:
    """Build (if needed) and load the kernel library; returns the seconds
    spent doing so in this call."""
    global _FN, BUILD_LOG
    if _FN is not None:
        return 0.0
    t0 = time.perf_counter()
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}"
            )
        BUILD_LOG = proc.stdout + proc.stderr
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.pair_score_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _FN = fn
    return time.perf_counter() - t0


def pair_score_cuda(st: torch.Tensor, coeffs: torch.Tensor,
                    n_categories: int = 4, n_valid=None) -> torch.Tensor:
    """Launch the kernel: st (P, 4) f32 CUDA, coeffs (4, 4) f32 CUDA ->
    (P, P) f32 pair costs with ``DIAG`` on the diagonal and on rows/cols
    at or past ``n_valid`` (default P).  Launches on the current stream
    and does not synchronise."""
    global LAUNCHES
    for name, t in (("st", st), ("coeffs", coeffs)):
        if t.device.type != "cuda":
            raise ValueError(f"pair_score_cuda: {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"pair_score_cuda: {name} is {t.dtype}, not f32")
        if not t.is_contiguous():
            raise ValueError(f"pair_score_cuda: {name} is not contiguous")
    if st.dim() != 2 or st.shape[1] != 4:
        raise ValueError(f"pair_score_cuda: st must be (P, 4), got {tuple(st.shape)}")
    if tuple(coeffs.shape) != (4, 4):
        raise ValueError(
            f"pair_score_cuda: coeffs must be (4, 4), got {tuple(coeffs.shape)}")
    if coeffs.device != st.device:
        raise ValueError("pair_score_cuda: st and coeffs on different devices")
    if st.data_ptr() % 16:
        raise ValueError("pair_score_cuda: st must be 16-byte aligned")
    if not 1 <= n_categories <= 4:
        raise ValueError(f"pair_score_cuda: n_categories={n_categories}")
    p = st.shape[0]
    n_valid = p if n_valid is None else int(n_valid)
    load()
    out = torch.empty((p, p), dtype=torch.float32, device=st.device)
    stream = torch.cuda.current_stream(st.device).cuda_stream
    err = _FN(st.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
              p, n_valid, n_categories, stream)
    if err != 0:
        raise RuntimeError(f"pair_score kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
