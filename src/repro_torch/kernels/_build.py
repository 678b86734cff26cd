"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` source with a plain C entry point.  At first use
it is compiled with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at
the root of the checkout, keyed on a hash of the source so that an edit
rebuilds, and loaded with ``ctypes``.  :func:`load_all` starts one ``nvcc``
per source at once and waits for all of them.  Nothing is built or imported
from the GPU toolchain when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class CudaLibrary:
    """One CUDA source and the C entry points it exports.

    ``entries`` maps each entry's name to its ``ctypes`` argument types;
    every entry returns an ``int``: a launch entry the ``cudaError_t`` of
    its launch (:meth:`launch`), a query entry its answer (:meth:`call`).
    """

    def __init__(self, source: Path, entries: dict):
        self.source = Path(source)
        self.entries = dict(entries)
        #: The compiler's report (``-Xptxas -v``: registers, shared memory,
        #: spills) of the build this process made, or "" when it found a
        #: library already built from the same source.
        self.build_log = ""
        #: Seconds the last :meth:`load` or :func:`load_all` spent on it.
        self.load_s = 0.0
        self._fns = None

    @property
    def name(self) -> str:
        return self.source.stem

    def library_path(self) -> Path:
        """Where the library built from the current source lives."""
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}_{digest}.so"

    def _start(self):
        """Start ``nvcc`` unless the library is loaded or already built;
        returns ``(process, temporary output)`` or None."""
        if self._fns is not None or self.library_path().exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library_path().with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish(self, started) -> None:
        if started is not None:
            proc, tmp = started
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name}:\n{out}")
            self.build_log = out
            os.replace(tmp, self.library_path())
        if self._fns is None:
            lib = ctypes.CDLL(str(self.library_path()))
            fns = {}
            for entry, argtypes in self.entries.items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                fns[entry] = fn
            self._fns = fns

    def load(self) -> float:
        """Build (if needed) and load; returns the seconds spent here."""
        if self._fns is not None:
            return 0.0
        t0 = time.perf_counter()
        self._finish(self._start())
        self.load_s = time.perf_counter() - t0
        return self.load_s

    def call(self, entry: str, *args) -> int:
        """Call the query ``entry`` (building on first use); its int."""
        self.load()
        return self._fns[entry](*args)

    def launch(self, entry: str, *args) -> None:
        """Call ``entry`` (building on first use) and raise on a CUDA error."""
        self.load()
        err = self._fns[entry](*args)
        if err != 0:
            raise RuntimeError(
                f"{entry} failed to launch: cudaError {err}")


def check_inputs(where: str, dtypes, **tensors) -> None:
    """Raise unless every tensor is a plain tensor (a DTensor's
    ``data_ptr()`` is not its local data: a kernel takes each rank's local
    tensor), lies on one CUDA device, has one of ``dtypes``, is contiguous
    and starts on a 16-byte boundary."""
    device = None
    for name, t in tensors.items():
        if hasattr(t, "placements"):
            raise TypeError(f"{where}: {name} is a DTensor; pass each rank's "
                            "local tensor (sharding.local_heads)")
        if t.device.type != "cuda":
            raise ValueError(f"{where}: {name} is on {t.device}, not a GPU")
        if device is not None and t.device != device:
            raise ValueError(f"{where}: {name} is on {t.device}, not {device}")
        device = t.device
        if t.dtype not in dtypes:
            raise TypeError(f"{where}: {name} is {t.dtype}, not one of "
                            f"{[str(d) for d in dtypes]}")
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{where}: {name} is not 16-byte aligned")


def load_all(libs) -> float:
    """Build every library at once (one ``nvcc`` each) and load them.

    Each library's :attr:`CudaLibrary.load_s` is the time from the common
    start to its own load; returns the wall time of the whole."""
    t0 = time.perf_counter()
    started = []
    try:
        for lib in libs:
            started.append(lib._start())
        for lib, st in zip(libs, started):
            if lib._fns is None:
                lib._finish(st)
                lib.load_s = time.perf_counter() - t0
    finally:
        for st in started:
            if st is not None and st[0].poll() is None:
                st[0].kill()
                st[0].wait()
    return time.perf_counter() - t0
