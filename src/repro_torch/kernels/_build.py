"""Build and load the port's CUDA kernels.

Every ``kernels/csrc/*.cu`` source is compiled by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  No PyTorch headers are
involved, so the build takes seconds.  It runs at first use, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
under a name keyed by a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  Nothing is built when this
module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FALLBACK_NVCC = Path("/usr/local/cuda/bin/nvcc")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(FALLBACK_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path.
    The seconds each ``nvcc`` took are kept in ``build.seconds``."""
    sources = _sources()
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest(sources)}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory and rename the library into place: a
    # concurrent process never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        # one nvcc per source, all at once: the build takes as long as the
        # slowest source, not the sum
        with ThreadPoolExecutor(len(sources)) as pool:
            secs = list(pool.map(
                _run, [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                       for src, obj in zip(sources, objs)]))
        so = str(Path(tmp) / lib.name)
        secs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]))
        os.replace(so, lib)
    build.seconds = dict(zip([s.name for s in sources] + ["link"], secs))
    return lib


build.seconds = {}


def _run(cmd) -> float:
    """Run one nvcc command; returns its seconds, raises with its output if
    it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    vp = ctypes.c_void_p
    fn = lib.repro_fused_local_update
    fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, vp, ctypes.c_int64,
                   ctypes.c_double, ctypes.c_double, vp]
    fn.restype = ctypes.c_int
    fn = lib.repro_threshold_select
    fn.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int64, ctypes.c_int64,
                   vp]
    fn.restype = ctypes.c_int
    fn = lib.repro_quantize
    fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    fn = lib.repro_weighted_commit
    fn.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int64, ctypes.c_int64,
                   vp]
    fn.restype = ctypes.c_int
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_int, vp, vp, vp, vp] + [ctypes.c_int64] * 12
                   + [ctypes.c_int] * 7 + [ctypes.c_double] * 2 + [vp])
    fn.restype = ctypes.c_int
    return lib
