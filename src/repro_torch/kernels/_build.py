"""Build and load the port's CUDA kernels.

Every ``kernels/csrc/*.cu`` source is compiled by its own ``nvcc`` process,
all started together, with its own flags (:data:`SOURCE_FLAGS`), and the
objects are linked into one shared library with a plain C interface, loaded
with ``ctypes``.  No PyTorch headers are involved, so the build takes
seconds.  It runs at first use, into
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
under a name keyed by a hash of the sources, the shared headers
(``csrc/*.cuh``) and every source's flags, so an edited source, header or
flag is rebuilt and a stale library is never loaded.  Nothing is built when
this module is imported.

:func:`launch` is the one launch path of the kernels: it calls a library
entry on the current stream of the tensor's card, raises on a refused
launch and counts an accepted one in :data:`COUNTS`, the one registry of
the kernels' counts: kernel ``name``'s launches under ``name + "s"``, the
:data:`EVENTS` by :func:`count`.  Its keys, each at 0 from import, are the
names the ``exec/chunk`` spans carry (``obs.trace.Tracer.counters``).

The plane kernels are bitwise equal to their plain versions only without
FMA contraction (``-fmad=false``); the flash-attention kernels (forward
and backward) and the split-TF32 GEMM are held to a tolerance, so they are
built with contraction on (the flash forward split across the CPUs) and
with ``-Xptxas -v``, whose report (registers, spills, shared memory per
kernel) is kept in ``build.ptxas`` and beside the library.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import json
import os
import re
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
COMMON_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")
DEFAULT_FLAGS = ("-fmad=false",)
# the flash source's nine instantiations (bf16 / f16 wgmma and float32
# split TF32, at three head dims) are compiled in parallel inside its nvcc
# (-split-compile=0: one job per CPU)
SOURCE_FLAGS = {"flash_attention.cu": ("-fmad=true", "-split-compile=0",
                                       "-Xptxas", "-v"),
                "flash_attention_bwd.cu": ("-fmad=true", "-Xptxas", "-v"),
                "split_gemm.cu": ("-fmad=true", "-Xptxas", "-v")}


def source_flags(src: Path) -> tuple:
    """The nvcc flags of one source: the common ones and its own."""
    return (*COMMON_FLAGS, *SOURCE_FLAGS.get(src.name, DEFAULT_FLAGS))


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
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(" ".join(source_flags(src)).encode())
        h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if it is not built yet; returns its path.
    The seconds each ``nvcc`` took are kept in ``build.seconds``, ptxas's
    report in ``build.ptxas``."""
    sources = _sources()
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest(sources)}.so"
    report = lib.with_suffix(".ptxas.json")
    if lib.exists():
        if report.exists():
            build.ptxas = json.loads(report.read_text())
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
            runs = list(pool.map(
                _run, [[nvcc, *source_flags(src), "-c", "-o", obj, str(src)]
                       for src, obj in zip(sources, objs)]))
        so = str(Path(tmp) / lib.name)
        runs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]))
        ptxas = {}
        for _, text in runs:
            ptxas.update(parse_ptxas(text))
        report.write_text(json.dumps(ptxas, indent=1))
        os.replace(so, lib)
    build.seconds = dict(zip([s.name for s in sources] + ["link"],
                             [secs for secs, _ in runs]))
    build.ptxas = ptxas
    return lib


build.seconds = {}
build.ptxas = {}


def _run(cmd) -> tuple[float, str]:
    """Run one nvcc command; returns its seconds and its output, raises with
    the output if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    return time.perf_counter() - t0, proc.stdout + proc.stderr


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_NAMED = re.compile(r"function '(\S+?)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_USED = re.compile(r"ptxas info\s*: Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(text: str) -> dict:
    """``-Xptxas -v`` output as ``{kernel: {"registers", "spill_stores",
    "spill_loads", "stack", "smem", "warnings"}}``; the kernels' mangled
    names are kept.  A warning or a performance note (``(C7...)``) goes to
    the kernel it names, else to the one it follows, else to ``""``."""
    out, name = {}, ""
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out.setdefault(name, {"warnings": []})
            continue
        named = _NAMED.search(line)
        rec = out.setdefault(named.group(1) if named else name,
                             {"warnings": []})
        m = _SPILLS.search(line)
        if m:
            rec.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            smem = _SMEM.search(line)
            rec.update(registers=int(m.group(1)),
                       smem=int(smem.group(1)) if smem else 0)
        if "warning" in line.lower() or "(C7" in line:
            rec["warnings"].append(line.strip())
    if out.get("") == {"warnings": []}:
        del out[""]
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    vp = ctypes.c_void_p
    fn = lib.repro_fused_local_update
    fn.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int64, vp]
    fn.restype = ctypes.c_int
    lib.repro_fused_table_bytes.argtypes = []
    lib.repro_fused_table_bytes.restype = ctypes.c_int
    fn = lib.repro_threshold_select
    fn.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int64, ctypes.c_int64,
                   vp]
    fn.restype = ctypes.c_int
    fn = lib.repro_quantize
    fn.argtypes = [ctypes.c_int, vp, vp, vp, vp, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    for fn in (lib.repro_weighted_commit, lib.repro_weighted_commit_loads):
        fn.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp, vp, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, vp]
        fn.restype = ctypes.c_int
    fn = lib.repro_flash_attention
    fn.argtypes = ([ctypes.c_int, vp, vp, vp, vp, vp] + [ctypes.c_int64] * 12
                   + [ctypes.c_int] * 7 + [ctypes.c_double] * 2 + [vp])
    fn.restype = ctypes.c_int
    fn = lib.repro_flash_attention_bwd
    fn.argtypes = ([vp] * 10 + [ctypes.c_int] * 7 + [ctypes.c_double] * 2
                   + [vp])
    fn.restype = ctypes.c_int
    fn = lib.repro_flash_tile_plan
    fn.argtypes = [ctypes.c_int] * 4 + [vp] * 3
    fn.restype = ctypes.c_int
    fn = lib.repro_split_gemm
    fn.argtypes = ([vp] * 3 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 8
                   + [ctypes.c_int] * 2 + [vp])
    fn.restype = ctypes.c_int
    return lib


#: the kernels :func:`launch` takes, by the name it is given, each launched
#: through the entry ``repro_<name>`` that :func:`load_library` declares
#: (its tile-plan and table-size queries launch nothing)
KERNELS = ("fused_local_update", "threshold_select", "quantize",
           "weighted_commit", "flash_attention", "flash_attention_bwd",
           "split_gemm")
#: the events that are not launches: the split GEMM's launches as ``C^T``
#: (``gemm.transposed``), the operands two wrappers copied before a launch
EVENTS = ("split_gemms_transposed", "split_gemm_copies",
          "fused_local_update_copies")
#: the launches (``name + "s"``) and events counted since import
COUNTS = collections.Counter(
    dict.fromkeys([name + "s" for name in KERNELS] + list(EVENTS), 0))


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to the event ``key`` of :data:`COUNTS` (one of
    :data:`EVENTS`); raises on any other key."""
    if key not in EVENTS:
        raise KeyError(f"{key!r} is not a counted event: {EVENTS}")
    COUNTS[key] += n


def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed`` ``DTensor`` (without
    importing ``torch.distributed`` when it is not loaded)."""
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def on_card(name: str, t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises, and so does a CUDA
    ``DTensor``: the kernels launch from raw pointers, so a placed tensor
    must be unwrapped to its local shard before it reaches one."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {t.device}")
    if is_dtensor(t):
        raise TypeError(f"the {name} kernel takes local tensors: unwrap the "
                        "DTensor to its shard (to_local) first")
    return True


def untracked(name: str, ts) -> None:
    """For a kernel's vmap rule that runs its Function's forward itself,
    which records nothing for autograd: right inside ``torch.func.grad``
    (which differentiates the Function from outside the rule), wrong where
    autograd would have to see through the rule (``backward()`` of a
    vmapped call, ``grad`` of ``vmap``).  Raises there rather than lose
    the gradient."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} under vmap is differentiable only by torch.func.grad / "
            f"vjp inside the vmap (vmap(grad(f))); an input here requires "
            f"grad from outside it")


def stream_handle(index: int) -> int:
    """The raw handle of the current CUDA stream on card ``index``."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


def launch(name: str, entry, device, *args, errors=None) -> None:
    """Call the library function ``entry`` of kernel ``name`` (one of
    :data:`KERNELS`, else it raises first) with ``args`` and the current
    stream of ``device``, entering that card's context only when it is not
    the current one; raises if the entry returns a nonzero (refused) launch
    code, with the message ``errors`` gives for that code if any, else
    counts the launch in :data:`COUNTS`.  No device work besides it."""
    import torch

    if name not in KERNELS:
        raise KeyError(f"{name!r} is not a counted kernel: {KERNELS}")
    index = device.index
    if index == torch.cuda.current_device():
        err = entry(*args, stream_handle(index))
    else:
        with torch.cuda.device(index):
            err = entry(*args, stream_handle(index))
    if err != 0:
        if errors and err in errors:
            raise RuntimeError(f"{name} kernel: {errors[err]}")
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    COUNTS[name + "s"] += 1
