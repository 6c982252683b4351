"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc`` per
source, all started together), linked into one shared library with a plain C
interface under ``build/repro_torch/`` at the repository root, and loaded with
ctypes.  The library's name carries a hash of the sources and flags, so an edit
to any source rebuilds it.  Nothing is built at import time, and there is no
fallback: a missing ``nvcc`` or a failed build raises.

This module also holds the launch counters: each kernel wrapper adds one to its
entry of :data:`LAUNCHES` when it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: libcuda, for cuTensorMapEncodeTiled (K4's TMA descriptors); nvcc links against
#: the toolkit's stub, and the installed libcuda.so.1 is loaded at run time
LINK_FLAGS = ["-lcuda"]

#: dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

#: Kernel launches since the last :func:`reset_launches`, by kernel name.  K1's
#: generated kernels (``codegen.py``) count under ``fused_map`` / ``fused_reduce``,
#: and each by its generated name in :data:`FUSED_LAUNCHES`.
LAUNCHES: dict[str, int] = {
    "rmsnorm_fwd": 0, "rmsnorm_bwd": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0,
    "ssd_scan_fwd": 0, "fused_map": 0, "fused_reduce": 0,
}
#: K1 launches since the last :func:`reset_launches`, by generated kernel name.
FUSED_LAUNCHES: dict[str, int] = {}
#: K2 launches since the last :func:`reset_launches`, by the route that took them
#: (``kernels/rmsnorm.py``: ``ROUTES``); they sum to ``LAUNCHES["rmsnorm_fwd"]``.
K2_ROUTES: dict[str, int] = {}
#: attention backward calls since the last :func:`reset_launches`, by route
#: (``kernels/ops.py``: ``attn_bwd_route``): ``"kernel"`` calls are the ones counted
#: in ``LAUNCHES["flash_attention_bwd"]``, ``"chunked"`` the plain chunked backward's.
ATTN_BWD_ROUTES: dict[str, int] = {"kernel": 0, "chunked": 0}

_LIB: ctypes.CDLL | None = None
#: Seconds the last build took in this process (None: loaded a cached library).
build_seconds: float | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    FUSED_LAUNCHES.clear()
    K2_ROUTES.clear()
    for route in ATTN_BWD_ROUTES:
        ATTN_BWD_ROUTES[route] = 0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{source_hash()}.so"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin, $CUDA_PATH/bin and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile and link the library if it is not built yet; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
            objs.append(obj)
        log, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / f"nvcc_{source_hash()}.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib), *LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    build_seconds = time.monotonic() - t0
    return out


def build_log() -> str:
    """nvcc's output for the current sources (ptxas register and shared-memory use)."""
    path = BUILD_DIR / f"nvcc_{source_hash()}.log"
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with its C signatures set."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rmsnorm_fwd.argtypes = [p, p, p, ctypes.c_longlong, i, i, f, p]
        lib.rmsnorm_fwd.restype = i
        lib.rmsnorm_fwd_on_route.argtypes = [p, p, p, ctypes.c_longlong, i, i, f, i, p]
        lib.rmsnorm_fwd_on_route.restype = i
        lib.rmsnorm_bwd.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, f, p]
        lib.rmsnorm_bwd.restype = i
        lib.rmsnorm_bwd_blocks.argtypes = [i, i]
        lib.rmsnorm_bwd_blocks.restype = i
        lib.rmsnorm_bwd_max_width.argtypes = []
        lib.rmsnorm_bwd_max_width.restype = i
        lib.flash_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_fwd_smem.argtypes = [i, i]
        lib.flash_attention_fwd_smem.restype = ctypes.c_longlong
        lib.flash_attention_bwd.argtypes = [p] * 13 + [i] * 9 + [f, p]
        lib.flash_attention_bwd.restype = i
        lib.ssd_scan_fwd.argtypes = [p] * 10 + [i] * 9 + [p]
        lib.ssd_scan_fwd.restype = i
        lib.ssd_scan_fwd_smem.argtypes = [i, i, i, i]
        lib.ssd_scan_fwd_smem.restype = ctypes.c_longlong
        lib.ssd_scan_fwd_chunk.argtypes = [i]
        lib.ssd_scan_fwd_chunk.restype = i
        _LIB = lib
    return _LIB
