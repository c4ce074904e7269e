"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``yolotpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, at first use.
The library lands in ``build/yolotpu_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and the command, so a changed source
builds anew and an unchanged one loads at once. Nothing here runs at import:
the CPU tests import this module on machines with no ``nvcc``.
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
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "yolotpu_torch"
GENCODE = "arch=compute_90a,code=sm_90a"
LIB_NAME = "libyolotpu_q16.so"

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "yq16_mm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "yq16_conv3x3": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}


@dataclass(frozen=True)
class KernelLibrary:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build was reused
    log: str               # nvcc's output (ptxas register/spill report)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of yolotpu_torch cannot be built on this machine")


FLAGS = ("-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_command(nvcc: str, out: Path) -> list[str]:
    return [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(out),
            *(str(s) for s in sources())]


def source_digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library. Raises
    RuntimeError with the compiler's output when nvcc is missing or fails."""
    out_dir = BUILD_ROOT / source_digest()
    out = out_dir / LIB_NAME
    log_path = out_dir / "nvcc.log"
    seconds = 0.0
    if not out.exists():
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(nvcc_command(nvcc, Path(tmp)), capture_output=True,
                              text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)
    cdll = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(cdll=cdll, path=out, build_seconds=seconds, log=log)
