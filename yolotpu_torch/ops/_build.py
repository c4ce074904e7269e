"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``yolotpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one process per source, all started together, and the objects
are linked into one shared library with a plain C interface, at first use.
The library lands in ``build/yolotpu_torch/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and the command, so a changed source
builds anew and an unchanged one loads at once. Nothing here runs at import:
the CPU tests import this module on machines with no ``nvcc``. ``launch``
calls an entry point and counts the launch.
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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "yolotpu_torch"
GENCODE = "arch=compute_90a,code=sm_90a"
LIB_NAME = "libyolotpu_q16.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    "yq16_mm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "yq16_conv3x3": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "yq_tc_config": (_I, _I),
    "yq16_conv3x3_pool": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P),
    "yq8_mm_s8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "yq8_mm_w8a16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "yq8_conv3x3_s8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "yq8_conv3x3_w8a16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    "yq8_conv3x3_pool_s8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P),
    "yq_nms_greedy": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "yq16_conv": (_P, _P, _P, _P, _P, *(_I,) * 15, _P),
    "yq16_conv_config": (_I, _I, _I),
    "yq8_conv_s8": (_P, _P, _P, _P, _P, _P, *(_I,) * 15, _P),
    "yq8_conv_s8_config": (_I, _I, _I),
    "yq8_conv_w8a16": (_P, _P, _P, _P, _P, _P, *(_I,) * 14, _P),
    "yq8_conv_w8a16_config": (_I, _I, _I),
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


FLAGS = ("-gencode", GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas=-v")


def nvcc_commands(nvcc: str, out: Path) -> tuple[list[list[str]], list[str]]:
    """One compile command per source, objects beside ``out``, then the
    command that links them into the shared library ``out``."""
    objs = [out.parent / f"{s.stem}.o" for s in sources()]
    compiles = [[nvcc, *FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(s)]
                for s, o in zip(sources(), objs)]
    link = [nvcc, "-gencode", GENCODE, "-shared", "-o", str(out),
            *(str(o) for o in objs)]
    return compiles, link


def _run_all(cmds: list[list[str]]) -> tuple[int, str]:
    """Run the commands together; the first non-zero exit code (0 if none)
    and their output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    rc = next((p.returncode for p in procs if p.returncode), 0)
    return rc, "".join(outs)


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
        tmp = Path(tempfile.mkdtemp(dir=out_dir))
        compiles, link = nvcc_commands(nvcc, tmp / LIB_NAME)
        t0 = time.perf_counter()
        rc, log = _run_all(compiles)
        if rc == 0:
            rc, link_log = _run_all([link])
            log += link_log
        seconds = time.perf_counter() - t0
        if rc != 0:
            shutil.rmtree(tmp)
            raise RuntimeError(f"nvcc failed (exit {rc}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp / LIB_NAME, out)
        shutil.rmtree(tmp)
    cdll = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(cdll=cdll, path=out, build_seconds=seconds, log=log)


def check_rows(name: str, m: int) -> None:
    """Raise unless M (the output rows) fits the entry points' C int."""
    if m >= 1 << 31:
        raise ValueError(f"{name}: M={m} does not fit the kernel's int")


def launch(name: str, fn: str, out: torch.Tensor, *args,
           counts: dict) -> torch.Tensor:
    """Call C entry point ``fn`` with ``args`` and the current stream of
    ``out``'s device, raise on a CUDA error, and count one launch of
    ``name`` in ``counts``."""
    lib = load_library()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = getattr(lib.cdll, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    counts[name] += 1
    return out
