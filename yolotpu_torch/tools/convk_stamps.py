"""Where a K step of the general convs' kernel spends its clocks, on the card.

Builds a copy of the package under ``build/convk_stamps/`` (the checkout's
gitignored build directory) whose ``csrc/convk_tc.cuh`` records
``clock64()`` at the phases of block 0's K steps: on its first consumer
thread the wait for the stage, ldmatrix and the byte split, the wgmma issue,
the wgmma wait and the release; on its first producer thread the wait for a
free stage, the B copy, the A gather and the cursor. It runs ``conv_q16``
(scheme Q16), or with ``--kernel conv_s8`` ``conv_s8`` (S8, int8 output),
there at yolov2-s2's strided shapes (at batch 1 one block per output tile,
so a block runs alone on its SM; at batch 8 the wrapper's own plan) and
prints each phase's median in clocks, with the card's name and power limit.
The package's own kernel is not changed.

    python -m yolotpu_torch.tools.convk_stamps [--kernel conv_q16|conv_s8]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)

# (anchor, what goes after it) in csrc/convk_tc.cuh
CONSUMER = "const bool rec = blockIdx.x == 0 && ct == 0 && j < 256;"
PRODUCER = "const bool rec = blockIdx.x == 0 && wt == 0 && j < 256;"
STAMPS = (
    ("namespace yq {\nnamespace convk {\n",
     "__device__ long long g_stamps[2][256][8];\n"),
    ("        for (int j = 0; j < nunits; ++j) {\n",
     f"            {PRODUCER}\n"
     "            if (rec) g_stamps[1][j][0] = clock64();\n"),
    ("            if (j >= STAGES) mbar_wait(empty + slot, (j / STAGES - 1) & 1);\n",
     "            if (rec) g_stamps[1][j][1] = clock64();\n"),
    ("            ld.load(p, sA + slot * T::A_STAGE, wt, full + slot);\n",
     "            if (rec) g_stamps[1][j][3] = clock64();\n"),
    ("                if (j + 1 < nunits) ld.seek(p, mt * BM, M, wt, 0);\n            }\n",
     "            if (rec) g_stamps[1][j][4] = clock64();\n"),
    ("        for (int step = kt; step < kend; ++step, ++j) {\n",
     f"            {CONSUMER}\n"
     "            if (rec) g_stamps[0][j][0] = clock64();\n"),
    ("            mbar_wait(full + slot, (j / STAGES) & 1);\n",
     "            if (rec) g_stamps[0][j][1] = clock64();\n"),
    ("            tc::wgmma_commit();\n",
     "            if (rec) g_stamps[0][j][3] = clock64();\n"),
    ("            tc::wgmma_wait_all();\n",
     "            if (rec) g_stamps[0][j][4] = clock64();\n"),
    ("            if (lane == 0) mbar_arrive(empty + slot);\n",
     "            if (rec) g_stamps[0][j][5] = clock64();\n"),
)
# stamps just before an anchor: the B copy's start on the producer, and the
# wgmma fence (the end of ldmatrix and the byte split) on the consumer
BEFORE = (
    ("            ld.load(p, sA + slot * T::A_STAGE, wt, full + slot);\n",
     "            if (rec) g_stamps[1][j][2] = clock64();\n"),
    ("            tc::wgmma_fence();\n#pragma unroll\n            for (int kc = 0; kc < KC; ++kc) {\n"
     "                if constexpr (S::SETS == 3) {",
     "            if (rec) g_stamps[0][j][2] = clock64();\n"),
)
# the reader copies the stamps out and zeroes them, so that each shape's
# K steps are its own
READ = '''
extern "C" int yq_stamps_read(void* dst) {
    static long long zeros[2][256][8];
    cudaDeviceSynchronize();
    const int err = (int)cudaMemcpyFromSymbol(dst, yq::convk::g_stamps, sizeof(zeros));
    return err ? err : (int)cudaMemcpyToSymbol(yq::convk::g_stamps, zeros, sizeof(zeros));
}
'''
# kernel -> the source of its C entry point, where the reader goes
KERNELS = {"conv_q16": "conv_q16.cu", "conv_s8": "conv_s8.cu"}
# the measurement, run in the copy (so that ``yolotpu_torch`` is the copy),
# of the kernel named by its argument
MEASURE = r'''
import ctypes, subprocess, sys
import numpy as np, torch
from yolotpu_torch.ops import _build, q8, q16, tc
kernel = sys.argv[1]
lib = _build.load_library().cdll
lib.yq_stamps_read.argtypes = (ctypes.c_void_p,)
dev = torch.device("cuda", 0)
rng = np.random.default_rng(0)
plan = tc.stream_k
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
for b, h, c in ((1, 26, 512), (1, 52, 256), (8, 208, 64), (8, 26, 512),
                (8, 416, 32)):
    t = np.int8 if kernel == "conv_s8" else np.int16
    x = torch.from_numpy(rng.integers(np.iinfo(t).min, np.iinfo(t).max + 1, (b, h, h, c)).astype(t)).to(dev)
    w = torch.from_numpy(rng.integers(np.iinfo(t).min, np.iinfo(t).max + 1, (3, 3, c, c)).astype(t)).to(dev)
    bias = torch.zeros(c, dtype=torch.int32, device=dev)
    if kernel == "conv_s8":
        planes, shift = q8.pack_s8(w), torch.full((c,), 12, dtype=torch.int32, device=dev)
        run = lambda: q8.conv_s8(x, w, bias, shift, True, 2, 1, planes=planes)
    else:
        planes = q16.pack_q16(w)
        run = lambda: q16.conv_q16(x, w, bias, 16, True, 2, 1, planes=planes)
    alone = b == 1
    if alone:   # one block per output tile
        tc.stream_k = lambda *a: (lambda p: tc.StreamK(
            p.bm, p.bn, p.ktiles, p.tiles, p.tiles, p.kchunk, p.ktiles))(plan(*a))
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    tc.stream_k = plan
    buf = np.zeros((2, 256, 8), np.int64)
    lib.yq_stamps_read(buf.ctypes.data)
    n = int((buf[0, :, 0] > 0).sum())
    c_, p_ = buf[0, :n], buf[1, :n]
    dc, dp = np.diff(c_[:, :6], axis=1), np.diff(p_[:, :5], axis=1)
    med = lambda v: f"{np.median(v):.0f}"
    print(f"{kernel} b={b} {h}x{h}x{c}->{c} 3x3/s2 ({'one block per tile' if alone else 'the wrapper plan'}), "
          f"{n} K steps of block 0: consumer {med(np.diff(c_[:, 0]))} clocks a step (wait "
          f"{med(dc[:, 0])}, ldmatrix (and byte split) {med(dc[:, 1])}, wgmma issue "
          f"{med(dc[:, 2])}, wgmma wait {med(dc[:, 3])}, release {med(dc[:, 4])}); producer "
          f"{med(np.diff(p_[:, 0]))} a stage (wait for a free stage {med(dp[:, 0])}, B copy "
          f"{med(dp[:, 1])}, A gather {med(dp[:, 2])}, cursor {med(dp[:, 3])})", flush=True)
'''


def instrument(src: str) -> str:
    """csrc/convk_tc.cuh with the clock64 stamps; raises if an anchor is
    missing (the kernel changed under the tool)."""
    for anchor, text in BEFORE:
        if anchor not in src:
            raise ValueError(f"convk_stamps: anchor not found: {anchor!r}")
        src = src.replace(anchor, text + anchor, 1)
    for anchor, text in STAMPS:
        if anchor not in src:
            raise ValueError(f"convk_stamps: anchor not found: {anchor!r}")
        src = src.replace(anchor, anchor + text, 1)
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="convk_stamps", description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="conv_q16")
    kernel = ap.parse_args(argv).kernel
    import torch
    if not torch.cuda.is_available():
        print("convk_stamps: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    copy = os.path.join(ROOT, "build", "convk_stamps")
    pkg = os.path.join(copy, "yolotpu_torch")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(pkg, "csrc")
    with open(os.path.join(csrc, "convk_tc.cuh")) as f:
        header = instrument(f.read())
    with open(os.path.join(csrc, "convk_tc.cuh"), "w") as f:
        f.write(header)
    with open(os.path.join(csrc, KERNELS[kernel]), "a") as f:
        f.write(READ)
    return subprocess.run([sys.executable, "-c", MEASURE, kernel], cwd=copy,
                          env={**os.environ, "PYTHONPATH": copy}).returncode


if __name__ == "__main__":
    sys.exit(main())
