"""Device sanity checks: the board bring-up tests, GPU edition.

The counterpart of ``yolotpu/cli/tpu_check.py``. The reference ships small
board binaries (``linux_app/tests/README.md:1-29``): ``test_accel``
(register liveness + write/readback), ``test_dma`` (udmabuf alloc + phys
addr), ``test_pl_ddr`` (PL<->DDR path), ``check_hp_clocks``. Their GPU
equivalents, runnable before any model work:

  enumerate   device table (name, memory, and the int16 engine plan each
              card runs for yolov2 416: its plan file, or the default
              rule, and each conv's kind)
  alloc       256 MiB device write/readback integrity (test_dma analog)
  compute     256x256 fp32 matmul vs numpy with TF32 off, and the int16
              datapath as one launch of the mm_q16 kernel vs its plain
              version (register/datapath liveness analog)
  bandwidth   host->device and device->host transfer rates (test_pl_ddr
              analog)
  latency     launch + sync round trip

Exit code 0 iff every check passes. Every check runs on the CUDA device and
fails without one: nothing falls back to the CPU.

    python -m yolotpu_torch.cli.gpu_check [enumerate alloc ...]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to this process")
    return torch.device("cuda", torch.cuda.current_device())


def check_enumerate() -> bool:
    from ..models import engine_plan, zoo
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"  torch {torch.__version__} CUDA {torch.version.cuda} devices={n}")
    spec = zoo.build("yolov2")
    for i in range(n):
        free, total = torch.cuda.mem_get_info(i)
        print(f"    [{i}] {torch.cuda.get_device_name(i)}: "
              f"{(total - free) / 1e9:.2f} / {total / 1e9:.2f} GB in use")
        knobs = engine_plan.resolve_knobs(spec, torch.device("cuda", i))
        print(f"        int16 plan for yolov2 416: "
              f"{knobs['source'] or 'no plan file, the default rule'}; kinds "
              + ", ".join(f"{c}:{k}" for c, k in
                          engine_plan.plan(spec, knobs["plan"]).items()))
    return n > 0


def check_alloc(mb: int = 256) -> bool:
    dev = _card()
    n = mb * 1024 * 1024 // 4
    host = np.random.default_rng(0).integers(0, 2**31 - 1, n, np.int32)
    back = torch.from_numpy(host).to(dev).cpu().numpy()
    ok = np.array_equal(host, back)
    print(f"  {mb} MiB write/readback: {'OK' if ok else 'MISMATCH'}")
    return ok


def check_compute() -> bool:
    from ..ops import q16
    dev = _card()
    rng = np.random.default_rng(1)
    a = rng.standard_normal((256, 256)).astype(np.float32)
    b = rng.standard_normal((256, 256)).astype(np.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = (torch.from_numpy(a).to(dev) @ torch.from_numpy(b).to(dev)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = a @ b
    err = np.abs(got.numpy() - want).max() / max(1e-9, np.abs(want).max())
    ok = err < 1e-5
    print(f"  256x256 fp32 matmul (TF32 off) vs numpy: rel err {err:.2e} "
          f"{'OK' if ok else 'FAIL'}")
    # the int16 datapath: one launch of the mm_q16 kernel (built at first
    # use) against its plain version
    x = torch.from_numpy(rng.integers(-2048, 2048, (256, 128))
                         .astype(np.int16)).to(dev)
    w = torch.from_numpy(rng.integers(-2048, 2048, (128, 128))
                         .astype(np.int16)).to(dev)
    bias = torch.from_numpy(rng.integers(-4096, 4096, 128)
                            .astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    got = q16.mm_q16(x, w, bias, 14, True, planes=q16.pack_q16(w))
    want = q16.mm_q16_plain(x, w, bias, 14, True)
    ok2 = torch.equal(got, want)
    print(f"  mm_q16 kernel 256x128x128 int16 vs its plain version: "
          f"{'OK' if ok2 else 'FAIL'} ({time.perf_counter() - t0:.1f} s, "
          "the kernels' build included)")
    return ok and ok2


def check_bandwidth(mb: int = 128) -> bool:
    dev = _card()
    host = torch.ones(mb * 1024 * 1024 // 4)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    d = host.to(dev)
    torch.cuda.synchronize(dev)
    up = mb / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    d.cpu()
    down = mb / (time.perf_counter() - t0)
    print(f"  host->device {up:.0f} MB/s, device->host {down:.0f} MB/s "
          f"({mb} MiB, pageable host memory)")
    return True


def check_latency() -> bool:
    dev = _card()
    v = torch.zeros((), device=dev)
    (v + 1).item()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        (v + 1).item()
        ts.append(time.perf_counter() - t0)
    print(f"  launch+sync roundtrip: p50 {np.median(ts) * 1e3:.3f} ms "
          f"min {min(ts) * 1e3:.3f} ms")
    return True


CHECKS = {
    "enumerate": check_enumerate,
    "alloc": check_alloc,
    "compute": check_compute,
    "bandwidth": check_bandwidth,
    "latency": check_latency,
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="gpu_check", description=__doc__)
    ap.add_argument("checks", nargs="*", choices=list(CHECKS),
                    help="subset to run (default: all)")
    args = ap.parse_args(argv)
    names = args.checks or list(CHECKS)
    ok = True
    for name in names:
        print(f"[{name}]")
        try:
            ok &= bool(CHECKS[name]())
        except Exception as e:  # a check that cannot run fails; report why
            print(f"  EXCEPTION: {e}")
            ok = False
    print("ALL OK" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
