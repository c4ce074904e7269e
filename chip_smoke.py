"""Smoke run of the PyTorch/CUDA port (``yolotpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

It builds the hand-written kernels from ``yolotpu_torch/csrc/`` with nvcc
for ``sm_90a`` and drives the port's main path, YOLOv2 at 416x416 in the
int16-exact tier with synthetic weights from seed 0, in four phases:

1. card: name and power limit, torch and CUDA versions, kernel build time;
2. kernels: each kernel against its plain PyTorch version on the card at
   all 23 yolov2 conv shapes (batch 2) and at edge cases (shift extremes,
   sums built to wrap, weights and inputs at the int16 limits, C=3, N=425,
   ragged M), compared with ``torch.equal``, with both times from CUDA
   events; every case keeps most outputs unsaturated, so they depend on the
   sums;
3. slice: ``Engine.detect`` on three frames and ``predict_batch_rgb`` at
   batch 8, the kernel launches of that run counted, the head held bit-equal
   to the plain versions on the card and on the CPU, and the ms per batch
   and batch-1 latency;
4. profile: each conv alone at batch 8 and 1 (CUDA events), the forward's
   device time by kernel against its time per forward (torch.profiler),
   and the SM clock and power draw sampled beside them.

Any failed check raises, so the exit code is not 0. The line before the
last is a JSON record of the kernels; the last is
``{"ok": true, "device": {...}}``. JAX is blocked from import for the whole
run: the port must not need it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.modules["jax"] = None   # any import of JAX now fails

import numpy as np  # noqa: E402
import torch  # noqa: E402

from yolotpu.models import zoo  # noqa: E402
from yolotpu.names import names_for  # noqa: E402
from yolotpu.quant import calibrate_activations, quantize_weights  # noqa: E402
from yolotpu.weights import WeightStore  # noqa: E402
from yolotpu_torch.models import engine_plan  # noqa: E402
from yolotpu_torch.models.yolov2 import YoloV2Int16  # noqa: E402
from yolotpu_torch.ops import _build, q16  # noqa: E402
from yolotpu_torch.runtime.engine import Engine  # noqa: E402

BATCH_SHAPES = 2
BATCH_SLICE = 8
SHIFTS = (-3, 0, 1, 7, 31, 40)
FULL_SHIFT = 16      # full-range sums wrap to ~uniform int32; >>16 spans int16
NARROW_SHIFT = 3
UNSAT_FLOOR = 0.5    # least share of unsaturated outputs in any case
WRAP_FLOOR = 0.1     # least share of unsaturated outputs whose sum wrapped
WRAP_BLOCK = 512     # 512 products (-32768)*(-32768) = 2^39, a multiple of 2^32
EXT = np.array([-32768, -32767, 32767])
KERNEL_SOURCES = {
    "mm_q16": ("yolotpu_torch/csrc/mm_q16.cu", "yolotpu/ops/pallas_q16.py:1691"),
    "conv3x3_q16": ("yolotpu_torch/csrc/conv3x3_q16.cu",
                    "yolotpu/ops/pallas_q16.py:675"),
}


class PlainYoloV2Int16(YoloV2Int16):
    """The same network with every conv through its kernel's plain PyTorch
    version, whatever the device: the reference the kernel path is held
    against on the card."""
    mm = staticmethod(q16.mm_q16_plain)
    conv3 = staticmethod(q16.conv3x3_q16_plain)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps launches, after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class KernelCheck:
    """Runs a kernel and its plain version on the same card inputs, holds
    them equal, and keeps the worst disagreement and the per-layer times.

    Each case must leave at least UNSAT_FLOOR of its outputs unsaturated,
    so that they depend on the sums and not on the bias alone; a case built
    to wrap must also show at least WRAP_FLOOR of its outputs unsaturated
    with an exact sum outside int32."""

    def __init__(self) -> None:
        self.max_abs_err = {k: 0 for k in KERNEL_SOURCES}
        self.ms = {k: 0.0 for k in KERNEL_SOURCES}
        self.plain_ms = {k: 0.0 for k in KERNEL_SOURCES}

    def compare(self, name: str, label: str, args: tuple, wraps: bool = False,
                timed: bool = False) -> None:
        kernel = getattr(q16, name)
        plain = getattr(q16, name + "_plain")
        got = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {label}: kernel != plain "
                                 f"(max abs err {err})")
        x, w, _, _, leaky = args
        sat = (want == 32767) | (want == -32768)
        if leaky:
            sat |= want == -3276            # -32768 through the leaky
        unsat = float((~sat).float().mean())
        exact = (q16.mm_sum64 if name == "mm_q16" else q16.conv3x3_sum64)(x, w)
        wrapped = float(((exact.abs() >= 2.0 ** 31) & ~sat).float().mean())
        if unsat < UNSAT_FLOOR or (wraps and wrapped < WRAP_FLOOR):
            raise AssertionError(
                f"{name} {label}: blind case, {unsat:.3f} of the outputs "
                f"unsaturated, {wrapped:.3f} unsaturated with a wrapped sum")
        if not timed:
            return
        k_ms = cuda_ms(lambda: kernel(*args), reps=10)
        p_ms = cuda_ms(lambda: plain(*args), reps=3)
        self.ms[name] += k_ms
        self.plain_ms[name] += p_ms
        say(f"  {name:12s} {label:36s} equal, unsat {unsat:.3f} wrapped "
            f"{wrapped:.3f}  kernel {k_ms:8.3f} ms  plain {p_ms:8.3f} ms")


def span(shift: int, k: int) -> int:
    """Operand bound r such that K products of two uniform [-r, r] draws
    (a sum with standard deviation sqrt(K) r^2 / 3), requantized by shift,
    span about +-2^13 in the output Q; capped at the int16 range."""
    m = min(shift, 30) if shift > 0 else shift
    return int(min(32767, max(1, (3 * 2.0 ** (13 + m) / k ** 0.5) ** 0.5)))


def small_bias(rng, n: int) -> np.ndarray:
    return rng.integers(-2**14, 2**14, n).astype(np.int32)


def narrow_operands(rng, xshape, wshape, shift: int):
    """x, w uniform in +-span(shift, K), with one row of x and one column
    of w at the int16 extremes; bias in +-2^14."""
    r = span(shift, int(np.prod(wshape[:-1])))
    x = rng.integers(-r, r + 1, xshape)
    w = rng.integers(-r, r + 1, wshape)
    x.reshape(-1, xshape[-1])[0] = rng.choice(EXT, xshape[-1])
    w[..., 0] = rng.choice(EXT, wshape[:-1])
    return x.astype(np.int16), w.astype(np.int16), small_bias(rng, wshape[-1])


def wrap_operands(rng, rows: int, taps: int, n: int, shift: int, nblk: int,
                  npair: int = 8, ns: int = 37):
    """x (rows, C), w (taps, C, N) whose exact sums reach 2^40 but wrap to
    small values, with C = nblk*WRAP_BLOCK + 2*npair + ns in shuffled order:

    - each block of WRAP_BLOCK channels is -32768 or 0 in x (per row) and in
      w (per tap and column), so it adds a multiple of 2^32 to a sum;
    - each pair of channels holds (v, -v) in x and (u, u) in w with v and u
      at +-32767, so it adds two products near 2^30 that cancel;
    - the last ns channels are uniform in +-span(shift, taps*ns)."""
    c = nblk * WRAP_BLOCK + 2 * npair + ns
    x = np.zeros((rows, c), np.int64)
    w = np.zeros((taps, c, n), np.int64)
    for i in range(nblk):
        blk = slice(i * WRAP_BLOCK, (i + 1) * WRAP_BLOCK)
        x[:, blk] = np.where(rng.random((rows, 1)) < 0.5, -32768, 0)
        w[:, blk] = np.where(rng.random((taps, 1, n)) < 0.5, -32768, 0)
    p = nblk * WRAP_BLOCK
    v = rng.choice([-32767, 32767], (rows, npair))
    u = rng.choice([-32767, 32767], (taps, npair, n))
    x[:, p:p + npair], x[:, p + npair:p + 2 * npair] = v, -v
    w[:, p:p + npair], w[:, p + npair:p + 2 * npair] = u, u
    r = span(shift, taps * ns)
    x[:, p + 2 * npair:] = rng.integers(-r, r + 1, (rows, ns))
    w[:, p + 2 * npair:] = rng.integers(-r, r + 1, (taps, ns, n))
    perm = rng.permutation(c)
    return (x[:, perm].astype(np.int16), w[:, perm].astype(np.int16),
            small_bias(rng, n))


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(f"[card] {smi}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.load_library()
    say(f"[card] kernels loaded from {os.path.relpath(lib.path)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s)")
    for line in lib.log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            say(f"[card]   {line.strip()}")
    return smi


def phase_kernels(check: KernelCheck, dev: torch.device) -> None:
    def on(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    rng = np.random.default_rng(0)
    say(f"[kernels] yolov2 416x416 conv shapes at batch {BATCH_SHAPES}: "
        f"full-range operands at shift {FULL_SHIFT} (the sums wrap), then "
        f"narrow ones at shift {NARROW_SHIFT} (the low bits show)")
    spec = zoo.build("yolov2")
    for l in spec.conv_layers():
        if engine_plan.select_engine(l) == "mm":
            name = "mm_q16"
            xshape, wshape = (BATCH_SHAPES * l.h * l.w, l.c), (l.c, l.n)
        else:
            name = "conv3x3_q16"
            xshape, wshape = (BATCH_SHAPES, l.h, l.w, l.c), (3, 3, l.c, l.n)
        leaky = l.activation == "leaky"
        label = f"conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n} {l.activation}"
        x, w, b = on(rng.integers(-32768, 32768, xshape).astype(np.int16),
                     rng.integers(-32768, 32768, wshape).astype(np.int16),
                     small_bias(rng, l.n))
        check.compare(name, label, (x, w, b, FULL_SHIFT, leaky), wraps=True,
                      timed=True)
        x, w, b = on(*narrow_operands(rng, xshape, wshape, NARROW_SHIFT))
        check.compare(name, label + " narrow", (x, w, b, NARROW_SHIFT, leaky))

    say(f"[kernels] edge cases: shifts {SHIFTS} x leaky on/off; sums built "
        "to wrap, weights and inputs at -32768 and +-32767, C=3, N=425, "
        "ragged M, K and C")
    cases = 0
    for shift in SHIFTS:
        for leaky in (False, True):
            # mm: M=1000 (not a multiple of any tile), K=2101, N=425
            x, w, b = on(*wrap_operands(rng, 1000, 1, 425, shift, nblk=4))
            check.compare("mm_q16", f"wrap shift={shift} leaky={leaky}",
                          (x, w[0], b, shift, leaky), wraps=True)
            x, w, b = on(*narrow_operands(rng, (333, 72), (72, 64), shift))
            check.compare("mm_q16", f"narrow shift={shift} leaky={leaky}",
                          (x, w, b, shift, leaky))
            # conv: C=1061 built to wrap, then C=3 with N=425, and C=N=16
            x, w, b = on(*wrap_operands(rng, 2 * 9 * 7, 9, 70, shift, nblk=2))
            c = x.shape[-1]
            check.compare("conv3x3_q16",
                          f"wrap 2x9x7x{c}->70 shift={shift} leaky={leaky}",
                          (x.reshape(2, 9, 7, c), w.reshape(3, 3, c, 70), b,
                           shift, leaky), wraps=True)
            for (bb, h, wd, c, n) in ((1, 13, 11, 3, 425), (1, 5, 3, 16, 16)):
                x, w, b = on(*narrow_operands(rng, (bb, h, wd, c), (3, 3, c, n),
                                              shift))
                check.compare("conv3x3_q16",
                              f"{bb}x{h}x{wd}x{c}->{n} shift={shift} leaky={leaky}",
                              (x, w, b, shift, leaky))
            cases += 5
    say(f"[kernels] {cases} edge cases equal, each with at least "
        f"{UNSAT_FLOOR} of its outputs unsaturated, and {WRAP_FLOOR} "
        "unsaturated with a wrapped sum where built to wrap")


def phase_slice(dev: torch.device) -> dict:
    spec = zoo.build("yolov2")
    store = WeightStore.synthetic(spec, seed=0)
    rng = np.random.default_rng(0)
    calib = [rng.random((3, spec.net.height, spec.net.width), dtype=np.float32)]
    quantize_weights(store, calibrate_activations(spec, store, calib))
    eng = Engine(spec, store, precision="int16", device=dev)
    n_mm = sum(k == "mm" for k in eng.model.kinds.values())
    n_c3 = sum(k == "conv3" for k in eng.model.kinds.values())
    say(f"[slice] yolov2 {spec.net.width}x{spec.net.height} int16, "
        f"{n_mm} mm_q16 + {n_c3} conv3x3_q16 convs per forward")

    rng = np.random.default_rng(0)
    frames = [rng.random((3, 480, 640), dtype=np.float32) for _ in range(3)]
    batch = rng.integers(0, 256, (BATCH_SLICE, spec.net.height, spec.net.width, 3),
                         dtype=np.uint8)
    names = names_for(spec.region.classes)

    # the main path, with the launch counts read around it
    q16.reset_launches()
    results = []
    for im in frames:
        before = dict(q16.LAUNCHES)
        results.append(eng.detect(im))
        per = {k: q16.LAUNCHES[k] - before[k] for k in before}
        if per != {"mm_q16": n_mm, "conv3x3_q16": n_c3}:
            raise AssertionError(f"detect ran {per} kernel launches")
    heads = eng.predict_batch_rgb(batch)
    torch.cuda.synchronize()
    launches = dict(q16.LAUNCHES)
    want = {"mm_q16": 4 * n_mm, "conv3x3_q16": 4 * n_c3}
    if launches != want:
        raise AssertionError(f"main path launched {launches}, want {want}")
    say(f"[slice] main path (3 detect + 1 batch of {BATCH_SLICE}) launched "
        f"{launches}")

    for i, (dets, res) in enumerate(results):
        labels = sum(int((d.prob > 0.25).sum()) for d in dets)
        top = sorted(dets, key=lambda d: d.objectness, reverse=True)[:2]
        desc = "; ".join(
            f"obj {d.objectness:.3f} {names[int(d.prob.argmax())]} "
            f"p={d.prob.max():.4f} box ({d.bbox[0]:.3f},{d.bbox[1]:.3f},"
            f"{d.bbox[2]:.3f},{d.bbox[3]:.3f})" for d in top)
        say(f"[slice] request {i}: {res.seconds * 1e3:.1f} ms, {len(dets)} boxes "
            f"over the objectness threshold, {labels} labels over 0.25"
            f"{'; top: ' + desc if desc else ''}")
        if not np.isfinite(res.head_chw).all():
            raise AssertionError(f"request {i}: non-finite head")

    oc = spec.layers[-1].out_c
    lh, lw = spec.layers[-1].out_h, spec.layers[-1].out_w
    if heads.shape != (BATCH_SLICE, oc, lh, lw) or not np.isfinite(heads).all():
        raise AssertionError(f"batch head {heads.shape}, finite "
                             f"{np.isfinite(heads).all()}")

    # the same model through the plain versions, on the card and on the CPU
    plain = PlainYoloV2Int16(spec, store.qtables, eng.params, dev)
    xb = torch.from_numpy(batch).to(dev)
    want_heads = plain(xb)["head"].permute(0, 3, 1, 2).cpu().numpy()
    if not np.array_equal(heads, want_heads):
        raise AssertionError("batch head: kernels != plain versions on the card")
    cpu_params = {k: {n: t.cpu() for n, t in v.items()} for k, v in eng.params.items()}
    cpu_model = YoloV2Int16(spec, store.qtables, cpu_params, "cpu")
    t0 = time.perf_counter()
    cpu_head = cpu_model(torch.from_numpy(batch[:1]))["head"].permute(0, 3, 1, 2).numpy()
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(heads[:1], cpu_head):
        raise AssertionError("frame 0 head: kernels on the card != plain on the CPU")
    say(f"[slice] head {heads.shape} bit-equal: kernels == plain on the card "
        f"(batch {BATCH_SLICE}) == plain on the CPU (frame 0, {cpu_s:.1f} s)")

    # throughput and latency on device-resident frames
    model = eng.model
    ms_b8 = cuda_ms(lambda: model(xb), reps=20)
    plain_ms_b8 = cuda_ms(lambda: plain(xb), reps=3)
    x1 = xb[:1].contiguous()
    lat = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(x1)["head"].cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = np.percentile(lat[5:], [50, 90])
    say(f"[slice] batch {BATCH_SLICE}: {ms_b8:.3f} ms per batch "
        f"({BATCH_SLICE * 1e3 / ms_b8:.1f} frames/s) kernels, "
        f"{plain_ms_b8:.3f} ms plain versions")
    say(f"[slice] batch 1 latency (host clock, head to host): p50 {p50:.3f} ms "
        f"p90 {p90:.3f} ms")
    return launches, model


def phase_profile(model: YoloV2Int16, dev: torch.device) -> None:
    """Where the device time goes, at batch BATCH_SLICE and 1: each conv
    alone (CUDA events, random full-range operands at its shape), the
    forward's device time by kernel (torch.profiler) against its time per
    forward (CUDA events), and the SM clock and power sampled beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec = model.spec
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(1)
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        rows = []
        for bsz in (BATCH_SLICE, 1):
            groups: dict[str, list] = {}
            for l in spec.conv_layers():
                x = torch.from_numpy(rng.integers(
                    -32768, 32768, (bsz, l.h, l.w, l.c)).astype(np.int16)).to(dev)
                w = getattr(model, f"w{l.idx}")
                b = getattr(model, f"b{l.idx}")
                if model.kinds[l.idx] == "mm":
                    fn = lambda: q16.mm_q16(x.reshape(-1, l.c), w, b, 16, True)  # noqa: E731
                else:
                    fn = lambda: q16.conv3x3_q16(x, w, b, 16, True)  # noqa: E731
                ms = cuda_ms(fn, reps=10)
                macs = bsz * l.h * l.w * l.c * l.n * l.size * l.size
                group = ("entry 3x3 C=3" if l.c == 3 else f"{l.size}x{l.size}"
                         + (" 13x13" if l.size == 3 and l.h == 13 else ""))
                groups.setdefault(group, []).append((ms, macs))
                say(f"[profile] b={bsz} conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n} "
                    f"{l.size}x{l.size}: {ms:.4f} ms {macs / ms / 1e9:.3f} "
                    "T int16 MAC/s")
            rows.append((bsz, groups))

            xb = torch.from_numpy(rng.integers(
                0, 256, (bsz, spec.net.height, spec.net.width, 3),
                dtype=np.uint8)).to(dev)
            fwd_ms = cuda_ms(lambda: model(xb), reps=20)
            reps = 10
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    model(xb)
                torch.cuda.synchronize()
            by = {"mm_q16": 0.0, "conv3x3_q16": 0.0, "glue": 0.0}
            glue_top = ("", 0.0)
            for e in prof.key_averages():
                if e.device_type != DeviceType.CUDA:
                    continue
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                ms = us / 1e3 / reps
                kind = ("mm_q16" if "MmLoader" in e.key else "conv3x3_q16"
                        if "ConvLoader" in e.key else "glue")
                by[kind] += ms
                if kind == "glue" and ms > glue_top[1]:
                    glue_top = (e.key[:60], ms)
            dev_ms = sum(by.values())
            if dev_ms == 0:
                say(f"[profile] b={bsz}: the profiler saw no device time; "
                    "device time by kernel and idle share not measured")
                continue
            say(f"[profile] b={bsz} forward: {fwd_ms:.3f} ms (CUDA events), "
                f"device busy {dev_ms:.3f} ms (profiler): conv3x3_q16 "
                f"{by['conv3x3_q16']:.3f}, mm_q16 {by['mm_q16']:.3f}, glue "
                f"{by['glue']:.3f} (largest {glue_top[0]!r} {glue_top[1]:.3f}); "
                f"convs {100 * (dev_ms - by['glue']) / dev_ms:.1f}% of device "
                f"time, device idle {100 * max(0.0, 1 - dev_ms / fwd_ms):.1f}%")
    finally:
        sampler.terminate()
        samples = sampler.communicate(timeout=30)[0]
    clk = np.array([[float(v) for v in ln.split(",")]
                    for ln in samples.strip().splitlines()
                    if ln.count(",") == 2 and "N/A" not in ln] or [[0, 0, 0]])
    busy = clk[clk[:, 2] >= np.median(clk[:, 2])]   # the busier half
    mhz = float(np.median(busy[:, 0]))
    say(f"[profile] nvidia-smi over the phase ({len(clk)} samples, the "
        f"busier half): SM clock median {mhz:.0f} MHz (max "
        f"{clk[:, 1].max():.0f}), power draw median {np.median(busy[:, 2]):.1f} W")
    for bsz, groups in rows:
        for group, vals in groups.items():
            ms = sum(v[0] for v in vals)
            macs = sum(v[1] for v in vals)
            per_clk = (f", {macs / (ms * 1e-3) / (sms * mhz * 1e6):.1f} "
                       "MAC/clk/SM" if mhz else "")
            say(f"[profile] b={bsz} {len(vals):2d} convs {group:14s} "
                f"{ms:8.3f} ms {macs / ms / 1e9:7.3f} T int16 MAC/s{per_clk}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    os.environ.setdefault("YOLO2_NO_DUMP", "1")   # no region text dumps
    dev = torch.device("cuda", 0)
    smi = phase_card()
    check = KernelCheck()
    phase_kernels(check, dev)
    launches, model = phase_slice(dev)
    phase_profile(model, dev)
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": check.max_abs_err[name],
                "ms": check.ms[name], "plain_ms": check.plain_ms[name]}
               for name, (src, rep) in KERNEL_SOURCES.items()]
    say(f"[card] {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
