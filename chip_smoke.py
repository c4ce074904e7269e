"""Smoke run of the PyTorch/CUDA port (``yolotpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

It builds the hand-written kernels from ``yolotpu_torch/csrc/`` with nvcc
for ``sm_90a`` (one nvcc per source, all started together) and drives the
port's main paths, YOLOv2 at 416x416 with synthetic weights from seed 0 in
each tier (fp32; int16-exact; int8 w8a8 with the head16 epilogue; w8a16)
and in two plan slices of the int16 tier, and yolov2-s2 (its five 2x2/s2
maxpools 3x3/s2 convs, which run on the general convs) in each tier, every
forward a replay of a CUDA graph that the engine captured, then trains
YOLOv2 and scores the trained weights through the integer tiers, and runs
the multi-GPU path in eight ranks on the one card, in ten phases (9 runs
after 2, 10 after 3):

1. card: name and power limit, torch and CUDA versions, kernel build time,
   each kernel's registers and spills (none allowed), each kernel's
   tensor-core MMA count (cuobjdump: the ten instantiations of the
   tensor-core body and the sixteen of the general convs' kernel,
   convk_tc_kernel, hold integer wgmma, the latter also TMA bulk copies,
   and the library holds no other kernel but nms_greedy's two passes, whose
   registers and shared memory it prints), and the tile, shared memory and
   registers of each operand scheme of the tensor-core body (Q16: mm_q16,
   conv3x3_q16, conv3x3_pool_q16 in its three pool orders; W8A16:
   mm_w8a16, conv3x3_w8a16; S8: mm_s8 with either output, conv3x3_s8,
   conv3x3_int8) and of each tile of convk_tc_kernel (conv_q16,
   conv_w8a16, conv_s8 with either output: BM, BN, ring stages, blocks per
   SM asked and kept, both equal to tc.CONVK_BLOCKS), checked against the
   wrappers' copy of it;
2. kernels: each of the six conv kernels against its plain PyTorch version
   on the card at all 23 yolov2 conv shapes of its kind (batch 2) and at
   edge cases (shift extremes, per-channel shift vectors that mix them, sums
   built to wrap, operands at the limits of their types, C=3, N=425, ragged
   M, the int16-output head16 form of mm_s8); the tensor-core kernels
   also at their yolov2 shapes at batch 1 and 8, the main path's batches,
   whose split of K over blocks differs from batch 2's, and with K beyond
   one split (33,000 to 131,472) and operands at their extremes, where an
   unsplit s32 partial sum would leave s32 (Q16 at K=33000, W8A16 at
   66,600, S8 at 131,472, whose exact sums wrap; the 1x1 and the 3x3
   kernel of each scheme); the
   fused conv+pool kernel in each pool order at the five
   yolov2 shapes a 2x2/s2 pool follows, at batch 1, 2 and 8, and at edge
   cases (C=3, 4 and 7, shifts, sums that wrap at shift 31, where the three
   orders must differ, splits of K forced through the workspace exit,
   K beyond one split);
   the scalar-shift int8 conv at the int8 tier's 15 3x3 shapes; all
   compared with ``torch.equal``, with both times from CUDA events, and, at
   the model's shapes, the bound (the least time the card could take) and
   one library call's time for the same sums; every case keeps most outputs
   unsaturated, so they depend on the sums; nms_greedy, the device NMS's
   class-wise NMS on the candidates' scores and boxes, against its plain
   version (``torch.equal``) on yolov2 416 candidate tables (N=845, K=256,
   C=80) at batch 1 and 8, timed (events and graph replays) beside its
   plain version and bound, and on tied scores, an empty class, K=N, a
   saturated crowd, K=1024 and pairs of boxes whose IoU lies within a few
   ulp of the threshold (counted: a case where too few do is refused), then
   its classes per block swept;
3. slices: the /255 normalisation and the letterbox of raw frames of three
   shapes, on the card against the CPU, bit for bit; then per tier an
   Engine (3 ``detect`` requests, ``predict_batch_rgb`` at batch 8) and an
   Engine with device NMS (3 ``detect_device`` requests, the batch's top-K
   tables, a batch of raw frames letterboxed on the card), each forward a
   replay of a CUDA graph: the kernel launches of that run counted per
   captured forward (one eager run and one capture per graph) and the
   replays (one per request), the replayed heads held bit-equal to the
   eager forward and the plain versions on the card, frame 0 also to the
   CPU (fp32: within the CPU tests' tolerance, and TF32 shown off),
   detect_device held to detect and the raw frames' tables to the host
   letterbox's, and the ms per batch and batch-1 latency, eager and replayed
   in turns, and what the device NMS adds to a replay; the launches per
   forward are those of the engine's kinds (``engine_plan.kernels``). The
   int16 engine runs the card's plan (``Engine.plan_source``, the plan file
   of the card's name in ``engine_plan.plan_dir()``, which it must load
   where there is one); the rule run, an int16 Engine with no plan file
   (``YOLO2_PLAN_DIR`` at an empty directory), serves the same requests:
   the planned engine's detect boxes and heads (b=1 and b=8) equal
   (``torch.equal``) the rule's and the plain path's, and the two engines'
   replays are timed in turns (rule, plan, plan, rule) at b=8 and b=1. Then
   the int16 tier under the plan slices P1 and P2 (``YOLO2_Q16_PLAN``, no
   plan file), whose heads must also equal the rule's, timed beside it;
4. profile: per path and graph, the replay's device time by kernel, the
   device's idle share in it and the device kernels it runs, and how many
   the decode and the NMS add (torch.profiler); per integer tier: each conv
   alone at batch 8 and 1 (CUDA events) beside
   its plain version, a library call and its bound, summed per kernel over
   one forward (the 1x1 kernel and its library calls also alone on the
   device, in CUDA graph replays, since events around such short calls hold
   the host's time per launch; int16 through the rule run's model); the
   eager forward's device time by kernel, its
   largest glue kernel and the device's idle share against its time per
   forward (torch.profiler, each kernel known by its full name), the bytes
   per second the 1x1 kernel moves on that device time, and the SM clock
   and power draw sampled beside them; each fused conv+pool alone
   against conv3x3_q16 then the pool, and summed over P1's fused convs
   beside its library call (a float64 matmul on im2col, then the pool),
   each alone on the device in CUDA graph replays, and the fused kernel's
   device time in P1's forward; then, for each tier's tensor-core convs
   and P1's fused convs at batch 1 and 8, the device time (CUDA graph
   replays) of every split of K beside the one ``tc.split`` picks;
5. runtime: ``cli.gpu_check`` (its five checks must pass; its device table
   names the card's int16 plan); then the streaming runtime through
   ``cli.main``'s own wiring (``load_model``,
   ``build_engine``, ``labels_of``, ``stream_config`` from a parsed argv:
   int16, synthetic weights, ``--batch-size 8 --device-nms --topk 845``)
   over 240 seeded raw 480x640 frames from memory, letterboxed on the card
   (the raw-frame graph captured by one request first, so the 30 timed
   batches are steady), and again at ``--batch-size 1`` without device NMS
   (the host path, with the native letterbox): both JSONL files hold the
   same frames and per frame the same sorted (class, prob) list, each graph
   is replayed once per request, each run's StepTimer summary is printed,
   and the kernel launches of this streaming path, read just after it, are
   the phase's count; ``predict_layers``/``dump_layers`` of one frame (a
   path of its own, its launches checked apart), every one of the 32 layers
   bit-equal to the plain versions' on the card, the region layer to a
   replay's head, each file c*h*w*itemsize bytes; the watchdog at
   YOLO2_LAYER_TIMEOUT_MS=200: a call whose first dispatch holds a side
   stream about 1 s (``torch.cuda._sleep``, then its sync; the engine's
   stream does not wait on it) recovers on its re-dispatch, one that holds
   it every time raises TimeoutError, and one that holds the engine's own
   stream once raises too, its re-dispatch queued behind the hold; once the
   card drains a request's head is still the plain head; then b=1
   ``predict`` with the watchdog at its default and off
   (YOLO2_LAYER_TIMEOUT_MS=0), in turns, 25 runs each, a predict's parts
   (host prep, handoff to the call, copy in, replay and head out, handoff
   back) on and off call by call, and the handoff alone.

6. artifacts, profile, report, pipeline (from a temporary directory): a
   seeded full-width yolov2 darknet blob (BN on every conv but the last, u64
   ``seen``; its size checked) through ``cli.weight_gen`` (--from-darknet
   --reorg-out, then ``from_darknet`` with one seeded calibration image for
   the int16 set), reloaded from the reorg files; the int16 and fp32
   engines' detect heads from the reloaded store equal (``torch.equal``)
   those of the same store built in memory and never written, the int16
   ones also the plain versions on the card; ``profile_layers`` and
   ``profile_prefix`` (int16, b=8, the card's plan) with the H100 roofline of
   each (a row for all 32 layers, every conv row above 0 ms; no reading
   faster than 1.05 of its bound: each row of ``profile_layers``, and each
   prefix's own time, not its rows, which are differences of two readings),
   the whole forward's time beside phase 3's replayed ms and the prefix
   rows' sum;
   ``cli.report`` run int16 (with its per-layer rows) and int8 at b=8, 10
   steps, their bundles' three files (each bundle's accuracy block the
   tier's evidence in ``yolotpu_torch/plans/`` at 416, where there is
   one), ``compare`` of the two and
   ``parse-log`` of the detect requests' log; ``cli.pipeline`` over its six
   stages (synthetic weights, batch 8, 5 steps), exit 0; the launches of
   ``mm_q16``, ``conv3x3_q16``, ``mm_s8`` and ``conv3x3_s8`` in this phase
   (and ``conv3x3_pool_q16`` where the card's plan fuses a pool), read just
   after it, join the kernels' counts.

7. training and the accuracy protocol, yolov2 416 (published widths and
   depth): (a) one train step (region loss, backward, SGD with momentum,
   the global-norm clip) on the card, with cuDNN's TF32 flag at PyTorch's
   default, against the same step on the CPU (b=2, random frames with two
   protocol scenes' truths, one flipped): the loss, each conv's clipped
   gradient (and the median conv's) and the new params within their
   tolerances; with cuDNN's deterministic algorithms the step with the
   flag on equals the step with it off throughout, bit for bit; the same
   step once with TF32 on in the backward differs and lands outside the
   median's tolerance; (b) train_flagship_store,
   b=8, 200 steps on the protocol's 2048 scenes: the loss falls, the steps a
   second and the ms a step (CUDA events), and forward + loss + backward
   alone; (c) a checkpoint of (a)'s state reloaded bit for bit and resumed
   one step, and the trained store exported and reloaded bit for bit; (d)
   the trained store quantized per tier and scored on the 64 eval scenes
   through ``eval.evaluate_engine_batched``: int16 (the card's plan and the
   rule), int8 and w8a16 on their kernels, each with heads bit-equal to the
   plain path's on the card on every scene and the same mAP, the planned
   int16 heads bit-equal to the rule's on every scene, and fp32; the mAP_50
   of each and its delta against fp32 (200 steps: not evidence); the
   kernel launches of that run, counted from 0, join the kernels' counts;
   (e) ``cli.train`` on the card: synthetic steps with checkpoints, a
   resume, the export, loaded by an fp32 Engine.

8. multi-GPU (M13), yolov2 416 (published widths and depth), eight ranks
   sharing the card (``parallel.dryrun.dryrun_multichip(8, "cuda", "gloo",
   416, root=...)``: the kernel library built here first, the ranks load
   it; gloo takes the CUDA tensors through the host, NCCL refuses two ranks
   on one card): the dryrun's five stages over meshes (dp=2, tp=4) and
   (dp=2, sp=4) at b=8, 4 frames a dp rank: one sharded train step, int16
   dp, int16 and int8 tp-sharded (head and detections ``torch.equal`` to
   the replicated run), int16 sp-sharded (head), ``mm_q16`` on each rank's
   rows; then the dp run's head and detections against the one-process
   forward on the card, the dp, tp and sp heads, the dp and tp detections
   and the int8 tp head and detections against the plain path on the card
   (``torch.equal``), and the sharded step against one process's step on
   the card, both with cuDNN's deterministic algorithms, within (a)'s
   tolerances, and against a second witness within 1e-5 of each conv's
   gradient norm: one process's step as two b=4 halves with their gradients
   averaged (each dp rank's frames, so only the dp and tp sums and the Cout
   blocks differ), itself read against the b=8 step; each rank shows JAX
   and ``yolotpu`` blocked; per stage the seconds, the ms of a sharded
   forward (or the step) and the bytes each collective kind received, all
   of it eight ranks time-sliced on one card with host-staged gloo
   collectives, which says nothing of scaling across cards; then the same
   stages in a world of one rank on NCCL (a mesh of 1 x 1: only size-1
   gathers reach NCCL, the batch gathers and stage 5's int16 gather as
   uint8; no tp, sp or dp collective runs there); the ranks' launches of
   ``mm_q16``, ``conv3x3_q16``, ``nms_greedy``, ``mm_s8`` and
   ``conv3x3_s8`` (each above 0, no other kernel) join the kernels' counts;
   then yolov2-s2 at 416 over a (dp=1, sp=2) mesh, two gloo ranks sharing
   the card, b=2, in the int16 and int8 tiers: each rank quantizes its H
   slab, runs conv0 (3x3/s1) on it with one halo row from its neighbour
   and gathers H before conv1, the first strided conv (``conv_q16``,
   ``conv_s8``), and the heads equal the one-process forward on the card
   (``torch.equal``); its launches of the general convs join the counts;
   the phase must end within 120 s.

9. general convs, kernels: conv_q16, conv_s8 (int8 and int16 output) and
   conv_w8a16 against their plain versions (``torch.equal``) at yolov2-s2's
   five 3x3/s2 shapes at batch 1, 2 and 8 (each on the schedule
   ``tc.stream_k`` plans; at batch 8 timed by CUDA events and in CUDA graph
   replays, beside
   the bound and one library call: a float64 matmul on the strided im2col,
   or ``_int_mm`` for int8); each of the five timed at batch 1 and 8 (graph
   replays and events) beside its bound, its library call and the rate at
   which its staged bytes reach the SMs, summed per forward; each general
   conv on every tile of ``tc.CONVK_TILES`` and on whole tiles and
   stream-K (three minimum shares) at those shapes, each equal and timed;
   the stream-K cases, whole tiles ruled out (tiles shared by 2 and by 3
   blocks, one output tile, M < 64, N of 24, 32, 40 and 425, C = 13,
   full-range sums that wrap; conv_s8 with either output);
   and at edge forms (a 7x7/s2 entry with C=3, a
   5x5, a VALID 3x3, a 2x2/s2 on odd H and W, a 1x1/s2 with N=425, a
   3x3/s2 with padding 2 and with padding 3, whose first windows are all
   padding, C=1024; shifts from -3 to 40 and vectors mixing them, leaky on
   and off), the int8 head16 form, sums built to wrap, and K beyond one
   split (a 7x7/s2 over 1024 channels, K=50,176; an int8 7x7 over 2731
   channels, K=133,819, whose exact sum leaves int32);

10. yolov2-s2 at 416 (published widths, nothing cut; 28 convs: 8 on mm, 15
   on conv3, 5 on the general conv), synthetic weights from seed 0
   quantized per tier: an Engine per tier, fp32 included (3 ``detect``,
   ``predict_batch_rgb`` at batch 8 and 1, each a replay of a captured
   graph), its launches per captured forward checked, the replayed heads
   bit-equal to the eager forward and to the plain versions on the card,
   the batch-8 replay's ms and the batch-1 p50/p90; the int16 engine runs
   the rule's kinds with nothing raised, since the card's plan file is
   keyed to yolov2 (``engine_plan.plan_key``); the mixed cfg of
   tests/test_torch_general_conv.py in every integer tier on the card,
   its heads bit-equal to the CPU's plain path (the int8 3x3 head on
   conv_s8's int16 output); ``profile_layers`` at int16 batch 8, the five
   strided convs against their bound.

``python3 chip_smoke.py --general-times`` prints the card, the registers
and SASS counts of every tensor-core function and phase 9's times of the
general convs and their sweep, with no checks of phase 1, so a copy of it
run from an earlier tree's root (one whose general convs all run on the
stream-K kernel) times that tree's kernels.

Any failed check raises, so the exit code is not 0. The line before the
last is a JSON record of the kernels; the last is
``{"ok": true, "device": {...}}``. JAX and the JAX package ``yolotpu`` are
blocked from import for the whole run: the port must not need them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import unittest.mock

sys.modules["jax"] = None       # any import of JAX now fails,
sys.modules["yolotpu"] = None   # and of the JAX package

import numpy as np  # noqa: E402
import torch  # noqa: E402

from yolotpu_torch import accuracy, checkpoint, darknet, train  # noqa: E402
from yolotpu_torch import eval as yeval  # noqa: E402
from yolotpu_torch.cli import gpu_check  # noqa: E402
from yolotpu_torch.cli import main as cli_main  # noqa: E402
from yolotpu_torch.cli import pipeline, report, weight_gen  # noqa: E402
from yolotpu_torch.cli import train as train_cli  # noqa: E402
from yolotpu_torch.graph import MaxPoolSpec, NetworkSpec  # noqa: E402
from yolotpu_torch.image import letterbox_image  # noqa: E402
from yolotpu_torch.models import engine_plan, zoo  # noqa: E402
from yolotpu_torch.models.yolov2 import (YoloV2Q, head_fp32,  # noqa: E402
                                         params_fp32)
from yolotpu_torch.names import names_for  # noqa: E402
from yolotpu_torch.ops import (_build, convops, letterbox, nms, pool,  # noqa: E402
                               q8, q16, tc)
from yolotpu_torch.parallel import dryrun, launch  # noqa: E402
from yolotpu_torch.parallel.dryrun import launch_counts  # noqa: E402
from yolotpu_torch.parallel.forward import (ShardedYoloV2Q,  # noqa: E402
                                            gather_batch)
from yolotpu_torch.parallel.mesh import (make_mesh_sp,  # noqa: E402
                                         spatial_batch_sharding)
from yolotpu_torch.quant import (calibrate_activations,  # noqa: E402
                                 calibrate_activations_int8, quantize_weights,
                                 quantize_weights_int8, quantize_weights_w8a16)
from yolotpu_torch.runtime.engine import (Engine, load_or_synthesize,  # noqa: E402
                                          tier_params, tier_qtables)
from yolotpu_torch.runtime.profiler import (H100_CHIP,  # noqa: E402
                                            layer_ops_bytes,
                                            prefix_alive_sets, profile_layers,
                                            profile_prefix, render_roofline,
                                            roofline_table)
from yolotpu_torch.runtime.stream import StreamRunner  # noqa: E402
from yolotpu_torch.tools import accuracy_protocol  # noqa: E402
from yolotpu_torch.weights import WeightStore  # noqa: E402

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
    "mm_s8": ("yolotpu_torch/csrc/mm_s8.cu", "yolotpu/ops/pallas_matmul.py:186"),
    "mm_w8a16": ("yolotpu_torch/csrc/mm_w8a16.cu",
                 "yolotpu/ops/pallas_matmul.py:127"),
    "conv3x3_s8": ("yolotpu_torch/csrc/conv3x3_s8.cu",
                   "yolotpu/ops/pallas_q16.py:953"),
    "conv3x3_w8a16": ("yolotpu_torch/csrc/conv3x3_w8a16.cu",
                      "yolotpu/ops/pallas_q16.py:1048"),
    "conv3x3_pool_q16": ("yolotpu_torch/csrc/conv3x3_pool_q16.cu",
                         "yolotpu/ops/pallas_q16.py:1857 (K8), :1377 (K9), "
                         ":1204/:1261 (K10), :417 (K11), :1521 (K12)"),
    "conv3x3_int8": ("yolotpu_torch/csrc/conv3x3_s8.cu",
                     "yolotpu/ops/pallas_conv.py:123, :85 (K13)"),
    "nms_greedy": ("yolotpu_torch/csrc/nms_greedy.cu",
                   "yolotpu/ops/nms.py:89 (the vmapped lax.scan of "
                   "greedy_nms_mask, :36-57, on box_iou_matrix, :21-33 and "
                   ":87; no Pallas kernel)"),
    "conv_q16": ("yolotpu_torch/csrc/conv_q16.cu",
                 "yolotpu/ops/convops.py:170 (conv_int16's XLA "
                 "lax.conv_general_dilated, int32 accumulation; :421/:424 in "
                 "conv_int16_dec8, :208 in conv_int16_nchw; no Pallas kernel)"),
    "conv_s8": ("yolotpu_torch/csrc/conv_s8.cu",
                "yolotpu/ops/convops.py:572 (conv_int8's XLA s8 "
                "lax.conv_general_dilated, head16 included; no Pallas "
                "kernel)"),
    "conv_w8a16": ("yolotpu_torch/csrc/conv_w8a16.cu",
                   "yolotpu/ops/convops.py:508 (conv_w8a16's XLA s8 "
                   "lax.conv_general_dilated over the stacked planes; no "
                   "Pallas kernel)"),
}
# the general convs: any k x k size, stride and padding; args (x, w, bias,
# shift, leaky, stride, pad)
GENERAL_KERNELS = ("conv_q16", "conv_s8", "conv_w8a16")
KERNEL_MODULE = {name: next(m for m in (q16, q8, nms) if name in m.LAUNCHES)
                 for name in KERNEL_SOURCES}
TIERS = tuple(YoloV2Q.kernels)   # the integer tiers; fp32 runs no kernel of ours
# tier -> the names of its (mm, conv3, conv) kernels
TIER_KERNELS = {tier: tuple(f.__name__ for f in fns)
                for tier, fns in YoloV2Q.kernels.items()}
# the 8-bit-weight kernels' cases: the spread the requantized sums aim at,
# by output type, and the bound of x where a case keeps it narrow
TARGET = {torch.int8: 2 ** 5, torch.int16: 2 ** 13}
X_NARROW = {torch.int8: 31, torch.int16: 2047}
WRAP_BLOCK8 = 1024   # 1024 products (-32768)*(-128) = 2^32
POOL_CONVS = (0, 2, 6, 10, 16)   # the yolov2 convs a 2x2/s2 pool follows
# the kernels on the 8-bit tensor cores, which take their weights also as
# packed planes: kernel -> (its operand scheme, what packs its planes)
TC_KERNELS = {"mm_q16": (tc.Q16, q16.pack_q16),
              "conv3x3_q16": (tc.Q16, q16.pack_q16),
              "conv3x3_pool_q16": (tc.Q16, q16.pack_q16),
              "mm_w8a16": (tc.W8A16, q8.pack_w8a16),
              "conv3x3_w8a16": (tc.W8A16, q8.pack_w8a16),
              "mm_s8": (tc.S8, q8.pack_s8),
              "conv3x3_s8": (tc.S8, q8.pack_s8),
              "conv3x3_int8": (tc.S8, q8.pack_s8),
              "conv_q16": (tc.Q16, q16.pack_q16),
              "conv_w8a16": (tc.W8A16, q8.pack_w8a16),
              "conv_s8": (tc.S8, q8.pack_s8)}
# the tensor-core instantiations: (kernel, what tells it from the others of
# the kernel, the scheme's and the loader's part of its mangled name); the
# int16 output of mm_s8 is a scheme struct of its own, S8Out16, and each
# pool order of conv3x3_pool_q16 a Q16Pool<order>, with the window-major
# loader ConvTc<int16_t, true>
TC_INSTANCES = (("mm_q16", "", "3Q16", "MmTcIs"),
                ("conv3x3_q16", "", "3Q16", "ConvTcIsLb0E"),
                ("mm_w8a16", "", "5W8A16", "MmTcIs"),
                ("conv3x3_w8a16", "", "5W8A16", "ConvTcIsLb0E"),
                ("mm_s8", " (int8 output)", "2S8", "MmTcIa"),
                ("mm_s8", " (int16 output)", "7S8Out16", "MmTcIa"),
                ("conv3x3_s8", "", "2S8", "ConvTcIaLb0E"),
                *(("conv3x3_pool_q16", f" (order {o})", f"7Q16PoolILi{i}E",
                   "ConvTcIsLb1E") for i, o in enumerate(q16.POOL_ORDERS)))
# the general convs, on their own kernel (csrc/convk_tc.cuh,
# convk_tc_kernel<scheme, BN, warpgroups>): kernel -> (the entry point of
# its tile configuration, and per output what tells it from the kernel's
# other output and the scheme's part of its mangled name: conv_s8's int16
# output is S8Out16); one instantiation per output and tile of
# tc.CONVK_TILES
CONVK_KERNELS = {"conv_q16": ("yq16_conv_config", (("", "3Q16"),)),
                 "conv_w8a16": ("yq8_conv_w8a16_config", (("", "5W8A16"),)),
                 "conv_s8": ("yq8_conv_s8_config",
                             ((" (int8 output)", "2S8"),
                              (" (int16 output)", "7S8Out16")))}
# SASS opcodes of a bulk copy by the Tensor Memory Accelerator
BULK_OPS = ("UBLKCP", "UTMALDG")
# int8 x int8
INT8_KERNELS = ("mm_s8", "conv3x3_s8", "conv3x3_int8", "conv_s8")
# the card's peaks, one definition with the profiler's roofline
# (runtime.profiler.H100_CHIP, the NVIDIA H100 SXM data sheet, dense): 8-bit
# tensor-core multiply-adds per second (1,979 T int8 ops), device memory
# bytes per second and fp32 operations per second outside the tensor cores.
# A bound counts 4 8-bit products per MAC for int16 x int16, 2 for int16 x
# int8 and 1 for int8 x int8, and each input, weight and output byte once.
PEAK_MAC8 = H100_CHIP["peak_s8_tops"] * 1e12 / 2
PEAK_BYTES = H100_CHIP["hbm_gbs"] * 1e9
PEAK_FP32 = H100_CHIP["peak_fp32_tops"] * 1e12
# nms_greedy at yolov2 416: N = 13*13*5 candidates, the engine's top K, and
# the COCO classes; the engine's IoU threshold
NMS_SHAPE = (845, 256, 80)
NMS_THRESH = 0.45
# nms_greedy's two functions: the table pass and the walk
NMS_FUNCTIONS = ("nms_table_kernel", "nms_greedy_kernel")
# the device kernels that the decode and the NMS added to a replay of the
# int16 forward at batch 1 and 8 while the IoU matrix was built by PyTorch
# ops and nms_greedy read it (a copy of this script run with
# --replay-kernels from the root of a checkout of that tree)
NMS_REPLAY_KERNELS_IOU = {1: 78, 8: 80}
# nms_greedy's near-threshold case: how close an IoU counts as near, and the
# least share of the K/2 pairs that must be that near
NEAR_ULPS = 4
NEAR_FLOOR = 0.75
NMS_WARPS_SWEEP = (1, 2, 4, 8, 16, 32)   # the walk's classes a block, timed
# the raw frame shapes whose letterbox is held to the CPU's; the first is
# the main path's
RAW_SHAPES = ((480, 640), (640, 360), (216, 216))
# fp32 heads, the card's cuDNN against the CPU's oneDNN: the tolerance of
# tests/test_torch_fp32.py, 1e-4 of the head's largest magnitude (other
# summation orders, compounded over 23 convs)
FP32_HEAD_TOL = 1e-4
# detect_device is held to detect at this threshold: the synthetic weights'
# class scores spread over 80 classes and reach 0.25 rarely; at 0.05 about 90
# detections a frame survive
DETECT_THRESH = 0.05
# the int16 plan slices: name -> (YOLO2_Q16_PLAN, per-forward launches of
# mm_q16, conv3x3_q16, conv3x3_pool_q16, the pools that run as their own op)
SPLIT_SWEEP = 32   # the most splits of K that phase_split times
PLANS = {"P1": ("0:entry_sdmm,2:sd_pool,6:sd_pool,10:sd_pool", (8, 11, 4), [17]),
         "P2": ("0:entryf,2:conv3p2,4:conv3p2", (8, 13, 2), [7, 11, 17])}


class PlainYoloV2Q(YoloV2Q):
    """The same network with every conv through its kernel's plain PyTorch
    version, whatever the device: the reference the kernel path is held
    against on the card."""
    kernels = {"int16": (q16.mm_q16_plain, q16.conv3x3_q16_plain,
                         q16.conv_q16_plain),
               "int8": (q8.mm_s8_plain, q8.conv3x3_s8_plain,
                        q8.conv_s8_plain),
               "w8a16": (q8.mm_w8a16_plain, q8.conv3x3_w8a16_plain,
                         q8.conv_w8a16_plain)}
    pooled = {"int16": q16.conv3x3_pool_q16_plain}


def reset_launches() -> None:
    q16.reset_launches()
    q8.reset_launches()
    nms.reset_launches()


def route_launches(tier: str, route: dict) -> dict[str, int]:
    """Kernel -> its launches in one forward of a ``tier`` model whose convs
    take ``route`` ({conv idx: (route, pool order)}, as engine_plan.kernels
    gives it)."""
    mm, c3, conv = TIER_KERNELS[tier]
    name = {"mm": mm, "conv3": c3, "conv": conv,
            "conv3_pool": "conv3x3_pool_q16"}
    out: dict[str, int] = {}
    for k, _ in route.values():
        out[name[k]] = out.get(name[k], 0) + 1
    return out


@contextlib.contextmanager
def no_plan_file():
    """YOLO2_PLAN_DIR at an empty directory: an int16 Engine built inside
    runs the default rule (with YOLO2_Q16_PLAN, where set)."""
    with tempfile.TemporaryDirectory() as empty, \
            unittest.mock.patch.dict(os.environ, {"YOLO2_PLAN_DIR": empty}):
        yield


def card_plan_file(dev: torch.device) -> str | None:
    """The plan file of the card's name in engine_plan.plan_dir(), or None."""
    path = os.path.join(engine_plan.plan_dir(), engine_plan.device_kind_slug(
        torch.cuda.get_device_name(dev)) + ".json")
    return path if os.path.exists(path) else None


def planned_kinds(spec, dev: torch.device) -> dict[int, str]:
    """The kinds of the int16 engine's plan for ``spec`` on ``dev``."""
    return engine_plan.plan(spec, engine_plan.tier_overrides(spec, "int16",
                                                             dev))


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


def products(x: torch.Tensor, w: torch.Tensor) -> int:
    """8-bit tensor-core products per MAC of an x by w multiply."""
    return x.element_size() * w.element_size()


def bound(m: int, k: int, n: int, per_mac: int, nbytes: int) -> tuple:
    """(operations ms, bytes ms) of the least time the card could take: m*n*k
    MACs of per_mac 8-bit products each on the tensor cores, and nbytes
    moved once."""
    return (m * n * k * per_mac / PEAK_MAC8 * 1e3, nbytes / PEAK_BYTES * 1e3)


def case_bound(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               out: torch.Tensor, shift, general: bool = False) -> tuple:
    """bound() of one kernel call on these operands: x (M, K) or NHWC, w
    (K, N) or HWIO, out its output; bias and a shift vector read once. A
    conv has a row of sums per pixel of x, a general conv (``general``) one
    per pixel of its output."""
    n = w.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, bias, out))
    if torch.is_tensor(shift):
        nbytes += shift.numel() * shift.element_size()
    rows = (out if general else x).numel() // (n if general else x.shape[-1])
    return bound(rows, w.numel() // n, n, products(x, w), nbytes)


def int_mm_ok(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether torch._int_mm takes these int8 operands (its CUDA shape rules:
    more than 16 rows, K and N multiples of 8)."""
    return (a.dtype == b.dtype == torch.int8 and a.shape[0] > 16
            and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0)


def library_call(name: str, x: torch.Tensor, w: torch.Tensor,
                 geometry: tuple = ()):
    """One PyTorch call that computes the kernel's sums (not its wrap or
    requant) on the same operands, as (fn, what): torch._int_mm for int8 x
    int8 where its shape rules allow, else a float64 matmul (exact below
    2^53), on the im2col matrix for a conv (a general conv's at its
    ``geometry``, (stride, pad)); for the conv fused with its pool, that
    matmul and then the 2x2/s2 pool of the sums (ops.pool). Never called by
    the port."""
    a = (x.reshape(-1, x.shape[-1]) if name.startswith("mm")
         else q16.im2col(x, w.shape[0], *geometry) if name in GENERAL_KERNELS
         else q16.im2col3x3(x))
    b = w.reshape(-1, w.shape[-1])
    if name in INT8_KERNELS and int_mm_ok(a, b):
        a, b = a.contiguous(), b.contiguous()
        return (lambda: torch._int_mm(a, b)), "_int_mm"
    a, b = a.to(torch.float64), b.to(torch.float64)
    if name == "conv3x3_pool_q16":
        sums = (*x.shape[:3], w.shape[-1])
        return (lambda: pool.maxpool((a @ b).reshape(sums), 2, 2, 0),
                "matmul fp64 + maxpool")
    return (lambda: a @ b), "matmul fp64"


def add_bound(acc: list, part: tuple) -> None:
    """Sum bounds: acc = [bound ms, of it bound by operations, by bytes]."""
    ops, by = part
    acc[0] += max(ops, by)
    acc[1 if ops >= by else 2] += max(ops, by)


def bound_by(acc: list) -> str:
    return "operations" if acc[1] >= acc[2] else "bytes"


class KernelCheck:
    """Runs a kernel and its plain version on the same card inputs, holds
    them equal, and keeps the worst disagreement and the per-layer times;
    in a timed case also the bound and one library call's time on the same
    inputs.

    Each case must leave at least UNSAT_FLOOR of its outputs unsaturated,
    so that they depend on the sums and not on the bias alone; a case built
    to wrap must also show at least WRAP_FLOOR of its outputs unsaturated
    with an exact sum outside int32."""

    def __init__(self) -> None:
        self.max_abs_err = {k: 0 for k in KERNEL_SOURCES}
        self.ms = {k: 0.0 for k in KERNEL_SOURCES}
        self.plain_ms = {k: 0.0 for k in KERNEL_SOURCES}
        self.library_ms = {k: 0.0 for k in KERNEL_SOURCES}
        self.graph_ms = {k: 0.0 for k in KERNEL_SOURCES}
        self.library = {k: set() for k in KERNEL_SOURCES}
        self.bound = {k: [0.0, 0.0, 0.0] for k in KERNEL_SOURCES}

    def compare(self, name: str, label: str, args: tuple, wraps: bool = False,
                timed: bool = False, **kw) -> torch.Tensor:
        module = KERNEL_MODULE[name]
        plain = getattr(module, name + "_plain")
        kernel = getattr(module, name)
        if name in TC_KERNELS:   # packed once, as at model build
            kernel = functools.partial(kernel,
                                       planes=TC_KERNELS[name][1](args[1]))
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {label}: kernel != plain "
                                 f"(max abs err {err})")
        x, w, leaky = args[0], args[1], args[4]
        info = torch.iinfo(want.dtype)
        sat = (want == info.max) | (want == info.min)
        if leaky:
            sat |= want == -((-info.min) // 10)   # the minimum through the leaky
        unsat = float((~sat).float().mean())
        general = name in GENERAL_KERNELS
        exact = (q16.mm_sum64(x, w) if name.startswith("mm")
                 else q16.conv_sum64(x, w, *args[5:7]) if general
                 else q16.conv3x3_sum64(x, w))
        if exact.shape != want.shape:   # a pooled output: each window's largest
            b_, h_, w_, n_ = exact.shape
            exact = exact.abs().reshape(b_, h_ // 2, 2, w_ // 2, 2, n_).amax(
                dim=(2, 4))
        wrapped = float(((exact.abs() >= 2.0 ** 31) & ~sat).float().mean())
        if unsat < UNSAT_FLOOR or (wraps and wrapped < WRAP_FLOOR):
            raise AssertionError(
                f"{name} {label}: blind case, {unsat:.3f} of the outputs "
                f"unsaturated, {wrapped:.3f} unsaturated with a wrapped sum")
        if not timed:
            return got
        k_ms = cuda_ms(lambda: kernel(*args, **kw), reps=10)
        # a general conv also alone on the device, in CUDA graph replays
        g_ms = graph_ms(lambda: kernel(*args, **kw)) if general else None
        p_ms = cuda_ms(lambda: plain(*args, **kw), reps=3)
        lib, what = library_call(name, x, w, args[5:7] if general else ())
        l_ms = cuda_ms(lib, reps=5)
        part = case_bound(x, w, args[2], want, args[3], general)
        self.ms[name] += k_ms
        self.plain_ms[name] += p_ms
        self.library_ms[name] += l_ms
        self.library[name].add(what)
        add_bound(self.bound[name], part)
        if general:
            self.graph_ms[name] += g_ms
        say(f"  {name:13s} {label:40s} equal, unsat {unsat:.3f} wrapped "
            f"{wrapped:.3f}  kernel {k_ms:8.3f} ms"
            + (f" (graph replays {g_ms:8.4f})" if general else "")
            + f"  plain {p_ms:8.3f} ms  {what} {l_ms:8.3f} ms  bound "
            f"{max(part):.4f} ms ({'operations' if part[0] >= part[1] else 'bytes'})")
        return got


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


def bias8(rng, n: int, out: torch.dtype) -> np.ndarray:
    """A bias small against the spread TARGET[out] of the sums."""
    t = TARGET[out]
    return rng.integers(-t // 2, t // 2, n).astype(np.int32)


def full_operands8(rng, xshape, wshape, xdtype, out: torch.dtype):
    """Full-range x (int8 or int16) and int8 w, their extremes included, a
    shift per column within 1 of the one that spreads the requantized sums
    about TARGET[out], and a small bias."""
    xmax = int(np.iinfo(xdtype).max)
    k, n = int(np.prod(wshape[:-1])), wshape[-1]
    x = rng.integers(-xmax - 1, xmax + 1, xshape)
    x.flat[:2] = [-xmax - 1, xmax]
    w = rng.integers(-128, 128, wshape)
    w.flat[:2] = [-128, 127]
    base = round(np.log2(k ** 0.5 * xmax * 127 / 3 / TARGET[out]))
    shift = base + rng.integers(-1, 2, n)
    return (x.astype(xdtype), w.astype(np.int8), bias8(rng, n, out),
            shift.astype(np.int32))


def narrow_operands8(rng, xshape, wshape, xdtype, out: torch.dtype,
                     shift: int):
    """x and int8 w sized to one shift (broadcast to every column): K
    products of two uniform [-rx, rx] x [-rw, rw] draws, a sum with standard
    deviation sqrt(K) rx rw / 3, spread about TARGET[out] after the shift;
    one row of x and one column of w at the extremes of their types."""
    xmax = int(np.iinfo(xdtype).max)
    k, n = int(np.prod(wshape[:-1])), wshape[-1]
    d = 3 * TARGET[out] * 2.0 ** min(shift, 30) / k ** 0.5   # rx * rw
    if xdtype == np.int8:
        rx = rw = int(np.clip(d ** 0.5, 1, 127))
    else:
        rw, rx = 127, int(np.clip(d / 127, 1, xmax))
    x = rng.integers(-rx, rx + 1, xshape)
    w = rng.integers(-rw, rw + 1, wshape)
    x.reshape(-1, xshape[-1])[0] = rng.choice([-xmax - 1, -xmax, xmax],
                                               xshape[-1])
    w[..., 0] = rng.choice([-128, -127, 127], wshape[:-1])
    return (x.astype(xdtype), w.astype(np.int8), bias8(rng, n, out),
            np.full(n, shift, np.int32))


def mixed_operands8(rng, xshape, wshape, xdtype, out: torch.dtype):
    """A shift vector that cycles through SHIFTS over the columns, x in
    +-X_NARROW with its first row at the extremes of its type, and each
    column j of w sized to its own shift: bound rw_j, and, where even
    rw_j = 1 would sum too much, only k_j nonzero rows, so that each
    column's requantized sums spread about TARGET[out]; w's first column at
    -128/127."""
    xmax = int(np.iinfo(xdtype).max)
    k, n = int(np.prod(wshape[:-1])), wshape[-1]
    rx = X_NARROW[torch.int8 if xdtype == np.int8 else torch.int16]
    x = rng.integers(-rx, rx + 1, xshape)
    x.reshape(-1, xshape[-1])[0] = rng.choice([-xmax - 1, -xmax, xmax],
                                               xshape[-1])
    shift = np.resize(np.array(SHIFTS, np.int32), n)
    w = np.zeros((k, n), np.int64)
    for j in range(n):
        d = 3 * TARGET[out] * 2.0 ** min(int(shift[j]), 30)  # sqrt(k_j) rx rw
        rw = int(np.clip(round(d / (k ** 0.5 * rx)), 1, 127))
        kj = int(np.clip((d / (rx * rw)) ** 2, 1, k))
        rows = rng.choice(k, kj, replace=False)
        w[rows, j] = rng.integers(-rw, rw + 1, kj)
    w[:, 0] = rng.choice([-128, 127], k)
    return (x.astype(xdtype), w.reshape(wshape).astype(np.int8),
            bias8(rng, n, out), shift)


def wrap_operands8(rng, rows: int, taps: int, n: int, shift: int, nblk: int,
                   npair: int = 8, ns: int = 37):
    """The w8a16 form of wrap_operands: x (rows, C) int16, w (taps, C, N)
    int8 whose exact sums leave int32 but wrap to small values, with
    C = nblk*WRAP_BLOCK8 + 2*npair + ns in shuffled order: blocks of
    WRAP_BLOCK8 channels at -32768 or 0 in x and -128 or 0 in w, each adding
    a multiple of 2^32; pairs (v, -v) x (u, u) at +-32767 and +-127 that
    cancel; ns channels with w uniform in +-127 and x sized to the shift."""
    c = nblk * WRAP_BLOCK8 + 2 * npair + ns
    x = np.zeros((rows, c), np.int64)
    w = np.zeros((taps, c, n), np.int64)
    for i in range(nblk):
        blk = slice(i * WRAP_BLOCK8, (i + 1) * WRAP_BLOCK8)
        x[:, blk] = np.where(rng.random((rows, 1)) < 0.5, -32768, 0)
        w[:, blk] = np.where(rng.random((taps, 1, n)) < 0.5, -128, 0)
    p = nblk * WRAP_BLOCK8
    v = rng.choice([-32767, 32767], (rows, npair))
    u = rng.choice([-127, 127], (taps, npair, n))
    x[:, p:p + npair], x[:, p + npair:p + 2 * npair] = v, -v
    w[:, p:p + npair], w[:, p + npair:p + 2 * npair] = u, u
    d = 3 * TARGET[torch.int16] * 2.0 ** min(shift, 30) / (taps * ns) ** 0.5
    r = int(np.clip(d / 127, 1, 32767))
    x[:, p + 2 * npair:] = rng.integers(-r, r + 1, (rows, ns))
    w[:, p + 2 * npair:] = rng.integers(-127, 128, (taps, ns, n))
    perm = rng.permutation(c)
    return (x[:, perm].astype(np.int16), w[:, perm].astype(np.int8),
            bias8(rng, n, torch.int16), np.full(n, shift, np.int32))


def sass_counts(lib_path) -> dict[str, tuple[int, int, str, int]]:
    """cuobjdump -sass of the kernel library: each kernel function's
    (instructions, tensor-core MMA instructions, their opcodes, TMA bulk
    copy instructions)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts: dict[str, list] = {}
    fn = None
    for line in dump.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0, set(), 0]
        elif fn and line.strip().startswith("/*") and "*/" in line:
            ins = line.split("*/", 1)[1].strip()
            if ins and not ins.startswith("/*"):
                counts[fn][0] += 1
                words = ins.split()
                op = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
                if "MMA" in op.split(".")[0]:   # IMMA, IGMMA, HMMA, HGMMA
                    counts[fn][1] += 1
                    counts[fn][2].add(op.split(".")[0])
                if op.split(".")[0] in BULK_OPS:
                    counts[fn][3] += 1
    return {k: (n, m, "/".join(sorted(ops)), b)
            for k, (n, m, ops, b) in counts.items()}


def ptxas_registers(log: str) -> dict[str, int]:
    """Each entry function's registers, from nvcc's -Xptxas=-v output
    (mangled name -> registers)."""
    regs, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = int(line.split("Used")[1].split("registers")[0])
            fn = None
    return regs


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
    sass = sass_counts(lib.path)
    for fn, (n, mma, ops, bulk) in sorted(sass.items()):
        say(f"[card]   SASS {fn}: {n} instructions, {mma} tensor-core MMA "
            f"{ops}, {bulk} TMA bulk copies")
    tc_fns = {fn for fn in sass if "igemm_tc_kernel" in fn}
    ck_fns = {fn for fn in sass if "convk_tc_kernel" in fn}
    nms_fns = {part: [fn for fn in sass if part in fn] for part in NMS_FUNCTIONS}
    convk = [(name, which, part, bm, bn)
             for name, (_, outs) in CONVK_KERNELS.items()
             for which, part in outs for bm, bn in tc.CONVK_TILES]
    if len(tc_fns) != len(TC_INSTANCES) or len(ck_fns) != len(convk) \
            or any(len(fns) != 1 for fns in nms_fns.values()) \
            or set(sass) != tc_fns.union(ck_fns, *nms_fns.values()) or any(
                "IGMMA" not in sass[fn][2] for fn in tc_fns | ck_fns) \
            or any(sass[fn][3] == 0 for fn in ck_fns):
        raise AssertionError(f"the library must hold the {len(TC_INSTANCES)} "
                             f"yq::tc kernels and the {len(convk)} yq::convk "
                             "kernels, each with integer warpgroup MMA "
                             "(wgmma: IGMMA in SASS), the convk ones with TMA "
                             f"bulk copies ({'/'.join(BULK_OPS)}), nms_greedy's "
                             f"two passes {NMS_FUNCTIONS} and no other kernel; "
                             f"it holds {sorted(sass)}")
    spills = [ln.strip() for ln in lib.log.splitlines() if any(
        int(v) for v in re.findall(r"(\d+) bytes spill", ln))]
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")
    regs = ptxas_registers(lib.log)
    cfg = lib.cdll.yq_tc_config
    for name, which, scheme_part, loader_part in TC_INSTANCES:
        scheme = TC_KERNELS[name][0]
        bm, bn, bk, smem, blocks, planes, kmax = (cfg(scheme.id, i)
                                                  for i in range(7))
        if (bm, bn, bk, planes, kmax) != (tc.BM, tc.BN, scheme.bk,
                                          scheme.planes, tc.KMAX) \
                or scheme.wave > blocks:
            raise AssertionError(
                f"{name}: the kernel's tile (BM {bm}, BN {bn}, BK {bk}, "
                f"{blocks} blocks per SM, {planes} planes, KMAX {kmax}) is not "
                f"the wrappers' {scheme}, or holds fewer blocks per SM than "
                "tc.split counts in a wave")
        fns = [fn for fn in regs if "igemm_tc_kernel" in fn
               and scheme_part in fn and loader_part in fn]
        if len(fns) != 1:
            raise AssertionError(f"{name}{which}: ptxas reports {fns}")
        say(f"[card] {name}{which} on the 8-bit tensor cores, scheme "
            f"{scheme.name.upper()}: {bm}x{bn} tiles, K steps of {bk}, "
            f"{planes} weight plane(s), {smem} bytes of dynamic shared memory "
            f"per block, {blocks} blocks per SM ({scheme.wave} in tc.split's "
            f"waves), {regs[fns[0]]} registers")
    for name, which, part, bm, bn in convk:
        scheme = TC_KERNELS[name][0]
        cfg = getattr(lib.cdll, CONVK_KERNELS[name][0])
        got = tuple(cfg(bm, bn, i) for i in range(8))
        _, _, bk, smem, blocks, resident, stages, kmax = got
        want = tc.CONVK_BLOCKS[(scheme.name, bm, bn)]
        if got[:3] != (bm, bn, scheme.bk) or kmax != tc.KMAX \
                or not want == blocks == resident:
            raise AssertionError(
                f"{name}{which} {bm}x{bn}: the kernel's tile (BM, BN, BK, smem, "
                f"blocks asked, blocks kept, stages, KMAX) {got} is not the "
                f"wrappers', or keeps other than the {want} blocks per SM "
                "that tc.stream_k counts")
        fns = [fn for fn in regs if "convk_tc_kernel" in fn
               and f"{part}ELi{bn}ELi{bm // 64}E" in fn]
        sfns = [fn for fn in ck_fns if f"{part}ELi{bn}ELi{bm // 64}E" in fn]
        if len(fns) != 1 or len(sfns) != 1:
            raise AssertionError(f"{name}{which} {bm}x{bn}: ptxas reports "
                                 f"{fns}, SASS {sfns}")
        say(f"[card] {name}{which} {bm}x{bn} on convk_tc_kernel, scheme "
            f"{scheme.name.upper()}: K steps of {bk}, a {stages}-stage ring, "
            f"{smem} bytes of dynamic shared memory per block, {blocks} blocks "
            f"per SM asked, {resident} kept ({want} in tc.stream_k's grid), "
            f"{regs[fns[0]]} registers, {sass[sfns[0]][0]} SASS instructions, "
            f"{sass[sfns[0]][1]} IGMMA, {sass[sfns[0]][3]} TMA bulk copies")
    table, walk = (next(fn for fn in regs if part in fn)
                   for part in NMS_FUNCTIONS)
    k, c = NMS_SHAPE[1:]
    say(f"[card] nms_greedy: the first pass ({regs[table]} registers, "
        f"{sass[table][0]} instructions, no shared memory) builds each frame's "
        f"K x ceil(K/32) bit table, one warp a row; the walk ({regs[walk]} "
        f"registers, {sass[walk][0]} instructions, no spills) runs one warp per "
        f"class, {nms.WARPS} classes a block, with {nms.walk_smem(k, nms.WARPS)} "
        f"bytes of dynamic shared memory a block at K={k} "
        f"({nms.walk_smem(NMS_SHAPE[0], nms.WARPS)} at K={NMS_SHAPE[0]}, "
        f"{nms.walk_smem(nms.MAX_K, nms.WARPS)} at K={nms.MAX_K}); "
        f"{-(-c // nms.WARPS)} blocks a frame at C={c}")
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

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say("[kernels] mm_q16 and conv3x3_q16 also at batch 1 and 8, the main "
        "path's batches, at all 23 shapes: K split over blocks as the "
        "wrapper chooses for each (tc.split), full-range operands")
    for l in spec.conv_layers():
        mm = engine_plan.select_engine(l) == "mm"
        for bsz in (1, 8):
            xshape = (bsz * l.h * l.w, l.c) if mm else (bsz, l.h, l.w, l.c)
            wshape = (l.c, l.n) if mm else (3, 3, l.c, l.n)
            m, k = bsz * l.h * l.w, l.c * l.size * l.size
            kps = tc.split(m, l.n, k, sms, tc.Q16)
            splits = -(-(-(-k // tc.Q16.bk)) // kps)
            x, w, b = on(rng.integers(-32768, 32768, xshape).astype(np.int16),
                         rng.integers(-32768, 32768, wshape).astype(np.int16),
                         small_bias(rng, l.n))
            check.compare("mm_q16" if mm else "conv3x3_q16",
                          f"conv{l.idx} b={bsz} {l.c}->{l.n} K in {splits} "
                          "splits", (x, w, b, FULL_SHIFT, l.activation == "leaky"),
                          wraps=True)
            say(f"  conv{l.idx} b={bsz} {l.h}x{l.w}x{l.c}->{l.n}: equal, K "
                f"{k} in {splits} splits of {kps * tc.Q16.bk}")

    say(f"[kernels] K beyond one s32 partial sum ({tc.KMAX}): every "
        "operand -32513 (high byte -128, low byte 255), where an unchunked "
        "middle sum leaves s32")
    for leaky in (False, True):
        x, w = (np.full(shape, -32513, np.int16) for shape in ((200, 33000),
                                                                (33000, 72)))
        x, w, b = on(x, w, small_bias(rng, 72))
        check.compare("mm_q16", f"K=33000 -32513 leaky={leaky}",
                      (x, w, b, 18, leaky), wraps=True)
        x, w = (np.full(shape, -32513, np.int16) for shape in ((1, 4, 5, 3700),
                                                                (3, 3, 3700, 16)))
        x, w, b = on(x, w, small_bias(rng, 16))
        check.compare("conv3x3_q16", f"1x4x5x3700->16 (K=33300) -32513 "
                      f"leaky={leaky}", (x, w, b, 18, leaky), wraps=True)

    say(f"[kernels] edge cases: shifts {SHIFTS} x leaky on/off; sums built "
        "to wrap, weights and inputs at -32768 and +-32767, C=3 and 7, "
        "N=425, ragged M, K and C")
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
            # conv: C=1061 built to wrap, then C=3 with N=425, C=7 (the
            # widest window that one K step holds) and C=N=16
            x, w, b = on(*wrap_operands(rng, 2 * 9 * 7, 9, 70, shift, nblk=2))
            c = x.shape[-1]
            check.compare("conv3x3_q16",
                          f"wrap 2x9x7x{c}->70 shift={shift} leaky={leaky}",
                          (x.reshape(2, 9, 7, c), w.reshape(3, 3, c, 70), b,
                           shift, leaky), wraps=True)
            for (bb, h, wd, c, n) in ((1, 13, 11, 3, 425), (2, 6, 5, 7, 24),
                                      (1, 5, 3, 16, 16)):
                x, w, b = on(*narrow_operands(rng, (bb, h, wd, c), (3, 3, c, n),
                                              shift))
                check.compare("conv3x3_q16",
                              f"{bb}x{h}x{wd}x{c}->{n} shift={shift} leaky={leaky}",
                              (x, w, b, shift, leaky))
            cases += 6
    say(f"[kernels] {cases} edge cases equal, each with at least "
        f"{UNSAT_FLOOR} of its outputs unsaturated, and {WRAP_FLOOR} "
        "unsaturated with a wrapped sum where built to wrap")


def phase_kernels8(check: KernelCheck, dev: torch.device) -> None:
    """The four kernels of the int8 and w8a16 tiers against their plain
    versions."""
    def on(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    rng = np.random.default_rng(8)
    spec = zoo.build("yolov2")
    head = spec.layers[spec.region.idx - 1]
    say(f"[kernels] int8 and w8a16: yolov2 416x416 conv shapes at batch "
        f"{BATCH_SHAPES}, full-range operands, a shift per column fitted to "
        "them; the head conv of the int8 tier through mm_s8's int16 output "
        "(head16: shift - 8, bias << 8)")
    for l in spec.conv_layers():
        mm = engine_plan.select_engine(l) == "mm"
        xshape = ((BATCH_SHAPES * l.h * l.w, l.c) if mm
                  else (BATCH_SHAPES, l.h, l.w, l.c))
        wshape = (l.c, l.n) if mm else (3, 3, l.c, l.n)
        leaky = l.activation == "leaky"
        label = f"conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n} {l.activation}"
        x, w, b, s = on(*full_operands8(rng, xshape, wshape, np.int8,
                                        torch.int8))
        if l.idx == head.idx:
            b, s = convops.head16(b, s)
            check.compare("mm_s8", label + " head16", (x, w, b, s, leaky),
                          timed=True, out_dtype=torch.int16)
        else:
            check.compare("mm_s8" if mm else "conv3x3_s8", label,
                          (x, w, b, s, leaky), timed=True)
        x, w, b, s = on(*full_operands8(rng, xshape, wshape, np.int16,
                                        torch.int16))
        check.compare("mm_w8a16" if mm else "conv3x3_w8a16", label,
                      (x, w, b, s, leaky), timed=True)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say("[kernels] the four kernels also at batch 1 and 8, the main path's "
        "batches, at all 23 shapes (the head conv through mm_s8's int16 "
        "output): K split over blocks as the wrapper chooses for each "
        "(tc.split), full-range operands")
    for l in spec.conv_layers():
        mm = engine_plan.select_engine(l) == "mm"
        for bsz in (1, 8):
            xshape = (bsz * l.h * l.w, l.c) if mm else (bsz, l.h, l.w, l.c)
            wshape = (l.c, l.n) if mm else (3, 3, l.c, l.n)
            m, k = bsz * l.h * l.w, l.c * l.size * l.size
            for name, xdtype, out in (
                    ("mm_s8" if mm else "conv3x3_s8", np.int8, torch.int8),
                    ("mm_w8a16" if mm else "conv3x3_w8a16", np.int16,
                     torch.int16)):
                scheme = TC_KERNELS[name][0]
                kps = tc.split(m, l.n, k, sms, scheme)
                splits = -(-(-(-k // scheme.bk)) // kps)
                x, w, b, s = on(*full_operands8(rng, xshape, wshape, xdtype, out))
                kw = {}
                if name == "mm_s8" and l.idx == head.idx:
                    b, s = convops.head16(b, s)
                    kw["out_dtype"] = torch.int16
                check.compare(name, f"conv{l.idx} b={bsz} {l.c}->{l.n} K in "
                              f"{splits} splits", (x, w, b, s,
                                                   l.activation == "leaky"), **kw)
                say(f"  {name} conv{l.idx} b={bsz} {l.h}x{l.w}x{l.c}->{l.n}"
                    f"{' head16' if kw else ''}: equal, K {k} in {splits} "
                    f"splits of {kps * scheme.bk}")

    say(f"[kernels] K beyond one split ({tc.KMAX} values of k), operands at "
        "their extremes, each scheme's 1x1 and 3x3 kernel: x = w = -128 (s8; "
        "at K=131,472 the exact sum leaves int32, and an unsplit s32 sum "
        "would too), x = -32513 (high byte -128, low byte 255) and w = -128 "
        "(w8a16; at K=66,600 an unsplit low-byte sum leaves s32)")
    for leaky in (False, True):
        for scheme, c, xv, shift, wraps in (
                ("s8", 3700, -128, 23, False),
                ("s8", 14608, -128, 25, True),
                ("w8a16", 3700, -32513, 18, True),
                ("w8a16", 7400, -32513, 18, True)):
            xdtype = np.int8 if scheme == "s8" else np.int16
            out = torch.int8 if scheme == "s8" else torch.int16
            x = np.full((1, 4, 5, c), xv, xdtype)
            w = np.full((3, 3, c, 16), -128, np.int8)
            args = on(x, w, bias8(rng, 16, out), np.full(16, shift, np.int32))
            check.compare(f"conv3x3_{scheme}", f"1x4x5x{c}->16 (K={9 * c}) "
                          f"x={xv} w=-128 leaky={leaky}", args + (leaky,),
                          wraps=wraps)
            x = np.full((200, 9 * c), xv, xdtype)
            w = np.full((9 * c, 72), -128, np.int8)
            args = on(x, w, bias8(rng, 72, out), np.full(72, shift, np.int32))
            check.compare(f"mm_{scheme}", f"200x{9 * c}->72 x={xv} w=-128 "
                          f"leaky={leaky}", args + (leaky,), wraps=wraps)

    say(f"[kernels] int8 and w8a16 edge cases, leaky on/off: shift vectors "
        f"mixing {SHIFTS} over the columns; each shift broadcast; "
        "operands at -128/127 and -32768/32767; C=3, 7, 14, N=425, ragged M, "
        "K, C; "
        "mm_s8's int16 output at shift - 8 with bias << 8; w8a16 sums built "
        f"to wrap from blocks of {WRAP_BLOCK8} products (-32768)*(-128). No "
        "int8 x int8 case is built to wrap: |x*w| <= 2^14 and K <= 9*1280 "
        "keep every such sum below 2^28")
    cases = 0
    for leaky in (False, True):
        for xdtype, out, mm, c3 in ((np.int8, torch.int8, "mm_s8", "conv3x3_s8"),
                                    (np.int16, torch.int16, "mm_w8a16",
                                     "conv3x3_w8a16")):
            # M=1000 (not a multiple of any tile), K=300, N=425
            args = on(*mixed_operands8(rng, (1000, 300), (300, 425), xdtype, out))
            check.compare(mm, f"mixed shifts 1000x300->425 leaky={leaky}",
                          args[:4] + (leaky,))
            # C=7 and 14: the widest windows one K step of int16 and of
            # int8 holds (and, for int16, C=14 gathered value by value)
            for (bb, h, wd, c, n) in ((1, 13, 11, 3, 425), (2, 6, 5, 7, 24),
                                      (1, 7, 6, 14, 24), (2, 9, 7, 40, 70)):
                args = on(*mixed_operands8(rng, (bb, h, wd, c), (3, 3, c, n),
                                           xdtype, out))
                check.compare(c3, f"mixed shifts {bb}x{h}x{wd}x{c}->{n} "
                              f"leaky={leaky}", args[:4] + (leaky,))
            cases += 5
            for shift in SHIFTS:
                args = on(*narrow_operands8(rng, (333, 72), (72, 64), xdtype,
                                            out, shift))
                check.compare(mm, f"shift={shift} 333x72->64 leaky={leaky}",
                              args[:4] + (leaky,))
                args = on(*narrow_operands8(rng, (1, 5, 3, 16), (3, 3, 16, 16),
                                            xdtype, out, shift))
                check.compare(c3, f"shift={shift} 1x5x3x16->16 leaky={leaky}",
                              args[:4] + (leaky,))
                cases += 2
        # the int8 head16 form at the head's shape, M ragged
        x, w, b, s = on(*full_operands8(rng, (2 * 169 + 7, 1024), (1024, 425),
                                        np.int8, torch.int8))
        b, s = convops.head16(b, s)
        check.compare("mm_s8", f"head16 345x1024->425 leaky={leaky}",
                      (x, w, b, s, leaky), out_dtype=torch.int16)
        cases += 1
        for shift in SHIFTS:
            x, w, b, s = on(*wrap_operands8(rng, 1000, 1, 425, shift, nblk=4))
            check.compare("mm_w8a16", f"wrap shift={shift} leaky={leaky}",
                          (x, w[0], b, s, leaky), wraps=True)
            x, w, b, s = on(*wrap_operands8(rng, 2 * 9 * 7, 9, 70, shift,
                                            nblk=2))
            c = x.shape[-1]
            check.compare("conv3x3_w8a16",
                          f"wrap 2x9x7x{c}->70 shift={shift} leaky={leaky}",
                          (x.reshape(2, 9, 7, c), w.reshape(3, 3, c, 70), b, s,
                           leaky), wraps=True)
            cases += 2
    say(f"[kernels] {cases} int8/w8a16 edge cases equal, each with at least "
        f"{UNSAT_FLOOR} of its outputs unsaturated, and {WRAP_FLOOR} "
        "unsaturated with a wrapped sum where built to wrap")


def phase_kernels_pool(check: KernelCheck, dev: torch.device) -> None:
    """conv3x3_pool_q16 in each pool order against its plain version."""
    def on(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    def full(shape):
        return rng.integers(-32768, 32768, shape).astype(np.int16)

    rng = np.random.default_rng(16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say(f"[kernels] conv3x3_pool_q16, orders {q16.POOL_ORDERS}: the yolov2 "
        f"416x416 convs a 2x2/s2 pool follows ({POOL_CONVS}) at batch "
        f"{BATCH_SHAPES} (timed), 1 and {BATCH_SLICE}, K split as the wrapper "
        f"chooses (tc.split), full-range operands at shift {FULL_SHIFT}, then "
        f"narrow ones at shift {NARROW_SHIFT}")
    spec = zoo.build("yolov2")
    for l in spec.conv_layers():
        if l.idx not in POOL_CONVS:
            continue
        leaky = l.activation == "leaky"
        wshape = (3, 3, l.c, l.n)
        label = f"conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n}"
        for bsz in (BATCH_SHAPES, 1, BATCH_SLICE):
            x, w, b = on(full((bsz, l.h, l.w, l.c)), full(wshape),
                         small_bias(rng, l.n))
            kps = tc.split(bsz * l.h * l.w, l.n, 9 * l.c, sms, tc.Q16)
            splits = -(-(-(-9 * l.c // tc.Q16.bk)) // kps)
            for order in q16.POOL_ORDERS:
                check.compare("conv3x3_pool_q16", f"{label} b={bsz} {order}",
                              (x, w, b, FULL_SHIFT, leaky), wraps=True,
                              timed=bsz == BATCH_SHAPES, order=order)
            if bsz != BATCH_SHAPES:
                say(f"  conv3x3_pool_q16 {label} b={bsz}: the three orders "
                    f"equal, K {9 * l.c} in {splits} splits of "
                    f"{kps * tc.Q16.bk}")
        x, w, b = on(*narrow_operands(rng, (BATCH_SHAPES, l.h, l.w, l.c),
                                      wshape, NARROW_SHIFT))
        for order in q16.POOL_ORDERS:
            check.compare("conv3x3_pool_q16", f"{label} {order} narrow",
                          (x, w, b, NARROW_SHIFT, leaky), order=order)

    say(f"[kernels] conv3x3_pool_q16 edge cases, each order: shifts {SHIFTS} "
        "x leaky on/off at C=3, 4, 7 and 16 (ragged M and N); full-range "
        "operands at shift 31, where acc + 2^29 wraps and the orders differ")
    cases = 0
    for shift in SHIFTS:
        for leaky in (False, True):
            for (bb, h, wd, c, n) in ((1, 14, 12, 3, 40), (2, 6, 10, 4, 70),
                                      (1, 6, 8, 7, 24), (1, 10, 6, 16, 16)):
                x, w, b = on(*narrow_operands(rng, (bb, h, wd, c), (3, 3, c, n),
                                              shift))
                for order in q16.POOL_ORDERS:
                    check.compare("conv3x3_pool_q16",
                                  f"{bb}x{h}x{wd}x{c}->{n} {order} "
                                  f"shift={shift} leaky={leaky}",
                                  (x, w, b, shift, leaky), order=order)
                    cases += 1
    for c in (3, 4):
        for leaky in (False, True):
            x, w, b = on(full((2, 8, 16, c)), full((3, 3, c, 32)),
                         small_bias(rng, 32))
            got = {order: check.compare(
                "conv3x3_pool_q16", f"2x8x16x{c}->32 {order} shift=31 "
                f"leaky={leaky}", (x, w, b, 31, leaky), wraps=True, order=order)
                for order in q16.POOL_ORDERS}
            differ = {(a, o): int((got[a] != got[o]).sum())
                      for i, a in enumerate(q16.POOL_ORDERS)
                      for o in q16.POOL_ORDERS[i + 1:]}
            if not all(differ.values()):
                raise AssertionError(f"conv3x3_pool_q16 C={c} shift=31: the "
                                     f"orders agree ({differ} outputs differ)")
            say(f"  conv3x3_pool_q16 2x8x16x{c}->32 shift=31 leaky={leaky}: "
                f"outputs that differ between orders {differ}")
            cases += 3
    say(f"[kernels] {cases} conv3x3_pool_q16 edge cases equal, each with at "
        f"least {UNSAT_FLOOR} of its outputs unsaturated")

    say("[kernels] conv3x3_pool_q16 through the split-K exit (the last block "
        "of a tile pools the workspace's sums), each order x leaky on/off, "
        "the K steps per split forced: ragged M and N at C=16, C=40, and "
        "conv10's shape at batch 1; then K beyond one s32 partial sum "
        f"({tc.KMAX}) at C=3700, every operand -32513")
    choose, cases = tc.split, 0
    try:
        for (bb, h, wd, c, n), steps in (((1, 6, 10, 16, 70), (1, 2)),
                                         ((2, 8, 12, 40, 32), (1, 4)),
                                         ((1, 52, 52, 128, 256), (1, 5, 9))):
            for leaky in (False, True):
                x, w, b = on(full((bb, h, wd, c)), full((3, 3, c, n)),
                             small_bias(rng, n))
                for kps in steps:
                    tc.split = lambda *a, kps=kps: kps   # noqa: E731
                    for order in q16.POOL_ORDERS:
                        check.compare(
                            "conv3x3_pool_q16", f"{bb}x{h}x{wd}x{c}->{n} {order} "
                            f"leaky={leaky}, {kps} K steps per split",
                            (x, w, b, FULL_SHIFT, leaky), wraps=True, order=order)
                        cases += 1
    finally:
        tc.split = choose
    for leaky in (False, True):
        x, w = (np.full(shape, -32513, np.int16) for shape in ((1, 4, 6, 3700),
                                                                (3, 3, 3700, 16)))
        x, w, b = on(x, w, small_bias(rng, 16))
        for order in q16.POOL_ORDERS:
            check.compare("conv3x3_pool_q16", f"1x4x6x3700->16 (K=33300) "
                          f"-32513 {order} leaky={leaky}", (x, w, b, 18, leaky),
                          wraps=True, order=order)
            cases += 1
    say(f"[kernels] {cases} conv3x3_pool_q16 split-K cases equal")


def phase_kernels_int8(check: KernelCheck, dev: torch.device) -> None:
    """q8.conv3x3_int8 (one shift for the layer) against its plain
    version."""
    def on(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    rng = np.random.default_rng(13)
    spec = zoo.build("yolov2")
    say(f"[kernels] conv3x3_int8: the int8 tier's 3x3 conv shapes at batch "
        f"{BATCH_SHAPES}, full-range operands, one shift for the layer fitted "
        f"to them; then shifts {SHIFTS} x leaky on/off at C=3")
    for l in spec.conv_layers():
        if l.size != 3:
            continue
        xshape, wshape = (BATCH_SHAPES, l.h, l.w, l.c), (3, 3, l.c, l.n)
        x, w, b, s = full_operands8(rng, xshape, wshape, np.int8, torch.int8)
        shift = int(np.median(s))   # the fitted shift; s spreads it by +-1
        check.compare("conv3x3_int8",
                      f"conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n} shift={shift}",
                      (*on(x, w, b), shift, l.activation == "leaky"),
                      timed=True)
    for shift in SHIFTS:
        for leaky in (False, True):
            x, w, b, _ = narrow_operands8(rng, (1, 13, 11, 3), (3, 3, 3, 40),
                                          np.int8, torch.int8, shift)
            check.compare("conv3x3_int8",
                          f"1x13x11x3->40 shift={shift} leaky={leaky}",
                          (*on(x, w, b), shift, leaky))


def nms_scene(rng, b: int, n: int, c: int, dev: torch.device,
              kind: str = "decoded") -> tuple:
    """Decoded region tensors (boxes (B, N, 4), obj (B, N), probs (B, N, C))
    on the card, as a scene of a few objects gives them: centers uniform
    over the frame, sizes up to 0.4 of it (many overlaps), objectness
    uniform, each box's class probabilities 0.7 on one of 6 classes and
    the rest spread (Dirichlet 0.1). ``kind``: "ties", objectness and class
    scores on coarse grids, as quantized heads give them; "empty", class 7
    never scores and class 0 dominates; "crowd", every candidate over the
    threshold and crowded into a quarter of the frame (a saturated top K,
    most boxes suppressed); "near", near_pairs: pairs of boxes whose IoU is
    the threshold in exact arithmetic, each pair alone in its cell and of
    one of 6 classes, its first box ahead of its second by objectness."""
    centers = rng.uniform(0.1, 0.9, (b, n, 2))
    sizes = rng.uniform(0.02, 0.4, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n))
    probs = 0.3 * rng.dirichlet(np.full(c, 0.1), (b, n))
    main = rng.integers(0, 6, (b, n))
    np.put_along_axis(probs, main[..., None], np.take_along_axis(
        probs, main[..., None], -1) + 0.7, -1)
    if kind == "ties":
        obj = rng.choice([0.0, 0.5, 0.75, 1.0], (b, n))
        probs = rng.choice([0.25, 0.5, 1.0], (b, n, c))
    elif kind == "empty":
        probs[..., 7] = 0.0
        probs[..., 0] += 0.5
    elif kind == "crowd":
        centers = rng.uniform(0.4, 0.6, (b, n, 2))
        obj = rng.uniform(0.5, 1.0, (b, n))
    boxes = np.concatenate([centers, sizes], -1)
    if kind == "near":
        pairs = n // 2
        boxes[:, :2 * pairs] = [near_pairs(rng, pairs) for _ in range(b)]
        first = rng.uniform(0.6, 1.0, (b, pairs))
        obj = np.zeros((b, n))   # an odd N's last box is no candidate
        obj[:, 0:2 * pairs:2], obj[:, 1:2 * pairs:2] = first, first - 1e-3
        probs = np.zeros((b, n, c))
        cls = np.repeat(rng.integers(0, 6, (b, pairs)), 2, axis=1)
        np.put_along_axis(probs[:, :2 * pairs], cls[..., None], 1.0, -1)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in (boxes, obj, probs))


def near_pairs(rng, pairs: int) -> np.ndarray:
    """(2 * pairs, 4) center-format boxes in pairs whose IoU is NMS_THRESH
    = 0.45 in exact arithmetic: equal heights, widths 29m and the second box
    shifted by 11m units of 2^-20 ((w - d) / (w + d) = 18/40), every
    coordinate a multiple of 2^-20 (so the corners and the overlap are
    exact), each pair alone in its cell of a g x g grid. Only the float32
    roundings of the products, the union and the quotient then decide
    whether iou > thresh: the pairs' IoUs fall within a few ulp of it, on
    both sides (as tests/test_torch_nms.py's _near_scene)."""
    unit = 2.0 ** -20
    g = int(np.ceil(np.sqrt(pairs)))
    cell = int(0.8 / g / unit)        # the room a pair may take, in units
    cells = np.arange(pairs)
    cx = np.round(((cells % g) + 0.1) / g / unit)
    cy = np.round(((cells // g) + 0.5) / g / unit)
    m = rng.integers(cell // 80, cell // 40, pairs)
    w, d = 29 * m, 11 * m             # the pair spans 40m <= cell
    h = 2 * rng.integers(cell // 8, cell // 2, pairs)
    a = np.stack([cx, cy, w, h], 1)
    b = np.stack([cx + d, cy, w, h], 1)
    return np.stack([a, b], 1).reshape(-1, 4) * unit


# fp32 operations of one IoU test: the overlap's 2 min, 2 max, 2 subtractions
# and 2 clamps, inter's product, the union's sum and difference, its clamp,
# the quotient and the comparison
IOU_OPS = 14


def nms_bound(cprob: torch.Tensor, cboxes: torch.Tensor) -> tuple:
    """(operations ms, bytes ms) of nms_greedy on these inputs: cboxes and
    cprob read once and the output written once; per frame K(K-1)/2 IoU
    tests (IOU_OPS each), and per frame and class n^2 score comparisons to
    rank its n live boxes (this run's data), fp32 operations outside the
    tensor cores."""
    b, k, c = cprob.shape
    live = (cprob > 0).sum(dim=1).double()
    ops = b * k * (k - 1) / 2 * IOU_OPS + float((live * live).sum())
    nbytes = 4 * (2 * cprob.numel() + cboxes.numel())
    return (ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3)


def near_threshold_pairs(cprob: torch.Tensor, cboxes: torch.Tensor) -> tuple:
    """(pairs of candidates live in one class whose IoU lies within NEAR_ULPS
    ulp of NMS_THRESH, of them over it), from box_iou_matrix on the card."""
    ious = nms.box_iou_matrix(cboxes, cboxes)
    ulp = float(np.spacing(np.float32(NMS_THRESH)))
    live = cprob > 0
    same = (live[:, :, None, :] & live[:, None, :, :]).any(-1)
    near = (((ious - NMS_THRESH).abs() <= NEAR_ULPS * ulp) & same).triu(1)
    return int(near.sum()), int((near & (ious > NMS_THRESH)).sum())


# the general convs' edge forms (B, H, W, C, N, k, stride, pad), each of
# them with ragged M
GENERAL_FORMS = (
    (1, 15, 13, 3, 7, 7, 2, 3),     # a 7x7/s2 entry, C=3, N=7
    (2, 9, 10, 12, 40, 5, 1, 2),    # 5x5/s1, darknet's padding
    (2, 9, 8, 4, 24, 3, 1, 0),      # 3x3 VALID
    (1, 11, 9, 7, 16, 2, 2, 0),     # 2x2/s2 padding=0 on odd H and W: the
                                    # last row and column are never read
    (2, 9, 7, 16, 425, 1, 2, 0),    # 1x1/s2, N=425
    (1, 8, 9, 8, 70, 3, 2, 2),      # 3x3/s2, padding=2
    (1, 5, 6, 4, 8, 3, 2, 3),       # 3x3/s2, padding=3: a row and a column
                                    # of windows all padding, bias only
    (1, 6, 7, 1024, 64, 3, 2, 1),   # C=1024
)
# the stream-K cases of the general convs: (B, H, W, C, N, k, stride, pad),
# the blocks the stream-K schedule is dealt to (None: the wrapper's own
# plan, whole tiles ruled out), the blocks that must share each tile (None:
# no condition), and what the case shows
SK_CASES = (
    ((1, 22, 22, 512, 64, 3, 2, 1), 4, 2,
     "2 tiles on 4 blocks, each tile shared by 2"),
    ((1, 22, 22, 512, 64, 3, 2, 1), 6, 3,
     "the same on 6 blocks, each tile shared by 3"),
    ((1, 8, 8, 512, 64, 3, 2, 1), None, None,
     "one output tile (M = 16 < 64) spread over blocks"),
    ((2, 20, 20, 64, 24, 3, 2, 1), None, None, "N = 24"),
    ((2, 20, 20, 64, 32, 3, 2, 1), None, None, "N = 32"),
    ((2, 20, 20, 64, 40, 3, 2, 1), None, None, "N = 40"),
    ((2, 20, 20, 64, 425, 3, 2, 1), None, None, "N = 425"),
    ((1, 17, 15, 13, 40, 3, 2, 1), None, None, "C = 13, the value gather"),
)
# general conv -> (x type, output type) of its operands
GENERAL_TYPES = {"conv_q16": (np.int16, torch.int16),
                 "conv_s8": (np.int8, torch.int8),
                 "conv_w8a16": (np.int16, torch.int16)}
S2_SIZE = 416
S2_BATCHES = (1, 2, BATCH_SLICE)


def yolov2_s2_cfg(size: int = S2_SIZE) -> str:
    """yolov2's cfg (``zoo.to_cfg``) with each of its five 2x2/s2 maxpools a
    3x3/s2 conv of the width before it (32, 64, 128, 256, 512), batch
    normalized and leaky: darknet-53-style downsampling, the layer indices,
    spatial sizes, reorg and routes as in yolov2; at size x size."""
    sections, filters = [], None
    for sec in zoo.to_cfg("yolov2").split("\n\n"):
        if sec.startswith("[maxpool]"):
            if "size=2\nstride=2" not in sec:
                raise AssertionError(f"yolov2's cfg has a maxpool {sec!r}")
            sec = ("[convolutional]\nbatch_normalize=1\n"
                   f"filters={filters}\nsize=3\nstride=2\npad=1\n"
                   "activation=leaky")
        if sec.startswith("[convolutional]"):
            filters = int(re.search(r"filters=(\d+)", sec).group(1))
        sections.append(sec)
    return re.sub(r"(width|height)=416", rf"\g<1>={size}",
                  "\n\n".join(sections))


# the small cfg of tests/test_torch_general_conv.py: a 7x7/s2 entry, a
# regular 3x3, a 3x3/s2, a regular 1x1, a 5x5, a 2x2/s2 padding=0, a VALID
# 3x3 (linear), a 1x1/s2 and a regular 3x3 head into a region
MIXED_SIZE = 96
MIXED_CFG = "\n\n".join(
    [f"[net]\nbatch=1\nwidth={MIXED_SIZE}\nheight={MIXED_SIZE}\nchannels=3"]
    + ["[convolutional]\n" + ("batch_normalize=1\n" if bn else "")
       + f"filters={n}\nsize={k}\nstride={st}\n{pad}\nactivation={act}"
       for n, k, st, pad, act, bn in (
           (16, 7, 2, "pad=1", "leaky", True), (32, 3, 1, "pad=1", "leaky", True),
           (32, 3, 2, "pad=1", "leaky", True), (16, 1, 1, "pad=1", "leaky", True),
           (32, 5, 1, "pad=1", "leaky", True),
           (32, 2, 2, "padding=0", "leaky", True),
           (48, 3, 1, "padding=0", "linear", True),
           (64, 1, 2, "pad=1", "leaky", True),
           (35, 3, 1, "pad=1", "linear", False))]
    + ["[region]\nanchors=0.57,0.68,1.87,2.06,3.34,5.47,7.88,3.53,9.77,9.17\n"
       "classes=2\ncoords=4\nnum=5\nsoftmax=1"]) + "\n"


def cfg_spec(text: str) -> NetworkSpec:
    """A cfg text parsed by the port's NetworkSpec.from_cfg."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "net.cfg")
        with open(path, "w") as f:
            f.write(text)
        return NetworkSpec.from_cfg(path)


def general_plan(name: str, x: torch.Tensor, w: torch.Tensor, stride: int,
                 pad: int) -> tc.StreamK:
    """The schedule the wrapper of general conv ``name`` launches for x and
    w: tc.stream_k's plan on tc.convk_tile."""
    scheme = TC_KERNELS[name][0]
    k, n = w.shape[0], w.shape[-1]
    ho, wo = q16.conv_out_hw(x.shape[1], x.shape[2], k, stride, pad)
    m, kk = x.shape[0] * ho * wo, k * k * x.shape[-1]
    sms = tc._sm_count(x.device.index or 0)
    return tc.stream_k(m, n, kk, sms, scheme,
                       tc.convk_tile(m, n, kk, sms, scheme))


def sharing(plan) -> dict[int, int]:
    """Tile -> the blocks whose segments sum it, in a stream-K plan."""
    blocks: dict[int, set] = {}
    for b, t, _, _ in plan.segments():
        blocks.setdefault(t, set()).add(b)
    return {t: len(bs) for t, bs in blocks.items()}


def plan_label(name: str, x, w, stride: int, pad: int) -> str:
    plan = general_plan(name, x, w, stride, pad)
    by = sharing(plan)
    shared = sum(v > 1 for v in by.values()) if plan.slots else 0
    return (f"{plan.bm}x{plan.bn} tiles, {plan.grid} blocks x "
            f"{plan.units / plan.grid:.1f} K steps, {shared}/{plan.tiles} "
            f"tiles shared (by up to {max(by.values())} blocks)")


def staged_bytes(name: str, x, w, stride: int, pad: int) -> int:
    """The bytes the kernel stages into shared memory for one call: per K
    step of each tile (a unit) BM rows of 128 bytes of A and a B stage of
    32 k x BN columns x planes per 32 k."""
    scheme = TC_KERNELS[name][0]
    plan = general_plan(name, x, w, stride, pad)
    return plan.units * (plan.bm * 128
                         + (scheme.bk // 32) * scheme.planes * 32 * plan.bn)


def s2_operands(name: str, rng, xshape, wshape, dev: torch.device) -> tuple:
    """Phase 9's operands of yolov2-s2's strided convs: int16 at full range
    with the shift FULL_SHIFT (the sums wrap), the 8-bit-weight kernels
    full range with a shift per column fitted to them; on dev."""
    def full(shape, dtype):
        return rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max + 1,
                            shape).astype(dtype)

    def on(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    if name == "conv_q16":
        return on(full(xshape, np.int16), full(wshape, np.int16),
                  small_bias(rng, wshape[-1])) + (FULL_SHIFT,)
    xdtype, out = GENERAL_TYPES[name]
    return on(*full_operands8(rng, xshape, wshape, xdtype, out))


def general_times(dev: torch.device, kernels=tuple(GENERAL_TYPES),
                  batches=(1, BATCH_SLICE)) -> dict:
    """Each of yolov2-s2's five strided convs alone on the device (CUDA
    graph replays) and around its wrapper (CUDA events) per kernel and
    batch, beside one library call (graph replays), the bound and the rate
    at which the kernel's staged bytes (staged_bytes) reach the SMs; summed
    per forward. Returns {kernel: {batch: {"graph_ms", "events_ms",
    "library_graph_ms", "bound", "convs"}}}."""
    rng = np.random.default_rng(15)
    spec = cfg_spec(yolov2_s2_cfg())
    strided = [l for l in spec.conv_layers() if l.stride == 2]
    out: dict = {}
    for bsz in batches:
        for name in kernels:
            module = KERNEL_MODULE[name]
            kernel, pack = getattr(module, name), TC_KERNELS[name][1]
            tot = {"graph_ms": 0.0, "events_ms": 0.0, "library_graph_ms": 0.0,
                   "bound": [0.0, 0.0, 0.0], "convs": []}
            for l in strided:
                args = s2_operands(name, rng, (bsz, l.h, l.w, l.c),
                                   (3, 3, l.c, l.n), dev) + (True, 2, 1)
                planes = pack(args[1])
                ms = graph_ms(lambda: kernel(*args, planes=planes))
                ev = cuda_ms(lambda: kernel(*args, planes=planes), reps=10)
                lib, what = library_call(name, args[0], args[1], (2, 1))
                lib_ms = graph_ms(lib, launches=5)
                want = kernel(*args, planes=planes)
                part = case_bound(args[0], args[1], args[2], want, args[3], True)
                staged = staged_bytes(name, args[0], args[1], 2, 1)
                tot["graph_ms"] += ms
                tot["events_ms"] += ev
                tot["library_graph_ms"] += lib_ms
                add_bound(tot["bound"], part)
                tot["convs"].append(ms)
                say(f"[general times] {name:10s} b={bsz} conv{l.idx} "
                    f"{l.h}x{l.w}x{l.c}->{l.n}: {ms:.4f} ms (graph replays; "
                    f"events {ev:.4f}), "
                    f"bound {max(part):.4f} ms "
                    f"({'operations' if part[0] >= part[1] else 'bytes'}), "
                    f"{what} {lib_ms:.4f} ms; "
                    f"{plan_label(name, args[0], args[1], 2, 1)}; staged "
                    f"{staged / 1e6:.2f} MB, {staged / ms / 1e9:.2f} TB/s "
                    "L2->SM")
                del args, planes, want
            say(f"[general times] {name} b={bsz} per forward (five strided "
                f"convs): {tot['graph_ms']:.4f} ms (graph replays; events "
                f"{tot['events_ms']:.4f}), bound "
                f"{tot['bound'][0]:.4f} ms ({bound_by(tot['bound'])}), "
                f"library {tot['library_graph_ms']:.4f} ms")
            out.setdefault(name, {})[bsz] = tot
    return out


def convk_sweep(dev: torch.device) -> None:
    """Each general conv on the stream-K kernel (conv_s8 with int8 output)
    at yolov2-s2's five strided convs at batch 1 and 8 on each tile of
    tc.CONVK_TILES, and on the chosen tile with whole tiles a block and with
    stream-K (SK_MIN_STEPS 4, 8 and 16): torch.equal to the plain version,
    and the device time in CUDA graph replays beside the wrapper's own
    choice."""
    rng = np.random.default_rng(16)
    spec = cfg_spec(yolov2_s2_cfg())
    strided = [l for l in spec.conv_layers() if l.stride == 2]
    saved = tc.convk_tile, tc.SK_MIN_STEPS, tc.SK_FIXUP
    for bsz in (1, BATCH_SLICE):
        for name in CONVK_KERNELS:
            module = KERNEL_MODULE[name]
            kernel, plain = getattr(module, name), getattr(module, name + "_plain")
            for l in strided:
                args = s2_operands(name, rng, (bsz, l.h, l.w, l.c),
                                   (3, 3, l.c, l.n), dev) + (True, 2, 1)
                planes = TC_KERNELS[name][1](args[1])
                want = plain(*args)
                chosen = saved[0](bsz * l.out_h * l.out_w, l.n, 9 * l.c,
                                  tc._sm_count(dev.index or 0),
                                  TC_KERNELS[name][0])
                plan = general_plan(name, args[0], args[1], 2, 1)
                variants = {f"{t[0]}x{t[1]}": (t, saved[1], saved[2])
                            for t in tc.CONVK_TILES}
                variants.update({"whole tiles": (chosen, saved[1], 10 ** 9),
                                 **{f"stream-K min {st}": (chosen, st, -10 ** 9)
                                    for st in (4, 8, 16)}})
                ms = {}
                try:
                    for label, (tile, steps, fixup) in variants.items():
                        tc.convk_tile = lambda *a, tile=tile: tile   # noqa: E731
                        tc.SK_MIN_STEPS, tc.SK_FIXUP = steps, fixup
                        tc.stream_k.cache_clear()
                        got = kernel(*args, planes=planes)
                        if not torch.equal(got, want):
                            raise AssertionError(f"{name} conv{l.idx} b={bsz} "
                                                 f"{label}: kernel != plain")
                        ms[label] = graph_ms(lambda: kernel(*args, planes=planes))
                finally:
                    tc.convk_tile, tc.SK_MIN_STEPS, tc.SK_FIXUP = saved
                    tc.stream_k.cache_clear()
                say(f"[convk sweep] {name:10s} b={bsz} conv{l.idx} "
                    f"{l.h}x{l.w}x{l.c}->{l.n} (equal in each): " + ", ".join(
                        f"{k} {v:.4f}" for k, v in ms.items())
                    + f"; chosen {plan.bm}x{plan.bn} "
                    + ("whole tiles" if plan.quantum > 1 else "stream-K"))
                del args, planes, want


def phase_kernels_general(check: KernelCheck, dev: torch.device) -> dict:
    """Phase 9: conv_q16, conv_s8 (both outputs) and conv_w8a16 against their
    plain versions (torch.equal) at yolov2-s2's five strided shapes, at the
    edge forms and at the stream-K cases; the five strided convs timed at
    batch 1 and 8 (general_times, returned)."""
    def on(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in arrays)

    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    spec = cfg_spec(yolov2_s2_cfg())
    strided = [l for l in spec.conv_layers() if l.stride == 2]
    say(f"[general] yolov2-s2 {S2_SIZE}x{S2_SIZE}: its five 3x3/s2 convs at "
        f"batch {', '.join(map(str, S2_BATCHES))} (timed at {BATCH_SLICE}: "
        "CUDA events and graph replays), full-range operands (int16: shift "
        f"{FULL_SHIFT}, the sums wrap; int8 and w8a16: a shift per column "
        "fitted to them); each on the schedule tc.stream_k plans")
    for l in strided:
        wshape = (3, 3, l.c, l.n)
        label = f"conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n} 3x3/s2"
        for bsz in S2_BATCHES:
            xshape = (bsz, l.h, l.w, l.c)
            for name in GENERAL_TYPES:
                args = s2_operands(name, rng, xshape, wshape, dev)
                check.compare(name, f"{label} b={bsz} "
                              f"{plan_label(name, args[0], args[1], 2, 1)}",
                              args + (True, 2, 1), wraps=name == "conv_q16",
                              timed=bsz == BATCH_SLICE)
    say(f"[general] the five strided convs at batch {BATCH_SLICE}, per "
        "forward: " + "; ".join(
            f"{name} events {check.ms[name]:.4f} ms, graph replays "
            f"{check.graph_ms[name]:.4f} ms, bound {check.bound[name][0]:.4f} "
            f"ms ({bound_by(check.bound[name])}), plain "
            f"{check.plain_ms[name]:.3f} ms, "
            f"{' / '.join(sorted(check.library[name]))} "
            f"{check.library_ms[name]:.3f} ms" for name in GENERAL_TYPES))
    times = general_times(dev)
    convk_sweep(dev)

    say(f"[general] edge forms {GENERAL_FORMS} (B, H, W, C, N, k, stride, "
        f"pad), each kernel, shifts {SHIFTS} x leaky on/off (int16: narrow "
        "operands; int8, w8a16: narrow ones at each shift broadcast, then a "
        "shift vector mixing them)")
    cases = 0
    for (bb, h, wd, c, n, k, st, pad) in GENERAL_FORMS:
        xshape, wshape = (bb, h, wd, c), (k, k, c, n)
        label = f"{bb}x{h}x{wd}x{c}->{n} {k}x{k}/s{st} pad {pad}"
        for leaky in (False, True):
            for shift in SHIFTS:
                x, w, b = on(*narrow_operands(rng, xshape, wshape, shift))
                check.compare("conv_q16", f"{label} shift={shift} "
                              f"leaky={leaky}", (x, w, b, shift, leaky, st, pad))
                cases += 1
                # at K=9216 even +-1 8-bit operands saturate at shift -3:
                # C=1024 takes its shifts from the mixed case's sparse columns
                for name in ("conv_s8", "conv_w8a16") if c < 1024 else ():
                    xdtype, out = GENERAL_TYPES[name]
                    args = on(*narrow_operands8(rng, xshape, wshape, xdtype,
                                                out, shift))
                    check.compare(name, f"{label} shift={shift} "
                                  f"leaky={leaky}", args + (leaky, st, pad))
                    cases += 1
            for name in ("conv_s8", "conv_w8a16"):
                xdtype, out = GENERAL_TYPES[name]
                args = on(*mixed_operands8(rng, xshape, wshape, xdtype, out))
                check.compare(name, f"{label} mixed shifts leaky={leaky}",
                              args + (leaky, st, pad))
                cases += 1

    say("[general] the int8 head16 form (conv_s8's int16 output, shift - 8, "
        "bias << 8): the yolov2 head's widths as a 3x3 conv at batch 2, and "
        "a 3x3/s2 with N=425 and mixed shifts; sums built to wrap (int16 "
        f"blocks of {WRAP_BLOCK} products (-32768)^2, w8a16 blocks of "
        f"{WRAP_BLOCK8} products (-32768)*(-128)) at each shift")
    for leaky in (False, True):
        # sized for int8 outputs: head16's shift - 8 and bias << 8 spread
        # them over int16
        x, w, b, s = on(*full_operands8(rng, (2, 13, 13, 1024),
                                        (3, 3, 1024, 425), np.int8,
                                        torch.int8))
        b, s = convops.head16(b, s)
        check.compare("conv_s8", f"head16 2x13x13x1024->425 3x3/s1 "
                      f"leaky={leaky}", (x, w, b, s, leaky, 1, 1),
                      out_dtype=torch.int16)
        x, w, b, s = on(*mixed_operands8(rng, (1, 9, 7, 64), (3, 3, 64, 425),
                                         np.int8, torch.int8))
        b, s = convops.head16(b, s)
        check.compare("conv_s8", f"head16 1x9x7x64->425 3x3/s2 mixed shifts "
                      f"leaky={leaky}", (x, w, b, s, leaky, 2, 1),
                      out_dtype=torch.int16)
        cases += 2
        for shift in SHIFTS:
            for (bb, h, wd, n, k, st, pad) in ((2, 9, 7, 70, 3, 2, 1),
                                               (1, 7, 6, 24, 5, 1, 2)):
                x, w, b = on(*wrap_operands(rng, bb * h * wd, k * k, n, shift,
                                            nblk=2))
                c = x.shape[-1]
                check.compare("conv_q16", f"wrap {bb}x{h}x{wd}x{c}->{n} "
                              f"{k}x{k}/s{st} shift={shift} leaky={leaky}",
                              (x.reshape(bb, h, wd, c), w.reshape(k, k, c, n),
                               b, shift, leaky, st, pad), wraps=True)
                x, w, b, s = on(*wrap_operands8(rng, bb * h * wd, k * k, n,
                                                shift, nblk=1))
                c = x.shape[-1]
                check.compare("conv_w8a16", f"wrap {bb}x{h}x{wd}x{c}->{n} "
                              f"{k}x{k}/s{st} shift={shift} leaky={leaky}",
                              (x.reshape(bb, h, wd, c), w.reshape(k, k, c, n),
                               b, s, leaky, st, pad), wraps=True)
                cases += 2

    say(f"[general] K beyond one split ({tc.KMAX} values of k): a 7x7/s2 "
        "conv over 1024 channels (K=50,176), pad 3, operands at their "
        "extremes (int16 -32513: high byte -128, low byte 255; int8 -128); "
        "and a 7x7 VALID int8 conv over 2731 channels (K=133,819) at -128, "
        "whose exact sum leaves int32")
    for leaky in (False, True):
        for name, xv, wv, shift, wraps in (("conv_q16", -32513, -32513, 18, True),
                                           ("conv_w8a16", -32513, -128, 18, True),
                                           ("conv_s8", -128, -128, 23, False)):
            xdtype, out = GENERAL_TYPES[name]
            x = np.full((1, 9, 9, 1024), xv, xdtype)
            w = np.full((7, 7, 1024, 16), wv,
                        np.int16 if name == "conv_q16" else np.int8)
            if name == "conv_q16":
                args = on(x, w, small_bias(rng, 16)) + (shift,)
            else:
                args = on(x, w, bias8(rng, 16, out),
                          np.full(16, shift, np.int32))
            check.compare(name, f"1x9x9x1024->16 7x7/s2 pad 3 (K=50176) "
                          f"x={xv} w={wv} leaky={leaky}",
                          args + (leaky, 2, 3), wraps=wraps)
        x = np.full((3, 7, 7, 2731), -128, np.int8)
        w = np.full((7, 7, 2731, 16), -128, np.int8)
        args = on(x, w, bias8(rng, 16, torch.int8), np.full(16, 25, np.int32))
        check.compare("conv_s8", f"3x7x7x2731->16 7x7 VALID (K=133819) -128 "
                      f"leaky={leaky}", args + (leaky, 1, 0), wraps=True)
        cases += 4
    say(f"[general] {cases} edge cases equal, each with at least "
        f"{UNSAT_FLOOR} of its outputs unsaturated, and {WRAP_FLOOR} "
        "unsaturated with a wrapped sum where built to wrap")

    say("[general] stream-K cases of conv_q16, conv_w8a16 and conv_s8 "
        "(int8 output, and int16 in the head16 form), whole tiles ruled out "
        f"(SK_FIXUP off), each with full-range operands (int16: shift "
        f"{FULL_SHIFT}, the sums wrap) and narrow ones at shift 7")
    sk = 0
    plan_of = tc.stream_k
    outs = [(name, None) for name in CONVK_KERNELS] + [("conv_s8", torch.int16)]
    with unittest.mock.patch.object(tc, "SK_FIXUP", -10 ** 9):
        tc.stream_k.cache_clear()
        for (bb, h, wd, c, n, k, st, pad), blocks, by, what in SK_CASES:
            xshape, wshape = (bb, h, wd, c), (k, k, c, n)

            def dealt(*a, blocks=blocks):
                return dataclasses.replace(plan_of(*a), grid=blocks, quantum=1)

            with (unittest.mock.patch.object(tc, "stream_k", dealt)
                  if blocks else contextlib.nullcontext()):
                for name, out16 in outs:
                    full = s2_operands(name, rng, xshape, wshape, dev)
                    xdtype, out = GENERAL_TYPES[name]
                    kw = {}
                    if out16:   # the int8 sizing, moved to int16 by head16
                        full = full[:2] + convops.head16(*full[2:])
                        out, kw = out16, {"out_dtype": out16}
                    narrow = (on(*narrow_operands(rng, xshape, wshape, 7)) + (7,)
                              if name == "conv_q16" else
                              on(*narrow_operands8(rng, xshape, wshape, xdtype,
                                                   out, 7)))
                    plan = general_plan(name, full[0], full[1], st, pad)
                    shared = sharing(plan)
                    if by is not None and set(shared.values()) != {by} \
                            or plan.quantum != 1:
                        raise AssertionError(f"{name} {what}: the plan {plan} "
                                             f"shares its tiles {shared}")
                    label = (f"{bb}x{h}x{wd}x{c}->{n} {k}x{k}/s{st} pad {pad}, "
                             f"{what}{' (int16 output)' if out16 else ''}: "
                             f"{plan_label(name, full[0], full[1], st, pad)}")
                    check.compare(name, label + " full range",
                                  full + (True, st, pad),
                                  wraps=name == "conv_q16", **kw)
                    check.compare(name, label + " narrow",
                                  narrow + (True, st, pad), **kw)
                    sk += 2
    tc.stream_k.cache_clear()
    say(f"[general] {sk} stream-K cases equal; phase 9 took "
        f"{time.perf_counter() - t0:.1f} s")
    return times


def phase_kernels_nms(check: KernelCheck, dev: torch.device) -> dict:
    """nms_greedy against its plain version (torch.equal) on the candidate
    tables that topk_decode_nms hands it: at yolov2 416's shape (N=845,
    K=256, C=80) at batch 1 and 8, timed (CUDA events around the wrapper,
    and alone on the device in CUDA graph replays) beside the plain version
    and the bound; then at edge cases, among them pairs of boxes whose IoU
    lies within a few ulp of the threshold (where an FMA in the kernel's
    IoU would show); then the walk's classes per block swept. Returns, per
    batch, the kernel's numbers for the JSON line."""
    rng = np.random.default_rng(21)
    n, k, c = NMS_SHAPE
    say(f"[kernels] nms_greedy: yolov2 416 tables (N={n}, K={k}, C={c}, "
        f"IoU threshold {NMS_THRESH}) at batch 1 and {BATCH_SLICE}, then "
        "tied scores, an empty class, K=N, a saturated crowd, K=1024 and "
        "pairs at the threshold")
    out = {}

    def one(label: str, scene: tuple, topk: int, timed: bool = False):
        cboxes, cprob, sat = nms.candidates(*scene, 0.25, topk)
        got = nms.nms_greedy(cprob, cboxes, NMS_THRESH)
        want = nms.nms_greedy_plain(cprob, cboxes, NMS_THRESH)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check.max_abs_err["nms_greedy"] = max(check.max_abs_err["nms_greedy"],
                                              err)
        if not torch.equal(got, want):
            raise AssertionError(f"nms_greedy {label}: kernel != plain (max "
                                 f"abs err {err}, {int((got != want).sum())} "
                                 "scores differ)")
        scored = int((cprob > 0).sum())
        kept = int((want > 0).sum())
        if not 0 < kept < scored:
            raise AssertionError(f"nms_greedy {label}: blind case, {kept} of "
                                 f"{scored} class scores kept")
        line = (f"  nms_greedy {label:34s} equal, {kept} of {scored} class "
                f"scores kept, saturated {sat.tolist()}")
        if timed:
            f = {"ms": cuda_ms(lambda: nms.nms_greedy(cprob, cboxes,
                                                      NMS_THRESH), reps=20),
                 "graph_ms": graph_ms(lambda: nms.nms_greedy(cprob, cboxes,
                                                             NMS_THRESH)),
                 "plain_ms": cuda_ms(lambda: nms.nms_greedy_plain(
                     cprob, cboxes, NMS_THRESH), reps=2)}
            part = nms_bound(cprob, cboxes)
            f["bound"] = [max(part), part[0] if part[0] >= part[1] else 0.0,
                          part[1] if part[1] > part[0] else 0.0]
            out[cprob.shape[0]] = f
            line += (f"; kernel {f['ms']:.4f} ms (events), {f['graph_ms']:.4f}"
                     f" ms alone on the device (graph replays), plain "
                     f"{f['plain_ms']:.3f} ms, bound {max(part):.5f} ms "
                     f"({bound_by(f['bound'])}), no library call")
        say(line)
        return cboxes, cprob

    tables = {f"b={bsz}": one(f"b={bsz} N={n} K={k} C={c}",
                              nms_scene(rng, bsz, n, c, dev), k, timed=True)
              for bsz in (1, BATCH_SLICE)}
    one(f"ties b=3 N={n} K={k}", nms_scene(rng, 3, n, c, dev, "ties"), k)
    one(f"an empty class b=2 N={n} K={k}", nms_scene(rng, 2, n, c, dev,
                                                      "empty"), k)
    tables["K=N"] = one(f"K=N b=2 N={n} K={n}", nms_scene(rng, 2, n, c, dev),
                        n)
    one(f"saturated crowd b=2 N={n} K={k}", nms_scene(rng, 2, n, c, dev,
                                                       "crowd"), k)
    one("K=1024 b=1 N=1100 C=20", nms_scene(rng, 1, 1100, 20, dev), 1024)
    for topk in (k, n):
        cboxes, cprob = one(f"near the threshold b=2 N={n} K={topk}",
                            nms_scene(rng, 2, n, c, dev, "near"), topk)
        near, over = near_threshold_pairs(cprob, cboxes)
        if near < NEAR_FLOOR * topk // 2 or not 10 <= over <= near - 10:
            raise AssertionError(
                f"nms_greedy near the threshold, K={topk}: blind case, {near} "
                f"pairs of one class within {NEAR_ULPS} ulp of {NMS_THRESH}, "
                f"{over} of them over it")
        say(f"  nms_greedy near the threshold K={topk}: {near} pairs of one "
            f"class within {NEAR_ULPS} ulp of the threshold ({over} over it), "
            "every one decided as box_iou_matrix decides it")
    phase_nms_warps(tables)
    return out



def phase_nms_warps(tables: dict) -> None:
    """The walk's classes per block (nms.WARPS) against the others that fit
    a block's shared memory: each alone on the device (graph_ms) on phase
    2's yolov2 416 tables at batch 1 and 8 and at K=N, each also held to the
    plain version."""
    chosen = nms.WARPS
    for label, (cboxes, cprob) in tables.items():
        b, k, _ = cprob.shape
        want = nms.nms_greedy_plain(cprob, cboxes, NMS_THRESH)
        times = {}
        try:
            for w in NMS_WARPS_SWEEP:
                if nms.walk_smem(k, w) > nms.SMEM_MAX:
                    continue
                nms.WARPS = w
                if not torch.equal(nms.nms_greedy(cprob, cboxes, NMS_THRESH),
                                   want):
                    raise AssertionError(f"nms_greedy {label} with {w} "
                                         "classes a block: != plain")
                times[w] = graph_ms(lambda: nms.nms_greedy(cprob, cboxes,
                                                           NMS_THRESH))
        finally:
            nms.WARPS = chosen
        say(f"  nms_greedy {label} (B={b}, K={k}), classes a block: "
            + ", ".join(f"{w} {ms:.4f}" for w, ms in times.items())
            + f" ms alone on the device (nms.WARPS = {chosen}; the fastest "
            f"{min(times, key=times.get)})")


def quantized_store(spec) -> WeightStore:
    """Synthetic weights from seed 0, calibrated on one seeded image and
    quantized for the three integer tiers, as load_or_synthesize does it."""
    store = WeightStore.synthetic(spec, seed=0)
    rng = np.random.default_rng(0)
    calib = [rng.random((3, spec.net.height, spec.net.width), dtype=np.float32)]
    act_q = calibrate_activations(spec, store, calib)
    quantize_weights(store, act_q)
    quantize_weights_w8a16(store, act_q)
    quantize_weights_int8(store, calibrate_activations_int8(spec, store, calib))
    return store


@functools.cache
def s2_store() -> tuple:
    """yolov2-s2 at S2_SIZE and its quantized_store, made once for phases
    10 and 8."""
    spec = cfg_spec(yolov2_s2_cfg())
    return spec, quantized_store(spec)


def close_heads(got: np.ndarray, want: np.ndarray, fp32: bool) -> bool:
    """Integer tiers: bit-equal. fp32: within FP32_HEAD_TOL of the largest
    magnitude (two summation orders of cuDNN's, or cuDNN's and oneDNN's)."""
    if not fp32:
        return np.array_equal(got, want)
    return bool(np.abs(got - want).max() <= FP32_HEAD_TOL * np.abs(want).max())


def hold_detect_heads(tag: str, spec, frames: list, results: list,
                      ref: YoloV2Q, dev: torch.device, fp32: bool) -> None:
    """Each detect request's head (a replay of the batch-1 graph) against
    ``ref``, eager on the same letterboxed frame on the card: the plain
    versions (integer tiers; at batch 1 the tensor-core kernels split K as
    they do at no other batch) or the fp32 model itself."""
    for i, (im, (_, res)) in enumerate(zip(frames, results)):
        boxed = letterbox_image(im, spec.net.width, spec.net.height)
        x = torch.from_numpy(np.ascontiguousarray(
            boxed.transpose(1, 2, 0)[None], np.float32)).to(dev)
        want = ref(x)["head"][0].permute(2, 0, 1).cpu().numpy()
        if not close_heads(res.head_chw, want, fp32):
            raise AssertionError(f"{tag} request {i}: replayed head (batch 1) "
                                 "!= the eager one on the card")
    say(f"{tag} the {len(results)} detect heads (batch 1, replayed) "
        f"{'within tolerance of' if fp32 else 'bit-equal to'} the "
        f"{'eager model' if fp32 else 'plain versions'} on the card")


def kept(dets: list, thresh: float = 0.25) -> list[tuple]:
    """(class, score, box) of each detection whose best class is over the
    threshold, by class and score (as tests/test_torch_nms.py)."""
    return sorted((*d.best_class(), *d.bbox) for d in dets
                  if d.best_class()[1] > thresh)


def same_detections(got: list, want: list) -> bool:
    """The same classes, scores and boxes within rtol 1e-4 (the host path
    decodes in numpy, the device path in PyTorch on the card)."""
    return ([g[0] for g in got] == [w[0] for w in want]
            and (not got or np.allclose([g[1:] for g in got],
                                        [w[1:] for w in want],
                                        rtol=1e-4, atol=1e-6)))


def close_tables(got: tuple, want: tuple, fp32: bool) -> bool:
    """Top-K tables (boxes, scores, classes, valid) equal, or in fp32 the
    boxes and scores within rtol 1e-4 and the rest equal."""
    if not fp32:
        return all(np.array_equal(g, w) for g, w in zip(got, want))
    return (np.allclose(got[0], want[0], rtol=1e-4, atol=1e-6)
            and np.allclose(got[1], want[1], rtol=1e-4, atol=1e-6)
            and np.array_equal(got[2], want[2])
            and np.array_equal(got[3], want[3]))


def tables_of(out: dict) -> tuple:
    return tuple(out[k].cpu().numpy() for k in ("det_boxes", "det_scores",
                                                "det_classes", "det_valid"))


def graph_of(eng: Engine, dtype: torch.dtype, shape: tuple,
             letterbox: bool = False):
    return eng.graphs[(letterbox, dtype, shape)]


def in_turns(fns: dict, measure) -> dict:
    """measure(fn) of each of two functions in turns (a, b, b, a)."""
    (a, fa), (b, fb) = fns.items()
    got = {a: [], b: []}
    for who, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        got[who].append(measure(fn))
    return got


def replay_fn(g):
    """One replay of a captured forward, its head read to the host."""
    def run():
        g.graph.replay()
        return g.out["head"].cpu()
    return run


def check_tf32_off(tag: str, model: YoloV2Q, dev: torch.device) -> None:
    """The fp32 tier's conv runs with TF32 off: one of its convs on random
    inputs against a float64 conv on the card, within 1e-5 of the sum of
    absolute products (TF32 keeps about 3 decimal digits: its error there is
    about 1e-3), and cuDNN's own flag left as the caller had it."""
    l = next(l for l in model.spec.conv_layers() if l.size == 3 and l.c >= 256)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, l.h, l.w, l.c),
                                             dtype=np.float32)).to(dev)
    w = getattr(model, f"w{l.idx}").permute(1, 2, 3, 0)   # HWIO view
    flag = torch.backends.cudnn.allow_tf32
    got = convops.conv_fp32(x, w, torch.zeros(l.n, device=dev), 1, l.pad,
                            "linear").double()

    def conv64(a, b):
        return torch.nn.functional.conv2d(
            a.double().permute(0, 3, 1, 2), b.double().permute(3, 2, 0, 1),
            padding=l.pad).permute(0, 2, 3, 1)

    err = float(((got - conv64(x, w)).abs() / conv64(x.abs(), w.abs())).max())
    if err > 1e-5 or torch.backends.cudnn.allow_tf32 != flag:
        raise AssertionError(f"{tag} conv{l.idx}: relative error {err:.2e} "
                             "against float64 (TF32 on?), or cuDNN's TF32 "
                             f"flag changed ({flag} -> "
                             f"{torch.backends.cudnn.allow_tf32})")
    say(f"{tag} TF32 off: conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n} within "
        f"{err:.2e} of float64 (relative to the sum of |products|); cuDNN's "
        f"allow_tf32 left at {flag}")


def phase_slice(spec, store: WeightStore, tier: str,
                dev: torch.device) -> dict:
    """One tier's main path, every forward a replay of a CUDA graph that the
    engines captured: Engine (the head; letterbox, decode and NMS on the
    host) serves 3 detect requests and a batch of BATCH_SLICE uint8 frames;
    Engine(device_nms=True) 3 detect_device requests, the same batch's top-K
    tables and a batch of 2 raw frames letterboxed on the card. Then its
    launch counts (per captured forward: each graph runs its forward once
    eagerly before its capture) and replays (one per request), its heads
    and tables against the eager forward and the plain versions on the card
    and the CPU, detect_device against detect, and the ms per batch and
    batch-1 latency, eager and replayed in turns. Returns the launches, the
    launches per forward, the two engines and the plain twin (None in
    fp32)."""
    fp32 = tier == "fp32"
    tag = f"[slice {tier}]"
    rng = np.random.default_rng(0)
    net = (1, spec.net.height, spec.net.width, 3)
    frames = [rng.random((3, 480, 640), dtype=np.float32) for _ in range(3)]
    batch = rng.integers(0, 256, (BATCH_SLICE, *net[1:]), dtype=np.uint8)
    raw = rng.integers(0, 256, (2, *RAW_SHAPES[0], 3), dtype=np.uint8)
    names = names_for(spec.region.classes)
    oc = spec.layers[-1].out_c
    lh, lw = spec.layers[-1].out_h, spec.layers[-1].out_w

    # the main path, with the launch counts read around it
    reset_launches()
    eng = Engine(spec, store, tier, dev)
    det = Engine(spec, store, tier, dev, device_nms=True)
    per_forward = ({} if fp32 else route_launches(
        tier, engine_plan.kernels(spec, eng.model.kinds)))
    if tier == "int16":
        path = card_plan_file(dev)
        if (eng.plan_source != path or det.plan_source != path
                or eng.model.kinds != planned_kinds(spec, dev)):
            raise AssertionError(f"{tag} the engines read the plan "
                                 f"{eng.plan_source} / {det.plan_source}, "
                                 f"kinds {eng.model.kinds}; want {path}")
        say(f"{tag} plan: {eng.plan_source or 'no plan file, the rule'}; "
            "kinds " + ", ".join(f"{i}:{k}" for i, k in
                                 eng.model.kinds.items()))
    g1 = graph_of(eng, torch.float32, net)
    results = []
    for im in frames:
        before, replays = launch_counts(), g1.replays
        results.append(eng.detect(im))
        if launch_counts() != before or g1.replays != replays + 1:
            raise AssertionError(f"{tag} detect was not one replay of the "
                                 "batch-1 graph")
    heads = eng.predict_batch_rgb(batch)
    device = [det.detect_device(im) for im in frames]
    tables = det.predict_batch_detections(batch)
    raw_tables = det.predict_batch_raw_frames(raw)
    torch.cuda.synchronize()
    launches = launch_counts()
    graphs = (len(eng.graphs), len(det.graphs))
    replays = sum(g.replays for e in (eng, det) for g in e.graphs.values())
    forwards = 2 * sum(graphs)   # each graph: one warm-up run, one capture
    want = dict.fromkeys(launches, 0)
    want.update({k: forwards * v for k, v in per_forward.items()})
    want["nms_greedy"] = 2 * graphs[1]
    if graphs != (2, 3) or launches != want or replays != 9:
        raise AssertionError(f"{tag} main path: {graphs} graphs, {replays} "
                             f"replays, launched {launches}; want (2, 3), 9, "
                             f"{want}")
    head16 = q8.INT16_OUT_LAUNCHES["mm_s8"]
    if head16 != (forwards if tier == "int8" else 0):
        raise AssertionError(f"{tag} {head16} mm_s8 launches wrote int16")
    per_forward["nms_greedy"] = 1
    say(f"{tag} main path (3 detect + 1 batch of {BATCH_SLICE} through "
        f"Engine, 3 detect_device + 1 batch of {BATCH_SLICE} + 1 raw batch of "
        f"2 {RAW_SHAPES[0]} through Engine(device_nms=True)): {sum(graphs)} "
        f"graphs captured, {replays} replays for 9 requests; launched "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f" = {forwards} captured forwards x {per_forward} per forward "
        f"(nms_greedy: the device-NMS engine's {2 * graphs[1]})"
        + (f"; {head16} mm_s8 launches with int16 output (head16)"
           if tier == "int8" else ""))

    for i, ((dets, res), (ddets, dsec)) in enumerate(zip(results, device)):
        top = sorted(dets, key=lambda d: d.objectness, reverse=True)[:2]
        desc = "; ".join(
            f"obj {d.objectness:.3f} {names[int(d.prob.argmax())]} "
            f"p={d.prob.max():.4f} box ({d.bbox[0]:.3f},{d.bbox[1]:.3f},"
            f"{d.bbox[2]:.3f},{d.bbox[3]:.3f})" for d in top)
        if not np.isfinite(res.head_chw).all():
            raise AssertionError(f"{tag} request {i}: non-finite head")
        say(f"{tag} request {i}: detect {res.seconds * 1e3:.2f} ms, "
            f"{len(dets)} boxes over the objectness threshold, "
            f"{len(kept(dets))} over 0.25 in their best class; detect_device "
            f"{dsec * 1e3:.2f} ms, "
            f"{len(ddets)}{'; top: ' + desc if desc else ''}")
    # detect_device against detect, as tests/test_torch_nms.py holds them:
    # with K = N (every box a candidate, so never saturated) and a threshold
    # that the synthetic weights' class scores reach
    n_boxes = lh * lw * spec.region.num
    agree = Engine(spec, store, tier, dev, device_nms=True,
                   thresh=DETECT_THRESH, topk=n_boxes)
    counts = []
    for i, im in enumerate(frames):
        host = kept(eng.detect(im, DETECT_THRESH)[0], DETECT_THRESH)
        got = kept(agree.detect_device(im)[0], DETECT_THRESH)
        if not host or not same_detections(got, host):
            raise AssertionError(f"{tag} request {i} at threshold "
                                 f"{DETECT_THRESH}: detect_device kept "
                                 f"{len(got)} {got[:3]}..., detect {len(host)} "
                                 f"{host[:3]}...")
        counts.append(len(got))
    say(f"{tag} detect_device == detect on the 3 frames at threshold "
        f"{DETECT_THRESH}, K=N={n_boxes}: {counts} detections (classes equal, "
        "scores and boxes within rtol 1e-4)")

    if heads.shape != (BATCH_SLICE, oc, lh, lw) or not np.isfinite(heads).all():
        raise AssertionError(f"{tag} batch head {heads.shape}, finite "
                             f"{np.isfinite(heads).all()}")
    if len(np.unique(heads)) < 1000:
        raise AssertionError(f"{tag} batch head takes only "
                             f"{len(np.unique(heads))} values")

    # the replayed heads and tables against the eager forward, the plain
    # versions on the card and the CPU
    xb = torch.from_numpy(batch).to(dev)
    eager = eng.model(xb)["head"].permute(0, 3, 1, 2).cpu().numpy()
    if not close_heads(heads, eager, fp32):
        raise AssertionError(f"{tag} batch head: replayed != eager")
    plain = None if fp32 else PlainYoloV2Q(spec, eng.qtables, eng.params, dev,
                                           tier)
    hold_detect_heads(tag, spec, frames, results, eng.model if fp32 else plain,
                      dev, fp32)
    if plain is not None and not np.array_equal(
            heads, plain(xb)["head"].permute(0, 3, 1, 2).cpu().numpy()):
        raise AssertionError(f"{tag} batch head: kernels != plain versions "
                             "on the card")
    cpu_params = {k: {n: t.cpu() for n, t in v.items()} for k, v in eng.params.items()}
    cpu_model = YoloV2Q(spec, eng.qtables, cpu_params, "cpu", tier)
    t0 = time.perf_counter()
    cpu_head = cpu_model(torch.from_numpy(batch[:1]))["head"].permute(0, 3, 1, 2).numpy()
    cpu_s = time.perf_counter() - t0
    if not close_heads(heads[:1], cpu_head, fp32):
        raise AssertionError(f"{tag} frame 0 head: the card != the CPU "
                             f"(max abs diff {np.abs(heads[:1] - cpu_head).max()})")
    rel = float(np.abs(heads[:1] - cpu_head).max() / np.abs(cpu_head).max())
    say(f"{tag} head {heads.shape} "
        + (f"replayed within {rel:.2e} (of its largest magnitude; tolerance "
           f"{FP32_HEAD_TOL}) of the CPU's (frame 0, {cpu_s:.1f} s), "
           f"{np.abs(heads - eager).max():.2e} from the eager forward"
           if fp32 else
           f"bit-equal: replayed == eager == plain on the card (batch "
           f"{BATCH_SLICE}) == plain on the CPU (frame 0, {cpu_s:.1f} s)")
        + f"; {len(np.unique(heads))} distinct values")
    if fp32:
        check_tf32_off(tag, eng.model, dev)
    if not close_tables(tables, tables_of(det.model(xb)), fp32):
        raise AssertionError(f"{tag} batch top-K tables: replayed != eager")
    boxed = np.stack([letterbox_image(
        (f.astype(np.float32) / np.float32(255)).transpose(2, 0, 1),
        spec.net.width, spec.net.height) for f in raw])
    if not close_tables(raw_tables, det.predict_batch_detections(boxed), fp32):
        raise AssertionError(f"{tag} raw frames: the tables of the card's "
                             "letterbox != those of the host's")
    say(f"{tag} top-K tables (batch {BATCH_SLICE}, "
        f"{int(tables[3].sum())} valid) replayed == eager; raw "
        f"{RAW_SHAPES[0]} frames letterboxed on the card: "
        f"{int(raw_tables[3].sum())} valid, == the host letterbox's"
        + (" (fp32: boxes and scores within rtol 1e-4)" if fp32 else ""))

    # ms per batch and batch-1 latency, eager and replayed in turns, on
    # device-resident frames
    g8 = graph_of(eng, torch.uint8, (BATCH_SLICE, *net[1:]))
    ms = in_turns({"eager": lambda: eng.model(xb), "replay": g8.graph.replay},
                  lambda fn: cuda_ms(fn, reps=20))
    x1 = g1.inp.clone()
    lat = in_turns({"eager": lambda: eng.model(x1)["head"].cpu(),
                    "replay": replay_fn(g1)}, latency_ms)
    for who in ("eager", "replay"):
        say(f"{tag} {who:6s} batch {BATCH_SLICE}: "
            f"{' / '.join(f'{v:.3f}' for v in ms[who])} ms per batch (in "
            f"turns); batch 1 latency p50 "
            f"{' / '.join(f'{v[0]:.3f}' for v in lat[who])} ms, p90 "
            f"{' / '.join(f'{v[1]:.3f}' for v in lat[who])} ms")
    if fp32:
        flops = BATCH_SLICE * sum(2 * l.out_h * l.out_w * l.n * l.c * l.size ** 2
                                  for l in spec.conv_layers())
        say(f"{tag} {flops / 1e9:.1f} GFLOP of convs per batch of "
            f"{BATCH_SLICE}: {flops / np.mean(ms['replay']) / 1e9:.1f} "
            f"TFLOP/s replayed, of the card's {PEAK_FP32 / 1e12:.0f} in fp32")
    # what the decode and the NMS add to a replayed forward
    d1 = graph_of(det, torch.float32, net)
    d8 = graph_of(det, torch.uint8, (BATCH_SLICE, *net[1:]))
    extra = {bsz: in_turns({"head": h.graph.replay, "nms": d.graph.replay},
                           lambda fn: cuda_ms(fn, reps=20))
             for bsz, h, d in ((1, g1, d1), (BATCH_SLICE, g8, d8))}
    for bsz, v in extra.items():
        say(f"{tag} device NMS at batch {bsz}: replay "
            f"{' / '.join(f'{t:.3f}' for t in v['nms'])} ms against "
            f"{' / '.join(f'{t:.3f}' for t in v['head'])} ms head only: "
            f"+{np.mean(v['nms']) - np.mean(v['head']):.3f} ms per forward")
    return {"launches": launches, "per_forward": per_forward, "eng": eng,
            "det": det, "plain": plain, "replay_ms": float(np.mean(ms["replay"]))}


def boxes_of(dets: list) -> np.ndarray:
    """Each detection's box, objectness and class probabilities, in order."""
    return np.array([[*d.bbox, d.objectness, *d.prob] for d in dets],
                    np.float32).reshape(len(dets), -1)


def phase_rule(spec, store: WeightStore, planned: dict,
               dev: torch.device) -> dict:
    """The rule run: an int16 Engine with no plan file serves phase_slice's
    requests (3 detect, a batch of BATCH_SLICE uint8 frames), its launches
    per captured forward those of the rule's kinds; the planned engine's
    (``planned``, phase_slice's int16 result, whose heads it held to the
    plain path) detect boxes and heads and its batch head equal
    (``torch.equal``) to the rule's, and the rule's batch head to the plain
    path's; the two engines' replays timed in turns (rule, plan, plan, rule)
    at BATCH_SLICE and 1 (CUDA events) and their b=1 latency (host clock).
    Returns the launches, the launches per forward, the engine and the
    plain twin."""
    tag = "[plan rule]"
    rng = np.random.default_rng(0)   # phase_slice's frames and batch
    net = (1, spec.net.height, spec.net.width, 3)
    frames = [rng.random((3, 480, 640), dtype=np.float32) for _ in range(3)]
    batch = rng.integers(0, 256, (BATCH_SLICE, *net[1:]), dtype=np.uint8)
    reset_launches()
    with no_plan_file():
        eng = Engine(spec, store, "int16", dev)
    rule = [eng.detect(im) for im in frames]
    heads = eng.predict_batch_rgb(batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    per_forward = route_launches("int16", engine_plan.kernels(
        spec, eng.model.kinds))
    forwards = 2 * len(eng.graphs)
    want = dict.fromkeys(launches, 0)
    want.update({k: forwards * v for k, v in per_forward.items()})
    if (eng.plan_source is not None or launches != want
            or eng.model.kinds != engine_plan.plan(spec)):
        raise AssertionError(f"{tag} the rule engine read {eng.plan_source}, "
                             f"runs {eng.model.kinds}, launched {launches}; "
                             f"want {want}")
    plan = planned["eng"]
    mine = [plan.detect(im) for im in frames]
    pheads = plan.predict_batch_rgb(batch)
    for i, ((rd, rr), (pd, pr)) in enumerate(zip(rule, mine)):
        if not (torch.equal(torch.from_numpy(pr.head_chw),
                            torch.from_numpy(rr.head_chw))
                and torch.equal(torch.from_numpy(boxes_of(pd)),
                                torch.from_numpy(boxes_of(rd)))):
            raise AssertionError(f"{tag} request {i}: the planned engine's "
                                 "head or boxes != the rule's")
    xb = torch.from_numpy(batch).to(dev)
    plain = planned["plain"](xb)["head"].permute(0, 3, 1, 2).cpu()
    if not (torch.equal(torch.from_numpy(pheads), torch.from_numpy(heads))
            and torch.equal(torch.from_numpy(heads), plain)):
        raise AssertionError(f"{tag} batch head: planned, rule and plain "
                             "differ")
    say(f"{tag} rule engine (no plan file): {len(eng.graphs)} graphs, "
        f"launched " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f" = {forwards} captured forwards x {per_forward}; the planned "
        f"engine ({plan.plan_source}) against it: the 3 detect heads and "
        f"their {sum(len(d) for d, _ in mine)} boxes and the batch-"
        f"{BATCH_SLICE} head torch.equal, the batch head also the plain "
        "path's on the card")
    g = {who: (graph_of(e, torch.uint8, (BATCH_SLICE, *net[1:])),
               graph_of(e, torch.float32, net))
         for who, e in (("rule", eng), ("plan", plan))}
    ms8 = in_turns({w: v[0].graph.replay for w, v in g.items()},
                   lambda fn: cuda_ms(fn, reps=20))
    ms1 = in_turns({w: v[1].graph.replay for w, v in g.items()},
                   lambda fn: cuda_ms(fn, reps=50))
    lat = in_turns({w: replay_fn(v[1]) for w, v in g.items()}, latency_ms)
    for who in ("rule", "plan"):
        say(f"{tag} {who} replayed, in turns (rule, plan, plan, rule): batch "
            f"{BATCH_SLICE} {' / '.join(f'{v:.3f}' for v in ms8[who])} ms, "
            f"batch 1 {' / '.join(f'{v:.4f}' for v in ms1[who])} ms (CUDA "
            f"events); batch 1 latency p50 "
            f"{' / '.join(f'{v[0]:.3f}' for v in lat[who])} ms, p90 "
            f"{' / '.join(f'{v[1]:.3f}' for v in lat[who])} ms")
    return {"launches": launches, "per_forward": per_forward, "eng": eng,
            "plain": planned["plain"]}


S2_TIER_ROUTES = {"mm": 8, "conv3": 15, "conv": 5}   # yolov2-s2's convs
S2_BUDGET_S = 120.0   # phase 10, the store's calibration included


def phase_general_slice(dev: torch.device) -> dict:
    """Phase 10: yolov2-s2 at 416 (yolov2 with each 2x2/s2 maxpool a 3x3/s2
    conv, published widths, nothing cut), synthetic weights from seed 0
    quantized per tier, in each tier through an Engine (3 detect requests,
    predict_batch_rgb at batch 8 and 1, each forward a replay of a captured
    graph): the launches per captured forward (5 of the tier's general conv,
    8 mm, 15 conv3), the replayed heads bit-equal to the eager forward and
    the plain versions on the card (fp32: within the tolerance of the eager
    model), the batch-8 replay's ms and the batch-1 p50/p90; then the small
    mixed cfg of the CPU tests in every integer tier on the card, its heads
    bit-equal to the CPU's plain path; then profile_layers at int16 batch 8
    for the strided convs' ms against their bound. Returns the launches of
    these paths and the general convs' launches per forward."""
    t0 = time.perf_counter()
    tag = "[yolov2-s2]"
    spec, store = s2_store()
    routes = [k for k, _ in engine_plan.kernels(
        spec, engine_plan.plan(spec)).values()]
    if {k: routes.count(k) for k in set(routes)} != S2_TIER_ROUTES:
        raise AssertionError(f"{tag} routes {routes}; want {S2_TIER_ROUTES}")
    gflop = sum(2 * l.out_h * l.out_w * l.n * l.c * l.size ** 2
                for l in spec.conv_layers()) / 1e9
    say(f"{tag} {len(spec.conv_layers())} convs ({S2_TIER_ROUTES}), "
        f"{gflop:.2f} GFLOP a frame; store calibrated and quantized in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    net = (1, spec.net.height, spec.net.width, 3)
    frames = [rng.random((3, 480, 640), dtype=np.float32) for _ in range(3)]
    batch = rng.integers(0, 256, (BATCH_SLICE, *net[1:]), dtype=np.uint8)
    xb = torch.from_numpy(batch).to(dev)
    total = dict.fromkeys(KERNEL_SOURCES, 0)
    per_forward: dict[str, dict] = {}
    for tier in (*TIERS, "fp32"):
        fp32 = tier == "fp32"
        reset_launches()
        eng = Engine(spec, store, tier, dev)
        if tier == "int16":
            if eng.model.kinds != engine_plan.plan(spec):
                raise AssertionError(f"{tag} int16 runs {eng.model.kinds} "
                                     f"under {eng.plan_source}: not the rule")
            say(f"{tag} int16 under {eng.plan_source or 'no plan file'}: "
                f"plan_key {engine_plan.plan_key(spec)} (yolov2's "
                f"{engine_plan.plan_key(zoo.build('yolov2'))}), the rule's "
                "kinds, nothing raised")
        results = [eng.detect(im) for im in frames]
        heads = eng.predict_batch_rgb(batch)
        head1 = eng.predict_batch_rgb(batch[:1])
        torch.cuda.synchronize()
        launches = launch_counts()
        forwards = 2 * len(eng.graphs)   # each: one warm-up, one capture
        replays = sum(g.replays for g in eng.graphs.values())
        want = dict.fromkeys(launches, 0)
        if not fp32:
            per = dict(zip(TIER_KERNELS[tier], S2_TIER_ROUTES.values()))
            want.update({k: forwards * v for k, v in per.items()})
            per_forward[f"yolov2-s2 {tier}"] = per
        if len(eng.graphs) != 3 or replays != 5 or launches != want:
            raise AssertionError(f"{tag} {tier}: {len(eng.graphs)} graphs, "
                                 f"{replays} replays, launched {launches}; "
                                 f"want 3, 5, {want}")
        head16 = (q8.INT16_OUT_LAUNCHES["mm_s8"],
                  q8.INT16_OUT_LAUNCHES["conv_s8"])
        if head16 != ((forwards, 0) if tier == "int8" else (0, 0)):
            raise AssertionError(f"{tag} {tier}: int16-output launches "
                                 f"(mm_s8, conv_s8) {head16}")
        for k, v in launches.items():
            total[k] += v
        eager = eng.model(xb)["head"].permute(0, 3, 1, 2).cpu().numpy()
        if not close_heads(heads, eager, fp32) or not np.isfinite(heads).all():
            raise AssertionError(f"{tag} {tier} batch head: replayed != eager")
        ref = eng.model if fp32 else PlainYoloV2Q(spec, eng.qtables,
                                                  eng.params, dev, tier)
        hold_detect_heads(f"{tag} {tier}", spec, frames, results, ref, dev,
                          fp32)
        if not fp32:
            plain = ref(xb)["head"].permute(0, 3, 1, 2).cpu().numpy()
            if not (np.array_equal(heads, plain)
                    and np.array_equal(head1, plain[:1])):
                raise AssertionError(f"{tag} {tier}: kernels != plain "
                                     "versions on the card (batch 8 or 1)")
        g8 = graph_of(eng, torch.uint8, (BATCH_SLICE, *net[1:]))
        g1 = graph_of(eng, torch.float32, net)
        ms = cuda_ms(g8.graph.replay, reps=20)
        p50, p90 = latency_ms(replay_fn(g1))
        say(f"{tag} {tier}: launched "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
            + f" = {forwards} captured forwards x "
            + (f"{per_forward[f'yolov2-s2 {tier}']}" if not fp32 else "cuDNN")
            + f"; {replays} replays; heads (b={BATCH_SLICE}, b=1, 3 detect) "
            + ("within tolerance of the eager model" if fp32 else
               "bit-equal: replayed == eager == plain on the card")
            + f"; replayed b={BATCH_SLICE} {ms:.3f} ms "
            f"({BATCH_SLICE * gflop / ms:.1f} TFLOP-equivalent/s), b=1 p50 "
            f"{p50:.3f} ms p90 {p90:.3f} ms")
        del eng, ref
        torch.cuda.empty_cache()

    # the mixed cfg of the CPU tests, every integer tier, card against CPU
    mspec = cfg_spec(MIXED_CFG)
    mstore = quantized_store(mspec)
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, MIXED_SIZE, MIXED_SIZE, 3), dtype=np.float32))
    reset_launches()
    for tier in TIERS:
        params = tier_params(mspec, mstore, tier, "cpu")
        qt = tier_qtables(mstore, tier)
        card = YoloV2Q(mspec, qt, params, dev, tier)
        got = card(x.to(dev))["head"].cpu()
        want_head = YoloV2Q(mspec, qt, params, "cpu", tier)(x)["head"]
        if not torch.equal(got, want_head):
            raise AssertionError(f"{tag} mixed cfg {tier}: the card's head "
                                 "!= the CPU's plain path")
    torch.cuda.synchronize()
    mixed = launch_counts()
    want = {**dict.fromkeys(mixed, 0), "mm_q16": 1, "conv3x3_q16": 2,
            "conv_q16": 6, "mm_s8": 1, "conv3x3_s8": 1, "conv_s8": 7,
            "mm_w8a16": 1, "conv3x3_w8a16": 2, "conv_w8a16": 6}
    if mixed != want or q8.INT16_OUT_LAUNCHES["conv_s8"] != 1:
        raise AssertionError(f"{tag} mixed cfg launches {mixed} "
                             f"({q8.INT16_OUT_LAUNCHES}); want {want}, the "
                             "int8 head on conv_s8's int16 output")
    for k, v in mixed.items():
        total[k] += v
    say(f"{tag} mixed cfg {MIXED_SIZE}x{MIXED_SIZE} (7x7/s2, 3x3/s2, 5x5, "
        "2x2/s2 padding=0, VALID 3x3, 1x1/s2, a 3x3 head; batch 2): int16, "
        "int8 (head16 on conv_s8's int16 output) and w8a16 heads on the card "
        f"bit-equal to the CPU's plain path; launched "
        + ", ".join(f"{k} {v}" for k, v in mixed.items() if v))

    rep = profile_layers(spec, store, "int16", batch=BATCH_SLICE, device=dev)
    rows = {r["idx"]: r for r in roofline_table(rep, spec, BATCH_SLICE,
                                                "int16")["rows"]}
    strided = [l.idx for l in spec.conv_layers() if l.stride == 2]
    say(f"{tag} profile_layers int16 b={BATCH_SLICE}, each layer alone (10 "
        "calls in one CUDA graph): the strided convs "
        + "; ".join(f"conv{i} {rows[i]['ms']:.3f} ms against "
                    f"{max(rows[i]['floor_mxu_ms'], rows[i]['floor_hbm_ms']):.3f}"
                    f" ({rows[i]['bound']})" for i in strided)
        + f"; all layers {sum(r['ms'] for r in rows.values()):.3f} ms")
    secs = time.perf_counter() - t0
    say(f"{tag} phase 10 took {secs:.1f} s (budget {S2_BUDGET_S:.0f})")
    if secs > S2_BUDGET_S:
        raise AssertionError(f"{tag} phase 10 took {secs:.1f} s, over its "
                             f"budget of {S2_BUDGET_S:.0f} s")
    return {"launches": total, "per_forward": per_forward}


def replay_kernels(dev: torch.device) -> None:
    """``chip_smoke.py --replay-kernels``: the int16 tier's head-only and
    device-NMS forwards at batch 1 and BATCH_SLICE, captured by the engine
    as phase 3 captures them, and the device kernels one replay of each
    runs. It uses only the engine's device-NMS path and its graphs, so a
    copy of this script counts them on an older tree too."""
    spec = zoo.build("yolov2")
    store = quantized_store(spec)
    net = (spec.net.height, spec.net.width, 3)
    batch = np.random.default_rng(0).integers(0, 256, (BATCH_SLICE, *net),
                                              dtype=np.uint8)
    eng = Engine(spec, store, "int16", dev)
    det = Engine(spec, store, "int16", dev, device_nms=True)
    eng.predict_batch_rgb(batch)
    det.predict_batch_detections(batch)
    for bsz, dt in ((1, torch.float32), (BATCH_SLICE, torch.uint8)):
        h, d = (device_ms_by_kernel(graph_of(e, dt, (bsz, *net)).graph.replay,
                                    {})[2] for e in (eng, det))
        say(f"[replay kernels] int16 b={bsz}: {d:g} device kernels a "
            f"device-NMS replay, {h:g} head only: {d - h:+g} for the decode "
            "and the NMS")


def latency_ms(fn) -> np.ndarray:
    """p50 and p90 of 25 fn() calls (host clock; fn ends with the head on
    the host), after 5 warm-up calls."""
    lat = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        lat.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(lat[5:], [50, 90])


def phase_letterbox(dev: torch.device) -> None:
    """The /255 normalisation of every uint8 value, and the letterbox of
    raw frames of RAW_SHAPES to 416x416, on the card against the CPU, bit
    for bit."""
    x = torch.arange(256, dtype=torch.uint8)
    want = convops.normalize_u8(x)
    recip = int((x.to(dev).to(torch.float32) / 255.0).cpu().ne(want).sum())
    if not torch.equal(convops.normalize_u8(x.to(dev)).cpu(), want):
        raise AssertionError("[letterbox] normalize_u8 on the card != the CPU")
    rng = np.random.default_rng(5)
    for h, w in RAW_SHAPES:
        u8 = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
        got = letterbox.device_letterbox(torch.from_numpy(u8).to(dev), 416,
                                         416).cpu().numpy()
        for i in range(2):
            host = letterbox_image((u8[i].astype(np.float32) / np.float32(255))
                                   .transpose(2, 0, 1), 416, 416)
            if not np.array_equal(got[i], host.transpose(1, 2, 0)):
                raise AssertionError(f"[letterbox] {h}x{w} frame {i}: the "
                                     "card's letterbox != the host's")
    say(f"[letterbox] /255 of all 256 uint8 values bit-equal on the card and "
        f"the CPU (a Python divisor would differ in {recip}); raw frames "
        f"{RAW_SHAPES} letterboxed to 416x416 on the card bit-equal to the "
        "host letterbox")


def phase_plan(spec, store: WeightStore, name: str, default: dict,
               dev: torch.device) -> dict:
    """An int16 plan slice through Engine under YOLO2_Q16_PLAN and no plan
    file: its launch counts per captured forward and its replays, its
    replayed head against its eager forward, the plain versions on the card
    and the CPU and the rule's, and its times beside the rule's in turns
    (rule, plan, plan, rule), eager and replayed. ``default`` is
    phase_rule's result. Returns the launches, the launches per forward and
    the engine."""
    plan, (n_mm, n_c3, n_pool), own_pools = PLANS[name]
    tag = f"[plan {name}]"
    rng = np.random.default_rng(0)
    net = (1, spec.net.height, spec.net.width, 3)
    frames = [rng.random((3, 480, 640), dtype=np.float32) for _ in range(3)]
    batch = rng.integers(0, 256, (BATCH_SLICE, *net[1:]), dtype=np.uint8)
    # the main path, with the launch counts read around it
    reset_launches()
    os.environ["YOLO2_Q16_PLAN"] = plan
    try:
        with no_plan_file():
            eng = Engine(spec, store, precision="int16", device=dev)
        overrides = engine_plan.plan_overrides()
    finally:
        del os.environ["YOLO2_Q16_PLAN"]
    if eng.plan_source is not None:
        raise AssertionError(f"{tag} read the plan file {eng.plan_source}")
    model = eng.model
    g1 = graph_of(eng, torch.float32, net)
    results = []
    for i, im in enumerate(frames):
        before, replays = launch_counts(), g1.replays
        dets, res = eng.detect(im)
        results.append((dets, res))
        if launch_counts() != before or g1.replays != replays + 1:
            raise AssertionError(f"{tag} detect was not one replay")
        if not np.isfinite(res.head_chw).all():
            raise AssertionError(f"{tag} request {i}: non-finite head")
    heads = eng.predict_batch_rgb(batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    per_forward = {"mm_q16": n_mm, "conv3x3_q16": n_c3,
                   "conv3x3_pool_q16": n_pool}
    forwards = 2 * len(eng.graphs)
    want = dict.fromkeys(launches, 0)
    want.update({k: forwards * v for k, v in per_forward.items()})
    replays = sum(g.replays for g in eng.graphs.values())
    if launches != want or replays != 4:
        raise AssertionError(f"{tag} main path launched {launches} in "
                             f"{replays} replays; want {want}, 4")
    fused = {i: o for i, (k, o) in model.route.items() if k == "conv3_pool"}
    pools = [l.idx for l in spec.layers
             if isinstance(l, MaxPoolSpec) and l.idx not in model.folded]
    if pools != own_pools:
        raise AssertionError(f"{tag} pools {pools} run alone, want {own_pools}")
    say(f"{tag} YOLO2_Q16_PLAN={plan}: conv3x3_pool_q16 at {fused}; pools "
        f"{pools} run as their own op; main path (3 detect + 1 batch of "
        f"{BATCH_SLICE}): {len(eng.graphs)} graphs, {replays} replays, "
        f"launched mm_q16 {launches['mm_q16']}, conv3x3_q16 "
        f"{launches['conv3x3_q16']}, conv3x3_pool_q16 "
        f"{launches['conv3x3_pool_q16']} = {forwards} captured forwards x "
        f"{per_forward}; no other kernel")

    xb = torch.from_numpy(batch).to(dev)
    plain = PlainYoloV2Q(spec, eng.qtables, eng.params, dev, "int16", overrides)
    hold_detect_heads(tag, spec, frames, results, plain, dev, False)
    for who, ref in (("eager", model), ("plain", plain),
                     ("the rule's", default["eng"].model)):
        if not np.array_equal(heads, ref(xb)["head"].permute(0, 3, 1, 2)
                              .cpu().numpy()):
            raise AssertionError(f"{tag} batch head: replayed != {who}")
    cpu_params = {k: {n: t.cpu() for n, t in v.items()} for k, v in eng.params.items()}
    cpu_model = YoloV2Q(spec, eng.qtables, cpu_params, "cpu", "int16", overrides)
    cpu_head = cpu_model(torch.from_numpy(batch[:1]))["head"].permute(0, 3, 1, 2).numpy()
    if not np.array_equal(heads[:1], cpu_head):
        raise AssertionError(f"{tag} frame 0 head: kernels on the card != "
                             "plain on the CPU")
    say(f"{tag} head {heads.shape} bit-equal: replayed == eager == plain on "
        f"the card (batch {BATCH_SLICE}) == plain on the CPU (frame 0) == the "
        "rule's kernels")

    d = default["eng"]
    dg8 = graph_of(d, torch.uint8, (BATCH_SLICE, *net[1:]))
    g8 = graph_of(eng, torch.uint8, (BATCH_SLICE, *net[1:]))
    x1 = g1.inp.clone()
    for mode, fns, lat_fns in (
            ("eager", {"rule": lambda: d.model(xb), name: lambda: model(xb)},
             {"rule": lambda: d.model(x1)["head"].cpu(),
              name: lambda: model(x1)["head"].cpu()}),
            ("replay", {"rule": dg8.graph.replay, name: g8.graph.replay},
             {"rule": replay_fn(graph_of(d, torch.float32, net)),
              name: replay_fn(g1)})):
        ms = in_turns(fns, lambda fn: cuda_ms(fn, reps=20))
        lat = in_turns(lat_fns, latency_ms)
        for who in ("rule", name):
            say(f"{tag} {mode:6s} {who:7s} batch {BATCH_SLICE}: "
                f"{' / '.join(f'{v:.3f}' for v in ms[who])} ms per batch (in "
                f"turns); batch 1 latency p50 "
                f"{' / '.join(f'{v[0]:.3f}' for v in lat[who])} ms, p90 "
                f"{' / '.join(f'{v[1]:.3f}' for v in lat[who])} ms")
    return {"launches": launches, "per_forward": per_forward, "eng": eng}


def is_memset(key: str) -> bool:
    """A profiler key of a memset (the split-K workspace's zeroing)."""
    return key.lower().startswith("memset")


def kernel_names(dev: torch.device) -> dict[str, str]:
    """The profiler's full name of each kernel -> the kernel, learned from
    one launch of each wrapper alone (mm_s8 with either output): a trace's
    kernels are then told apart by their whole names, not by a part that
    the instantiations of the shared body have in common."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def t(shape, dtype):
        return torch.ones(shape, dtype=dtype, device=dev)

    i8, i16, i32 = torch.int8, torch.int16, torch.int32
    b, s = t(16, i32), t(16, i32)
    x8, x16 = t((40, 16), i8), t((40, 16), i16)
    w8, w16 = t((16, 16), i8), t((16, 16), i16)
    c8, c16 = t((1, 4, 4, 16), i8), t((1, 4, 4, 16), i16)
    k8, k16 = t((3, 3, 16, 16), i8), t((3, 3, 16, 16), i16)
    p16, pk16 = q16.pack_q16(w16), q16.pack_q16(k16)
    ps8, pw8 = q8.pack_s8(k8), q8.pack_w8a16(k8)
    pm8, pmw8 = q8.pack_s8(w8), q8.pack_w8a16(w8)
    # the operands exist before the profiler starts: only the kernel runs
    # (at these shapes K is not split, so the tensor-core kernels launch
    # alone, with no workspace memset)
    cprob, cboxes = torch.rand((2, 64, 8), device=dev), torch.rand((2, 64, 4),
                                                                   device=dev)
    calls = [
        ("nms_greedy", lambda: nms.nms_greedy(cprob, cboxes, 0.5)),
        ("mm_q16", lambda: q16.mm_q16(x16, w16, b, 3, True, planes=p16)),
        ("conv3x3_q16", lambda: q16.conv3x3_q16(c16, k16, b, 3, True,
                                                planes=pk16)),
        ("mm_s8", lambda: q8.mm_s8(x8, w8, b, s, True, planes=pm8)),
        ("mm_s8", lambda: q8.mm_s8(x8, w8, b, s, True, i16, planes=pm8)),
        ("mm_w8a16", lambda: q8.mm_w8a16(x16, w8, b, s, True, planes=pmw8)),
        ("conv3x3_s8", lambda: q8.conv3x3_s8(c8, k8, b, s, True,
                                             planes=ps8)),
        ("conv3x3_w8a16", lambda: q8.conv3x3_w8a16(c16, k8, b, s, True,
                                                   planes=pw8)),
        *(("conv3x3_pool_q16",
           lambda o=o: q16.conv3x3_pool_q16(c16, k16, b, 3, True, o,
                                            planes=pk16))
          for o in q16.POOL_ORDERS),
    ]
    names: dict[str, str] = {}
    for name, call in calls:
        call()   # the first launch loads the library
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        keys = {e.key for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not is_memset(e.key)}
        # nms_greedy launches its two passes
        if len(keys) != (len(NMS_FUNCTIONS) if name == "nms_greedy" else 1):
            say(f"[profile] {name}: the profiler saw kernels {sorted(keys)}")
            continue
        names.update(dict.fromkeys(keys, name))
    return names


def device_ms_by_kernel(fn, names: dict[str, str],
                        reps: int = 10) -> tuple[dict, tuple, float]:
    """The device time of one fn() call by kernel (torch.profiler over reps
    calls, kernels known by their full names): ms per call of each kernel of
    KERNEL_SOURCES, of the split-K workspace's memsets and of everything
    else ("glue"), the largest glue kernel as (name, ms), and the device
    kernels one call runs (memsets and copies left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by = dict.fromkeys(KERNEL_SOURCES, 0.0) | {"glue": 0.0, "memset": 0.0}
    glue_top = ("", 0.0)
    kernels = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        ms = us / 1e3 / reps
        kind = "memset" if is_memset(e.key) else names.get(e.key, "glue")
        by[kind] += ms
        if kind == "glue" and ms > glue_top[1]:
            glue_top = (e.key[:60], ms)
        if kind != "memset" and not e.key.lower().startswith("memcpy"):
            kernels += e.count
    return by, glue_top, kernels / reps


def phase_profile_replay(tag: str, graphs: dict, names: dict[str, str]) -> None:
    """Where the device time of a replayed forward goes: for each captured
    graph (label -> CapturedForward), its ms per replay (CUDA events) and
    its device busy time by kernel (torch.profiler over replays, kernels
    known by their full names), and so the device's idle share in a
    replay; and the device kernels a replay runs, and how many of them a
    device-NMS graph adds to the head-only one of its batch."""
    count = {}
    for label, g in graphs.items():
        fwd_ms = cuda_ms(g.graph.replay, reps=20)
        by, glue_top, count[label] = device_ms_by_kernel(g.graph.replay,
                                                         names)
        busy = sum(by.values())
        if busy == 0:
            say(f"{tag} {label} replay: {fwd_ms:.3f} ms; the profiler saw no "
                "device time in the replays: busy and idle not measured")
            continue
        ours = ", ".join(f"{k} {v:.3f}" for k, v in by.items()
                         if v and k not in ("glue", "memset"))
        say(f"{tag} {label} replay: {fwd_ms:.3f} ms (CUDA events), device "
            f"busy {busy:.3f} ms (profiler): {ours or 'no kernel of ours'}, "
            f"memsets {by['memset']:.3f}, glue {by['glue']:.3f} (largest "
            f"{glue_top[0]!r} {glue_top[1]:.3f}); device idle "
            f"{100 * max(0.0, 1 - busy / fwd_ms):.1f}%; {count[label]:g} "
            "device kernels a replay")
    for label, n in count.items():
        head = label.removeprefix("device NMS ")
        if head != label and head in count:
            bsz = int(head.removeprefix("b="))
            say(f"{tag} {head}: the decode and the NMS add {n - count[head]:+g} "
                "device kernels to a replay (with the IoU matrix of PyTorch "
                f"ops, int16: {NMS_REPLAY_KERNELS_IOU[bsz]:+g})")


def new_forward() -> dict:
    return {"ms": 0.0, "device_ms": None, "graph_ms": None, "plain_ms": 0.0,
            "library_ms": 0.0, "library_graph_ms": None, "library": set(),
            "bound": [0.0, 0.0, 0.0], "bytes": 0}


def phase_profile(model: YoloV2Q, plain: YoloV2Q, dev: torch.device,
                  names: dict[str, str]) -> dict:
    """Where the device time goes in one tier, at batch BATCH_SLICE and 1:
    each conv alone (CUDA events, random full-range operands at its shape)
    beside its plain version, one library call for its sums and its bound,
    the forward's device time by kernel (torch.profiler, kernels known by
    their full names) against its time per forward (CUDA events), and the
    SM clock and power sampled beside them. Returns, per kernel and batch,
    those summed over one forward's convs (ms: CUDA events around the
    wrappers, which hold the host's time per launch where the device outruns
    it; device_ms: the profiler's device time of the kernel per forward;
    graph_ms and library_graph_ms, for the 1x1 kernel: it and its library
    calls alone on the device, from graph_ms)."""
    spec, tier = model.spec, model.precision
    tag = f"[profile {tier}]"
    mm, c3, _ = TIER_KERNELS[tier]
    act = torch.int8 if tier == "int8" else torch.int16
    lim = torch.iinfo(act)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(1)
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    forward = {mm: {}, c3: {}}
    try:
        rows = []
        for bsz in (BATCH_SLICE, 1):
            groups: dict[str, list] = {}
            for name in forward:
                forward[name][bsz] = new_forward()
            for l in spec.conv_layers():
                x = torch.from_numpy(rng.integers(
                    lim.min, lim.max + 1, (bsz, l.h, l.w, l.c))).to(act).to(dev)
                name = mm if model.route[l.idx][0] == "mm" else c3
                w = getattr(model, f"w{l.idx}")
                ms = cuda_ms(lambda: model._conv(l, x), reps=10)   # noqa: B023
                p_ms = cuda_ms(lambda: plain._conv(l, x), reps=3)   # noqa: B023
                lib, what = library_call(name, x, w)
                l_ms = cuda_ms(lib, reps=5)
                f = forward[name][bsz]
                if name == mm:
                    # the 1x1 convs' events hold the host's time per launch:
                    # the kernel and the library call on the device alone
                    f["graph_ms"] = (f["graph_ms"] or 0.0) + graph_ms(
                        lambda: model._conv(l, x))   # noqa: B023
                    f["library_graph_ms"] = ((f["library_graph_ms"] or 0.0)
                                             + graph_ms(lib))
                del lib
                macs = bsz * l.h * l.w * l.c * l.n * l.size * l.size
                out16 = tier != "int8" or l.idx == model.head16
                nbytes = (x.numel() * x.element_size()
                          + w.numel() * w.element_size()
                          + 4 * l.n * (1 if tier == "int16" else 2)
                          + bsz * l.h * l.w * l.n * (2 if out16 else 1))
                part = bound(bsz * l.h * l.w, l.c * l.size * l.size, l.n,
                             products(x, w), nbytes)
                f["ms"] += ms
                f["plain_ms"] += p_ms
                f["library_ms"] += l_ms
                f["library"].add(what)
                f["bytes"] += nbytes
                add_bound(f["bound"], part)
                group = ("entry 3x3 C=3" if l.c == 3 else f"{l.size}x{l.size}"
                         + (" 13x13" if l.size == 3 and l.h == 13 else ""))
                groups.setdefault(group, []).append((ms, macs))
                say(f"{tag} b={bsz} conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n} "
                    f"{l.size}x{l.size}: {ms:.4f} ms {macs / ms / 1e9:.3f} "
                    f"T {tier} MAC/s; plain {p_ms:.4f} ms; {what} {l_ms:.4f} "
                    f"ms; bound {max(part):.4f} ms "
                    f"({'operations' if part[0] >= part[1] else 'bytes'}), "
                    f"{100 * max(part) / ms:.1f}% of it")
            rows.append((bsz, groups))
            for name, per in forward.items():
                f = per[bsz]
                say(f"{tag} b={bsz} {name} per forward: kernel {f['ms']:.4f} "
                    f"ms, bound {f['bound'][0]:.4f} ms ({bound_by(f['bound'])}; "
                    f"{100 * f['bound'][0] / f['ms']:.1f}% of the kernel time), "
                    f"plain {f['plain_ms']:.4f} ms, "
                    f"{' / '.join(sorted(f['library']))} {f['library_ms']:.4f} ms"
                    + ("" if f["graph_ms"] is None else
                       f"; device alone (CUDA graph replays): kernel "
                       f"{f['graph_ms']:.4f} ms, the library calls "
                       f"{f['library_graph_ms']:.4f} ms"))

            xb = torch.from_numpy(rng.integers(
                0, 256, (bsz, spec.net.height, spec.net.width, 3),
                dtype=np.uint8)).to(dev)
            fwd_ms = cuda_ms(lambda: model(xb), reps=20)   # noqa: B023
            by, glue_top, _ = device_ms_by_kernel(
                lambda: model(xb), names)   # noqa: B023
            dev_ms = sum(by.values())
            if dev_ms == 0:
                say(f"{tag} b={bsz}: the profiler saw no device time; "
                    "device time by kernel and idle share not measured")
                continue
            others = {k: v for k, v in by.items()
                      if v and k not in (mm, c3, "glue", "memset")}
            if others:
                raise AssertionError(f"{tag} the {tier} forward ran {others}")
            say(f"{tag} b={bsz} forward: {fwd_ms:.3f} ms (CUDA events), "
                f"device busy {dev_ms:.3f} ms (profiler): {c3} "
                f"{by[c3]:.3f}, {mm} {by[mm]:.3f}, split-K workspace memsets "
                f"{by['memset']:.3f}, glue {by['glue']:.3f} (largest "
                f"{glue_top[0]!r} {glue_top[1]:.3f}); convs "
                f"{100 * (dev_ms - by['glue']) / dev_ms:.1f}% of device "
                f"time, device idle {100 * max(0.0, 1 - dev_ms / fwd_ms):.1f}%")
            for name in forward:
                forward[name][bsz]["device_ms"] = by[name]
            # the 1x1 convs are bound by their bytes: the rate they move
            # them at, on the kernel's device time
            f = forward[mm][bsz]
            if by[mm]:
                say(f"{tag} b={bsz} {mm}: {f['bytes'] / 1e6:.1f} MB per forward "
                    f"(each operand and output once) in {by[mm]:.4f} ms of "
                    f"device time, {f['bytes'] / by[mm] / 1e6:.0f} GB/s of "
                    f"{PEAK_BYTES / 1e9:.0f}; bound {f['bound'][0]:.4f} ms, "
                    f"{100 * f['bound'][0] / by[mm]:.1f}% of it")
    finally:
        sampler.terminate()
        samples = sampler.communicate(timeout=30)[0]
    clk = np.array([[float(v) for v in ln.split(",")]
                    for ln in samples.strip().splitlines()
                    if ln.count(",") == 2 and "N/A" not in ln] or [[0, 0, 0]])
    busy = clk[clk[:, 2] >= np.median(clk[:, 2])]   # the busier half
    mhz = float(np.median(busy[:, 0]))
    say(f"{tag} nvidia-smi over the phase ({len(clk)} samples, the "
        f"busier half): SM clock median {mhz:.0f} MHz (max "
        f"{clk[:, 1].max():.0f}), power draw median {np.median(busy[:, 2]):.1f} W")
    for bsz, groups in rows:
        for group, vals in groups.items():
            ms = sum(v[0] for v in vals)
            macs = sum(v[1] for v in vals)
            per_clk = (f", {macs / (ms * 1e-3) / (sms * mhz * 1e6):.1f} "
                       "MAC/clk/SM" if mhz else "")
            say(f"{tag} b={bsz} {len(vals):2d} convs {group:14s} "
                f"{ms:8.3f} ms {macs / ms / 1e9:7.3f} T {tier} MAC/s{per_clk}")
    return forward


def phase_profile_pool(model: YoloV2Q, p1_model: YoloV2Q, dev: torch.device,
                       names: dict[str, str]) -> dict:
    """Each conv a 2x2/s2 pool follows, fused (conv3x3_pool_q16, each order)
    against conv3x3_q16 then pool.maxpool, at batch BATCH_SLICE and 1, on
    random full-range int16 inputs and the int16 model's weights (CUDA
    events). Returns, per batch, the fused kernel's time (order "acc"), its
    plain version's, one library call's (a float64 matmul on im2col, then
    the pool) and its bound, summed over the convs that plan P1 fuses: one
    P1 forward's conv3x3_pool_q16 launches; those three and conv3x3_q16
    then the pool also alone on the device (graph_ms), and the fused
    kernel's device time in the forward of ``p1_model``, the model of plan
    P1 (device_ms_by_kernel)."""
    rng = np.random.default_rng(2)
    p1 = [int(i.split(":")[0]) for i in PLANS["P1"][0].split(",")]
    forward = {}
    for bsz in (BATCH_SLICE, 1):
        sums = dict.fromkeys(("unfused", *q16.POOL_ORDERS), 0.0)
        f = forward[bsz] = new_forward()
        f["graph_ms"] = f["library_graph_ms"] = unfused_graph = 0.0
        for l in model.spec.conv_layers():
            if l.idx not in POOL_CONVS:
                continue
            x = torch.from_numpy(rng.integers(
                -32768, 32768, (bsz, l.h, l.w, l.c)).astype(np.int16)).to(dev)
            w, b = getattr(model, f"w{l.idx}"), getattr(model, f"b{l.idx}")
            shift, leaky = model.plan.conv_shift_out[l.idx], l.activation == "leaky"
            p = model.spec.layers[l.idx + 1]
            planes = getattr(model, f"p{l.idx}")

            def unfused():
                return pool.maxpool(q16.conv3x3_q16(   # noqa: B023
                    x, w, b, shift, leaky, planes=planes),   # noqa: B023
                    p.size, p.stride, p.padding)   # noqa: B023

            def fused(order="acc"):
                return q16.conv3x3_pool_q16(x, w, b, shift, leaky,   # noqa: B023
                                            order, planes=planes)   # noqa: B023

            ms = {"unfused": cuda_ms(unfused, reps=10)}
            for o in q16.POOL_ORDERS:
                ms[o] = cuda_ms(functools.partial(fused, o), reps=10)
            for k, v in ms.items():
                sums[k] += v
            say(f"[profile pool] b={bsz} conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n}: "
                f"conv3x3_q16 + maxpool {ms['unfused']:.4f} ms; "
                "conv3x3_pool_q16 " + ", ".join(
                    f"{o} {ms[o]:.4f}" for o in q16.POOL_ORDERS) + " ms")
            if l.idx in p1:
                lib, what = library_call("conv3x3_pool_q16", x, w)
                f["ms"] += ms["acc"]
                f["plain_ms"] += cuda_ms(lambda: q16.conv3x3_pool_q16_plain(  # noqa: B023
                    x, w, b, shift, leaky, "acc"), reps=3)   # noqa: B023
                f["library_ms"] += cuda_ms(lib, reps=5)
                f["library"].add(what)
                f["graph_ms"] += graph_ms(fused)
                f["library_graph_ms"] += graph_ms(lib)
                unfused_graph += graph_ms(unfused)
                del lib
                out = bsz * l.h * l.w // 4 * l.n
                add_bound(f["bound"], bound(
                    bsz * l.h * l.w, 9 * l.c, l.n, 4,
                    2 * (x.numel() + w.numel() + out) + 4 * l.n))
        say(f"[profile pool] b={bsz} sum over convs {POOL_CONVS}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()) + " ms")
        say(f"[profile pool] b={bsz} conv3x3_pool_q16 per P1 forward (convs "
            f"{p1}, order acc): kernel {f['ms']:.4f} ms, bound "
            f"{f['bound'][0]:.4f} ms ({bound_by(f['bound'])}), plain "
            f"{f['plain_ms']:.4f} ms, {' / '.join(sorted(f['library']))} "
            f"{f['library_ms']:.4f} ms; device alone (CUDA graph replays): "
            f"kernel {f['graph_ms']:.4f} ms, the library calls "
            f"{f['library_graph_ms']:.4f} ms, conv3x3_q16 + maxpool "
            f"{unfused_graph:.4f} ms")
        xb = torch.from_numpy(rng.integers(
            0, 256, (bsz, model.spec.net.height, model.spec.net.width, 3),
            dtype=np.uint8)).to(dev)
        by, _, _ = device_ms_by_kernel(lambda: p1_model(xb), names)   # noqa: B023
        if not sum(by.values()):
            say(f"[profile pool] b={bsz}: the profiler saw no device time")
            continue
        f["device_ms"] = by["conv3x3_pool_q16"]
        say(f"[profile pool] b={bsz} P1 forward, device time (profiler): "
            f"conv3x3_pool_q16 {by['conv3x3_pool_q16']:.4f} ms, conv3x3_q16 "
            f"{by['conv3x3_q16']:.4f}, mm_q16 {by['mm_q16']:.4f}, memsets "
            f"{by['memset']:.4f}, glue {by['glue']:.4f}, busy "
            f"{sum(by.values()):.4f} ms")
    return forward


def graph_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device ms of one fn() call: fn launched ``launches`` times into a
    CUDA graph, whose replays are timed with CUDA events, so the host's
    time per call does not enter."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    ms = cuda_ms(g.replay, reps) / launches
    del g
    return ms


def split_steps(k: int, bk: int) -> list[int]:
    """The K steps (of bk) per split of each split count of K, from the least
    that one s32 partial sum allows up to SPLIT_SWEEP (or one step per
    split), largest first, each once."""
    kt = -(-k // bk)
    steps: list[int] = []
    for s in range(-(-k // tc.KMAX), min(SPLIT_SWEEP, kt) + 1):
        if -(-kt // s) not in steps:
            steps.append(-(-kt // s))
    return steps


def phase_split(model: YoloV2Q, dev: torch.device,
                fused_only: bool = False) -> None:
    """tc.split's split of K against every other split (split_steps),
    for each conv of one tier's model that runs on the tensor cores (the
    convs with packed planes; ``fused_only``: of those, the convs fused
    with their pool, conv3x3_pool_q16), at batch 1 and 8, on random
    full-range inputs and the model's weights (``model._conv``): each
    conv's device time (graph_ms) at every split, the split chosen, the
    fastest, and their sums over one forward; a choice more than 10% slower
    than the fastest split is flagged."""
    rng = np.random.default_rng(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    choose = tc.split
    tier = model.precision
    act = torch.int8 if tier == "int8" else torch.int16
    lim = torch.iinfo(act)
    convs = [l for l in model.spec.conv_layers() if hasattr(model, f"p{l.idx}")
             and (not fused_only or model.route[l.idx][0] == "conv3_pool")]
    tag = f"[split {tier}{' fused' if fused_only else ''}]"
    say(f"{tag} tc.split against every split of K (1 to {SPLIT_SWEEP} "
        f"splits) of the {len(convs)} tensor-core convs, device ms per call "
        "from CUDA graph replays")
    try:
        for bsz in (1, 8):
            tot = dict.fromkeys(("chosen", "fastest", "unsplit"), 0.0)
            near, far = 0, []
            for l in convs:
                mm, c3, _ = TIER_KERNELS[tier]
                name = {"mm": mm, "conv3": c3,
                        "conv3_pool": "conv3x3_pool_q16"}[model.route[l.idx][0]]
                scheme = TC_KERNELS[name][0]
                m, k = bsz * l.h * l.w, l.c * l.size * l.size
                x = torch.from_numpy(rng.integers(
                    lim.min, lim.max + 1, (bsz, l.h, l.w, l.c))).to(act).to(dev)
                fn = functools.partial(model._conv, l, x)
                chosen = choose(m, l.n, k, sms, scheme)
                ms = {}
                for kps in split_steps(k, scheme.bk) + [chosen]:
                    if kps not in ms:
                        tc.split = lambda *a, kps=kps: kps   # noqa: E731
                        ms[kps] = graph_ms(fn)
                tc.split = choose
                kt = -(-k // scheme.bk)
                best = min(ms, key=ms.get)
                tot["chosen"] += ms[chosen]
                tot["fastest"] += ms[best]
                tot["unsplit"] += ms[max(ms)]   # the fewest splits
                near += ms[chosen] <= 1.05 * ms[best]
                if ms[chosen] > 1.10 * ms[best]:
                    far.append(f"conv{l.idx}")
                say(f"{tag} b={bsz} conv{l.idx} {l.h}x{l.w}x{l.c}->{l.n} "
                    f"{name} M={m} K={k} ({kt} steps), ms by splits: "
                    + ", ".join(f"{-(-kt // v)}: {t:.4f}" for v, t in ms.items())
                    + f"; tc.split {-(-kt // chosen)} ({ms[chosen]:.4f}), "
                    f"fastest {-(-kt // best)} ({ms[best]:.4f}), chosen/fastest "
                    f"{ms[chosen] / ms[best]:.3f}")
            say(f"{tag} b={bsz} per forward ({len(convs)} convs): tc.split's "
                f"splits {tot['chosen']:.4f} ms, the fastest split of each conv "
                f"{tot['fastest']:.4f} ms, unsplit {tot['unsplit']:.4f} ms; "
                f"{near} convs within 5% of their fastest; more than 10% "
                f"slower: {', '.join(far) or 'none'}")
    finally:
        tc.split = choose


# phase 5: the streaming runtime's frames (240 raw camera-sized frames, 30
# batches of 8, enough for a steady p50), the JSONL threshold (the synthetic
# weights' class scores reach 0.25 rarely; 0.05 keeps some boxes a frame),
# and the watchdog's deadline and hold
STREAM_FRAMES = 240
STREAM_THRESH = 0.05
WATCHDOG_MS = 200
HOLD_S = 1.0


class MemoryFrames:
    """A frame source over HWC uint8 frames held in memory."""

    def __init__(self, frames: np.ndarray):
        self.frames = list(frames)

    def read(self):
        return self.frames.pop(0) if self.frames else None

    def close(self) -> None:
        pass


def best_classes(path: str) -> tuple[list[int], list[list]]:
    """The frame indexes of a JSONL file and, per frame, its sorted (class,
    prob) list."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return ([r["frame_index"] for r in recs],
            [sorted((d["class_id"], d["prob"]) for d in r["detections"])
             for r in recs])


def same_records(got: list, want: list) -> bool:
    """One frame's sorted (class, prob) lists: the same classes, and probs
    within one unit of the JSONL's 6th decimal (the host path decodes in
    numpy, the device path in PyTorch on the card: a float32 ulp apart, which
    rounding to 6 decimals can turn into one unit)."""
    return (len(got) == len(want)
            and all(g[0] == w[0] and abs(g[1] - w[1]) <= 1.01e-6
                    for g, w in zip(got, want)))


def sleep_cycles(dev: torch.device, seconds: float) -> int:
    """The torch.cuda._sleep cycles that hold the card about ``seconds``,
    from one timed sleep."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    torch.cuda.synchronize(dev)
    return int(100_000_000 * seconds * 1e3 / start.elapsed_time(end))


def check_launches(tag: str, path: str, forwards: int, nms_forwards: int,
                   per_forward: dict[str, int]) -> dict:
    """The launch counts since the last reset, held to an int16 path of
    ``forwards`` forwards run eagerly or under capture, each launching
    ``per_forward``, ``nms_forwards`` of them with the device NMS."""
    got = launch_counts()
    want = dict.fromkeys(got, 0)
    want.update({k: v * forwards for k, v in per_forward.items()})
    want["nms_greedy"] = nms_forwards
    if got != want:
        raise AssertionError(f"{tag} {path} launched {got}; want {want}")
    say(f"{tag} {path} launched "
        + ", ".join(f"{k} {v}" for k, v in got.items() if v)
        + f" ({forwards} forwards run eagerly or under capture)")
    return got


def phase_runtime(dev: torch.device) -> dict:
    """Phase 5 (see the module's docstring): gpu_check, the streaming
    runtime built from cli.main's argv both ways, per-layer dumps, the
    watchdog. Returns the kernel launches of the streaming path."""
    tag = "[runtime]"
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = gpu_check.main([])
    for line in out.getvalue().splitlines():
        say(f"{tag} gpu_check: {line}")
    if rc != 0:
        raise AssertionError(f"{tag} gpu_check exited {rc}")
    frames = np.random.default_rng(7).integers(
        0, 256, (STREAM_FRAMES, *RAW_SHAPES[0], 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--precision", "int16", "--synthetic-weights", "--topk",
                "845", "--thresh", str(STREAM_THRESH)]
        parse = cli_main.build_argparser().parse_args
        args8 = parse(base + ["--batch-size", "8", "--device-nms",
                              "--output-json", f"{tmp}/b8.jsonl"])
        args1 = parse(base + ["--batch-size", "1", "--output-json",
                              f"{tmp}/b1.jsonl"])
        spec, store = cli_main.load_model(args8)    # one store serves both
        labels = cli_main.labels_of(args8, spec)
        say(f"{tag} model and synthetic int16 weights from the argv in "
            f"{time.perf_counter() - t0:.1f} s")
        # the streaming path, with the launch counts read around it; the b=8
        # engine's raw-frame graph is captured by one request before its
        # stream, so the StepTimer sees steady batches only
        reset_launches()
        runs = {}
        for name, args in (("b8", args8), ("b1", args1)):
            eng = cli_main.build_engine(args, spec, store)
            if name == "b8":
                eng.predict_batch_raw_frames(frames[:8])
            cfg = cli_main.stream_config(args, labels)
            cfg.mode, cfg.source = "video", "memory"
            runner = StreamRunner(eng, cfg)
            native_lb = runner._native
            summary = runner.run(MemoryFrames(frames))
            runs[name] = (eng, summary, best_classes(args.output_json),
                          native_lb, runner.timer.samples_ms)
        eng8, eng1 = runs["b8"][0], runs["b1"][0]
        torch.cuda.synchronize(dev)
        if eng1.model.kinds != eng8.model.kinds:
            raise AssertionError(f"{tag} the two engines' plans differ")
        launches = check_launches(
            tag, "the streaming path",
            2 * (len(eng8.graphs) + len(eng1.graphs)), 2 * len(eng8.graphs),
            route_launches("int16", engine_plan.kernels(spec,
                                                        eng8.model.kinds)))
        (idx8, dets8), (idx1, dets1) = runs["b8"][2], runs["b1"][2]
        bad = [i for i, (a, b) in enumerate(zip(dets8, dets1))
               if not same_records(a, b)]
        if idx8 != list(range(STREAM_FRAMES)) or idx1 != idx8 or bad:
            raise AssertionError(f"{tag} b=8 device-NMS records != b=1 host "
                                 f"records: frames {idx8} / {idx1}, differing "
                                 f"at {bad[:5]}: {dets8[bad[0]] if bad else ''}"
                                 f" / {dets1[bad[0]] if bad else ''}")
        rounded = sum(a != b for a, b in zip(dets8, dets1))
        n_dets = sum(map(len, dets8))
        if n_dets == 0:
            raise AssertionError(f"{tag} no detection over {STREAM_THRESH}")
        net = (spec.net.height, spec.net.width, 3)
        replays = {"b8 raw": graph_of(eng8, torch.uint8,
                                      (8, *RAW_SHAPES[0], 3), True).replays,
                   "b8 warm-up": graph_of(eng8, torch.float32,
                                          (8, *net)).replays,
                   "b1": graph_of(eng1, torch.float32, (1, *net)).replays}
        if (replays != {"b8 raw": STREAM_FRAMES // 8 + 1, "b8 warm-up": 0,
                        "b1": STREAM_FRAMES}
                or len(eng8.graphs) != 2 or len(eng1.graphs) != 1):
            raise AssertionError(f"{tag} replays {replays}, graphs "
                                 f"{len(eng8.graphs)} / {len(eng1.graphs)}")
        say(f"{tag} {STREAM_FRAMES} raw {RAW_SHAPES[0]} frames streamed "
            f"through cli.main's wiring twice: b=8 device NMS (letterbox on "
            f"the card, K=N=845) and b=1 host path (native letterbox "
            f"{runs['b1'][3]}): {STREAM_FRAMES} records each, the same "
            f"frames and per frame the same sorted (class, prob) list "
            f"({rounded} frames with a prob one unit apart in the 6th "
            f"decimal), {n_dets} detections over {STREAM_THRESH}; replays "
            f"{replays} (one per request, b8 raw's first the capture's)")
        for name, bsz in (("b8", 8), ("b1", 1)):
            s, steps = runs[name][1], runs[name][4]
            say(f"{tag} stream {name} StepTimer: {s['count']} steps, p50 "
                f"{s['median_ms']:.3f} ms per batch of {bsz}, p90 "
                f"{s['p90_ms']:.3f}, mean {s['mean_ms']:.3f}, {s['fps']:.1f} "
                f"fps; steps min {min(steps):.2f}, max {max(steps):.2f}, "
                f"first {' '.join(f'{v:.2f}' for v in steps[:3])} ms")

        # per-layer dumps of one frame against the plain versions: a path of
        # its own, two eager forwards
        boxed = letterbox_image((frames[0].astype(np.float32) / np.float32(255))
                                .transpose(2, 0, 1), spec.net.width,
                                spec.net.height)
        reset_launches()
        layers = eng1.predict_layers(boxed)
        eng1.dump_layers(boxed, f"{tmp}/dump")
        torch.cuda.synchronize(dev)
        check_launches(tag, "predict_layers and dump_layers", 2, 0,
                       route_launches("int16", eng1._debug.route))
        plain = PlainYoloV2Q(spec, eng1.qtables, eng1.params, dev, "int16",
                             None, ("acts",))
        x = torch.from_numpy(np.ascontiguousarray(
            boxed.transpose(1, 2, 0)[None])).to(dev)
        want = {i: a[0].permute(2, 0, 1).cpu().numpy()
                for i, a in plain(x)["acts"].items()}
        head = eng1.predict(boxed).head_chw
        bad = [i for i in want if i not in layers
               or layers[i].dtype != want[i].dtype
               or not np.array_equal(layers[i], want[i])]
        sizes = {l.idx: os.path.getsize(f"{tmp}/dump/layer{l.idx:02d}.bin")
                 for l in spec.layers}
        short = [l.idx for l in spec.layers if sizes[l.idx] != l.out_c
                 * l.out_h * l.out_w * layers[l.idx].itemsize]
        if (len(layers) != 32 or bad or short
                or not np.array_equal(layers[spec.n - 1], head)):
            raise AssertionError(f"{tag} per-layer dumps: {len(layers)} "
                                 f"layers, differing from the plain versions "
                                 f"at {bad}, files of the wrong size {short}, "
                                 "region == replayed head "
                                 f"{np.array_equal(layers[spec.n - 1], head)}")
        say(f"{tag} predict_layers: {len(layers)} layers "
            f"({', '.join(sorted({str(a.dtype) for a in layers.values()}))}) "
            "bit-equal to the plain versions on the card, the region layer to "
            f"a replay's head; dump_layers wrote {len(sizes)} files of "
            f"c*h*w*itemsize bytes ({sum(sizes.values())} in all)")

    # the watchdog, on the b=1 engine's graph
    x = torch.from_numpy(np.ascontiguousarray(
        boxed.transpose(1, 2, 0)[None], np.float32))
    key = (False, x.dtype, tuple(x.shape))

    def drain() -> int:
        """The parked workers, once the card drained and they ended."""
        parked = len(eng1._abandoned_threads)
        torch.cuda.synchronize(dev)
        for t in list(eng1._abandoned_threads):
            t.join(timeout=30)
            if t.is_alive():
                raise AssertionError(f"{tag} watchdog: a worker outlived "
                                     "the drained card")
        return parked

    def guarded(name: str, fn) -> tuple:
        """fn under the watchdog, as a seen key: its outcome and seconds."""
        eng1._seen_shapes.add((name, *key))
        t1 = time.perf_counter()
        try:
            got = ("ok", eng1._guarded(fn, x, tag=name, key=key))
        except TimeoutError as e:
            got = ("TimeoutError", str(e))
        return got, time.perf_counter() - t1

    os.environ["YOLO2_LAYER_TIMEOUT_MS"] = str(WATCHDOG_MS)
    try:
        cycles = sleep_cycles(dev, HOLD_S)
        side = torch.cuda.Stream(dev)
        calls = []

        def fetch(v):
            return eng1._run(v)["head"][0].permute(2, 0, 1).cpu().numpy()

        def hold_side(v):
            """Holds a side stream the engine's stream does not wait on,
            then waits for it: a stall outside the engine's stream."""
            calls.append(1)
            if len(calls) == 1 or len(calls) > 2:
                with torch.cuda.stream(side):
                    torch.cuda._sleep(cycles)
                side.synchronize()
                return None
            return fetch(v)

        def hold_engine(v):
            """Holds the engine's own stream once: the replay queues behind
            the hold, and so does the re-dispatch's."""
            calls.append(1)
            if len(calls) == 1:
                torch.cuda._sleep(cycles)
            return fetch(v)

        (ok, got), recovered = guarded("hold_side", hold_side)
        if (ok != "ok" or len(calls) != 2 or not np.array_equal(got, head)
                or not 2 * WATCHDOG_MS / 1e3 > recovered > WATCHDOG_MS / 1e3):
            raise AssertionError(f"{tag} watchdog: {ok}, {len(calls)} "
                                 f"dispatches, head equal "
                                 f"{ok == 'ok' and np.array_equal(got, head)}, "
                                 f"{recovered:.3f} s")
        (raised, msg), raised_s = guarded("hold_side_always", hold_side)
        parked_side = drain()
        calls.clear()
        (raised_eng, msg_eng), raised_eng_s = guarded("hold_engine", hold_engine)
        parked_eng = drain()
        for what, m in ((raised, msg), (raised_eng, msg_eng)):
            if what != "TimeoutError" or "twice" not in m:
                raise AssertionError(f"{tag} watchdog: {what} {m!r}")
        if len(calls) != 2:
            raise AssertionError(f"{tag} watchdog: the engine-stream hold "
                                 f"ran {len(calls)} dispatches")
        after = eng1.predict(boxed).head_chw
        if not np.array_equal(after, want[spec.n - 1]):
            raise AssertionError(f"{tag} head after the watchdog != plain")
        say(f"{tag} watchdog at {WATCHDOG_MS} ms, the card held {HOLD_S:.1f} "
            f"s a dispatch ({cycles} sleep cycles): held on a side stream "
            f"once, recovered on its re-dispatch in {recovered:.3f} s (head "
            f"bit-equal); held there every time, raised TimeoutError after "
            f"{raised_s:.3f} s ({msg.split(' (')[0]}); held once on the "
            f"engine's own stream, the re-dispatch queued behind the hold "
            f"and raised TimeoutError after {raised_eng_s:.3f} s; "
            f"{parked_side} and {parked_eng} workers parked, all ended once "
            "the card drained; the next request's head is the plain head")
    finally:
        del os.environ["YOLO2_LAYER_TIMEOUT_MS"]

    # what the watchdog costs a b=1 request: predict with it at its default
    # and off, in turns; a predict's parts, on and off call by call; and the
    # handoff alone (a call that does nothing)
    def timeout_ms(ms: str, fn):
        os.environ["YOLO2_LAYER_TIMEOUT_MS"] = ms
        try:
            return fn()
        finally:
            del os.environ["YOLO2_LAYER_TIMEOUT_MS"]

    def p50(fn, runs: int = 25) -> float:
        ts = []
        for _ in range(runs + 5):
            t1 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t1) * 1e3)
        return float(np.median(ts[5:]))

    lat = {"60000": [], "0": []}
    for ms in ("60000", "0", "0", "60000"):
        lat[ms].append(timeout_ms(ms, lambda: p50(lambda: eng1.predict(boxed))))

    def stamped(v, st):
        st.append(time.perf_counter())          # the call starts
        out = eng1._run(v)                      # frame copied in, replay queued
        st.append(time.perf_counter())
        head = out["head"].permute(0, 3, 1, 2).cpu().numpy()
        st.append(time.perf_counter())          # the head on the host
        return head

    def parts() -> list:
        """One predict's stamps: start, frame to NHWC float32 (predict's
        own host work), the call starts, copied in, head on the host,
        back on the caller."""
        st = [time.perf_counter()]
        v = torch.from_numpy(np.ascontiguousarray(
            boxed.transpose(1, 2, 0)[None].astype(np.float32)))
        st.append(time.perf_counter())
        eng1._guarded(stamped, v, st, key=key)
        st.append(time.perf_counter())
        return st

    split = {"60000": [], "0": []}
    for i in range(220):
        ms = ("60000", "0")[i % 2]
        st = timeout_ms(ms, parts)
        if i >= 20:
            split[ms].append(np.diff(st) * 1e3)
    names = ("prep", "to the call", "copy in", "replay and head out",
             "back", "all")
    med = {ms: [float(v) for v in np.median(np.asarray(d), axis=0)]
           + [float(np.median(np.asarray(d).sum(axis=1)))]
           for ms, d in split.items()}
    noop = {ms: timeout_ms(ms, lambda: p50(lambda: eng1._guarded(
        lambda v: None, x, tag="noop", key=key), runs=200))
        for ms in ("60000", "0")}
    say(f"{tag} b=1 predict p50 (25 runs, in turns): watchdog on (60000 ms) "
        f"{' / '.join(f'{v:.3f}' for v in lat['60000'])} ms, off (0) "
        f"{' / '.join(f'{v:.3f}' for v in lat['0'])} ms; its parts, p50 of "
        "100 calls each, on and off call by call: "
        + ", ".join(f"{n} {med['60000'][i]:.3f} / {med['0'][i]:.3f}"
                    for i, n in enumerate(names))
        + f" ms; the handoff alone (a call doing nothing, p50 of 200) "
        f"{noop['60000']:.4f} ms on, {noop['0']:.4f} off; phase 5 took "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# phase 6: the artifact-to-report flow
ARTIFACT_FRAMES = 2        # detect requests held across the stores
PROFILE_BATCH = 8
BOUND_SLACK = 1.05         # no profile reading may be faster than its bound
REPORT_STEPS = 10
PIPELINE_CONFIG = """\
model: yolov2
precision: int16
compute: int32
weights_dir: weights
synthetic_weights: true
report_label: p6_pipeline
batch: 8
steps: 5
"""
P6_KERNELS = ("mm_q16", "conv3x3_q16", "mm_s8", "conv3x3_s8")


def darknet_layers(spec, rng) -> dict:
    """Seeded darknet parameters for every conv of ``spec``: He-scaled
    weights and, where the cfg says batch_normalize, BN statistics near the
    identity, so the folded weights keep activations in a trained-like
    range."""
    layers = {}
    for l in spec.conv_layers():
        w = (rng.standard_normal((l.n, l.c, l.size, l.size), dtype=np.float32)
             * np.float32(np.sqrt(2.0 / (l.c * l.size * l.size))))
        b = (rng.standard_normal(l.n, dtype=np.float32) * np.float32(0.05))
        bn = {}
        if l.batch_normalize:
            bn = {"scales": rng.uniform(0.8, 1.2, l.n).astype(np.float32),
                  "rolling_mean": (rng.standard_normal(l.n, dtype=np.float32)
                                   * np.float32(0.05)),
                  "rolling_variance": rng.uniform(0.6, 1.4, l.n).astype(
                      np.float32)}
        layers[l.idx] = darknet.ConvParams(w, b, **bn)
    return layers


def check_rows(tag: str, what: str, report, doc: dict, spec) -> float:
    """A row for every layer, every conv row above 0 ms, and no reading
    faster than BOUND_SLACK of its bound (a reading faster than the card's
    peak is a broken timer). A row of ``profile_layers`` is a reading. A
    row of ``profile_prefix`` is the difference of two prefixes' readings
    and carries both readings' noise, so there each prefix's own time
    (``prefix_ms``) is held to the sum of the bounds of the layers it
    runs. Returns the least reading over its bound."""
    idx = [t.idx for t in report.timings]
    zero = [t.idx for t in report.timings
            if t.type == "convolutional" and not t.ms > 0]
    floor = {r["idx"]: max(r["floor_mxu_ms"], r["floor_hbm_ms"])
             for r in doc["rows"]}
    if report.prefix_ms:
        alive = prefix_alive_sets(spec)
        readings = [(i, ms, sum(floor[j] for j in alive[i]))
                    for i, ms in report.prefix_ms.items()]
    else:
        readings = [(t.idx, t.ms, floor[t.idx]) for t in report.timings]
    fast = [(i, round(ms, 4), round(b, 4)) for i, ms, b in readings
            if ms * BOUND_SLACK < b]
    if idx != [l.idx for l in spec.layers] or zero or fast:
        raise AssertionError(f"{tag} {what}: rows {idx}, conv rows at 0 ms "
                             f"{zero}, readings faster than {BOUND_SLACK} "
                             f"of their bound (idx, ms, bound ms) {fast}")
    return min(ms / b for _, ms, b in readings if b > 0)


def phase_artifacts(dev: torch.device, smi: str,
                    replay_ms: float | None) -> dict:
    """Phase 6 (see the module's docstring): darknet blob -> weight_gen ->
    reload -> Engine, the profiler and its roofline, report bundles and the
    pipeline, all at yolov2 416. Returns the phase's kernel launches."""
    tag = "[artifacts]"
    t0 = time.perf_counter()
    spec = zoo.build("yolov2")
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) a seeded darknet blob -> the artifact contract -> reloaded
        blob, wdir = f"{tmp}/yolov2.weights", f"{tmp}/weights"
        darknet.write_darknet(blob, spec, darknet_layers(
            spec, np.random.default_rng(6)), darknet.DarknetHeader(0, 2, 0))
        floats = sum(l.n * (4 if l.batch_normalize else 1) + l.nweights
                     for l in spec.conv_layers())
        size = os.path.getsize(blob)
        if size != 20 + 4 * floats:
            raise AssertionError(f"{tag} blob of {size} bytes; want 20 + 4 x "
                                 f"{floats}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = weight_gen.main(["--from-darknet", blob, "--out-dir", wdir,
                                  "--reorg-out"])
        if rc != 0:
            raise AssertionError(f"{tag} weight_gen exited {rc}")
        calib = [np.random.default_rng(0).random(
            (3, spec.net.height, spec.net.width), dtype=np.float32)]
        with contextlib.redirect_stdout(out):
            weight_gen.from_darknet(spec, blob, wdir, calib, reorg_out=True)
        files = sorted(os.listdir(wdir))
        # the same store in memory, never written
        mem = darknet.load_darknet_weights(spec, blob)
        quantize_weights(mem, calibrate_activations(spec, mem, calib))
        re16 = load_or_synthesize(spec, wdir, "int16")
        re32 = load_or_synthesize(spec, wdir, "fp32")
        say(f"{tag} darknet blob {size} bytes (20 + 4 x {floats} floats, u64 "
            f"seen); weight_gen --from-darknet --reorg-out and its int16 set "
            f"from one seeded image: {', '.join(files)}; reloaded from the "
            f"reorg files in {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(3)
        frames = [rng.random((3, 480, 640), dtype=np.float32)
                  for _ in range(ARTIFACT_FRAMES)]
        heads = {}
        for tier, stores in (("int16", (re16, mem)), ("fp32", (re32, mem))):
            for name, store in zip(("reloaded", "in memory"), stores):
                eng = Engine(spec, store, tier, dev)
                results = [eng.detect(im) for im in frames]
                heads[tier, name] = [torch.from_numpy(r.head_chw)
                                     for _, r in results]
                if tier == "int16" and name == "reloaded":
                    plain = PlainYoloV2Q(spec, eng.qtables, eng.params, dev,
                                         tier)
                    hold_detect_heads(f"{tag} int16 reloaded", spec, frames,
                                      results, plain, dev, False)
                    log = "".join(f"frame {i}: inference time: "
                                  f"{r.seconds * 1e3:.2f} ms\n"
                                  for i, (_, r) in enumerate(results))
                    del plain
                del eng
            got, want = heads[tier, "reloaded"], heads[tier, "in memory"]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{tag} {tier} heads of the reloaded "
                                     "store != the in-memory store's")
            say(f"{tag} {tier}: the {ARTIFACT_FRAMES} detect heads from the "
                "reloaded reorg artifacts equal (torch.equal) those of the "
                "in-memory store")
        torch.cuda.empty_cache()

        # (b) the profiler, int16 at b=8 under the card's plan
        t1 = time.perf_counter()
        layers = profile_layers(spec, re16, "int16", batch=PROFILE_BATCH,
                                device=dev)
        prefix = profile_prefix(spec, re16, "int16", batch=PROFILE_BATCH,
                                device=dev)
        for what, rep in (("profile_layers", layers),
                          ("profile_prefix", prefix)):
            doc = roofline_table(rep, spec, PROFILE_BATCH, "int16")
            say(f"{tag} {what} int16 b={PROFILE_BATCH}, {smi}:")
            for line in render_roofline(doc).splitlines():
                say(f"{tag}   {line}")
            least = check_rows(tag, what, rep, doc, spec)
            say(f"{tag}   the least of its "
                + ("prefixes' times" if rep.prefix_ms else "rows")
                + f" is {least:.2f}x its bound")
        rows = sum(t.ms for t in prefix.timings)
        say(f"{tag} the whole forward's replay (the last prefix) "
            f"{prefix.total_ms:.3f} ms per batch of {PROFILE_BATCH}; phase "
            "3's replayed int16 forward "
            + (f"{replay_ms:.3f}" if replay_ms is not None else "not run")
            + f" ms; the prefix rows sum to {rows:.3f} ms (the whole "
            "forward's, but for deltas clamped at 0); each layer alone "
            f"{layers.total_ms:.3f} ms; profiles took "
            f"{time.perf_counter() - t1:.1f} s")

        # (c) report bundles, int16 (with its per-layer rows) and int8
        rd = f"{tmp}/reports"
        bundles = []
        for tier, extra in (("int16", ["--profile-layers"]), ("int8", [])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = report.main(["--report-dir", rd, "run", "--label",
                                  f"p6_{tier}", "--precision", tier,
                                  "--batch", str(PROFILE_BATCH), "--steps",
                                  str(REPORT_STEPS), "--synthetic-weights",
                                  *extra])
            bundle = out.getvalue().strip().splitlines()[-1]
            missing = [f for f in ("meta.json", "metrics.json", "summary.md")
                       if not os.path.exists(os.path.join(bundle, f))]
            if rc != 0 or missing:
                raise AssertionError(f"{tag} report run {tier}: exit {rc}, "
                                     f"{bundle} lacks {missing}")
            m = json.load(open(os.path.join(bundle, "metrics.json")))
            lat = m["latency"]
            # the tier's committed accuracy evidence at 416, if any, is
            # the bundle's accuracy block (report.accuracy_evidence)
            evidence = report.accuracy_evidence(tier, spec.net.width)
            if (lat["count"] != REPORT_STEPS or m["platform"] != "gpu"
                    or len(m.get("per_layer", [])) != (
                        spec.n if extra else 0)
                    or m.get("accuracy") != evidence):
                raise AssertionError(f"{tag} report run {tier}: {m}")
            bundles.append(os.path.basename(bundle))
            say(f"{tag} report run {tier} b={PROFILE_BATCH}: "
                f"{lat['median_ms']:.3f} ms p50 a step ({lat['fps']:.1f} "
                f"fps), b=1 replay p50 {m['batch1_device_p50_ms']} ms, build "
                f"{m['build_seconds']} s, capture {m['capture_seconds']} s, "
                f"peak {m['memory']['max_memory_allocated_bytes'] / 1e6:.0f} "
                f"MB, {m['device']} {m['power_limit_w']} W"
                + (f", {len(m['per_layer'])} per-layer rows" if extra else "")
                + (f"; accuracy block: mAP_50 {evidence['mAP_50_mean']}, "
                   f"{evidence['delta_vs_fp32_mean']:+} against fp32 "
                   f"(yolotpu_torch/plans/accuracy_{tier}.json)"
                   if evidence else "; no accuracy evidence"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = report.main(["--report-dir", rd, "compare", *bundles])
            with open(f"{tmp}/run.log", "w") as f:
                f.write(log)
            rc_log = report.main(["parse-log", f"{tmp}/run.log"])
        stats = report.parse_inference_log(f"{tmp}/run.log")
        if rc != 0 or rc_log != 0 or stats["count"] != ARTIFACT_FRAMES:
            raise AssertionError(f"{tag} compare exited {rc}, parse-log "
                                 f"{rc_log} with {stats}")
        say(f"{tag} compare {bundles[0]} {bundles[1]}: "
            f"{len(out.getvalue().splitlines())} lines; parse-log of the "
            f"detect requests' log: {stats}")

        # (d) the pipeline, its six stages, in the tempdir
        with open(f"{tmp}/pipe.yaml", "w") as f:
            f.write(PIPELINE_CONFIG)
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.chdir(tmp), contextlib.redirect_stdout(out):
            rc = pipeline.main(["--config", "pipe.yaml"])
        for line in out.getvalue().splitlines():
            say(f"{tag} pipeline: {line}")
        if rc != 0:
            raise AssertionError(f"{tag} pipeline exited {rc}")
        say(f"{tag} pipeline: all {len(pipeline.STAGES)} stages in "
            f"{time.perf_counter() - t1:.1f} s")
    torch.cuda.synchronize(dev)
    launches = launch_counts()
    planned = route_launches("int16", engine_plan.kernels(
        spec, planned_kinds(spec, dev)))
    p6 = P6_KERNELS + tuple(k for k in planned if k not in P6_KERNELS)
    if any(not launches[k] for k in p6) or any(
            v for k, v in launches.items() if k not in p6):
        raise AssertionError(f"{tag} launched {launches}; want each of "
                             f"{p6} and no other")
    say(f"{tag} launched " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                       if v)
        + f"; phase 6 took {time.perf_counter() - t0:.1f} s")
    return launches




# phase 7: training and the accuracy protocol
STEP_BATCH = 2          # (a) the card's train step against the CPU's
LOSS_TOL = 1e-5         # (a) card vs CPU, the loss, relative
STEP_TOL = 1e-3         # (a) card vs CPU, norm-wise, each conv's gradient
STEP_TOL_MEDIAN = 3e-4  # (a) card vs CPU, the median conv's
TRAIN_STEPS = 200       # (b) train_flagship_store at 416
TRAIN_BATCH = 8
TRAIN_TIMED = 10        # (b) fwd+bwd alone, CUDA events
EVAL_BATCH = 16         # (d) evaluate_engine_batched's batch
EVAL_THRESH = 0.05      # the protocol tool's
CLI_STEPS = 4           # (e) cli.train, then --resume to CLI_STEPS + 2
P7_KERNELS = ("mm_q16", "conv3x3_q16", "conv3x3_pool_q16", "mm_s8",
              "conv3x3_s8", "mm_w8a16", "conv3x3_w8a16")


class Conv2dTF32Backward(convops.Conv2dNoTF32):
    """The fp32 conv as a plain ``F.conv2d`` under the forward's flags
    would train: the forward with TF32 off, the backward under the flags
    that hold when autograd runs it (PyTorch's default: TF32 on). Only to
    show how far that lands from the CPU."""

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gx, gw, _ = torch.ops.aten.convolution_backward(
            grad, x, w, None, [ctx.stride] * 2, [0, 0], [1, 1], False,
            [0, 0], 1, [*ctx.needs_input_grad[:2], False])
        return gx, gw, None


def grad_err(got: dict, want: dict) -> tuple[float, str, float]:
    """The worst leaf's norm-wise relative error ||got - want|| / ||want||,
    that leaf's name, and the median leaf's error (on the host, in
    float64)."""
    def host(t):
        return t.cpu().double()
    errs = {f"{k}/{leaf}": float((host(got[k][leaf]) - host(want[k][leaf]))
                                 .norm() / host(want[k][leaf]).norm())
            for k in want for leaf in want[k]}
    worst = max(errs, key=errs.get)
    return errs[worst], worst, float(np.median(list(errs.values())))


def update_ulps(p_got: dict, p_want: dict, v_got: dict, v_want: dict) -> float:
    """How far the new params are apart beyond their velocities' difference,
    in ulps of the params, the worst element: p + v rounds once, so an
    update that is the CPU's gives at most 1."""
    worst = 0.0
    for k in p_want:
        for leaf in p_want[k]:
            pg, pw = p_got[k][leaf].cpu().numpy(), p_want[k][leaf].numpy()
            dv = np.abs(v_got[k][leaf].cpu().numpy().astype(np.float64)
                        - v_want[k][leaf].numpy())
            ulp = np.spacing(np.maximum(np.abs(pg), np.abs(pw)))
            beyond = np.abs(pg.astype(np.float64) - pw) - dv
            worst = max(worst, float((beyond / ulp).max()))
    return worst


class PlainEngine:
    """What ``evaluate_engine_batched`` reads of an engine (``spec``,
    ``predict_batch_rgb``), running ``PlainYoloV2Q`` eagerly on the card:
    the plain path of a tier whose kernels an Engine runs."""

    def __init__(self, eng: Engine):
        self.spec, self.device = eng.spec, eng.device
        self.model = PlainYoloV2Q(eng.spec, eng.qtables, eng.params,
                                  eng.device, eng.precision, eng._overrides,
                                  ("head",))

    def predict_batch_rgb(self, frames: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(frames).to(self.device)
        return self.model(x)["head"].permute(0, 3, 1, 2).cpu().numpy()


class Recorder:
    """An engine whose batches' heads are kept, in order."""

    def __init__(self, eng):
        self.eng, self.spec, self.heads = eng, eng.spec, []

    def predict_batch_rgb(self, frames: np.ndarray) -> np.ndarray:
        heads = self.eng.predict_batch_rgb(frames)
        self.heads.append(heads.copy())
        return heads


def fwd_bwd_ms(spec, params: dict, batch: dict, reps: int) -> list[float]:
    """CUDA-event ms of the forward (``head_fp32``), the region loss and
    its backward (``torch.autograd.grad``) alone, reps times."""
    leaves = [v.detach().requires_grad_(True) for p in params.values()
              for v in p.values()]
    it = iter(leaves)
    p = {k: {leaf: next(it) for leaf in params[k]} for k in params}
    cfg = train.LossConfig(rescore=False)
    ts = []
    for _ in range(reps + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        loss = train.region_loss(
            head_fp32(spec, p, batch["images"]), batch["boxes"],
            batch["classes"], batch["mask"], spec.region, cfg)
        torch.autograd.grad(loss, leaves)
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return ts[1:]   # the first builds cuDNN's plans


def step_vs_cpu(spec, init: WeightStore, step, dev: torch.device) -> tuple:
    """(a) One train step on the card against the same step on the CPU:
    seeded random frames with two protocol scenes' truths, the second
    flipped. Random frames, not the scenes' flat rectangles: a pool window
    whose conv outputs tie on one device and round apart on the other sends
    the gradient another way (with the scenes the worst conv's gradient read
    1.9e-3 off the CPU's; PERF.md §6).

    cuDNN (Winograd and other orders) and oneDNN round differently, and a
    conv's gradient carries the rounding of every backward conv between it
    and the loss, so the early convs' gradients differ most: with cuDNN's
    flags at PyTorch's defaults (TF32 on), each conv's gradient is held
    within STEP_TOL of its norm and the median conv's within
    STEP_TOL_MEDIAN, the loss within LOSS_TOL and the new params within 1
    ulp beyond their velocities' difference. On the card, with cuDNN's
    deterministic algorithms (so that two runs are bit-equal), the step
    with the TF32 flag on equals the step with it off throughout, bit for
    bit: no backward conv read the flag. The same step with TF32 on in the
    backward (Conv2dTF32Backward) must differ from it and land outside
    STEP_TOL_MEDIAN. Returns the card's (params, velocity, batch) after the
    step at the defaults."""
    tag = "[train]"
    size = spec.net.width
    scenes = accuracy.make_scenes(STEP_BATCH, size, 21)
    host = accuracy.batch_builder(scenes, size)(list(range(STEP_BATCH)))
    host["images"] = np.random.default_rng(21).random(
        host["images"].shape, dtype=np.float32)
    host["images"][1] = host["images"][1][:, ::-1]
    host["boxes"][1, :, 0] = 1.0 - host["boxes"][1, :, 0]
    on = {d: {k: torch.from_numpy(np.ascontiguousarray(v)).to(d)
              for k, v in host.items()} for d in ("cpu", dev)}
    params = {d: params_fp32(spec, init, d) for d in ("cpu", dev)}
    vel = {d: train.zeros_like_velocity(params[d]) for d in ("cpu", dev)}
    t1 = time.perf_counter()
    p_cpu, v_cpu, l_cpu = step(params["cpu"], vel["cpu"], on["cpu"])
    cpu_s = time.perf_counter() - t1
    flag = torch.backends.cudnn.allow_tf32
    if not flag:
        raise AssertionError(f"{tag} cuDNN's allow_tf32 is {flag}, not "
                             "PyTorch's default; (a) must run under it")
    p_dev, v_dev, l_dev = step(params[dev], vel[dev], on[dev])
    loss_err = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    g_err, g_leaf, g_med = grad_err(v_dev, v_cpu)
    ulps = update_ulps(p_dev, p_cpu, v_dev, v_cpu)

    def deterministic(tf32: bool, backward=convops.Conv2dNoTF32) -> tuple:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=tf32), \
                unittest.mock.patch.object(convops, "Conv2dNoTF32", backward):
            return step(params[dev], vel[dev], on[dev])
    on_flag, off_flag = deterministic(True), deterministic(False)
    same = all(torch.equal(a[k][leaf], b[k][leaf])
               for a, b in zip(on_flag[:2], off_flag[:2])
               for k in a for leaf in a[k]) and torch.equal(on_flag[2],
                                                            off_flag[2])
    tf32 = deterministic(True, Conv2dTF32Backward)
    tf_err, tf_leaf, tf_med = grad_err(tf32[1], v_cpu)
    tf_off, tf_off_leaf, tf_off_med = grad_err(tf32[1], off_flag[1])
    say(f"{tag} (a) a train step, yolov2 {size}x{size} b={STEP_BATCH} "
        f"(clip 1.0, one sample flipped), the card against the CPU "
        f"({cpu_s:.1f} s), cuDNN's flags at PyTorch's defaults (allow_tf32="
        f"{flag}): loss {float(l_dev):.6f} vs {float(l_cpu):.6f} (relative "
        f"error {loss_err:.2e}, tolerance {LOSS_TOL}); each conv's clipped "
        f"gradient (the velocity, -lr g) within {g_err:.2e} of its norm (the "
        f"worst, {g_leaf}; tolerance {STEP_TOL}), the median conv's "
        f"{g_med:.2e} (tolerance {STEP_TOL_MEDIAN}); the new params at most "
        f"{ulps:.2f} ulp beyond their velocities' difference (tolerance 1); "
        f"with cuDNN's deterministic algorithms the step with the TF32 flag "
        f"on {'equals' if same else 'DIFFERS FROM'} the step with it off, "
        f"bit for bit")
    say(f"{tag} (a) the same step with TF32 on in the backward "
        f"(Conv2dTF32Backward, deterministic algorithms): against the CPU "
        f"the worst conv's gradient {tf_err:.2e} ({tf_leaf}), the median "
        f"conv's {tf_med:.2e}; against the card's step with TF32 off "
        f"{tf_off:.2e} ({tf_off_leaf}), the median {tf_off_med:.2e}")
    if loss_err > LOSS_TOL or g_err > STEP_TOL or g_med > STEP_TOL_MEDIAN \
            or ulps > 1.0 or not same:
        raise AssertionError(
            f"{tag} (a) the card's step is off: loss {loss_err}, gradient "
            f"{g_err} ({g_leaf}), median {g_med}, update {ulps} ulp, the "
            f"TF32 flag {'not ' if same else ''}ignored")
    if tf_med <= STEP_TOL_MEDIAN or tf_off == 0:
        raise AssertionError(f"{tag} (a) TF32 in the backward lands within "
                             f"the tolerance (median {tf_med:.2e}, against "
                             f"TF32 off {tf_off:.2e}): it cannot be told "
                             "apart")
    return p_dev, v_dev, on[dev]


def checkpoint_roundtrip(params: dict, vel: dict, batch: dict, step,
                         dev: torch.device) -> None:
    """(c) Save, reload bit for bit, resume one step."""
    tag = "[train]"
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save_checkpoint(f"{tmp}/ck", 1, params, vel)
        n, p_back, v_back = checkpoint.load_checkpoint(
            checkpoint.latest_checkpoint(f"{tmp}/ck"))
    if n != 1 or not all(
            np.array_equal(t[k][leaf].cpu().numpy(), back[k][leaf])
            for t, back in ((params, p_back), (vel, v_back))
            for k in t for leaf in t[k]):
        raise AssertionError(f"{tag} (c) {path} reloaded != in memory")

    def on_card(tree):
        return {k: {leaf: torch.from_numpy(v).to(dev) for leaf, v in p.items()}
                for k, p in tree.items()}
    p2, _, loss = step(on_card(p_back), on_card(v_back), batch)
    if not torch.isfinite(loss) or not all(
            torch.isfinite(v).all() for p in p2.values() for v in p.values()):
        raise AssertionError(f"{tag} (c) the resumed step is not finite")
    say(f"{tag} (c) checkpoint {os.path.basename(path)} reloaded equal to the "
        f"params and velocity in memory, bit for bit; a resumed step to loss "
        f"{float(loss):.6f}")


def train_protocol(spec, dev: torch.device, smi: str) -> WeightStore:
    """(b) train_flagship_store on the protocol scenes: the loss falls; the
    steps a second and the ms a step; then (c) the trained store exported
    and reloaded bit for bit."""
    tag = "[train]"
    size = spec.net.width
    t1 = time.perf_counter()
    ms: list[float] = []
    store, losses = accuracy.train_flagship_store(
        spec, seed=0, size=size, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
        device=dev, step_ms=ms)
    wall = time.perf_counter() - t1
    batch = {k: torch.from_numpy(v).to(dev) for k, v in accuracy.batch_builder(
        accuracy.make_scenes(TRAIN_BATCH, size, 5), size)(
        list(range(TRAIN_BATCH))).items()}
    fb = fwd_bwd_ms(spec, params_fp32(spec, store, dev), batch, TRAIN_TIMED)
    # the convs' operations: forward, the weights' gradient, and the
    # inputs' gradient of every conv but the first (the frames take none)
    convs = [layer_ops_bytes(l, TRAIN_BATCH, 4)[0] for l in spec.conv_layers()]
    ops = 3 * sum(convs) - convs[0]
    bound_ms = ops / PEAK_FP32 * 1e3
    say(f"{tag} (b) train_flagship_store yolov2 {size}x{size}, b={TRAIN_BATCH}, "
        f"{TRAIN_STEPS} steps on the protocol scenes in {wall:.1f} s "
        f"(rendering and staging the {accuracy.PROTOCOL['train_scenes']} "
        f"scenes included): {TRAIN_STEPS / (sum(ms) / 1e3):.2f} steps/s on "
        f"the device's time, a step (gather, flip, forward, backward, "
        f"update) {np.median(ms[1:]):.3f} ms at the median (p90 "
        f"{np.percentile(ms[1:], 90):.3f}, first {ms[0]:.1f}); forward + "
        f"loss + backward alone {np.median(fb):.3f} ms (min {min(fb):.3f}, "
        f"{TRAIN_TIMED} runs, CUDA events), against a bound of "
        f"{bound_ms:.3f} ms ({ops / 1e9:.1f} GFLOP of convs, forward and "
        f"backward, over the fp32 peak, {PEAK_FP32 / 1e12:.0f} TFLOP/s: "
        f"{np.median(fb) / bound_ms:.1f}x); {smi}")
    say(f"{tag} (b) losses every {max(1, TRAIN_STEPS // 8)} steps: "
        + ", ".join(f"{v:.3f}" for v in losses))
    if not losses[-1] < losses[0] or not np.isfinite(losses).all():
        raise AssertionError(f"{tag} (b) the loss did not fall: {losses}")
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.export_weight_artifacts(params_fp32(spec, store), spec, tmp)
        back = WeightStore.load_fp32(spec, f"{tmp}/weights.bin",
                                     f"{tmp}/bias.bin")
    if not all(np.array_equal(a, b) for l in spec.conv_layers()
               for a, b in zip(back.fp32[l.idx], store.fp32[l.idx])):
        raise AssertionError(f"{tag} (c) exported artifacts != the store")
    say(f"{tag} (c) export_weight_artifacts then WeightStore.load_fp32: the "
        "trained arrays, bit for bit")
    return store


def score_tiers(spec, store: WeightStore, dev: torch.device) -> dict:
    """(d) The trained store quantized per tier as the protocol tool does
    and scored on the 64 eval scenes through evaluate_engine_batched: the
    integer engines on their kernels (int16 under the card's plan and under
    the rule, no plan file read, int8, w8a16), each held to the same tier's
    plain path on the card (heads bit-equal, mAP identical), the planned
    int16 heads bit-equal to the rule's on these trained weights, and fp32.
    Returns the kernel launches of the engines' run, the counts set to 0
    just before it."""
    tag = "[train]"
    size = spec.net.width
    t1 = time.perf_counter()
    tiers = ("int16", "int8", "w8a16")
    with tempfile.TemporaryDirectory() as tmp:
        pairs = accuracy.write_eval_set(tmp, size)
        accuracy_protocol.quantize_tiers(spec, store, accuracy.calib_images(
            size), tiers)
        say(f"{tag} (d) {len(pairs)} eval scenes written and the store "
            f"quantized for {', '.join(tiers)} in "
            f"{time.perf_counter() - t1:.1f} s")

        def score(eng) -> dict:
            return yeval.evaluate_engine_batched(
                eng, pairs, num_classes=spec.region.classes,
                thresh=EVAL_THRESH, batch=EVAL_BATCH)
        scores = {"fp32": score(Engine(spec, store, "fp32", dev,
                                       warmup=False))}
        recorders = {}
        reset_launches()
        for path in (*tiers, "rule"):
            with (no_plan_file() if path == "rule"
                  else contextlib.nullcontext()):
                eng = Engine(spec, store, "int16" if path == "rule" else path,
                             dev, warmup=False)
            recorders[path] = Recorder(eng)
            scores[path] = score(recorders[path])
        torch.cuda.synchronize(dev)
        launches = launch_counts()
        fused = any(order for _, order in engine_plan.kernels(
            spec, recorders["int16"].eng.model.kinds).values())
        need = [k for k in P7_KERNELS if fused or k != "conv3x3_pool_q16"]
        if any(not launches[k] for k in need) or any(
                v for k, v in launches.items() if k not in P7_KERNELS):
            raise AssertionError(f"{tag} (d) launched {launches}; want each "
                                 f"of {need} and no other")
        for path, rec in recorders.items():
            plain = Recorder(PlainEngine(rec.eng))
            want = score(plain)
            got = np.concatenate(rec.heads)
            if not np.array_equal(got, np.concatenate(plain.heads)) \
                    or scores[path] != want:
                raise AssertionError(f"{tag} (d) {path}: the kernels' heads "
                                     "or mAP != the plain path's on the card")
            say(f"{tag} (d) {path}: the {got.shape[0]} heads through the "
                "kernels bit-equal to the plain path's on the card, mAP "
                "identical")
        planned, rule = recorders["int16"], recorders["rule"]
        got, want = np.concatenate(planned.heads), np.concatenate(rule.heads)
        if (planned.eng.plan_source != card_plan_file(dev)
                or rule.eng.plan_source is not None
                or not np.array_equal(got, want)):
            raise AssertionError(
                f"{tag} (d) int16 under {planned.eng.plan_source} against the "
                f"rule ({rule.eng.plan_source}): heads equal "
                f"{np.array_equal(got, want)}")
        say(f"{tag} (d) int16 under "
            f"{planned.eng.plan_source or 'no plan file'} (kinds "
            + ",".join(f"{i}:{k}" for i, k in planned.eng.model.kinds.items()
                       if k not in ("mm", "conv3"))
            + f"): its {got.shape[0]} heads on the trained weights bit-equal "
            "to the rule's")
    f32 = scores["fp32"]["mAP_50"]
    say(f"{tag} (d) mAP_50 on the {len(pairs)} eval scenes at {size}x{size} "
        f"after {TRAIN_STEPS} steps (not evidence): "
        + ", ".join(f"{p} {r['mAP_50']:.4f}"
                    + ("" if p == "fp32" else f" ({r['mAP_50'] - f32:+.4f})")
                    for p, r in scores.items())
        + "; launched " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                    if v)
        + f"; (d) took {time.perf_counter() - t1:.1f} s")
    return launches


def train_cli_run(spec, dev: torch.device) -> None:
    """(e) cli.train on the card: synthetic steps with checkpoints, a
    resume, the export, and the exported set loaded by Engine."""
    tag = "[train]"
    size = spec.net.width
    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        # the CLI takes no clip (as the JAX package's): at full width its
        # default lr of 1e-3 on the He init reached NaN by step 3 on the
        # card; 1e-5 keeps these few steps finite
        args = ["--synthetic-data", "--batch", str(STEP_BATCH), "--lr",
                "1e-5", "--ckpt-every", "2", "--ckpt-dir", f"{tmp}/ck",
                "--export-weights", f"{tmp}/w"]
        with contextlib.redirect_stdout(out):
            rcs = [train_cli.main([*args, "--steps", str(CLI_STEPS)]),
                   train_cli.main([*args, "--steps", str(CLI_STEPS + 2),
                                   "--resume"])]
        text = out.getvalue()
        for line in text.splitlines():
            say(f"{tag} (e) cli.train: {line}")
        ckpts = sorted(os.listdir(f"{tmp}/ck"))
        eng = Engine(spec, load_or_synthesize(spec, f"{tmp}/w", "fp32"),
                     "fp32", dev, warmup=False)
        head = eng.predict_batch_rgb(np.zeros((1, size, size, 3), np.uint8))
    if rcs != [0, 0] or "resumed from" not in text or ckpts != [
            f"ckpt_{i:08d}.npz" for i in (2, 4, 6)] or not np.isfinite(
            head).all():
        raise AssertionError(f"{tag} (e) cli.train: exits {rcs}, checkpoints "
                             f"{ckpts}, head finite {np.isfinite(head).all()}")
    say(f"{tag} (e) cli.train ran {CLI_STEPS} steps, resumed to "
        f"{CLI_STEPS + 2}, kept {ckpts}, exported weights.bin/bias.bin; the "
        f"fp32 Engine on them gives a finite head {head.shape}")


def phase_train(dev: torch.device, smi: str) -> dict:
    """Phase 7 (see the module's docstring): training and the accuracy
    protocol at yolov2 416. Returns the kernel launches of (d)."""
    t0 = time.perf_counter()
    spec = zoo.build("yolov2")
    step = train.make_train_step(spec, lr=1e-3, momentum=0.9,
                                 cfg=train.LossConfig(rescore=False),
                                 clip_norm=1.0)
    params, vel, batch = step_vs_cpu(spec, WeightStore.synthetic(spec, seed=0),
                                     step, dev)
    checkpoint_roundtrip(params, vel, batch, step, dev)
    del params, vel, batch
    torch.cuda.empty_cache()
    store = train_protocol(spec, dev, smi)
    launches = score_tiers(spec, store, dev)
    del store
    torch.cuda.empty_cache()
    train_cli_run(spec, dev)
    say(f"[train] phase 7 took {time.perf_counter() - t0:.1f} s")
    return launches


# phase 8: multi-GPU (M13), eight ranks on one card
RANKS = 8
P8_BUDGET_S = 120.0
# the sharded step against one process's two halves of the batch (each dp
# rank's frames, cuDNN's deterministic algorithms on both), each conv's
# gradient norm-wise: the same frames a conv call, so only the dp and tp
# sums and the convs' Cout blocks differ (an H100 read 1.40e-6 at worst,
# 1.49e-7 the median); the b=8 step itself differs from the halves by
# cuDNN's rounding for 8 frames against 4 (2.95e-4, 1.85e-4), which only
# phase 7 (a)'s tolerances cover
SPLIT_TOL = 1e-5
P8_KERNELS = ("mm_q16", "conv3x3_q16", "nms_greedy", "mm_s8", "conv3x3_s8")
# the general convs under sp: yolov2-s2 over (dp=1, sp=2), two gloo ranks
# sharing the card, the int16 and int8 tiers, and the kernels they launch
# (conv_q16 and conv_s8 once H is gathered before conv1)
SP_RANKS, SP_BATCH, SP_TIERS = 2, 2, ("int16", "int8")
SP_KERNELS = ("mm_q16", "conv3x3_q16", "conv_q16", "mm_s8", "conv3x3_s8",
              "conv_s8")


def sp_job(root: str) -> dryrun.Job:
    """Phase 8's sp case as a dryrun.Job: yolov2-s2 (s2_store), SP_BATCH
    frames from seed 8, each of SP_TIERS' Q tables, and its params in files
    under ``root``, as Job.params reads them."""
    spec, store = s2_store()
    for tier in SP_TIERS:
        os.makedirs(os.path.join(root, tier))
        for name, p in tier_params(spec, store, tier, "cpu").items():
            for leaf, v in p.items():
                np.save(os.path.join(root, tier, f"{name}.{leaf}.npy"),
                        v.numpy())
    x = np.random.default_rng(8).random((SP_BATCH, S2_SIZE, S2_SIZE, 3),
                                        dtype=np.float32)
    return dryrun.Job(S2_SIZE, time.time(), {}, x, (), SP_TIERS,
                      {t: tier_qtables(store, t) for t in SP_TIERS}, root)


def sp_ranks(device: torch.device, job: dryrun.Job) -> dict:
    """One rank of phase 8's sp case: yolov2-s2 over a (dp, sp=2) mesh of
    the world in each of the job's tiers (``ShardedYoloV2Q``: the rank's H
    slab, conv0 on it with a halo row, H gathered before conv1). Every rank
    returns its kernel launches, the bytes its collectives received and
    the modules of JAX it loaded; rank 0 also the gathered heads."""
    spec = cfg_spec(yolov2_s2_cfg(job.size))
    mesh = make_mesh_sp(sp=2)
    x = spatial_batch_sharding(mesh)(torch.from_numpy(job.x)).contiguous()
    reset_launches()
    rec = {"heads": {}, "bytes": {}}
    for tier in job.tiers:
        model = ShardedYoloV2Q(spec, job.qtables[tier], job.params(tier), mesh,
                               device, tier, outputs=("head",))
        rec["heads"][tier] = gather_batch(model(x.to(device)),
                                          mesh)["head"].cpu().numpy()
        rec["bytes"][tier] = dict(model.tally)
    rec["launches"] = launch_counts()
    rec["blocked"] = all(sys.modules.get(m, 0) is None
                         for m in ("jax", "yolotpu"))
    rec["loaded"] = dryrun.jax_modules()
    if torch.distributed.get_rank():
        del rec["heads"]
    return rec


def phase_sp_general(dev: torch.device, tag: str) -> dict:
    """Phase 8's sp case (SP_RANKS gloo ranks on the card): each tier's
    gathered head ``torch.equal`` to the one-process forward on the card.
    Returns the ranks' launches, summed."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        job = sp_job(tmp)
        recs = launch.spawn(sp_ranks, SP_RANKS, "cuda", "gloo", args=(job,),
                            timeout=300)
        spec, x = s2_store()[0], torch.from_numpy(job.x).to(dev)
        for tier in SP_TIERS:
            one = YoloV2Q(spec, job.qtables[tier], job.params(tier), dev,
                          tier, outputs=("head",))(x)["head"].cpu()
            if not torch.equal(one, torch.from_numpy(recs[0]["heads"][tier])):
                raise AssertionError(f"{tag} sp {tier}: the sharded head != "
                                     "the one-process forward")
    launches = {k: sum(r["launches"][k] for r in recs)
                for k in recs[0]["launches"]}
    bad = [(r["loaded"]) for r in recs if not r["blocked"] or r["loaded"]]
    if bad or {k for k, v in launches.items() if v} != set(SP_KERNELS):
        raise AssertionError(f"{tag} sp ranks launched {launches} (want each "
                             f"of {SP_KERNELS} and no other), JAX {bad}")
    say(f"{tag} yolov2-s2 {S2_SIZE}x{S2_SIZE} over (dp=1, sp={SP_RANKS}), "
        f"{SP_RANKS} gloo ranks on the card, b={SP_BATCH}: the "
        f"{' and '.join(SP_TIERS)} heads equal the one-process forward on "
        "the card (torch.equal); H gathered before conv1 (3x3/s2); bytes "
        f"received by rank 0: {recs[0]['bytes']}; launched "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + f"; {time.perf_counter() - t0:.1f} s")
    return launches


def sum_launches(recs: list) -> dict:
    """Every rank's kernel launches over every stage, summed."""
    out = {}
    for rec in recs:
        for counts in rec["launches"].values():
            for k, v in counts.items():
                out[k] = out.get(k, 0) + v
    return out


def say_stages(tag: str, recs: list, what: str) -> None:
    """Per stage: seconds, ms per forward (the slowest and fastest rank) and
    the bytes each collective kind moved, per rank (rank 0) and in all."""
    r0 = recs[0]
    for name, sec in r0["seconds"].items():
        key = {"tp": [k for k in r0["ms"] if k.startswith("tp_")]}.get(
            name, [name] if name in r0["ms"] else [])
        for k in key:
            ms = [rec["ms"][k] for rec in recs]
            moved = {kind: (b, sum(rec["bytes"].get(k, {}).get(kind, 0)
                                   for rec in recs))
                     for kind, b in r0["bytes"].get(k, {}).items()}
            say(f"{tag} {what}: stage {name} ({k}) {sec:.1f} s; "
                f"{'the step' if k == 'train' else 'a forward'} "
                f"{max(ms):.1f} ms (slowest rank; fastest {min(ms):.1f}); "
                "bytes received per rank / all ranks, by collective: "
                + (", ".join(f"{kind} {b} / {tot}"
                             for kind, (b, tot) in moved.items()) or "none"))
        if not key:
            say(f"{tag} {what}: stage {name} {sec:.1f} s")


def phase_multirank(dev: torch.device, smi: str) -> dict:
    """Phase 8 (see the module's docstring): multi-GPU at yolov2 416,
    eight ranks sharing the card. Returns the ranks' kernel launches."""
    tag = "[multirank]"
    t0 = time.perf_counter()
    what = (f"{RANKS} ranks time-sliced on one card ({smi}) with host-staged "
            "gloo collectives; these numbers say nothing of scaling across "
            "cards")
    spec = zoo.build("yolov2")
    with tempfile.TemporaryDirectory() as tmp:
        run = dryrun.dryrun_multichip(RANKS, "cuda", "gloo", size=416,
                                      root=tmp)
        job, recs = run["job"], run["ranks"]
        out = recs[0]["outputs"]
        bad = [(r["rank"], r["loaded"]) for r in recs
               if not r["blocked"] or r["loaded"]]
        if bad:
            raise AssertionError(f"{tag} ranks with JAX or yolotpu not "
                                 f"blocked, or loaded: {bad}")
        # the plain path on the card, the whole batch at once
        x = torch.from_numpy(job.x).to(dev)
        for tier, key in (("int16", "int16"), ("int16", "tp_int16"),
                          ("int8", "tp_int8")):
            plain = PlainYoloV2Q(spec, job.qtables[tier], job.params(tier),
                                 dev, tier, outputs=dryrun.OUTPUTS)(x)
            diff = [k for k in plain if not torch.equal(
                plain[k].cpu(), torch.from_numpy(out[key][k]))]
            if tier == "int16" and not torch.equal(
                    plain["head"].cpu(), torch.from_numpy(out["sp"]["head"])):
                diff.append("sp head")
            if diff:
                raise AssertionError(f"{tag} {key}: {diff} differ from the "
                                     "plain path")
        del plain, x
        say(f"{tag} the dp, tp and sp int16 heads and the dp and tp "
            f"detections of {dryrun.BATCH} frames, and the int8 tp head and "
            "detections, equal the plain path on the card (torch.equal)")
        # the sharded train step against one process's on the card, and
        # a second witness: the one-process step as two halves of the
        # batch (each dp rank's frames), their gradients averaged
        params = {k: {leaf: v.to(dev) for leaf, v in p.items()}
                  for k, p in job.params("fp32").items()}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in job.batch.items()}
        step, half = train.make_train_step(spec), dryrun.BATCH // 2
        zeros = train.zeros_like_velocity(params)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True):
            p1, v1, l1 = step(params, zeros, batch)
            halves = [step(params, zeros, {k: v[i * half:(i + 1) * half]
                                           for k, v in batch.items()})[1]
                      for i in (0, 1)]
        del params, batch, zeros
        host = lambda tree: {k: {leaf: v.cpu() for leaf, v in p.items()}
                             for k, p in tree.items()}
        cpu = host(p1), host(v1)
        v_halves = {k: {leaf: (halves[0][k][leaf] + halves[1][k][leaf]).cpu()
                        / 2 for leaf in p} for k, p in v1.items()}
        del p1, v1, halves
        got = out["train"]
        as_t = [{k: {leaf: torch.from_numpy(v) for leaf, v in p.items()}
                 for k, p in got[t].items()} for t in ("params", "velocity")]
        loss_err = abs(got["loss"] - float(l1)) / abs(float(l1))
        g_err, g_leaf, g_med = grad_err(as_t[1], cpu[1])
        h_err, h_leaf, h_med = grad_err(v_halves, cpu[1])
        s_err, s_leaf, s_med = grad_err(as_t[1], v_halves)
        ulps = update_ulps(as_t[0], cpu[0], as_t[1], cpu[1])
        say(f"{tag} the sharded train step (mesh dp=2 x tp=4, "
            f"b={dryrun.BATCH}, cuDNN's deterministic algorithms) against one "
            f"process's on the card: loss {got['loss']:.6f} vs "
            f"{float(l1):.6f} (relative error {loss_err:.2e}, tolerance "
            f"{LOSS_TOL}); each conv's gradient (the velocity) within "
            f"{g_err:.2e} of its norm (the worst, {g_leaf}; tolerance "
            f"{STEP_TOL}), the median conv's {g_med:.2e} (tolerance "
            f"{STEP_TOL_MEDIAN}); the new params at most {ulps:.2f} ulp "
            "beyond their velocities' difference (tolerance 1)")
        say(f"{tag} second witness, one process's step as two b={half} "
            f"halves with their gradients averaged: against the b="
            f"{dryrun.BATCH} step {h_err:.2e} ({h_leaf}), median {h_med:.2e}; "
            f"the sharded step against the halves {s_err:.2e} ({s_leaf}; "
            f"tolerance {SPLIT_TOL}), median {s_med:.2e}")
        if loss_err > LOSS_TOL or g_err > STEP_TOL or s_err > SPLIT_TOL \
                or g_med > STEP_TOL_MEDIAN or ulps > 1.0:
            raise AssertionError(f"{tag} the sharded step is off: loss "
                                 f"{loss_err}, gradient {g_err} ({g_leaf}), "
                                 f"median {g_med}, against the halves "
                                 f"{s_err} ({s_leaf}), median {s_med}, "
                                 f"update {ulps} ulp")
        del got, as_t, cpu, out
        say_stages(tag, recs, what)
        launches = sum_launches(recs)
        # the same calls on NCCL: a world of one rank
        one = launch.spawn(dryrun.run_stages, 1, "cuda", "nccl", args=(job,),
                           timeout=300)
        dryrun.check_one_process(job, one[0], dev)
    if not one[0]["blocked"] or one[0]["loaded"]:
        raise AssertionError(f"{tag} the NCCL rank: JAX or yolotpu not "
                             f"blocked, or loaded: {one[0]['loaded']}")
    say(f"{tag} each of the {RANKS} gloo ranks and the NCCL rank ran with "
        "jax and yolotpu blocked in its sys.modules (None) and loaded "
        "neither")
    say_stages(f"{tag} nccl", one, "one rank on NCCL")
    nccl = sum_launches(one)
    missing = [k for k in P8_KERNELS if not launches.get(k)
               or not nccl.get(k)]
    if missing or any(v for k, v in {**launches, **nccl}.items()
                      if k not in P8_KERNELS):
        raise AssertionError(f"{tag} launches: gloo {launches}, nccl {nccl}; "
                             f"want {P8_KERNELS} and no other")
    sp = phase_sp_general(dev, tag)
    total = {k: launches.get(k, 0) + nccl.get(k, 0) + sp.get(k, 0)
             for k in launches}
    secs = time.perf_counter() - t0
    say(f"{tag} launches, {RANKS} gloo ranks: {launches}; the NCCL rank: "
        f"{nccl}; the sp ranks: {sp}; phase 8 took {secs:.1f} s (budget "
        f"{P8_BUDGET_S:.0f})")
    if secs > P8_BUDGET_S:
        raise AssertionError(f"{tag} phase 8 took {secs:.1f} s, over its "
                             f"budget of {P8_BUDGET_S:.0f} s")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    os.environ.setdefault("YOLO2_NO_DUMP", "1")   # no region text dumps
    if sys.argv[1:] == ["--replay-kernels"]:
        replay_kernels(torch.device("cuda", 0))
        return 0
    if sys.argv[1:] == ["--general-times"]:
        general_times_main(torch.device("cuda", 0))
        return 0
    return run(torch.device("cuda", 0))


def general_times_main(dev: torch.device) -> None:
    """``chip_smoke.py --general-times``: the card, each tensor-core
    function's registers and SASS instruction counts, and general_times of
    conv_q16, conv_w8a16 and conv_s8, with none of phase 1's checks, so a
    copy of this script run from an earlier tree's root times that tree's
    kernels; then convk_sweep."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(f"[general times] {smi}; tree {os.getcwd()}")
    lib = _build.load_library()
    regs, sass = ptxas_registers(lib.log), sass_counts(lib.path)
    for fn in sorted(sass):
        if "tc_kernel" in fn:
            say(f"[general times] {fn}: {regs.get(fn)} registers, "
                f"{sass[fn][0]} SASS instructions, {sass[fn][1]} MMA, "
                f"{sass[fn][3]} TMA bulk copies")
    times = general_times(dev)
    say(json.dumps({name: {f"b{b}": {"graph_ms": f["graph_ms"], "convs": f["convs"],
                                      "events_ms": f["events_ms"],
                                      "library_graph_ms": f["library_graph_ms"],
                                      "bound_ms": f["bound"][0]}
                           for b, f in by.items()} for name, by in times.items()}))
    convk_sweep(dev)


def run(dev: torch.device) -> int:
    """Phases 1-8 on ``dev``, then the JSON record of the kernels and the
    last line."""
    t0 = time.perf_counter()
    smi = phase_card()
    check = KernelCheck()
    phase_kernels(check, dev)
    phase_kernels8(check, dev)
    phase_kernels_pool(check, dev)
    phase_kernels_int8(check, dev)
    general_b = phase_kernels_general(check, dev)
    nms_times = phase_kernels_nms(check, dev)
    say(f"[card] phases 1, 2 and 9 took {time.perf_counter() - t0:.1f} s")
    phase_letterbox(dev)
    spec = zoo.build("yolov2")
    store = quantized_store(spec)
    # each main path -> its launches, launches per forward and engines
    runs = {tier: phase_slice(spec, store, tier, dev)
            for tier in (*TIERS, "fp32")}
    runs["rule"] = phase_rule(spec, store, runs["int16"], dev)
    for name in PLANS:
        runs[name] = phase_plan(spec, store, name, runs["rule"], dev)
    general = phase_general_slice(dev)
    # conv3x3_int8 is on no path, as K13 in the JAX package
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values())
                + general["launches"][k] for k in KERNEL_SOURCES}
    per_forward = {k: {path: r["per_forward"][k] for path, r in runs.items()
                       if r["per_forward"].get(k)} for k in KERNEL_SOURCES}
    for path, per in general["per_forward"].items():
        for k, v in per.items():
            if v:
                per_forward[k][path] = v
    say(f"[card] launches per captured forward, by kernel and path: "
        f"{per_forward}")
    say(f"[card] phases 1-3, 9 and 10 took {time.perf_counter() - t0:.1f} s")
    names = kernel_names(dev)
    say(f"[profile] kernels by full name: {len(names)} of "
        f"{len(TC_INSTANCES) + len(NMS_FUNCTIONS)} functions of yolov2's "
        "paths seen by the "
        "profiler")
    net = (spec.net.height, spec.net.width, 3)
    for path, r in runs.items():
        engines = [("", r["eng"])] + ([("device NMS ", r["det"])]
                                      if "det" in r else [])
        phase_profile_replay(f"[profile {path}]", {
            f"{what}b={b}": graph_of(e, dt, (b, *net))
            for what, e in engines
            for b, dt in ((BATCH_SLICE, torch.uint8), (1, torch.float32))},
            names)
    # each tier's convs unfused: int16 through the rule run's model
    unfused = {tier: runs["rule" if tier == "int16" else tier]
               for tier in TIERS}
    forward = {}
    for tier in TIERS:
        forward.update(phase_profile(unfused[tier]["eng"].model,
                                     unfused[tier]["plain"], dev, names))
    forward["conv3x3_pool_q16"] = phase_profile_pool(
        runs["rule"]["eng"].model, runs["P1"]["eng"].model, dev, names)
    forward["nms_greedy"] = nms_times
    for tier in TIERS:
        phase_split(unfused[tier]["eng"].model, dev)
    phase_split(runs["P1"]["eng"].model, dev, fused_only=True)
    say(f"[card] phases 1-4 took {time.perf_counter() - t0:.1f} s")
    runtime = phase_runtime(dev)
    for k in launches:
        launches[k] += runtime.get(k, 0)
    say(f"[card] phases 1-5 took {time.perf_counter() - t0:.1f} s")
    replay_ms = runs["int16"]["replay_ms"]
    del runs
    torch.cuda.empty_cache()
    artifacts = phase_artifacts(dev, smi, replay_ms)
    for k in launches:
        launches[k] += artifacts.get(k, 0)
    say(f"[card] phases 1-6 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    training = phase_train(dev, smi)
    for k in launches:
        launches[k] += training.get(k, 0)
    say(f"[card] phases 1-7 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    multirank = phase_multirank(dev, smi)
    for k in launches:
        launches[k] += multirank.get(k, 0)
    say(f"[card] phases 1-8 took {time.perf_counter() - t0:.1f} s")

    def at(f: dict) -> dict:
        return {"ms": f["ms"], "device_ms": f.get("device_ms"),
                "graph_ms": f["graph_ms"],
                "library_graph_ms": f.get("library_graph_ms"),
                "bound_ms": f["bound"][0],
                "bound_by": bound_by(f["bound"]), "plain_ms": f["plain_ms"],
                "library_ms": f.get("library_ms"),
                "library": " / ".join(sorted(f.get("library", ())))}

    def general_at(name: str, bsz: int) -> dict:
        """A general conv's sums over yolov2-s2's five strided convs at
        batch bsz (phase 9: events at BATCH_SLICE, graph replays at both)."""
        f = general_b[name][bsz]
        events = bsz == BATCH_SLICE
        return {"ms": check.ms[name] if events else f["events_ms"],
                "graph_ms": f["graph_ms"], "bound_ms": f["bound"][0],
                "bound_by": bound_by(f["bound"]),
                "plain_ms": check.plain_ms[name] if events else None,
                "library_ms": check.library_ms[name] if events else None,
                "library_graph_ms": f["library_graph_ms"],
                "library": " / ".join(sorted(check.library[name]))}

    # ms, plain_ms, bound_ms and library_ms: summed over phase 2's timed
    # cases (the yolov2 416 shapes of the kernel's kind at batch 2; for the
    # general convs phase 9's, yolov2-s2's five strided convs at batch 8,
    # the batch of their main path, where per_forward adds their graph
    # replays; for nms_greedy its yolov2 416 table at batch 8, which has no
    # library call); per_forward: phase 4's sums over one forward's convs at batch 8
    # and 1 (ms and library_ms from CUDA events around the calls, which hold
    # the host's time per launch; device_ms the kernel's device time in the
    # forward, from the profiler; graph_ms and library_graph_ms, for the 1x1
    # kernels and the fused conv+pool, the kernel and the library calls
    # alone in CUDA graph replays; for nms_greedy phase 2's tables at batch
    # 8 and 1); launches: the main paths' launches (phases 3, 10, 5, 6, 7
    # and 8, phase 8's summed over its ranks), each
    # path's forwards run once eagerly and once under capture
    # (launches_per_forward; phase 5's streaming path: its three graphs;
    # phase 6's engines, profiles, report bundles and pipeline; phase 7's
    # four engines scoring the trained store, one graph each), and
    # replayed for every request
    kernels = []
    for name, (src, rep) in KERNEL_SOURCES.items():
        nms_b8 = nms_times[BATCH_SLICE] if name == "nms_greedy" else None
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": check.max_abs_err[name],
            "ms": nms_b8["ms"] if nms_b8 else check.ms[name],
            "plain_ms": nms_b8["plain_ms"] if nms_b8 else check.plain_ms[name],
            "bound_ms": nms_b8["bound"][0] if nms_b8 else check.bound[name][0],
            "bound_by": bound_by(nms_b8["bound"] if nms_b8
                                 else check.bound[name]),
            "library_ms": None if nms_b8 else check.library_ms[name],
            "library": ("none: PyTorch has no NMS call, torchvision is not "
                        "installed" if nms_b8
                        else " / ".join(sorted(check.library[name]))),
            "launches_per_forward": per_forward[name],
            "per_forward": ({f"b{b}": at(f) for b, f in forward[name].items()}
                            if name in forward else
                            {f"b{b}": general_at(name, b)
                             for b in general_b[name]}
                            if name in GENERAL_KERNELS else None)})
    say(f"[card] {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
