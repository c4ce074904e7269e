"""The control of the check: the reference put in the system's place,
computed in the tier below the configuration's (its ``control``: int8 for
int16, int4 for int8), and held to the reference by the same comparison and
limits that decide a run's ``correct``. It has to come out not correct.

    python3 -m portbench.control --workload <name> --seeds 1,2,3

prints, for each seed, one JSON line with the check's numbers of the
control, on the cell's own sizes: the seed's inputs, as many frames as a run
compares, drawn as its requests draw them. It runs on the card and exits 2
without one. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from . import check, synth
from .netcfg import layers_of
from .references import load as load_reference
from .traffic import Traffic


def control_numbers(config: dict, traffic: Traffic, seed: int,
                    device: str) -> dict:
    """The check's numbers of the reference in the configuration's control
    tier against the reference in its own tier, over the frames of the
    first requests the seed draws, as many as a run compares."""
    dev = torch.device(device)
    layers = layers_of(config)
    inputs = synth.make_inputs(layers, config["weights"], config["engine"],
                               traffic.pool_shape(layers[0].h, layers[0].w),
                               traffic.raw, seed, dev)
    n = math.ceil(config["check"]["sample_frames"] / traffic.batch)
    drawn = list(itertools.islice(synth.request_order(seed, traffic.choices),
                                  n))
    frames = np.concatenate([traffic.request(inputs.pool, c) for c in drawn])
    ref = load_reference(config["reference"])
    want = ref(config, inputs.weights, inputs.calib, config["precision"],
               dev).detect(frames, traffic.raw)
    got = ref(config, inputs.weights, inputs.calib, config["control"],
              dev).detect(frames, traffic.raw)
    chk = config["check"]
    return check.compare(got, want, chk["pair_box"], chk["pair_score"])


def main(argv=None) -> int:
    from .manifest import Manifest
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    manifest = Manifest(Path.cwd() / "BENCHMARK.json")
    cell = manifest.cell(args.workload)
    config, traffic = manifest.config(cell), manifest.traffic(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_numbers(config, traffic, seed, "cuda:0")
        correct, _ = check.judge(numbers, config["check"]["limits"])
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          "control": config["control"], "correct": correct,
                          **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
