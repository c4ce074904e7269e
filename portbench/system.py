"""The system under test: the PyTorch port's engine, built from a
configuration and a run's inputs through the port's own API (its cfg
sections, weight store, calibration and quantization, ``Engine``). This is
the only module of the benchmark that imports the port, and it does so
inside its functions."""

from __future__ import annotations

import numpy as np


def _quantize(spec, store, precision: str, calib: list[np.ndarray]) -> None:
    """The port's calibration and quantization of one tier, as its
    ``load_or_synthesize`` runs them for synthetic weights."""
    from yolotpu_torch import quant
    if precision == "int16":
        quant.quantize_weights(store, quant.calibrate_activations(
            spec, store, calib))
    elif precision == "int8":
        quant.quantize_weights_int8(store, quant.calibrate_activations_int8(
            spec, store, calib))
    elif precision == "w8a16":
        quant.quantize_weights_w8a16(store, quant.calibrate_activations(
            spec, store, calib))
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r}")


def build(config: dict, weights: dict, calib: np.ndarray, device: str):
    """The port's Engine for a configuration on ``device``: the network from
    the configuration's sections, the fp32 weights, the tier's scales from
    the calibration image, and the engine settings. No warm-up graph: the
    cell's first call captures its own."""
    from yolotpu_torch.cfg import Section
    from yolotpu_torch.graph import NetworkSpec
    from yolotpu_torch.runtime.engine import Engine
    from yolotpu_torch.weights import WeightStore

    net = config["net"]
    sections = [Section("net", 0, {k: str(v) for k, v in net.items()})]
    sections += [Section(sec["type"], i + 1, {k: str(v) for k, v in sec.items()
                                              if k != "type"})
                 for i, sec in enumerate(config["layers"])]
    spec = NetworkSpec.from_sections(sections)
    store = WeightStore(spec=spec)
    store.fp32 = dict(weights)
    _quantize(spec, store, config["precision"], [calib])
    e = config["engine"]
    return Engine(spec, store, precision=config["precision"], device=device,
                  device_nms=e["device_nms"], thresh=e["thresh"],
                  nms=e["nms"], topk=e["topk"], warmup=False)
