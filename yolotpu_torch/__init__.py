"""yolotpu_torch — the int16-exact YOLOv2 detector of ``yolotpu`` on PyTorch
and CUDA (NVIDIA Hopper).

The JAX package ``yolotpu`` is the reference; this package runs the same
graphs, weights and Q tables with PyTorch, and every conv through a CUDA C++
kernel written for ``sm_90a`` (``csrc/``). Its numpy host layer (cfg, graph,
zoo, weights, quant, postprocess, image, names) is ``yolotpu``'s, imported as
it is. It never imports JAX.

Public entry points:
    yolotpu_torch.runtime.engine.Engine         — weights + graph -> detections
    yolotpu_torch.models.yolov2.YoloV2Int16     — the network as an nn.Module
    yolotpu_torch.ops.q16                       — the two conv kernels
    yolotpu_torch.cli.detect                    — `yolov2_detect`-compatible CLI
"""

__version__ = "0.1.0"
