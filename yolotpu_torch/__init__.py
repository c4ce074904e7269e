"""yolotpu_torch — the integer YOLOv2 detector of ``yolotpu`` (int16-exact,
int8 w8a8 and w8a16 tiers) on PyTorch and CUDA (NVIDIA Hopper).

The JAX package ``yolotpu`` is the reference; this package runs the same
graphs, weights and Q tables with PyTorch, and every conv through a CUDA C++
kernel written for ``sm_90a`` (``csrc/``). Its numpy host layer (cfg, graph,
models.zoo, weights, golden's fp32 forward, quant, image, postprocess, names,
runtime.logging and runtime.drawing) is its own copy of ``yolotpu``'s, module
for module, each saying which file it mirrors. It imports nothing of
``yolotpu`` and never imports JAX.

Public entry points:
    yolotpu_torch.runtime.engine.Engine         — weights + graph -> detections
    yolotpu_torch.models.yolov2.YoloV2Q         — the network as an nn.Module
    yolotpu_torch.ops.q16                       — the int16 tier's conv kernels
    yolotpu_torch.ops.q8                        — the int8 and w8a16 tiers' ones
    yolotpu_torch.cli.detect                    — `yolov2_detect`-compatible CLI
"""

__version__ = "0.1.0"
