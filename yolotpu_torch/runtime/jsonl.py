"""JSONL detection records, field-compatible with the reference board app.

Format mirror of ``linux_app/src/main.c:1028-1077``: one JSON object per
inference with mode/source/frame_index/inference_index/width/height and a
``detections`` array of {class_id, label, prob, bbox_norm{x,y,w,h},
bbox_px{x0,y0,x1,y1}} — only each detection's best class is recorded, and
pixel corners are truncated toward zero like the C int casts.

Mirrors ``yolotpu/runtime/jsonl.py``; the port keeps its own copy and imports nothing
of ``yolotpu``.
"""

from __future__ import annotations

import json


class JsonlWriter:
    def __init__(self, path: str):
        self._f = open(path, "a", buffering=1)

    def close(self) -> None:
        self._f.close()

    def write_record(self, mode: str, source: str, frame_index: int,
                     inference_index: int, width: int, height: int,
                     dets, labels: list[str], thresh: float) -> None:
        out = {
            "mode": mode,
            "source": source,
            "frame_index": frame_index,
            "inference_index": inference_index,
            "width": width,
            "height": height,
            "detections": [],
        }
        for d in dets:
            best_class, best_prob = d.best_class()
            if best_prob <= thresh or best_class < 0:
                continue
            bx, by, bw, bh = d.bbox
            rec = {
                "class_id": int(best_class),
                "label": labels[best_class] if best_class < len(labels) else "unknown",
                "prob": round(float(best_prob), 6),
                "bbox_norm": {"x": round(bx, 6), "y": round(by, 6),
                              "w": round(bw, 6), "h": round(bh, 6)},
                "bbox_px": {"x0": int((bx - bw / 2) * width),
                            "y0": int((by - bh / 2) * height),
                            "x1": int((bx + bw / 2) * width),
                            "y1": int((by + bh / 2) * height)},
            }
            out["detections"].append(rec)
        self._f.write(json.dumps(out, separators=(",", ":")) + "\n")
