"""The comparison that decides ``correct``: the system's top-K tables
against the reference's detections of the same frames.

Each valid detection of the system (its box, score and class) is paired
with a detection of the reference of the same frame and class whose box
coordinates all lie within ``pair_box`` of its own and whose score lies
within ``pair_score``, the nearest box first, each reference detection
paired once. Equal to rounding, the two sides pair whole: float32 on the
card against float64 here leave gaps near 1e-7. The number compared is
``unmatched``, the detections of either side left without a partner. Its
limit lets one through: a score within rounding of the threshold, or an
IoU within rounding of the NMS's, can fall on either side of it. One
answer altered (its box, score or class) leaves two: itself and the one
it replaced. A sampled request that returned no table of the right shape
leaves every reference detection of its frames unmatched. The largest
score and box gaps of the pairs are reported beside it.
"""

from __future__ import annotations

import numpy as np


def frame_detections(tables: tuple, f: int):
    """The valid entries of frame f of a system's top-K tables (boxes,
    scores, classes, valid), in the tables' order."""
    boxes, scores, classes, valid = tables
    v = np.asarray(valid[f], bool)
    return (np.asarray(boxes[f], np.float64)[v],
            np.asarray(scores[f], np.float64)[v],
            np.asarray(classes[f], np.int64)[v])


def compare(got: list, want: list, pair_box: float,
            pair_score: float) -> dict:
    """got, want: per frame (boxes (D, 4), scores (D,), classes (D,)), or
    None in got for a frame whose table never came. -> ``unmatched``, the
    pairs' largest gaps, and the detections of both sides."""
    unmatched = total = 0
    score_gap = box_gap = 0.0
    for g, w in zip(got, want, strict=True):
        wb, ws, wc = w
        total += len(ws)
        if g is None:
            unmatched += len(ws)
            continue
        gb, gs, gc = g
        total += len(gs)
        free = np.ones(len(ws), bool)
        for b, s, c in zip(gb, gs, gc):
            cand = np.flatnonzero(free & (wc == c))
            if cand.size:
                d = np.abs(wb[cand] - b).max(axis=1)
                k = cand[int(np.argmin(d))]
                dbox, dscore = float(d.min()), abs(float(ws[k]) - float(s))
                if dbox <= pair_box and dscore <= pair_score:
                    free[k] = False
                    box_gap = max(box_gap, dbox)
                    score_gap = max(score_gap, dscore)
                    continue
            unmatched += 1
        unmatched += int(free.sum())
    return {"unmatched": unmatched, "score_gap": score_gap,
            "box_gap": box_gap, "detections": total}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every compared number at or under its limit, with detections to
    compare. -> (correct, {name: {"value", "limit"}})."""
    shown = {k: {"value": numbers[k], "limit": lim} for k, lim in
             limits.items()}
    ok = numbers["detections"] > 0 and all(numbers[k] <= lim for k, lim in
                                           limits.items())
    return ok, shown
