"""The comparison that decides ``correct``, on detections made by hand."""

import numpy as np

from portbench import check

LIMITS = {"unmatched": 1}


def dets(*rows):
    """(box x, y, w, h, score, class) rows -> one frame's detections."""
    a = np.array(rows, np.float64).reshape(-1, 6)
    return a[:, :4], a[:, 4], a[:, 5].astype(np.int64)


REF = [dets((0.2, 0.2, 0.1, 0.1, 0.9, 3), (0.5, 0.5, 0.2, 0.2, 0.6, 7),
            (0.52, 0.5, 0.05, 0.05, 0.4, 7)),
       dets((0.7, 0.1, 0.3, 0.2, 0.3, 0))]


def judge(got):
    n = check.compare(got, REF, pair_box=1e-4, pair_score=1e-4)
    return n, check.judge(n, LIMITS)[0]


def test_equal_to_rounding_is_correct():
    got = [(b + 1e-7, s - 1e-7, c) for b, s, c in REF]
    n, ok = judge(got)
    assert ok and n["unmatched"] == 0 and n["detections"] == 8
    assert 0 < n["box_gap"] < 2e-7 and 0 < n["score_gap"] < 2e-7


def test_pairs_by_class_and_nearest_box():
    # the system's order differs: pairs are found by class and box
    b, s, c = REF[0]
    got = [(b[::-1], s[::-1], c[::-1]), REF[1]]
    assert judge(got)[1]


def test_one_detection_at_the_threshold_passes():
    b, s, c = REF[1]
    got = [REF[0], (b[:0], s[:0], c[:0])]   # one side lost one detection
    n, ok = judge(got)
    assert n["unmatched"] == 1 and ok


def test_one_altered_answer_fails():
    b, s, c = REF[0]
    for altered in ((b, s, c + np.array([0, 1, 0])),
                    (b + np.array([[1e-3, 0, 0, 0], [0] * 4, [0] * 4]), s, c),
                    (b, s + np.array([0.0, 0.0, 1e-3]), c)):
        n, ok = judge([altered, REF[1]])
        assert n["unmatched"] == 2 and not ok


def test_a_missing_table_counts_its_detections():
    n, ok = judge([REF[0], None])
    assert n["unmatched"] == 1 and ok   # one reference detection missing
    n, ok = judge([None, None])
    assert n["unmatched"] == 4 and not ok


def test_no_detections_is_not_correct():
    empty = (np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64))
    n = check.compare([empty], [empty], 1e-4, 1e-4)
    assert n["detections"] == 0 and not check.judge(n, LIMITS)[0]
