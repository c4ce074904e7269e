"""The port's weight artifact writers (yolotpu_torch.weights) against
yolotpu's, on the CPU: weight_reorg on exact and ragged tile blocks, and the
files of save_fp32, save_int16 (odd-count padding) and QTables.save,
byte-equal with and without reorg, and read back by the port's loaders."""

import os

import numpy as np
import pytest

from yolotpu import weights as jw
from yolotpu.models import zoo as jzoo
from yolotpu_torch import weights as tw
from yolotpu_torch.models import zoo as tzoo


@pytest.mark.parametrize("shape,tm,tn", [
    ((64, 32, 3, 3), 32, 4),     # exact blocks
    ((37, 11, 3, 3), 32, 4),     # ragged in both
    ((5, 7, 1, 1), 3, 2),        # ragged, 1x1
    ((425, 1024, 1, 1), 32, 4),  # the yolov2 head
    ((3, 5, 3, 3), 8, 8),        # one block smaller than a tile
], ids=["exact", "ragged", "ragged-1x1", "head", "sub-tile"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_weight_reorg_equal_and_inverse(shape, tm, tn, dtype):
    w = np.random.default_rng(0).integers(-999, 999, shape).astype(dtype)
    got = tw.weight_reorg(w, tm, tn)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, jw.weight_reorg(w, tm, tn))
    n, c, k, _ = shape
    np.testing.assert_array_equal(tw.weight_unreorg(got, n, c, k, tm, tn), w)


def _stores(name, width, rng):
    """The same seeded fp32/int16 weights and Q tables in a store of each
    package (``yolov2-tiny`` has odd element counts: its head conv's 425
    biases)."""
    ts, js = tzoo.build(name, width=width, height=width), jzoo.build(
        name, width=width, height=width)
    t, j = tw.WeightStore(spec=ts), jw.WeightStore(spec=js)
    for l in ts.conv_layers():
        w = rng.standard_normal((l.n, l.c, l.size, l.size)).astype(np.float32)
        b = rng.standard_normal(l.n).astype(np.float32)
        wi = rng.integers(-32768, 32767, w.shape).astype(np.int16)
        bi = rng.integers(-32768, 32767, l.n).astype(np.int16)
        t.fp32[l.idx] = j.fp32[l.idx] = (w, b)
        t.int16[l.idx] = j.int16[l.idx] = (wi, bi)
    n = len(ts.conv_layers())
    q = [rng.integers(0, 16, n).tolist(), rng.integers(0, 16, n).tolist(),
         rng.integers(0, 16, n + 1).tolist()]
    t.qtables, j.qtables = tw.QTables(*q), jw.QTables(*q)
    return t, j


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("reorg,tm,tn", [(False, 32, 4), (True, 32, 4),
                                         (True, 5, 3)],
                         ids=["plain", "reorg", "reorg-ragged"])
@pytest.mark.parametrize("name", ["yolov2-tiny", "yolov2-voc"])
def test_save_fp32_int16_qtables_byte_equal(tmp_path, name, reorg, tm, tn):
    t, j = _stores(name, 64, np.random.default_rng(1))
    for store, d in ((t, tmp_path / "port"), (j, tmp_path / "jax")):
        store.save_fp32(str(d), reorg=reorg, tm=tm, tn=tn)
        store.save_int16(str(d), reorg=reorg, tm=tm, tn=tn)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want
    wname = "weights_reorg_int16.bin" if reorg else "weight_int16.bin"
    assert set(got) == {"weights_reorg.bin" if reorg else "weights.bin",
                        "bias.bin", wname, "bias_int16.bin",
                        "weight_int16_Q.bin", "bias_int16_Q.bin",
                        "iofm_Q.bin"}
    # odd-count padding: one int16 pad after each odd-sized layer
    convs = t.spec.conv_layers()
    pad_w = sum(l.nweights & 1 for l in convs)
    pad_b = sum(l.n & 1 for l in convs)
    assert len(got[wname]) == 2 * (sum(l.nweights for l in convs) + pad_w)
    assert len(got["bias_int16.bin"]) == 2 * (sum(l.n for l in convs) + pad_b)
    if name == "yolov2-voc":
        assert pad_b == 1      # the 125-filter head
    # read back through the port's loaders
    d = str(tmp_path / "port")
    back = tw.WeightStore.load_int16(t.spec, f"{d}/{wname}",
                                     f"{d}/bias_int16.bin", d, reorg=reorg,
                                     tm=tm, tn=tn)
    back32 = tw.WeightStore.load_fp32(
        t.spec, f"{d}/{'weights_reorg.bin' if reorg else 'weights.bin'}",
        f"{d}/bias.bin", reorg=reorg, tm=tm, tn=tn)
    assert back.qtables == t.qtables
    for l in convs:
        for a, b in zip(back.int16[l.idx] + back32.fp32[l.idx],
                        t.int16[l.idx] + t.fp32[l.idx]):
            np.testing.assert_array_equal(a, b)


def test_qtables_save_alone(tmp_path):
    q = ([3, 4, -1], [5, 6, 7], [8, 9, 10, 11])
    tw.QTables(*q).save(str(tmp_path))
    assert tw.QTables.load(str(tmp_path)) == tw.QTables(*q)
    os.makedirs(tmp_path / "j")
    jw.QTables(*q).save(str(tmp_path / "j"))
    for n in ("weight_int16_Q.bin", "bias_int16_Q.bin", "iofm_Q.bin"):
        assert (tmp_path / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


def test_save_int16_without_qtables_writes_no_q_files(tmp_path):
    t, j = _stores("yolov2-tiny", 32, np.random.default_rng(2))
    t.qtables = j.qtables = None
    t.save_int16(str(tmp_path / "port"))
    j.save_int16(str(tmp_path / "jax"))
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert set(_files(tmp_path / "port")) == {"weight_int16.bin",
                                              "bias_int16.bin"}
