"""The port's darknet ingest (yolotpu_torch.darknet) and weight_gen CLI
against yolotpu's, on the CPU: the same blob bytes from each writer, each
package reading the other's blob, fold_batchnorm bit-equal in both eps
variants, the same errors for truncated blobs and trailing floats, the full
yolov2 graph's blob size, and every file weight_gen writes byte-equal for
the same argv (--from-darknet with PNG --calib images, --reorg-out, the
--unreorg round trip, the in-place guard)."""

import os

import numpy as np
import pytest

from yolotpu import darknet as jdn
from yolotpu.cli import weight_gen as jwg
from yolotpu.graph import NetworkSpec as JSpec
from yolotpu.models import zoo as jzoo
from yolotpu_torch import darknet as tdn
from yolotpu_torch.cli import weight_gen as twg
from yolotpu_torch.graph import NetworkSpec as TSpec
from yolotpu_torch.models import zoo as tzoo

CFG = """
[net]
height=32
width=32
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=5
size=3
stride=1
pad=1
activation=leaky

[convolutional]
filters=7
size=1
stride=1
pad=1
activation=linear

[region]
anchors=1,1
num=1
classes=2
coords=4
softmax=1
"""


@pytest.fixture()
def cfg(tmp_path):
    p = tmp_path / "t.cfg"
    p.write_text(CFG)
    return str(p)


def _params(spec, rng, mod):
    """Seeded darknet parameters, as ``mod``'s ConvParams."""
    layers = {}
    for l in spec.conv_layers():
        w = rng.standard_normal((l.n, l.c, l.size, l.size)).astype(np.float32)
        b = rng.standard_normal(l.n).astype(np.float32)
        bn = {}
        if l.batch_normalize:
            bn = dict(scales=rng.uniform(0.5, 2.0, l.n).astype(np.float32),
                      rolling_mean=rng.standard_normal(l.n).astype(np.float32),
                      rolling_variance=rng.uniform(0.1, 2.0, l.n).astype(
                          np.float32))
        layers[l.idx] = mod.ConvParams(w, b, **bn)
    return layers


@pytest.mark.parametrize("version", [(0, 2, 0), (0, 1, 0), (1, 0, 5)],
                         ids=["u64-seen", "u32-seen", "v1-u64"])
def test_blob_bytes_equal_and_read_across(tmp_path, cfg, version):
    js, ts = JSpec.from_cfg(cfg), TSpec.from_cfg(cfg)
    jp, tp = str(tmp_path / "j.weights"), str(tmp_path / "t.weights")
    jdn.write_darknet(jp, js, _params(js, np.random.default_rng(0), jdn),
                      jdn.DarknetHeader(*version, seen=987654321))
    tdn.write_darknet(tp, ts, _params(ts, np.random.default_rng(0), tdn),
                      tdn.DarknetHeader(*version, seen=987654321))
    assert open(jp, "rb").read() == open(tp, "rb").read()
    got, want = tdn.read_darknet(ts, jp), jdn.read_darknet(js, tp)
    assert vars(got.header) == vars(want.header)
    assert got.header.seen_is_u64 == want.header.seen_is_u64
    assert got.layers.keys() == want.layers.keys()
    for idx, p in got.layers.items():
        for k in ("weights", "biases", "scales", "rolling_mean",
                  "rolling_variance"):
            a, b = getattr(p, k), getattr(want.layers[idx], k)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), (idx, k)


@pytest.mark.parametrize("eps,inside", [(1e-6, False), (1e-5, True),
                                        (1e-3, False)],
                         ids=["pjreddie", "alexeyab", "large-eps"])
def test_fold_batchnorm_bit_equal(tmp_path, cfg, eps, inside):
    rng = np.random.default_rng(1)
    ts = TSpec.from_cfg(cfg)
    for l in ts.conv_layers():
        p = _params(ts, rng, tdn)[l.idx]
        jp = jdn.ConvParams(p.weights, p.biases, p.scales, p.rolling_mean,
                            p.rolling_variance)
        got = tdn.fold_batchnorm(p, eps, inside)
        want = jdn.fold_batchnorm(jp, eps, inside)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            assert a.tobytes() == b.tobytes(), l.idx
    path = str(tmp_path / "w.weights")
    tdn.write_darknet(path, ts, _params(ts, rng, tdn))
    got = tdn.load_darknet_weights(ts, path, eps, inside)
    want = jdn.load_darknet_weights(JSpec.from_cfg(cfg), path, eps, inside)
    for idx in want.fp32:
        for a, b in zip(got.fp32[idx], want.fp32[idx]):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("keep", [-64, -4, 24], ids=["tail", "one-float",
                                                    "header-and-one"])
def test_truncated_blob_same_error(tmp_path, cfg, keep):
    ts, js = TSpec.from_cfg(cfg), JSpec.from_cfg(cfg)
    path = str(tmp_path / "w.weights")
    tdn.write_darknet(path, ts, _params(ts, np.random.default_rng(3), tdn))
    short = str(tmp_path / "short.weights")
    open(short, "wb").write(open(path, "rb").read()[:keep])
    errors = []
    for mod, spec in ((tdn, ts), (jdn, js)):
        with pytest.raises(ValueError) as e:
            mod.read_darknet(spec, short)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "truncated" in errors[0]


def test_trailing_floats_and_tiny_file_same_error(tmp_path, cfg):
    ts, js = TSpec.from_cfg(cfg), JSpec.from_cfg(cfg)
    path = str(tmp_path / "w.weights")
    tdn.write_darknet(path, ts, _params(ts, np.random.default_rng(3), tdn))
    longer = str(tmp_path / "long.weights")
    open(longer, "wb").write(open(path, "rb").read() + b"\x00" * 16)
    tiny = str(tmp_path / "tiny.weights")
    open(tiny, "wb").write(b"\x00" * 12)
    for blob, what in ((longer, "trailing"), (tiny, "too small")):
        errors = []
        for mod, spec in ((tdn, ts), (jdn, js)):
            with pytest.raises(ValueError) as e:
                mod.read_darknet(spec, blob)
            errors.append(str(e.value))
        assert errors[0] == errors[1] and what in errors[0]


def test_bn_without_params_same_error(tmp_path, cfg):
    ts, js = TSpec.from_cfg(cfg), JSpec.from_cfg(cfg)
    errors = []
    for mod, spec in ((tdn, ts), (jdn, js)):
        layers = _params(spec, np.random.default_rng(4), mod)
        layers[0].scales = None
        with pytest.raises(ValueError) as e:
            mod.write_darknet(str(tmp_path / "w.weights"), spec, layers)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_yolov2_full_graph_blob_size(tmp_path):
    """The real yolov2 graph's blob (BN on every conv but the last), as the
    official 194 MB one is sized, from the port's writer; yolotpu reads
    it."""
    ts = tzoo.build("yolov2", width=64, height=64)
    layers, nfloats = {}, 0
    for l in ts.conv_layers():
        bn = ((np.ones(l.n, np.float32), np.zeros(l.n, np.float32),
               np.ones(l.n, np.float32)) if l.batch_normalize
              else (None, None, None))
        layers[l.idx] = tdn.ConvParams(
            np.zeros((l.n, l.c, l.size, l.size), np.float32),
            np.zeros(l.n, np.float32), *bn)
        nfloats += l.nweights + l.n * (4 if l.batch_normalize else 1)
    path = str(tmp_path / "yolov2.weights")
    tdn.write_darknet(path, ts, layers)
    assert os.path.getsize(path) == 20 + 4 * nfloats
    assert os.path.getsize(path) // 2 ** 20 == 194     # MiB
    assert [l.batch_normalize for l in ts.conv_layers()] == [True] * 22 + [False]
    blob = jdn.read_darknet(jzoo.build("yolov2", width=64, height=64), path)
    assert len(blob.layers) == 23 and blob.header.seen == 32013312


def _png(path, rng, h, w):
    from PIL import Image
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
    return path


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("extra", [[], ["--reorg-out"],
                                   ["--reorg-out", "--tm", "3", "--tn", "2",
                                    "--bn-eps", "1e-5", "--bn-eps-inside"]],
                         ids=["plain", "reorg-out", "ragged-tiles-alexeyab"])
def test_weight_gen_from_darknet_files_equal(tmp_path, cfg, extra, capsys):
    rng = np.random.default_rng(5)
    blob = str(tmp_path / "m.weights")
    tdn.write_darknet(blob, TSpec.from_cfg(cfg),
                      _params(TSpec.from_cfg(cfg), rng, tdn))
    calib = [_png(str(tmp_path / f"c{i}.png"), rng, 40 + 8 * i, 24)
             for i in range(2)]
    got = {}
    for name, mod in (("port", twg), ("jax", jwg)):
        out = str(tmp_path / name)
        assert mod.main(["--cfg", cfg, "--from-darknet", blob, "--out-dir",
                         out, "--calib", *calib, *extra]) == 0
        got[name] = _files(out)
    assert got["port"] == got["jax"]
    want = {"weights.bin", "bias.bin", "weight_int16.bin", "bias_int16.bin",
            "weight_int16_Q.bin", "bias_int16_Q.bin", "iofm_Q.bin"}
    if extra:
        want |= {"weights_reorg.bin", "weights_reorg_int16.bin"}
    assert set(got["port"]) == want


def test_weight_gen_from_darknet_without_calib(tmp_path, cfg):
    blob = str(tmp_path / "m.weights")
    tdn.write_darknet(blob, TSpec.from_cfg(cfg),
                      _params(TSpec.from_cfg(cfg), np.random.default_rng(6),
                              tdn))
    got = {}
    for name, mod in (("port", twg), ("jax", jwg)):
        out = str(tmp_path / name)
        assert mod.main(["--cfg", cfg, "--from-darknet", blob, "--out-dir",
                         out]) == 0
        got[name] = _files(out)
    assert got["port"] == got["jax"]
    assert set(got["port"]) == {"weights.bin", "bias.bin"}
    # --calib with no image fails in both
    for mod in (twg, jwg):
        assert mod.main(["--cfg", cfg, "--from-darknet", blob, "--out-dir",
                         str(tmp_path / "x"), "--calib"]) == 1


@pytest.mark.parametrize("precision", ["fp32", "int16"])
def test_weight_gen_reorg_unreorg_round_trip(tmp_path, cfg, precision):
    """The same argv through both CLIs: reorg (with --tm/--tn that leave
    ragged blocks) byte-equal, and --unreorg gives back the input file."""
    rng = np.random.default_rng(7)
    spec = TSpec.from_cfg(cfg)
    dtype = np.int16 if precision == "int16" else np.float32
    parts = []
    for l in spec.conv_layers():
        parts.append(rng.integers(-999, 999, l.nweights).astype(dtype))
        if precision == "int16" and l.nweights & 1:
            parts.append(np.zeros(1, dtype))
    src = str(tmp_path / "in.bin")
    np.concatenate(parts).tofile(src)
    got = {}
    for name, mod in (("port", twg), ("jax", jwg)):
        reorg, back = str(tmp_path / f"{name}_r.bin"), str(tmp_path / f"{name}_b.bin")
        base = ["--cfg", cfg, "--precision", precision, "--tm", "3", "--tn",
                "2"]
        assert mod.main([*base, "--weights", src, "--out", reorg]) == 0
        assert mod.main([*base, "--unreorg", "--weights", reorg, "--out",
                         back]) == 0
        got[name] = (open(reorg, "rb").read(), open(back, "rb").read())
    assert got["port"] == got["jax"]
    assert got["port"][1] == open(src, "rb").read()
    assert got["port"][0] != got["port"][1]


def test_weight_gen_in_place_guard_and_truncation(tmp_path, cfg, capsys):
    src = str(tmp_path / "w.bin")
    np.zeros(10, np.float32).tofile(src)
    for mod in (twg, jwg):
        assert mod.main(["--cfg", cfg, "--weights", src, "--out", src]) == 1
        assert "refusing to overwrite" in capsys.readouterr().err
        assert mod.main(["--cfg", cfg, "--weights", src, "--out",
                         str(tmp_path / "o.bin")]) == 1
        assert "truncated at conv layer 0" in capsys.readouterr().err
    assert np.fromfile(src, np.float32).size == 10


def test_from_darknet_takes_arrays(tmp_path, cfg):
    """from_darknet's body with calibration arrays writes what the CLI
    writes from the same images as PNG files."""
    from yolotpu_torch.image import load_image
    rng = np.random.default_rng(8)
    spec = TSpec.from_cfg(cfg)
    blob = str(tmp_path / "m.weights")
    tdn.write_darknet(blob, spec, _params(spec, rng, tdn))
    png = _png(str(tmp_path / "c.png"), rng, 32, 48)
    assert twg.main(["--cfg", cfg, "--from-darknet", blob, "--out-dir",
                     str(tmp_path / "cli"), "--calib", png]) == 0
    store = twg.from_darknet(spec, blob, str(tmp_path / "arr"),
                             [load_image(png)])
    assert _files(str(tmp_path / "cli")) == _files(str(tmp_path / "arr"))
    assert store.qtables is not None and len(store.int16) == 3
