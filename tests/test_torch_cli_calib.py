"""The port's detect CLI flag contract and class-name loading, and the
activation calibrator's route-scale grouping, against the JAX package, on
the CPU."""

import numpy as np
import pytest

from yolotpu import names as jnames
from yolotpu import quant as jquant
from yolotpu import weights as jweights
from yolotpu.cli import detect as jdetect
from yolotpu.models import zoo as jzoo
from yolotpu_torch import names, quant, weights
from yolotpu_torch.cli import detect
from yolotpu_torch.golden import GoldenNet
from yolotpu_torch.graph import ConvSpec, ReorgSpec, RouteSpec
from yolotpu_torch.models import zoo
from yolotpu_torch.models.yolov2 import Int16Plan

# where the port's parser differs from the JAX CLI's, by design: its own
# --device
DIFFERENT = {"device"}

ARGVS = [
    ["--names", "f.names", "--hier", "0.4", "-v", "2", "img.png"],
    ["--input", "a.jpg", "--output", "out/p", "--thresh", "0.3", "--nms",
     "0.5", "--verbose", "0"],
    ["--cfg", "net.cfg", "--names", "voc.names", "--weights-dir", "w",
     "--precision", "int8", "b.png"],
    ["--model", "yolov2-tiny", "--synthetic-weights", "--seed", "3",
     "--net-size", "96", "--precision", "w8a16", "--hier", "0.9", "c.png"],
    ["d.png"],
    ["--topk", "64", "--precision", "fp32", "--thresh", "0.1", "e.png"],
    ["--dump-layers", "dumps", "--precision", "int16", "f.png"],
    ["--backend", "cpu", "--precision", "int8", "g.png"],
    ["--compute", "exact", "--backend", "hls", "--precision", "int16", "h.png"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_detect_argv_parses_as_in_the_jax_cli(argv):
    """An argv the JAX CLI parses, the port's parses too, to the same values
    at every destination the two share (all of the port's but --device),
    the defaults of --precision (fp32) and --topk (256) included."""
    want = vars(jdetect.build_argparser().parse_args(argv))
    got = vars(detect.build_argparser().parse_args(argv))
    assert set(got) - set(want) == {"device"}
    shared = set(got) & set(want) - DIFFERENT
    assert {"names", "hier", "verbose", "cfg", "model", "input", "output",
            "thresh", "nms", "weights_dir", "synthetic_weights", "seed",
            "net_size", "positional", "precision", "topk", "dump_layers",
            "backend", "compute"} == shared
    for dest in shared:
        assert got[dest] == want[dest], dest
    if "--precision" not in argv:
        assert got["precision"] == "fp32"
    assert got["topk"] == (64 if "--topk" in argv else 256)
    assert got["device"] == "cuda"


def test_load_names_equal(tmp_path):
    path = tmp_path / "three.names"
    path.write_text("cat\ntraffic light\n\nlast one")
    assert names.load_names(str(path)) == jnames.load_names(str(path)) == [
        "cat", "traffic light", "", "last one"]


CFG3 = """[net]
batch=1
width=32
height=32
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
size=1
stride=1
pad=1
filters=16
activation=linear

[region]
anchors=1.0,1.0,3.0,3.0
bias_match=1
classes=3
coords=4
num=2
softmax=1
thresh=.6
"""


def test_cli_names_reach_the_labels(tmp_path, monkeypatch, capsys):
    """A 3-class cfg has no built-in name table: without --names the labels
    are class numbers, with it the file's names."""
    from pathlib import Path
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    cfg = tmp_path / "three.cfg"
    cfg.write_text(CFG3)
    names_file = tmp_path / "three.names"
    names_file.write_text("ant\nbee\nwasp\n")
    img = Path(__file__).resolve().parent.parent / "examples" / "small.png"
    argv = ["--cfg", str(cfg), "--device", "cpu", "--synthetic-weights",
            "--thresh", "0.01", "--hier", "0.4", "-v", "0", "--output",
            str(tmp_path / "pred"), str(img)]

    def labels(extra):
        assert detect.main(extra + argv) == 0
        out = capsys.readouterr().out
        return [ln.split(":")[0] for ln in out.splitlines()
                if ln.endswith("%")]

    plain = labels([])
    named = labels(["--names", str(names_file)])
    assert plain and set(plain) <= {"0", "1", "2"}
    assert named == [["ant", "bee", "wasp"][int(i)] for i in plain]
    assert (tmp_path / "pred.png").exists()


def _stores(size, scale):
    """yolov2 at size x size with the same synthetic weights in the port's
    store and the JAX package's; ``scale`` {conv idx: factor} multiplies a
    conv's fp32 weights and bias in both, which moves its natural Q."""
    spec = zoo.build("yolov2", width=size, height=size)
    jspec = jzoo.build("yolov2", width=size, height=size)
    store = weights.WeightStore.synthetic(spec, seed=0)
    jstore = jweights.WeightStore.synthetic(jspec, seed=0)
    for idx, f in scale.items():
        for s in (store, jstore):
            w, b = s.fp32[idx]
            s.fp32[idx] = (w * np.float32(f), b * np.float32(f))
    return spec, jspec, store, jstore


@pytest.mark.parametrize("scale", [{}, {26: 16.0}, {24: 32.0}, {16: 64.0}],
                         ids=["synthetic", "conv26 x16", "conv24 x32",
                              "conv16 x64"])
def test_calibrator_groups_the_route_scales(scale):
    """calibrate_activations gives each scale group one Q. In yolov2 the
    group is conv 16 (whose output the passthrough route reads), conv 24
    (whose stored scale the linear Q walk aliases to conv 26's input, conv
    16's output) and conv 26 (concatenated with conv 24, through the reorg,
    at the two-input route): their Q is the least of their natural Qs, the
    reorg realign shift is 0, every other conv keeps its natural Q, and the
    table is the JAX package's."""
    spec, jspec, store, jstore = _stores(64, scale)
    img = np.random.default_rng(7).random((3, 64, 64), dtype=np.float32)
    table = quant.calibrate_activations(spec, store, [img])
    assert table == jquant.calibrate_activations(jspec, jstore, [img])

    convs = spec.conv_layers()
    order = {l.idx: i for i, l in enumerate(convs)}
    assert len(table) == len(convs) + 1
    stored = {l.idx: table[order[l.idx] + 1] for l in convs}   # output Qs
    acts = GoldenNet(spec).forward_fp32(img, store.fp32, keep_all=True)
    natural = {l.idx: quant.q_for_absmax(float(np.abs(acts[l.idx]).max()), 2.0)
               for l in convs}

    routes = [l for l in spec.layers
              if isinstance(l, RouteSpec) and len(l.layers) > 1]
    reorgs = [l for l in spec.layers if isinstance(l, ReorgSpec)]
    assert [tuple(r.layers) for r in routes] == [(27, 24)]
    assert [r.idx for r in reorgs] == [27]
    assert isinstance(spec.layers[26], ConvSpec)
    group = (16, 24, 26)
    assert len({stored[i] for i in group}) == 1
    assert stored[24] == min(natural[i] for i in group)
    # the members' natural Qs differ, so the grouping decides the table
    assert len({natural[i] for i in group}) > 1
    for l in convs:
        if l.idx not in group:
            assert stored[l.idx] == natural[l.idx], l.idx
    # conv 26 reads conv 16's output through the route, at the table's entry
    # for conv 24's output
    assert order[26] == order[24] + 1 and table[order[26]] == stored[16]

    quant.quantize_weights(store, table)
    plan = Int16Plan.build(spec, store.qtables)
    assert plan.reorg_realign.get(27, 0) == 0


# the training CLI: the port adds --device (cuda by default)
TRAIN_ARGVS = [
    [],
    ["--synthetic-data", "--steps", "20", "--batch", "2", "--lr", "5e-4",
     "--momentum", "0.8"],
    ["--cfg", "net.cfg", "--train-list", "train.txt", "--ckpt-dir", "ck",
     "--ckpt-every", "5", "--resume", "--export-weights", "out"],
    ["--model", "yolov2-tiny", "--width", "96", "--height", "128", "--seed",
     "3", "--mesh"],
]


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("argv", TRAIN_ARGVS,
                         ids=[" ".join(a) or "defaults" for a in TRAIN_ARGVS])
def test_train_argv_parses_as_in_the_jax_cli(argv, monkeypatch):
    """An argv the JAX training CLI parses, the port's parses to the same
    values at every destination, defaults included; the port's --device
    defaults to cuda."""
    import argparse

    from yolotpu.cli import train as jtrain_cli
    from yolotpu_torch.cli import train as train_cli
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as parsed:
            jtrain_cli.main(argv)
    want = vars(parsed.value.args[0])
    got = vars(train_cli.parser().parse_args(argv))
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got) and len(want) == 16
    for dest in want:
        assert got[dest] == want[dest], dest
    assert got["device"] == "cuda"
