"""The tensor-core form of the port's fused conv+pool kernel
(yolotpu_torch.ops.q16.conv3x3_pool_q16), held on the CPU at small sizes.

The kernel is conv3x3_q16's implicit GEMM on the 8-bit tensor cores with the
output pixels visited window-major and the 2x2/s2 pool in the epilogue. Its
arithmetic is rebuilt here from the port's own pieces: the im2col rows in
``q16.window_major`` order, the Q16 scheme's sums from the packed planes
(``tc.emulate`` with ``q16.pack_q16``), rows 4i .. 4i+3 pooled and
requantized in each order (``q16.pool_windows``). That must equal the plain
version, bit for bit, and the TPU forms of K8-K12 on the same seeded numpy
inputs (the Pallas kernels in interpret mode, the XLA kinds as they are), at
C=3 and C%8==0, where the sums wrap at shift 31 and the three orders differ,
and with K beyond one s32 partial sum. The kernel itself runs only on the
card, where chip_smoke.py holds it to the plain version.
"""

import numpy as np
import pytest
import torch

from test_torch_pool_fused import FORMS, _operands, _unsaturated
from yolotpu_torch.models import engine_plan, zoo
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.ops import _build, q16, tc
from yolotpu_torch.runtime.engine import load_or_synthesize


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _emulated(x, w, bias, shift, leaky, order):
    """conv3x3_pool_q16 as the kernel computes it: window-major im2col rows,
    the Q16 sums from the packed planes, four rows pooled into one."""
    b, h, wd, c = x.shape
    n = w.shape[-1]
    rows = q16.im2col3x3(_t(x))[q16.window_major(b, h, wd)]
    sums = tc.emulate(rows, q16.pack_q16(_t(w)), 9 * c, n, tc.Q16)
    # rows (b, ho, wo, dy, dx) -> the window's members on axes 2 and 4
    win = sums.reshape(b, h // 2, wd // 2, 2, 2, n).permute(0, 1, 3, 2, 4, 5)
    return q16.pool_windows(win, _t(bias), shift, leaky, order).numpy()


def _plain(x, w, bias, shift, leaky, order):
    return q16.conv3x3_pool_q16_plain(_t(x), _t(w), _t(bias), shift, leaky,
                                      order).numpy()


@pytest.mark.parametrize("b,h,wd", [(1, 2, 2), (2, 4, 6), (3, 8, 2), (1, 6, 10)])
def test_window_major_rows_are_the_plain_versions_windows(b, h, wd):
    """Row 4i + 2 dy + dx of the kernel's GEMM is member (dy, dx) of pool
    window i, the windows in the (b, ho, wo) order of the pooled output."""
    pix = q16.window_major(b, h, wd)
    assert sorted(pix.tolist()) == list(range(b * h * wd))
    ident = torch.arange(b * h * wd).reshape(b, h, wd)
    # the plain version's axes: (b, ho, dy, wo, dx)
    want = ident.reshape(b, h // 2, 2, wd // 2, 2).permute(0, 1, 3, 2, 4)
    assert torch.equal(pix.reshape(b, h // 2, wd // 2, 2, 2), want)
    # as the loader computes a row's pixel: window m >> 2, member m & 3
    for m in (0, 1, 2, 3, b * h * wd - 1, (b * h * wd) // 2 + 1):
        win, q = m >> 2, m & 3
        img, r = divmod(win, h * wd // 4)
        ho, wo = divmod(r, wd // 2)
        assert pix[m] == (img * h + 2 * ho + (q >> 1)) * wd + 2 * wo + (q & 1)


@pytest.mark.parametrize("name,shift,leaky,wmax", [
    ("entry_sdmm", 9, True, 30000), ("entry_sd", 7, True, 32767),
    ("entry_s2d", 5, False, 30000), ("sd_pool", 7, True, 32767),
    ("entryf", 5, False, 32767), ("entry8", 7, True, 32639),
    ("conv3p2", 9, True, 32767), ("conv3p2f", 40, False, 32767),
    ("conv_then_pool", 1, False, 32767),
])
def test_emulated_kernel_equals_plain_and_tpu_form(name, shift, leaky, wmax):
    form, order, shape = FORMS[name]
    x, w, bias = _operands(np.random.default_rng(70), shape, shift, wmax)
    got = _emulated(x, w, bias, shift, leaky, order)
    np.testing.assert_array_equal(got, _plain(x, w, bias, shift, leaky, order))
    np.testing.assert_array_equal(got, np.asarray(form(x, w, bias, shift, leaky)))
    assert _unsaturated(got, leaky).mean() > 0.5


@pytest.mark.parametrize("name", sorted(FORMS))
def test_emulated_orders_differ_where_the_sum_wraps(name):
    """Full-range operands at shift 31: acc + 2^29 wraps, the emulated kernel
    equals the plain version in each order, the three differ, and the TPU
    form's result is its own order's."""
    form, order, shape = FORMS[name]
    leaky = name.startswith("entry")
    x, w, bias = _operands(np.random.default_rng(71), shape, 31, 32767,
                           full=True)
    got = {o: _emulated(x, w, bias, 31, leaky, o) for o in q16.POOL_ORDERS}
    for o in q16.POOL_ORDERS:
        np.testing.assert_array_equal(got[o], _plain(x, w, bias, 31, leaky, o))
    np.testing.assert_array_equal(got[order],
                                  np.asarray(form(x, w, bias, 31, leaky)))
    for a, b in ((0, 1), (0, 2), (1, 2)):
        oa, ob = q16.POOL_ORDERS[a], q16.POOL_ORDERS[b]
        assert (got[oa] != got[ob]).any(), (oa, ob)


@pytest.mark.parametrize("order", q16.POOL_ORDERS)
@pytest.mark.parametrize("value", [-32513, None])
def test_emulated_kernel_beyond_one_split_of_k(order, value):
    """C = 3700 (K = 33,300 > tc.KMAX): at -32513 (high byte -128, low byte
    255) an unchunked middle sum leaves s32; emulate raises if a set does."""
    rng = np.random.default_rng(72)
    c, n = 3700, 8
    assert 9 * c > tc.KMAX
    if value is None:
        x = rng.integers(-32768, 32768, (1, 2, 4, c)).astype(np.int16)
        w = rng.integers(-32768, 32768, (3, 3, c, n)).astype(np.int16)
    else:
        x = np.full((1, 2, 4, c), value, np.int16)
        w = np.full((3, 3, c, n), value, np.int16)
    bias = rng.integers(-2**14, 2**14, n).astype(np.int32)
    got = _emulated(x, w, bias, 18, True, order)
    np.testing.assert_array_equal(got, _plain(x, w, bias, 18, True, order))
    assert _unsaturated(got, True).mean() > 0.5


def _small_case():
    rng = np.random.default_rng(73)
    x = _t(rng.integers(-99, 99, (2, 4, 6, 8)).astype(np.int16))
    w = _t(rng.integers(-99, 99, (3, 3, 8, 5)).astype(np.int16))
    return x, w, torch.zeros(5, dtype=torch.int32)


@pytest.mark.parametrize("order", q16.POOL_ORDERS)
def test_planes_required_off_the_cpu(order, monkeypatch):
    """The wrapper's card branch, reached here with tensors on the meta
    device and the launch recorded instead of made: without planes= it
    raises naming pack_q16, with planes of another weight it raises, and
    with pack_q16(w) it hands the C entry point its arguments in the order
    of _build.SIGNATURES (x, planes, bias, out, workspace, B, H, W, C, N,
    shift, leaky, order, K steps per split; the stream is added by
    _build.launch)."""
    x, w, b = (t.to("meta") for t in _small_case())
    calls = []
    monkeypatch.setattr(q16, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(tc, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, out, *args, counts: calls.append(
                            (name, fn, out, args)) or out)
    with pytest.raises(TypeError, match="planes=pack_q16"):
        q16.conv3x3_pool_q16(x, w, b, 3, True, order)
    wrong = q16.pack_q16(torch.zeros((3, 3, 16, 5), dtype=torch.int16,
                                     device="meta"))
    with pytest.raises(ValueError, match="planes"):
        q16.conv3x3_pool_q16(x, w, b, 3, True, order, planes=wrong)
    assert not calls
    out = q16.conv3x3_pool_q16(x, w, b, 3, True, order,
                               planes=q16.pack_q16(w))
    assert out.shape == (2, 2, 3, 5) and out.dtype == torch.int16
    (name, fn, _, args), = calls
    assert (name, fn) == ("conv3x3_pool_q16", "yq16_conv3x3_pool")
    assert len(args) == len(_build.SIGNATURES[fn]) - 1   # all but the stream
    # K = 72 is two K steps and M = 48 rows one tile: left unsplit, no
    # workspace
    assert args[4] is None
    assert args[5:] == (2, 4, 6, 8, 5, 3, 1, q16.POOL_ORDERS.index(order), 2)


def test_planes_ignored_on_the_cpu_and_by_the_plain_version():
    x, w, b = _small_case()
    junk = torch.full((3,), 7, dtype=torch.uint8)
    for order in q16.POOL_ORDERS:
        want = q16.conv3x3_pool_q16_plain(x, w, b, 3, True, order)
        assert torch.equal(q16.conv3x3_pool_q16_plain(x, w, b, 3, True, order,
                                                      planes=junk), want)
        assert torch.equal(q16.conv3x3_pool_q16(x, w, b, 3, True, order,
                                                planes=junk), want)
    assert q16.LAUNCHES["conv3x3_pool_q16"] == 0


def test_model_packs_the_fused_convs_weights():
    """YoloV2Q packs, off the CPU, the weights of every int16 conv, the ones
    fused with their pool included, with pack_q16 (buffers p{idx} of the
    planes' shape), and none on the CPU, where the fused convs still run
    (their plain version)."""
    assert ty.YoloV2Q.packers["int16"] == dict.fromkeys(
        ("mm", "conv3", "conv3_pool", "conv"), q16.pack_q16)
    spec = zoo.build("yolov2", width=64, height=64)
    store = load_or_synthesize(spec, None, "int16", synthetic=True, seed=0)
    overrides = engine_plan._parse_plan_items(
        "0:entry_sdmm,2:conv3p2,6:sd_pool")
    params = ty.params_int16(spec, store)
    on_cpu = ty.YoloV2Q(spec, store.qtables, params, "cpu", "int16", overrides)
    off_cpu = ty.YoloV2Q(spec, store.qtables, params, "meta", "int16", overrides)
    assert {i: off_cpu.route[i] for i in (0, 2, 6)} == {
        0: ("conv3_pool", "acc"), 2: ("conv3_pool", "out"),
        6: ("conv3_pool", "acc")}
    for l in spec.conv_layers():
        assert not hasattr(on_cpu, f"p{l.idx}")
        planes = getattr(off_cpu, f"p{l.idx}")
        assert planes.dtype == torch.uint8 and tuple(planes.shape) == \
            tc.Q16.planes_shape(l.c * l.size * l.size, l.n)
    frames = np.random.default_rng(74).integers(0, 256, (1, 64, 64, 3),
                                                dtype=np.uint8)
    default = ty.YoloV2Q(spec, store.qtables, params, "cpu", "int16")
    assert torch.equal(on_cpu(_t(frames))["head"], default(_t(frames))["head"])


# (M, N, K, splits): the five yolov2 416 convs a 2x2/s2 pool follows, at
# batch 1 and 8; tc.split is asked with the conv's rows, not the pooled ones
@pytest.mark.parametrize("m,n,k,want", [
    (416 * 416, 32, 27, 1), (8 * 416 * 416, 32, 27, 1),
    (208 * 208, 64, 288, 1), (8 * 208 * 208, 64, 288, 1),
    (104 * 104, 128, 576, 1), (8 * 104 * 104, 128, 576, 1),
    (52 * 52, 256, 1152, 1), (8 * 52 * 52, 256, 1152, 1),
    (26 * 26, 512, 2304, 4), (8 * 26 * 26, 512, 2304, 1),
])
def test_split_at_the_pooled_convs(m, n, k, want):
    kps = tc.split(m, n, k, 132, tc.Q16)
    ktiles = -(-k // tc.Q16.bk)
    assert -(-ktiles // kps) == want
    assert m % 4 == 0 and tc.BM % 4 == 0   # a tile holds whole windows
