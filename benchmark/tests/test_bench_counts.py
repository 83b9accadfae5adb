"""The yardstick's counts against shapes worked by hand, and the trace
readers on a synthetic event list."""

import math

import pytest
from mribench import devtrace
from mribench.flops import bound_ms, kernel_bounds
from mribench.models import cirim, varnet
from mribench.spec import metric_reader

KNEE = {"coils": 15, "height": 320, "width": 320}
CIRIM = {"conv_filters": [64, 64, 2], "conv_kernels": [5, 3, 3], "conv_dilations": [1, 2, 1],
         "recurrent_filters": [64, 64, 0], "num_cascades": 5, "time_steps": 8}
VN = {"num_cascades": 8, "channels": 18, "pooling_layers": 4, "padding_size": 11}
FFT = 5 * 102400 * math.log2(102400)


def test_cirim_flops_by_hand():
    # a step: 4->64 5x5, 64->64 1x1, 64->64 3x3, 64->64 1x1, 64->2 3x3 at 320 x 320
    step = 102400 * (4 * 64 * 25 + 64 * 64 + 64 * 64 * 9 + 64 * 64 + 64 * 2 * 9)
    assert step == 5_387_059_200
    psf1d = 40 * 15 * 8 * 320 * 320 * 320 + 5 * 15 * FFT + 15 * FFT
    full = 40 * 2 * 15 * FFT + 15 * FFT
    assert cirim.forward_flops(KNEE, {**CIRIM, "dc_mode": "psf1d"}) == pytest.approx(2 * step * 40 + psf1d)
    assert cirim.forward_flops(KNEE, {**CIRIM, "dc_mode": "full"}) == pytest.approx(2 * step * 40 + full)


def test_varnet_flops_by_hand():
    px = [102400, 25600, 6400, 1600, 400]  # 320^2 ... 20^2: no padding at 320 with padding_size 11
    down = [(2, 18), (18, 36), (36, 72), (72, 144)]
    macs = sum(p * 9 * (ci * co + co * co) for p, (ci, co) in zip(px, down))
    macs += px[4] * 9 * (144 * 288 + 288 * 288)
    for j, (ci, co) in enumerate([(288, 144), (144, 72), (72, 36), (36, 18)]):
        p = px[3 - j]
        macs += p * ci * co  # the 2x2 stride-2 transpose: in * out a pixel out
        macs += p * 9 * (ci * co + co * co)
    macs += 102400 * 18 * 2
    dc = 7 * 15 * 8 * 320 ** 3 + 15 * FFT
    assert varnet.forward_flops(KNEE, {**VN, "dc_mode": "psf1d"}) == pytest.approx(2 * macs * 8 + dc)


def test_kernel_bounds_match_the_kernel_table():
    """The bounds of PERF.md's kernel table (B=8, 15 coils, 320 x 320, 64 filters)."""
    b = kernel_bounds(8, 15, 320, 320, "bfloat16", 64, [(4, 2), (64, 2), (64, 1)])
    assert b["k1_fwd"] == pytest.approx(0.0239, abs=5e-5)  # operations: 6 B C H W^2 on bf16 tensor cores
    assert b["k3_fwd"] == pytest.approx(0.0939, abs=5e-5)
    assert b["k2_expand"] == pytest.approx(0.0606, abs=5e-5)
    assert b["k4_bias_act"] == pytest.approx(0.0626, abs=5e-5)
    f = kernel_bounds(8, 15, 320, 320, "float32", 64)
    assert f["k1_fwd"] == pytest.approx(0.1430, abs=5e-5)  # 3xTF32 at 165 TFLOP/s
    assert bound_ms(3.35e9, {}) == pytest.approx(1.0)


def _ctx():
    dev = [("Memcpy HtoD (Pageable -> Device)", 0, 100), ("void cudnn::conv_kernel", 150, 350),
           ("void (anonymous namespace)::tc::psf1d_dc_bf16_kernel<false>(...)", 350, 400),
           ("void at::native::vectorized_elementwise_kernel", 500, 550),
           ("Memcpy DtoH (Device -> Pageable)", 900, 950)]
    host = [("bench.profiled_calls", 0, 1000), ("bench.predict_batch", 0, 960), ("aten::to", 100, 150),
            ("aten::copy_", 600, 900)]
    return {"device": dev, "host": host, "window": (0.0, 1000.0), "window_span": "bench.profiled_calls",
            "call_spans": ("bench.predict_batch",), "slices": 2, "bounds": {"k1_fwd": 0.025},
            "flops_per_slice": 1e9, "peak_flops": 1e12, "slices_per_s": 100.0}


def test_trace_readers():
    ctx = _ctx()
    assert devtrace.layer_of("Memcpy HtoD (Pageable -> Device)") == "memcpy HtoD"
    assert devtrace.entry_of(ctx["device"][2][0]) == "k1_fwd"
    assert devtrace.entry_of("void at::native::(anonymous namespace)::reduce_kernel") is None
    assert metric_reader("io_copy_ms.serve")(ctx) == pytest.approx(0.15 / 2)
    assert metric_reader("conv_ms.serve")(ctx) == pytest.approx(0.2 / 2)
    assert metric_reader("elementwise_ms.serve")(ctx) == pytest.approx(0.05 / 2)
    assert metric_reader("dc_ms.serve")(ctx) == pytest.approx(0.05 / 2)
    assert metric_reader("k1_roofline.serve")(ctx) == pytest.approx(50.0)
    assert metric_reader("idle_share.serve")(ctx) == pytest.approx(100 * (1 - 450 / 1000))
    assert metric_reader("mfu.serve")(ctx) == pytest.approx(10.0)
    assert devtrace.busy_s(ctx) == pytest.approx(450e-6)


def test_readers_find_nothing():
    ctx = {**_ctx(), "device": [("void cudnn::conv_kernel", 150, 350)]}
    assert metric_reader("k1_roofline.serve")(ctx) is None
    assert metric_reader("io_copy_ms.train")(ctx) is None


def test_breakdown_names_gaps_by_host_work():
    bd = devtrace.breakdown(_ctx())
    gaps = dict(bd["idle_gaps"])
    assert gaps["bench.predict_batch > aten::copy_"] == pytest.approx(350e-6)
    assert gaps["bench.predict_batch > aten::to"] == pytest.approx(50e-6)
    assert gaps["outside the calls"] == pytest.approx(50e-6)
    assert gaps["bench.predict_batch"] == pytest.approx(100e-6)
    assert bd["device_ops"][0][0] == "void cudnn::conv_kernel" and len(bd["device_ops"]) <= 10
