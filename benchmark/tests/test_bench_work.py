"""The frozen roofline arithmetic at small shapes, worked by hand."""
import math

import pytest

from benchmark import work

H100 = "NVIDIA H100 80GB HBM3"


def test_fft_flops():
    assert work.fft_flops(8) == 5 * 8 * 3
    assert work.fft_flops(8, batch=3, real=True) == 3 * 5 * 8 * 3 / 2
    assert work.fft_flops(1) == 5.0


def test_welch_flops():
    # a segment of 16: window 16, real FFT 5*16*4/2 = 160, powers 4*9 = 36
    assert work.welch_flops(navr=3, nwins=16, nch=2) == 3 * (16 + 160 + 36) * 3


def test_fir_flops_and_the_fewer_of_the_two_forms():
    assert work.fir_flops(100, 5, 2, "direct") == 2 * 100 * 5 * 2
    # 5 taps: nfft 32, hop 28, 4 blocks of 2 * 5*32*5 + 6*32
    os_ = 4 * (2 * 800 + 192) * 2
    assert work.fir_flops(100, 5, 2) == os_
    assert work.fir_least_flops(100, 5, 2) == min(os_, 2000)
    # config 0: overlap-save is the fewer at 129 taps
    nt = 1 << 25
    assert work.fir_least_flops(nt, 129, 9) == work.fir_flops(nt, 129, 9)


def test_least_time_names_its_bound():
    ms, bound = work.least_ms(67e9, 1.0, H100)
    assert bound == "operations" and math.isclose(ms, 1.0)
    ms, bound = work.least_ms(1.0, 3.35e9, H100)
    assert bound == "bytes" and math.isclose(ms, 1.0)


def test_config_zero_least_time():
    from benchmark import harness
    import json
    cfg = json.loads((harness.ROOT / "benchmark/configs/welch_fir_8ch.json")
                     .read_text())
    flops, nbytes = harness.load_module(
        "configs", "welch_fir_8ch").work_counts(cfg)["welch_core"]
    ms, bound = work.least_ms(flops, nbytes, H100)
    assert bound == "operations" and 0.80 < ms < 0.84


def test_no_peaks_for_an_unknown_card():
    with pytest.raises(ValueError):
        work.peaks("cpu")


def test_a_pool_placed_on_the_host_holds_the_same_records_as_numpy():
    import json
    import numpy as np
    from benchmark import harness, traffic
    from conftest import small
    cfg = small(json.loads((harness.ROOT / "benchmark/configs/"
                            "welch_fir_8ch.json").read_text()))
    inputs = harness.load_module("configs", "welch_fir_8ch")
    mix = traffic.load("resident")
    dev = traffic.make_pool(mix, cfg, inputs, 2**31 + 5, "cpu")
    host = traffic.make_pool(dict(mix, placement="host"), cfg, inputs,
                             2**31 + 5, "cpu")
    assert len(host) == mix["pool"]
    for d, h in zip(dev, host):
        assert set(d) == set(h)
        for k in d:
            assert isinstance(h[k], np.ndarray)
            assert np.array_equal(h[k], d[k].numpy())
