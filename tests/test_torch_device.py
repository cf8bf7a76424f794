"""The port's device rule (pyfft_tpu_torch.config.resolve_device).

An entry point computes on its ``device=`` argument, else on its first
tensor argument's device, else on the package default, else on the card;
where there is no card that last step raises, naming ``device="cpu"``.
The port never falls back to the CPU unasked.  These tests report CUDA
absent (``torch.cuda.is_available`` patched) and run on the CPU.
"""
import numpy as np
import pytest
import torch

import pyfft_tpu_torch as pt
from pyfft_tpu_torch import config
from pyfft_tpu_torch import entry as pentry
from pyfft_tpu_torch import segmentation as pseg
from pyfft_tpu_torch.utils import profiling


@pytest.fixture
def no_card(monkeypatch):
    """CUDA reported absent, and no package default set."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = config.set_default_device(None)
    yield
    config.set_default_device(prev)


def _signals():
    rng = np.random.default_rng(0)
    t = np.arange(4096) / 1e3
    x = np.sin(2 * np.pi * 97.0 * t) + 0.1 * rng.standard_normal(t.size)
    return t, x, np.roll(x, 2)


_NW = dict(navr=15, nwins=512, noverlap=256)    # 4096 samples


def _forward(fwd, args):
    return fwd(*args)


_ENTRIES = {
    "fft_pwelch": lambda t, x, y, **kw: pt.fft_pwelch(
        t, x, y, Navr=4, plotit=False, **kw),
    "welch_filtered_cross_spectra": lambda t, x, y, **kw:
        pt.welch_filtered_cross_spectra(
            x, y, np.ones(3) / 3, np.hanning(512),
            pseg.plan_segments(x.size, nwins=512, windowoverlap=0.5), 1e3,
            **kw),
    "envelope_phase": lambda t, x, y, **kw: pt.hilbert_mod.envelope_phase(
        x, **kw),
    "filtfilt": lambda t, x, y, **kw: pt.filters.filtfilt(
        *pt.filters.butter(2, 0.1), x, **kw),
    "fir_filter": lambda t, x, y, **kw: pt.filters.fir_filter(
        x, np.ones(3) / 3, **kw),
    "oaconvolve": lambda t, x, y, **kw: pt.filters.oaconvolve(
        x, np.ones(3) / 3, **kw),
    "smooth": lambda t, x, y, **kw: pt.filters.smooth(x, 11, **kw),
    "stft_segments": lambda t, x, y, **kw: pt.stft_segments(
        x, t, np.hanning(512),
        pseg.plan_segments(x.size, nwins=512, windowoverlap=0.5), 1e3, **kw),
    "measure_pipeline_overlap": lambda t, x, y, **kw:
        profiling.measure_pipeline_overlap(nrows=512, N=8, iters=1, **kw),
    # the kernel layer's entries
    "fir_pallas": lambda t, x, y, **kw: pt.ops.fir_pallas(
        x, np.ones(3) / 3, **kw),
    "tile_rows": lambda t, x, y, **kw: pt.ops.fir.tile_rows(x, **kw),
    "fir_transpose_pallas": lambda t, x, y, **kw:
        pt.ops.fir_transpose_pallas(x, y[None], np.ones(3) / 3, 32, **kw),
    "welch_fir_pallas3": lambda t, x, y, **kw: pt.ops.welch_fir_pallas3(
        x, y[None], np.hanning(512), 257, 1.0, **_NW, **kw),
    "welch_pallas3_twosided": lambda t, x, y, **kw:
        pt.ops.welch_pallas3_twosided(x, y[None], np.hanning(512), 1.0,
                                      **_NW, **kw),
    "welch_auto_packed": lambda t, x, y, **kw: pt.ops.welch_auto_packed(
        x, np.hanning(512), 257, 1.0, **_NW, **kw),
    "welch_pair_packed": lambda t, x, y, **kw: pt.ops.welch_pair_packed(
        x, y, np.hanning(512), 257, 1.0, **_NW, **kw),
    "welch_pallas_fused": lambda t, x, y, **kw: pt.ops.welch_pallas_fused(
        x, y[None], np.hanning(512), 257, 1.0, **_NW, **kw),
    "welch_power_pallas": lambda t, x, y, **kw: pt.ops.welch_power_pallas(
        x.reshape(8, 512), y.reshape(1, 8, 512), np.hanning(512), 257,
        **kw),
    "stft_pallas3": lambda t, x, y, **kw: pt.ops.stft_pallas3(
        x, y[None], np.hanning(512), 1.0, **_NW, **kw),
    # the top-level entry points
    "entry": lambda t, x, y, **kw: _forward(*pentry.entry(**kw)),
    "dryrun_multichip": lambda t, x, y, **kw: pentry.dryrun_multichip(
        1, **kw),
}


@pytest.mark.parametrize("name", sorted(_ENTRIES))
def test_entry_without_card_raises_unless_the_cpu_is_asked_for(no_card,
                                                               name):
    """NumPy input and no device: RuntimeError naming device="cpu".  The
    same call with device="cpu", or under the package default "cpu",
    runs."""
    t, x, y = _signals()
    call = _ENTRIES[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(t, x, y)
    call(t, x, y, device="cpu")
    with config.default_device("cpu"):
        call(t, x, y)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(t, x, y)


def test_resolution_order(no_card):
    """device= first, then the first tensor's device, then the default."""
    cpu = torch.device("cpu")
    meta = torch.empty(1, device="meta")
    assert config.resolve_device("cpu", meta) == cpu
    assert config.resolve_device(None, np.zeros(1), meta) == meta.device
    with config.default_device("meta"):
        assert config.resolve_device(None, np.zeros(1)) == meta.device
        assert config.resolve_device(None, torch.zeros(1)) == cpu
        assert config.resolve_device("cpu") == cpu
    assert config.set_default_device("cpu") is None
    assert config.set_default_device(None) == cpu
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.resolve_device()


def test_cpu_tensors_run_without_a_device_argument(no_card):
    """A tensor on the CPU asks for the CPU."""
    t, x, y = _signals()
    out = pt.fft_pwelch(torch.from_numpy(t), torch.from_numpy(x),
                        torch.from_numpy(y), Navr=4, plotit=False)
    assert np.all(np.isfinite(out[2]))


def test_jax_top_level_names():
    """``windows_mod`` is the alias of the ``windows`` module and
    ``backend_supports_complex`` holds on every torch device, as the JAX
    package exports them."""
    assert pt.windows_mod is pt.windows
    assert pt.backend_supports_complex() is True
    assert pt.spectral.backend_supports_complex is pt.backend_supports_complex
    assert {"windows_mod", "backend_supports_complex"} <= set(pt.__all__)
