"""pyfft_tpu_torch — the PyTorch / CUDA port of ``pyfft_tpu``.

A second package beside the JAX one, under the same public names and
return contracts.  It imports ``torch`` (with numpy, and scipy where the JAX
package uses it) and never ``jax`` or ``pyfft_tpu``.  The first slice is
the headline chain: causal FIR -> global-mean detrend -> Hann segments ->
DFT -> averaged auto-/cross-powers -> ``fft_pwelch``'s coherence, phase and
``fftinfosc``.  The second is the STFT path: the ``fftanal`` class,
``stft_segments``, ``spectrogram`` and the ``integrate`` toolbox.  The
third is the Hilbert demodulation path (``hilbert``, ``envelope_phase``)
and the analysis tier around it: the rest of ``filters``, ``notch``,
``deriv``, ``laplace``, ``ccf``, ``doppler``, ``pca``, ``dft``,
``crosscheck`` and the ``fft_analysis`` facade.  The fourth is the
heat-pulse transport analysis (``heatpulse``, ``HeatPulseFFT``) with Welch
at any segment length, and ``utils.profiling`` with its two probes.  The
fifth ports the last TPU kernels: the packed Welch of one signal or one
pair (``ops.welch_auto_packed``, ``ops.welch_pair_packed`` and the
``PYFFT_PACKED=1`` route), the FIR-transpose feeder
(``ops.fir_transpose_pallas``), and the v2 geometries on kernel B.

Map from the JAX package:

=================================  ======================================
``pyfft_tpu``                      ``pyfft_tpu_torch``
=================================  ======================================
``utils/structure.py``             ``utils/structure.py`` (no pytree)
``utils/detrend.py``               ``utils/detrend.py`` (tensors)
``utils/interp.py``                ``utils/interp.py`` (NumPy)
``windows.py``                     ``windows.py`` (copy)
``plotting.py``                    ``plotting.py`` (copy)
``segmentation.py``                ``segmentation.py`` (framing in torch)
``ops/pallas_fir.py``              ``ops/fir.py`` + ``csrc/fir.cu``
``ops/pallas_welch3.py`` and the   ``ops/welch.py`` +
v2 kernel and entries of           ``csrc/welch_pair.cu`` (kernel B, real
``ops/pallas_welch.py``            signals) + ``csrc/welch.cu`` (complex)
``ops/pallas_welch3.py`` (packed   ``ops/welch_packed.py`` +
entries)                           ``csrc/welch_pair.cu`` (kernel H)
``ops/pallas_fir.py`` (FIR-        ``ops/fir.py`` + ``csrc/fir.cu``
transpose feeder)
``ops/pallas_welch3.py`` (STFT     ``ops/stft.py`` + ``csrc/stft.cu``
entries)
``hilbert.py`` (slab kernel)       ``ops/hilbert.py`` + ``csrc/hilbert.cu``
``ops/pallas_welch.py`` (v1:       ``ops/welch_v1.py`` +
``welch_pallas_fused``,            ``csrc/welch_dft.cu``
``welch_power_pallas``)
``utils/profiling.py`` (probes)    ``ops/probe.py`` + ``csrc/probe.cu``
(the FFT of B, C, D, E, H)         ``csrc/fft_reg.cuh``
(the partial sums of B, F-H)       ``csrc/reduce.cuh``
``ops/transform.py``               ``ops/transform.py`` (``torch.fft``)
(kernel build and load)            ``ops/_build.py``
``filters.py``                     ``filters.py`` (blocked IIR)
``spectral.py``                    ``spectral.py``
``parallel/`` (the Welch half:     ``parallel/`` (``torch.distributed``,
mesh, welch, fir, stft, runtime)   ``DeviceMesh``; the FFT half to come)
``fftanal.py``                     ``fftanal.py``
``spectrogram.py``                 ``spectrogram.py``
``integrate.py``                   ``integrate.py`` (host NumPy)
``hilbert.py``                     ``hilbert.py`` (no mesh: the FFT half)
``notch.py``, ``deriv.py``,        the same names
``laplace.py``, ``ccf.py``,
``doppler.py``, ``pca.py``,
``crosscheck.py``
``dft.py``                         ``dft.py`` (copy)
``fft_analysis.py``                ``fft_analysis.py`` (facade)
``examples.py``                    ``examples.py``
``heatpulse.py``                   ``heatpulse.py``
``utils/profiling.py``             ``utils/profiling.py`` (H100 peaks)
``utils/workunits.py``             ``utils/workunits.py`` (copy)
``config.py``                      ``config.py`` (+ ``from_reference``)
=================================  ======================================

CUDA tensors go through the hand-written kernels in ``csrc/`` (built with
``nvcc`` at first use); CPU tensors take each kernel's plain PyTorch
version.  The entry points compute on their ``device=`` argument, else on
their tensors' device, else on the package default
(``config.set_default_device``), else on the card, and raise where there
is none: the CPU runs only when asked for.  The rest of the JAX package
waits for later slices (ROADMAP.md).
"""

__version__ = "0.1.0"

from . import utils
# `windows` is a callable module, as in the JAX package, and `windows_mod`
# its alias there
from . import windows
from . import windows as windows_mod
from .windows import get_window
from . import segmentation
from . import ops
from . import filters
from .filters import upsample
from .spectral import (
    fft_pwelch,
    fftinfosc,
    Cxy_Cxy2,
    welch_cross_spectra,
    welch_filtered_cross_spectra,
    csd_oracle,
    resolve_fft_backend,
    backend_supports_complex,
)
from .fftanal import fftanal, stft_segments
from . import spectrogram
from .spectrogram import stft, specgram
from . import hilbert as hilbert_mod
from .hilbert import hilbert, hilbert_1d
from . import laplace as laplace_mod
from .laplace import laplace, laplace_1d
from .filters import (
    butter_lowpass_filter,
    butter_bandpass,
    downsample,
    downsample_efficient,
)
from . import notch
from .notch import iirnotch, iirpeak
from .deriv import fft_deriv
from . import fft_analysis as fft
from . import integrate
from .integrate import (
    integratespectra,
    getNpeaks,
    varcoh,
    varphi,
    monticoh,
    montiphi,
    mean_angle,
    unwrap_tol,
)
from . import ccf as ccf_mod
from .ccf import ccf, ccf_sh, align_signals
from . import doppler
from .doppler import cog, cogspec
from . import pca
from .pca import PCA, basic_pca
from . import heatpulse
from .heatpulse import HeatPulseFFT
from . import streaming
from .streaming import StreamingWelch
from . import io
from .io import ShotLoader
from . import multitaper
from .multitaper import multitaper_psd, multitaper_csd
from . import wavelet
# the reference's optional pycwt slot (reference __init__.py:38-42)
pycwt = wavelet
from . import config
from .config import SpectralConfig, welch_psd
from . import dft as dft_mod
from . import crosscheck
from .crosscheck import coh, coh2, psd, csd, fft_pmlab
from .utils.detrend import (
    detrend_none,
    detrend_mean,
    detrend_linear,
)

__all__ = [
    "windows",
    "windows_mod",
    "get_window",
    "fftanal",
    "stft_segments",
    "ops",
    "spectrogram",
    "stft",
    "specgram",
    "hilbert",
    "hilbert_1d",
    "laplace",
    "laplace_1d",
    "filters",
    "notch",
    "iirnotch",
    "iirpeak",
    "fft_deriv",
    "butter_lowpass_filter",
    "butter_bandpass",
    "upsample",
    "downsample",
    "downsample_efficient",
    "fft",
    "integrate",
    "integratespectra",
    "getNpeaks",
    "varcoh",
    "varphi",
    "monticoh",
    "montiphi",
    "mean_angle",
    "unwrap_tol",
    "ccf",
    "ccf_sh",
    "align_signals",
    "doppler",
    "cog",
    "cogspec",
    "pca",
    "PCA",
    "basic_pca",
    "heatpulse",
    "HeatPulseFFT",
    "streaming",
    "StreamingWelch",
    "io",
    "ShotLoader",
    "multitaper",
    "multitaper_psd",
    "multitaper_csd",
    "wavelet",
    "pycwt",
    "config",
    "SpectralConfig",
    "welch_psd",
    "crosscheck",
    "coh",
    "coh2",
    "psd",
    "csd",
    "fft_pmlab",
    "fft_pwelch",
    "fftinfosc",
    "Cxy_Cxy2",
    "welch_cross_spectra",
    "welch_filtered_cross_spectra",
    "csd_oracle",
    "resolve_fft_backend",
    "backend_supports_complex",
    "detrend_none",
    "detrend_mean",
    "detrend_linear",
    "segmentation",
    "utils",
]
