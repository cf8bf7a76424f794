"""Compatibility facade matching the reference ``fft_analysis`` namespace
(counterpart of :mod:`pyfft_tpu.fft_analysis`).

A user of the reference can ``from pyfft_tpu_torch import fft_analysis as
fft`` (mirroring the reference package's ``from . import fft_analysis as
fft``, ``__init__.py:13``) and find every public symbol of the reference
module under its original name, backed by the port's implementations.
"""

# Welch engine + class API (reference fft_analysis.py:36-791, 1695-2887)
from .spectral import (fft_pwelch, fftinfosc, Cxy_Cxy2,  # noqa: F401
                       csd_oracle, welch_cross_spectra)
from .fftanal import fftanal, stft_segments  # noqa: F401

# statistics toolbox (reference :835-1409)
from .integrate import (integratespectra, getNpeaks, monticoh, varcoh,  # noqa: F401
                        montiphi, varphi, mean_angle, unwrap_tol)

# spectral derivative helpers (reference :1419-1588)
from .deriv import rescale, unscale, fft_deriv  # noqa: F401

# mlab-style convenience wrappers (reference :1037-1155)
from .crosscheck import fft_pmlab, coh, coh2, psd, csd  # noqa: F401

# detrending re-exports (reference :23)
from .utils.detrend import (detrend_mean, detrend_none,  # noqa: F401
                            detrend_linear)

# window dispatcher (reference :26-30)
from .windows import windows  # noqa: F401

# executable examples / demo tests (reference :2895-3109)
from .examples import (test_fftpwelch, test_fftanal,  # noqa: F401
                       create_turb_spectra, testFFTanal, test,
                       test_fft_deriv)
