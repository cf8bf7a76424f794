"""Kernel layer of the port.

- :mod:`pyfft_tpu_torch.ops.fir` — kernel A, the causal FIR
  (``csrc/fir.cu``), and its plain version;
- :mod:`pyfft_tpu_torch.ops.fir` also holds kernel I, the FIR-transpose
  feeder (``fir_transpose_pallas``), and its plain version;
- :mod:`pyfft_tpu_torch.ops.welch` — kernel B, fused FIR + detrend +
  Welch cross-powers (``csrc/welch_pair.cu`` for real signals,
  ``csrc/welch.cu`` for complex ones, both on ``csrc/fft_reg.cuh``), and
  its plain version; the real kernel launched with ``welch_cuda(...,
  packed=True)`` is kernel H;
- :mod:`pyfft_tpu_torch.ops.welch_packed` — the entries of kernel H, the
  packed Welch of one signal or one pair, two real sequences per complex
  FFT, and the JAX package's gates for them;
- :mod:`pyfft_tpu_torch.ops.stft` — kernel C, the per-segment STFT after
  mean and window (``csrc/stft.cu``), and its plain version;
- :mod:`pyfft_tpu_torch.ops.hilbert` — kernel D, the rows' section of the
  factored analytic-signal transform (``csrc/hilbert.cu``), and its plain
  version;
- :mod:`pyfft_tpu_torch.ops.welch_v1` — kernel E, Welch cross-powers at
  any segment length (``csrc/welch_dft.cu``), and its plain version;
- :mod:`pyfft_tpu_torch.ops.probe` — kernels F and G, the memory and
  compute probes of ``utils.profiling.measure_pipeline_overlap``
  (``csrc/probe.cu``), and their plain versions;
- :mod:`pyfft_tpu_torch.ops.transform` — NumPy-in, NumPy-out ``torch.fft``
  helpers;
- :mod:`pyfft_tpu_torch.ops._build` — builds and loads the kernels with
  ``nvcc`` at first use on a CUDA tensor.
"""
from . import (fir, welch, welch_packed, welch_v1, stft, hilbert, probe,
               transform)
from .fir import fir_pallas, fir_transpose_pallas, PALLAS_FIR_MAX_TAPS
from .welch import (welch_fir_pallas3, welch_fir_pallas_fused,
                    welch_pallas3_twosided, pallas_welch2_applicable)
from .welch_packed import (welch_auto_packed, welch_pair_packed,
                           packed_parts_geometry, packed_pair_geometry)
from .welch_v1 import (welch_pallas_fused, welch_power_pallas,
                       pallas_welch_applicable)
from .stft import stft_pallas3, stft_applicable

__all__ = ["fir", "welch", "welch_packed", "welch_v1", "stft", "hilbert",
           "probe", "transform", "fir_pallas", "fir_transpose_pallas",
           "PALLAS_FIR_MAX_TAPS", "stft_pallas3", "welch_auto_packed",
           "welch_pair_packed", "packed_parts_geometry",
           "packed_pair_geometry",
           "stft_applicable", "welch_fir_pallas3", "welch_fir_pallas_fused",
           "welch_pallas3_twosided", "pallas_welch2_applicable",
           "welch_pallas_fused", "welch_power_pallas",
           "pallas_welch_applicable"]
