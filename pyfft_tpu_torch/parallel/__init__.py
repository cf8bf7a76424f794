"""Multi-device scaling layer on ``torch.distributed``: mesh construction,
sharded Welch (time-split blocks with a halo exchange, all-reduced sums),
time-sharded FIR, the sharded STFT, the distributed FFT (four-step over
all-to-all, Bluestein for the other lengths, the analytic signal), and the
runtime around them with its scaling projections.

Counterpart of :mod:`pyfft_tpu.parallel`.  The program runs SPMD, one
process per device: every rank calls a mesh function with the same global
inputs, computes its shard and returns the same full NumPy result.  The
JAX package's ``shard_map``, ``P`` and ``NamedSharding`` are JAX's own
sharding API and have no counterpart; ``Mesh`` is
:class:`torch.distributed.device_mesh.DeviceMesh`.  The FFT functions
return this rank's block of the output axis (the shard a JAX device
holds), as tensors on its device.
"""

from .mesh import make_mesh, Mesh, device_counts
from .welch import welch_psd_sharded, plan_shard_segments
from .fir import fir_filter_sharded
from .runtime import (init_distributed, make_host_mesh, scaling_report,
                      measure_scaling, audit_collectives, project_scaling,
                      project_scaling_paths)
from .stft import stft_sharded, specgram_sharded
from .fft import (fft_sharded, ifft_sharded, rfft_sharded, irfft_sharded,
                  hilbert_sharded, axis_swap, four_step_factor)

__all__ = ["make_mesh", "Mesh", "device_counts",
           "welch_psd_sharded", "plan_shard_segments", "fir_filter_sharded",
           "init_distributed", "make_host_mesh", "scaling_report",
           "measure_scaling", "audit_collectives", "project_scaling",
           "project_scaling_paths", "stft_sharded", "specgram_sharded",
           "fft_sharded", "ifft_sharded", "rfft_sharded", "irfft_sharded",
           "hilbert_sharded", "axis_swap", "four_step_factor"]
