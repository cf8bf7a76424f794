"""Multi-device scaling layer on ``torch.distributed``, the Welch half:
mesh construction, sharded Welch (time-split blocks with a halo exchange,
all-reduced sums), time-sharded FIR, the sharded STFT, and the runtime
around them.

Counterpart of :mod:`pyfft_tpu.parallel`.  The program runs SPMD, one
process per device: every rank calls a mesh function with the same global
inputs, computes its shard and returns the same full NumPy result.  The
JAX package's ``shard_map``, ``P`` and ``NamedSharding`` are JAX's own
sharding API and have no counterpart; ``Mesh`` is
:class:`torch.distributed.device_mesh.DeviceMesh`.  The FFT half
(``fft_sharded`` and the four-step FFT, ``hilbert_sharded``,
``project_scaling``) is not ported yet.
"""

from .mesh import make_mesh, Mesh, device_counts
from .welch import welch_psd_sharded, plan_shard_segments
from .fir import fir_filter_sharded
from .runtime import (init_distributed, make_host_mesh, scaling_report,
                      measure_scaling, audit_collectives)
from .stft import stft_sharded, specgram_sharded

__all__ = ["make_mesh", "Mesh", "device_counts",
           "welch_psd_sharded", "plan_shard_segments", "fir_filter_sharded",
           "init_distributed", "make_host_mesh", "scaling_report",
           "measure_scaling", "audit_collectives",
           "stft_sharded", "specgram_sharded"]
