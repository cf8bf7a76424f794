"""The port's public names against the JAX package's.

``pyfft_tpu_torch.__all__`` covers ``pyfft_tpu.__all__``, except the names
ROADMAP.md lists as TPU-only ("Not to port").  The same holds for ``ops``,
``utils`` and ``parallel``, whose FFT half (Queue 1 item 4b) is not ported
yet.
"""
import importlib

import pytest

import pyfft_tpu
import pyfft_tpu_torch

# ROADMAP.md "Not to port": the matmul DFTs of ops/mxu_fft.py and JAX's
# own sharding API
TPU_ONLY = {"ops": {"mxu_fft", "rfft_pair", "fft_pair", "ifft_pair",
                    "irfft_pair", "dft_matrices"},
            "parallel": {"shard_map", "P", "NamedSharding"}}
# Queue 1 item 4b: the FFT half of the mesh tier
MESH = {"parallel": {"fft_sharded", "ifft_sharded", "rfft_sharded",
                     "irfft_sharded", "hilbert_sharded", "axis_swap",
                     "four_step_factor", "project_scaling",
                     "project_scaling_paths"}}


@pytest.mark.parametrize("module", ["", "ops", "utils", "parallel"])
def test_all_covers_the_jax_package(module):
    suffix = f".{module}" if module else ""
    jax_mod = importlib.import_module("pyfft_tpu" + suffix)
    port = importlib.import_module("pyfft_tpu_torch" + suffix)
    missing = (set(jax_mod.__all__) - set(port.__all__)
               - TPU_ONLY.get(module, set()) - MESH.get(module, set()))
    assert not missing
    for name in port.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize("name", [
    "StreamingWelch", "ShotLoader", "multitaper_psd", "multitaper_csd",
    "pycwt", "streaming", "io", "multitaper", "wavelet"])
def test_the_streaming_slice_names(name):
    port = getattr(pyfft_tpu_torch, name)
    ref = getattr(pyfft_tpu, name)
    if name in ("streaming", "io", "multitaper", "wavelet", "pycwt"):
        assert port.__name__ == ref.__name__.replace("pyfft_tpu",
                                                     "pyfft_tpu_torch")
    else:
        assert port.__name__ == ref.__name__
    assert pyfft_tpu_torch.io.stream_welch.__name__ == "stream_welch"
    assert pyfft_tpu_torch.wavelet.cwt is pyfft_tpu_torch.pycwt.cwt
    assert pyfft_tpu_torch.utils.sanity.nan_guard.__name__ == "nan_guard"
