"""Kernels A and B on a CUDA card against their plain versions.

Runs only where there is a card (each test skips elsewhere, deciding in
the ``cuda_device`` fixture).  It imports neither JAX nor the JAX package,
so it runs on a machine without JAX:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py -q

Each plain version runs in float64 on the card, so the bounds are the
kernels' float32 error alone.
"""
import numpy as np
import pytest
import torch

from pyfft_tpu_torch.ops import fir as pfir
from pyfft_tpu_torch.ops import welch as pw


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nt,K", [(3, 100003, 1), (9, 1 << 20, 129),
                                      (2, 5000, 1024)])
def test_fir_kernel_matches_plain_on_card(cuda_device, nch, nt, K):
    """Kernel A vs its plain version in float64 on the card: max |diff| /
    max |ref| <= 1e-5 (float32 accumulation of K products)."""
    rng = np.random.default_rng(K)
    x = torch.as_tensor(rng.standard_normal((nch, nt)), dtype=torch.float32,
                        device=cuda_device)
    taps = rng.standard_normal(K)
    before = pfir.LAUNCHES
    got = pfir.fir_pallas(x, taps)
    assert pfir.LAUNCHES == before + 1
    ref = pfir.fir_plain(x.double(), taps)
    err = ((got.double() - ref).abs().max() / ref.abs().max()).item()
    assert err <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nch,nt,nwins,hop,ntaps,detrend,cplx", [
    (3, 1 << 15, 2048, 1024, 129, 1, False),
    (0, 1 << 15, 2048, 1024, 0, 1, False),
    (20, 1 << 14, 1024, 200, 63, 0, False),
    (1, 1 << 14, 16, 7, 5, 1, False),
    (2, 1 << 16, 16384, 8192, 1024, 1, False),
    (2, 1 << 14, 512, 256, 97, 1, True),
])
def test_welch_kernel_matches_plain_on_card(cuda_device, nch, nt, nwins, hop,
                                            ntaps, detrend, cplx):
    """Kernel B vs its plain version in float64 on the card: max |diff| /
    max |ref| <= 2e-5 per output (float32 FFT, float64 sums)."""
    rng = np.random.default_rng(nt + nch)
    dt = torch.complex64 if cplx else torch.float32
    x = rng.standard_normal(nt) + 0.3
    y = rng.standard_normal((nch, nt))
    if cplx:
        x = x + 1j * rng.standard_normal(nt)
        y = y + 1j * rng.standard_normal((nch, nt))
    xt = torch.as_tensor(x, dtype=dt, device=cuda_device)
    yt = torch.as_tensor(y, dtype=dt, device=cuda_device)
    taps = rng.standard_normal(ntaps) / ntaps if ntaps else None
    navr = (nt - nwins) // hop + 1
    win = np.hanning(nwins + 1)[:-1]
    nf = nwins if cplx else nwins // 2
    kw = dict(navr=navr, nwins=nwins, hop=hop, taps=taps,
              detrend_style=detrend)
    before = pw.LAUNCHES
    got = pw.welch_cuda(xt, yt, win, nf, 1.0 / navr, **kw)
    assert pw.LAUNCHES == before + 1
    wide = torch.complex128 if cplx else torch.float64
    ref = pw.welch_plain(xt.to(wide), yt.to(wide), win, nf, 1.0 / navr, **kw)
    for g, r in zip(got, ref):
        if r.numel():
            err = ((g.double() - r).abs().max() / r.abs().max()).item()
            assert err <= 2e-5
