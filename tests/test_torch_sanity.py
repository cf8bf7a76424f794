"""pyfft_tpu_torch.utils.sanity: each sanitizer passing and failing, and
the compiled/eager consistency of the port's streaming block sums (the
counterpart of tests/test_sanity.py), on the CPU."""
import numpy as np
import pytest
import torch

from pyfft_tpu_torch import streaming as pstream
from pyfft_tpu_torch.ops import welch as pw
from pyfft_tpu_torch.utils import sanity
from pyfft_tpu_torch.utils.structure import Struct


def test_check_jit_eager_pass_and_fail():
    out = sanity.check_jit_eager(lambda x: (x * 2).sum(), torch.arange(8.0))
    assert float(out) == 56.0

    # a function whose compiled and eager results genuinely differ
    state = {"n": 0}

    def impure(x):
        state["n"] += 1
        return x + state["n"]

    with pytest.raises(AssertionError):
        sanity.check_jit_eager(impure, torch.zeros(3))


def test_assert_finite_paths():
    tree = {"a": np.ones(3), "b": [torch.zeros(2), Struct({"c": 1.0})]}
    assert sanity.assert_finite(tree) is tree
    with pytest.raises(FloatingPointError, match="a"):
        sanity.assert_finite({"a": np.array([1.0, np.nan])})
    with pytest.raises(FloatingPointError,
                       match=r"out\['b'\]\[1\]\.c: 1/2 non-finite"):
        sanity.assert_finite(
            {"b": (0, Struct({"c": torch.tensor([1.0, float("inf")])}))},
            name="out")
    with pytest.raises(FloatingPointError, match=r"\[0\]"):
        sanity.assert_finite([torch.tensor([complex(1, float("nan"))])])


def test_nan_guard():
    with pytest.raises(FloatingPointError, match="log"):
        with sanity.nan_guard():
            torch.log(torch.tensor(-1.0)) + 1.0
    with pytest.raises(FloatingPointError, match="div"):
        with sanity.nan_guard():
            torch.ones(2) / torch.zeros(2)
    with sanity.nan_guard():
        assert float(torch.log(torch.tensor(2.0))) > 0
    # off, and after the scope: no guard
    with sanity.nan_guard(enable=False):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))
    assert torch.isnan(torch.log(torch.tensor(-1.0)))


def test_welch_core_compiled_eager_consistent():
    """The streaming block sums (kernel B's plain version, the linear sums,
    the float64 recombination) compute identically compiled and eager."""
    rng = np.random.default_rng(0)
    sig = torch.as_tensor(rng.standard_normal((3, 2048)) + 5.0)
    win = np.hanning(257)[:-1]
    w = torch.as_tensor(win)
    W = torch.fft.rfft(w)[:128]

    def sums(xc, yc):
        return pw.welch_plain(xc, yc, win, 128, 1.0, navr=15, nwins=256,
                              hop=128, detrend_style=0)

    def core(sig):
        return pstream._block_sums(sig, w, W, sums, navr=15, nwins=256,
                                   hop=128, nfreq=128, onesided=True)

    sanity.check_jit_eager(core, sig, rtol=1e-12, atol=1e-12)


def test_check_sharded_consistency_pass_and_fail():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((4, 1000)))

    def single(x):
        return {"sum": x.sum(-1), "parts": [x.mean()]}

    def sharded(x):
        # four shards, all-reduced in another order
        return {"sum": sum(c.sum(-1) for c in x.chunk(4, dim=-1)),
                "parts": [torch.stack([c.mean() for c in x.chunk(4, -1)])
                          .mean()]}

    sanity.check_sharded_consistency(sharded, single, x, rtol=1e-12)
    with pytest.raises(AssertionError):
        sanity.check_sharded_consistency(
            lambda x: {"sum": x[:, :500].sum(-1), "parts": [x.mean()]},
            single, x)
    with pytest.raises(AssertionError, match="structures differ"):
        sanity.check_sharded_consistency(lambda x: {"sum": x.sum(-1)},
                                         single, x)
