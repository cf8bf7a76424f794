"""Principal component analysis.

Role of the reference ``PCA.py``: covariance (:13), eigen-decomposition PCA
with standardization (``basic_pca``, :22-40) and mean-centering only
(``PCA``, :63-87).

The eigenproblem is small (nch x nch) and runs in host LAPACK (float64);
the data projection — the only O(N) work — is a float32 ``torch.matmul``
on the device when the input is large, as the JAX package runs it in
float32 on its device.  Counterpart of :mod:`pyfft_tpu.pca`.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import _np, resolve_device

__all__ = ["cov", "basic_pca", "PCA", "test_data", "test", "test_PCA",
           "plot_pca"]


def cov(data):
    """Covariance of mean-centered data normalized by N
    (reference ``cov``, :13-19; NumPy's ``cov`` uses N-1)."""
    data = np.asarray(data)
    return np.dot(data.T, data) / data.shape[0]


def _project(data, evecs, device=None):
    """Device matmul for the projection when worthwhile, else host."""
    if data.size >= 1 << 16:
        dev = resolve_device(device)
        out = torch.matmul(
            torch.as_tensor(data, dtype=torch.float32, device=dev),
            torch.as_tensor(evecs, dtype=torch.float32, device=dev))
        return _np(out).astype(np.float64)
    return np.dot(data, evecs)


def basic_pca(data, pc_count=None, device=None):
    """PCA of standardized data via ``eigh`` of the covariance
    (reference ``basic_pca``, :22-40).  Mean-centers and auto-scales the
    input in place, matching the reference's semantics.

    Returns ``(U, E, V)``: projected data, eigenvalues, eigenvectors.
    """
    data = np.asarray(data, dtype=np.float64)
    data -= np.mean(data, 0)
    data /= np.std(data, 0)
    C = cov(data)
    E, V = np.linalg.eigh(C)
    key = np.argsort(E)[::-1][:pc_count]
    E, V = E[key], V[:, key]
    U = _project(data, V, device)
    return U, E, V


def PCA(data, dims_rescaled_data=2, device=None):
    """Mean-centering PCA (reference ``PCA``, :63-87).

    Returns ``(transformed, evals, evecs)`` with the data projected onto
    the leading ``dims_rescaled_data`` eigenvectors.
    """
    data = np.asarray(data, dtype=np.float64)
    data = data - data.mean(axis=0)
    R = np.cov(data, rowvar=False)
    evals, evecs = np.linalg.eigh(R)
    idx = np.argsort(evals)[::-1]
    evecs = evecs[:, idx]
    evals = evals[idx]
    evecs = evecs[:, :dims_rescaled_data]
    return _project(data, evecs, device), evals, evecs


def test_data(rng=None):
    """Two-cluster random test data (reference ``test_data``, :139-145)."""
    if rng is None:
        rng = np.random.default_rng()
    data = rng.standard_normal((150, 8))
    data[:50, 2:4] += 5
    data[50:, 2:5] += 5
    return data


def test(data=None, plotit=True):
    """Scatter the two clusters before/after projection (reference
    ``test``, :43-58).  Returns the projected data for assertions."""
    if data is None:
        data = test_data()
    trans = basic_pca(data.copy(), 3)[0]
    if plotit:  # pragma: no cover - headless CI draws to Agg
        import matplotlib.pyplot as plt
        fig, (ax1, ax2) = plt.subplots(1, 2)
        ax1.scatter(data[:50, 0], data[:50, 1], c="r")
        ax2.scatter(trans[:50, 0], trans[:50, 1], c="r")
        ax1.scatter(data[50:, 0], data[50:, 1], c="b")
        ax2.scatter(trans[50:, 0], trans[50:, 1], c="b")
        plt.draw()
    return trans


def test_PCA(data=None, dims_rescaled_data=2, plotit=True):
    """Project onto the leading eigenvectors and overplot the projection on
    the original data (reference ``test_PCA``, :89-113).  Returns
    ``(data, data_recovered)``."""
    if data is None:
        data = test_data()
    _, _, eigenvectors = PCA(data.copy(), dims_rescaled_data=dims_rescaled_data)
    data_recovered = np.dot(eigenvectors.T, np.asarray(data).T).T
    if plotit:  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.figure()
        plt.plot(data, "-")
        plt.plot(data_recovered, ".")
        plot_pca(data)
    return data, data_recovered


def plot_pca(data, pcindices=(0, 1)):  # pragma: no cover
    """Three-panel PCA diagnostic: data+projection, eigenvalue scree, and
    the PC-vs-PC scatter (reference ``plot_pca``, :116-137)."""
    import matplotlib.pyplot as plt
    clr1 = "#2026B2"
    data_resc, eigenval, _ = PCA(np.asarray(data).copy())
    plt.figure()
    ax1 = plt.subplot(3, 1, 1)
    ax1.plot(data, "-", data_resc, ".")
    ax2 = plt.subplot(3, 1, 2)
    ax2.plot(1 + np.arange(0, len(eigenval)), eigenval, "s-")
    ax2.set_ylabel("eigval")
    ax3 = plt.subplot(3, 1, 3)
    ax3.plot(data_resc[:, pcindices[0]], data_resc[:, pcindices[1]], ".",
             mfc=clr1, mec=clr1)
    ax3.set_xlabel("PC%i" % (pcindices[0],))
    ax3.set_ylabel("PC%i" % (pcindices[1],))
    plt.draw()
    return ax1, ax2, ax3
