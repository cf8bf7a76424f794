"""IO tier: native streaming shot-file loader + HDF5 persistence hooks."""

from .loader import ShotLoader, stream_welch, native_available
from ..heatpulse import save_hdf5, load_hdf5

__all__ = ["ShotLoader", "stream_welch", "native_available",
           "save_hdf5", "load_hdf5"]
