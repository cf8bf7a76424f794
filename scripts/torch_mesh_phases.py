"""chip_smoke.py's mesh phases alone (24-28), on one card.

    python scripts/torch_mesh_phases.py

Builds the kernels, then runs ``chip_smoke.mesh_phases``: the mesh tier on
a one-rank NCCL group against the single-device path, one JSON line a
phase, then the kernels' launch counts and the seconds taken.  Run it
from the repository root; it needs a CUDA device.
"""
import sys
import time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
t0 = time.perf_counter()
import chip_smoke as cs
import torch
from pyfft_tpu_torch.ops import _build, fir, stft, welch
_build.library()
print("build_s", time.perf_counter() - t0, flush=True)
def reset():
    fir.LAUNCHES = welch.LAUNCHES = stft.LAUNCHES = 0
    welch.COMPLEX_LAUNCHES = 0
launches = dict(welch=0, welch_complex=0, stft=0, fir=0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.mesh_phases(torch.device("cuda", 0), reset, launches)
print(launches, "total_s", time.perf_counter() - t0, flush=True)
