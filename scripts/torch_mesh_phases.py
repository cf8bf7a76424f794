"""chip_smoke.py's mesh phases alone (24-33), on one card.

    python scripts/torch_mesh_phases.py [fft | entry]

Builds the kernels, then runs ``chip_smoke.mesh_phases`` (24-28: the
Welch half on a one-rank NCCL group against the single-device path),
``chip_smoke.mesh_fft_phases`` (29-31: the FFT half) and
``chip_smoke.entry_phases`` (32-33: ``entry()``'s forward step and
``dryrun_multichip(1)`` on that group); with ``fft`` phases 29-31 alone,
with ``entry`` phases 32-33 alone.  One JSON line a phase, then the
kernels' launch counts and the seconds taken.  Run it from the repository root; it needs a CUDA
device.
"""
import subprocess
import sys
import time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
t0 = time.perf_counter()
import chip_smoke as cs
import torch
import torch.distributed as dist
from pyfft_tpu_torch import parallel as par
from pyfft_tpu_torch.ops import _build
_build.library()
print("build_s", time.perf_counter() - t0, flush=True)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True,
                      text=True, check=True).stdout.strip().splitlines()[0]
print(card, flush=True)
launches = dict(welch=0, welch_complex=0, stft=0, fir=0, welch_dft=0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
only = sys.argv[1:2]
if not only:
    cs.mesh_phases(dev, launches)
if only in ([], ["fft"]):
    cs.mesh_fft_phases(dev, card)
if only in ([], ["entry"]):
    par.init_distributed()
    cs.entry_phases(dev, card, launches)
dist.destroy_process_group()
print(launches, "total_s", time.perf_counter() - t0, flush=True)
