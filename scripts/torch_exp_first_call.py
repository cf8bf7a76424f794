"""How often torch's first float64 ``torch.exp`` on the CPU is wrong.

    python scripts/torch_exp_first_call.py [PROCESSES] [PARALLEL]

Starts PROCESSES fresh interpreters (PARALLEL at a time; defaults 60 and
6), each of which calls ``torch.exp`` on the Morlet exponent grid of
``pyfft_tpu_torch.wavelet.cwt`` at 4096 samples and its default scales
(97 x 4096 float64, large enough for torch to split it over threads)
twice, and compares both calls with ``np.exp`` bit for bit; then the same
with ``torch.set_num_threads(1)``.  Prints, for each setting, how many
processes' first and second calls differed and the largest difference.
Imports numpy and torch only.
"""
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = r"""
import json, sys
import numpy as np
import torch
if int(sys.argv[1]):
    torch.set_num_threads(int(sys.argv[1]))
n, dt = 4096, 1 / 2000.0
s0, dj = 2 * dt, 0.125
scales = s0 * 2.0 ** (dj * np.arange(int(np.log2(n * dt / s0) / dj) + 1))
om = 2 * np.pi * np.fft.fftfreq(n, dt)
arg = torch.as_tensor(-0.5 * (scales[:, None] * om[None, :] - 6.0) ** 2)
ref = np.exp(arg.numpy())
out = [float(np.abs(torch.exp(arg).numpy() - ref).max()) for _ in range(2)]
print(json.dumps({"threads": torch.get_num_threads(), "first": out[0],
                  "second": out[1]}))
"""


def run(threads):
    res = subprocess.run([sys.executable, "-c", CHILD, str(threads)],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(nproc=60, parallel=6):
    for threads in (0, 1):
        with ThreadPoolExecutor(parallel) as ex:
            rows = list(ex.map(run, [threads] * nproc))
        print(json.dumps({
            "threads": rows[0]["threads"], "processes": nproc,
            "first_call_wrong": sum(r["first"] > 0 for r in rows),
            "second_call_wrong": sum(r["second"] > 0 for r in rows),
            "max_abs_err": max(max(r["first"], r["second"]) for r in rows),
            "torch": __import__("torch").__version__}))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
