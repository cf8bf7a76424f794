"""Readings of a cell's output check at its own size, seed by seed, in one
process: the program's, the control's (the reference one precision down
in the program's place) and the planted faults' (``faults.py``).  The
limits in ``configs/<config>.json`` lie between the program's largest
reading and the smallest of the control's.

    python3 benchmark/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--control 3]

Each seed prints one JSON line: the worst reading over the seed's pool of
records for the program, and for the first ``--control`` seeds the
control's and each fault's.  Needs the card, as a run does.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, harness, traffic  # noqa: E402


def worst(readings):
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, float(v)), float(v))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    device = "cuda"
    import torch

    cs = harness.cell_spec(harness.load_spec(), args.workload)
    harness.card_info(device, cs["cell"]["chips"])
    cfg = json.loads((harness.ROOT / cs["config"]["file"]).read_text())
    inputs = harness.load_module("configs", cs["config"]["name"])
    program = harness.load_module("programs", cs["config"]["name"])
    mix = traffic.load(cs["cell"]["traffic"])
    state = program.prepare(cfg, inputs, device)
    plans = dict(stale=faults.stale(program.call),
                 half_batch=faults.half_batch(program)(program.call),
                 altered=faults.altered(program.call))
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        pool = traffic.make_pool(mix, cfg, inputs, seed, device)
        outs = [program.call(state, rec) for rec in pool]
        refs = [inputs.reference(cfg, rec, device) for rec in pool]
        line = dict(workload=args.workload, seed=seed, program=worst(
            inputs.compare(cfg, o, r) for o, r in zip(outs, refs)))
        if n < args.control:
            line["control"] = worst(
                inputs.compare(cfg, inputs.control(cfg, rec, device), r)
                for rec, r in zip(pool, refs))
            for name, call in plans.items():
                line[name] = worst(inputs.compare(cfg, call(state, rec), r)
                                   for rec, r in zip(pool, refs))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del pool, outs, refs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
