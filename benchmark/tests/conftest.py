"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository.  They run on the CPU at small sizes; those marked
``cuda`` run a cell on the card and skip without one."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small(cfg):
    """A configuration cut to a size the CPU runs in about a second."""
    cfg = json.loads(json.dumps(cfg))
    if cfg["name"] == "welch_fir_8ch":
        cfg["nt"] = 1 << 16
    else:
        raise KeyError(f"no small size for {cfg['name']}")
    return cfg
