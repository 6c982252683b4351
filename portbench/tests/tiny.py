"""A checkout in miniature for the harness's CPU tests: the real BENCHMARK.json's cells
with their configurations cut to a few layers and narrow widths, and short mixes."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.lib.common import ROOT, load_json

TINY_MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
              "vocab": 512}
TINY_DIMS = {"vocab": 512, "d_model": 32, "d_hidden": 64}
TINY_TRAIN = {"batch": 2, "seq": 16, "batches": 8}
TINY_SERVE = {"batch": 2, "gen": 3, "round": [[8, 2], [16, 1]], "rounds": 40,
              "prompt_sets": 2, "check_requests": 4}


def make_root(tmp: Path, limits: dict | None = None) -> Path:
    """A root with BENCHMARK.json and the cells' files, cut to tiny sizes; ``limits``
    replaces a workload's limits."""
    bench = load_json(ROOT / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits"):
        (tmp / "portbench" / sub).mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for c in bench["configs"]:
        conf = load_json(ROOT / c["file"])
        if "model" in conf:
            conf["model"].update(TINY_MODEL)
        if "dims" in conf:
            conf["dims"].update(TINY_DIMS)
        (tmp / c["file"]).write_text(json.dumps(conf))
    for w in bench["workloads"]:
        mix = load_json(ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
        mix.update(TINY_TRAIN if mix["kind"] == "train" else TINY_SERVE)
        (tmp / "portbench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
        lim = load_json(ROOT / "portbench" / "limits" / f"{w['name']}.json")
        lim.update((limits or {}).get(w["name"], {}))
        (tmp / "portbench" / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    return tmp
