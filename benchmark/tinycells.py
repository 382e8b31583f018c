"""Small cells for the CPU tests, added as data.

Each file `benchmark/tiny/<tiny-cell>.json` describes one small cell:
`shrinks`, the full-size cell of `BENCHMARK.json` it is cut from;
`config`, the configuration's keys it changes (nested objects change key
by key); `traffic`, the traffic mix's keys it changes; `limits`, its
limits; `faults`, the files of `benchmark/faults/` that break its timed
path; `fault_seconds`, its window under a fault; `control`, the full-size
cell's control (`control.py`) for the test on the card.

`make_root(tmp)` copies `BENCHMARK.json` and the benchmark's files into
`tmp`, links the program beside them, and adds every small cell (`shrink`)
as new files and new entries only: its configuration, traffic mix and
limits, each named after the small cell, and the cell itself, which the
metrics of the cell it shrinks list too. A cell this small converges
otherwise than its full-size parent, and its gaps swing from seed to seed,
so its limits hold only for the tests' seed.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict

REPO = Path(__file__).resolve().parent.parent


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def cells(bench: Path = REPO / "benchmark") -> Dict[str, dict]:
    """The small cells of `bench/tiny/`, by name (the file's stem)."""
    return {p.stem: json.loads(p.read_text()) for p in sorted((bench / "tiny").glob("*.json"))}


def shrink(root: Path) -> None:
    """Add to the checkout at `root` each small cell of its
    `benchmark/tiny/` that its `BENCHMARK.json` does not have yet."""
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    workloads = {w["name"]: w for w in spec["workloads"]}
    configs = {c["name"]: c for c in spec["configs"]}
    for name, tiny in cells(bench).items():
        if name in workloads:
            continue
        big = workloads[tiny["shrinks"]]
        config = configs[big["config"]]
        cfg = _merge(json.loads((root / config["file"]).read_text()), tiny["config"])
        cfg["name"] = name
        _write(bench / "configs" / f"{name}.json", cfg)
        spec["configs"].append(dict(config, name=name, file=f"benchmark/configs/{name}.json"))
        traffic = json.loads((bench / "traffic" / f"{big['traffic']}.json").read_text())
        _write(bench / "traffic" / f"{name}.json", _merge(traffic, tiny["traffic"]))
        _write(bench / "limits" / f"{name}.json", tiny["limits"])
        spec["workloads"].append({"name": name, "config": name, "traffic": name, "chips": 1,
                                  "why": "a CPU test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if big["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    _write(root / "BENCHMARK.json", spec)


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("_runs", "_cache", "__pycache__"))
    (root / "icpx_torch").symlink_to(REPO / "icpx_torch")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shrink(root)
    return root
