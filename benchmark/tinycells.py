"""Small cells for the CPU tests, added as data.

`make_root(tmp)` copies `BENCHMARK.json` and the benchmark's files into
`tmp`, links the program beside them, and adds, as new files and new
entries only, one small cell for each of the benchmark's traffic entries:
`tiny-pair.stream` (2,048-point ground-truth pairs) and
`tiny-lidar.offline` (5 scans of 4,096 rows, requests of 2 pairs). The
metrics of the cell each shrinks list it too. Its limits are its own
(`LIMITS`): about ten times the gaps the tests' seed gives on the CPU, far
under the guarantee controls' (the covariances left out: 0.04 rad and m; a
third of the iterations: 0.1 m and more). A cell this small converges
otherwise than its full-size parent, and its gaps swing from seed to seed,
so they hold only for that seed (at 2,048 rows the first phase's 512
source rows leave pairs a quarter metre from the truth, and the gaps
swing by orders of magnitude).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
LIMITS = {
    "tiny-pair.stream": {"rot_gap_rad": 1e-6, "t_gap_m": 1e-6},
    "tiny-lidar.offline": {"rot_gap_rad": 3e-5, "t_gap_m": 5e-4, "rmse_gap_m": 3e-6},
}
SHRINKS = {"tiny-pair.stream": "pair1m-gicp.stream", "tiny-lidar.offline": "lidar65k.offline"}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    bench = root / "benchmark"
    shutil.copytree(REPO / "benchmark", bench,
                    ignore=shutil.ignore_patterns("_runs", "_cache", "__pycache__"))
    (root / "icpx_torch").symlink_to(REPO / "icpx_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in spec["configs"]}

    pair = json.loads((REPO / configs["pair1m-gicp"]["file"]).read_text())
    pair.update(name="tiny-pair", points=2048)
    _write(bench / "configs" / "tiny-pair.json", pair)
    lidar = json.loads((REPO / configs["lidar65k"]["file"]).read_text())
    lidar.update(name="tiny-lidar")
    lidar["scans"]["points"] = 4096
    lidar["trajectory"]["frames"] = 5
    _write(bench / "configs" / "tiny-lidar.json", lidar)
    spec["configs"] += [dict(configs["pair1m-gicp"], name="tiny-pair",
                             file="benchmark/configs/tiny-pair.json"),
                        dict(configs["lidar65k"], name="tiny-lidar",
                             file="benchmark/configs/tiny-lidar.json")]

    # every answer of the window checked: a fault that spoils some of them
    # cannot hide behind the sample
    stream = json.loads((bench / "traffic" / "stream.json").read_text())
    stream.update(check_answers=1000)
    _write(bench / "traffic" / "tiny-stream.json", stream)
    offline = json.loads((bench / "traffic" / "offline.json").read_text())
    offline.update(starts=[0, 2], scans_per_request=3, check_answers=1000)
    _write(bench / "traffic" / "tiny-offline.json", offline)

    traffic = {"tiny-pair.stream": "tiny-stream", "tiny-lidar.offline": "tiny-offline"}
    for name, big in SHRINKS.items():
        spec["workloads"].append({"name": name, "config": name.split(".")[0],
                                  "traffic": traffic[name], "chips": 1, "why": "a CPU test"})
        _write(bench / "limits" / f"{name}.json", LIMITS[name])
        for m in spec["end_to_end"] + spec["per_layer"]:
            if big in m.get("workloads", []):
                m["workloads"].append(name)
    _write(root / "BENCHMARK.json", spec)
    return root
