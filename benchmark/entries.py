"""The general traffic generator: every traffic mix is a data file that
names an entry and gives its parameters.

An entry is a class in a file of its own, `benchmark/entry/<name>.py`,
which exports it as `ENTRY`; a traffic file's `"entry": "<name>"` names
that file, and `load` is the one place that finds it. An entry makes a
cell's inputs from its configuration and the seed, warms the shapes its
requests use, issues request j of the closed loop (each request ends in a
synchronise, so the harness's host clock times it whole), judges each
finished request against the simulator's truth, and checks a sample of the
window's answers against the plain reference (`reference.py`). This module
holds what entries share: the `Entry` base class and its helpers.

The program is reached only through module attributes looked up at call
time, so the harness's spans (and a test's faults) wrap what a request
really calls.

Controls (`control.py`) put the reference in the program's place:
"float32" and "tf32" run it in that working precision
(`reference.working_precision`); "guarantee" breaks one guarantee the
configuration states, as a cheaper program would (each entry's
`reference` says which).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

import generators as gen
import reference as ref

PRECISIONS = ("float32", "tf32")
ENTRY_DIR = Path(__file__).resolve().parent / "entry"


def load(name: str) -> type:
    """The entry class that `entry/<name>.py` beside this file exports as
    `ENTRY`."""
    path = ENTRY_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no entry {name!r}: {path} is not there")
    spec = importlib.util.spec_from_file_location(f"bench_entry_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ENTRY


def _mod(name: str):
    import importlib

    return importlib.import_module(name)


def _icp_config(d: dict):
    return _mod("icpx_torch.registration.icp").ICPConfig(**d)


def _se3_np(R: torch.Tensor, t: torch.Tensor) -> np.ndarray:
    return ref.se3(R.detach().double().cpu().numpy(), t.detach().double().cpu().numpy())


def _worst(numbers: Dict[str, float], name: str, value: float) -> None:
    numbers[name] = max(numbers.get(name, 0.0), value if math.isfinite(value) else float("inf"))


def _settings(icp: dict, **over) -> ref.Settings:
    """The reference's settings from the configuration's ICP block."""
    keep = {f.name for f in dataclasses.fields(ref.Settings)}
    d = {k: v for k, v in icp.items() if k in keep}
    d.update(over)
    return ref.Settings(**d)


def _precision(control: Optional[str]) -> str:
    return control if control in PRECISIONS else "float64"


class Entry:
    """What every entry has: its configuration, traffic, seed and device,
    the program's ICP settings (`configure`), and the comparison of the
    sampled answers with the reference's."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self._answers: Dict[object, ref.Answer] = {}

    def configure(self, **over) -> None:
        """The program's ICP settings, with `over` on top (a control's)."""
        self.icp = {**self.config["icp"], **self.traffic.get("icp", {}), **over}
        self.cfg = _icp_config(self.icp)

    def warm(self) -> None:
        for j in range(int(self.traffic.get("warm_requests", 1))):
            self.request(j)

    def kernel_work(self, record: dict) -> dict:
        """Work of a finished request that per-layer metrics count."""
        return {}

    def summary(self, records: List[dict]) -> Dict[str, float]:
        """Accuracy against the simulator's truth, for the run's file."""
        return {}

    def release(self) -> None:
        """Drop the program's inputs on the device before the reference runs."""

    def answer(self, key, control: Optional[str] = None) -> ref.Answer:
        """The reference's answer for `key` (cached), or a control's."""
        if control is not None:
            with ref.working_precision(_precision(control)):
                return self.reference(key, control)
        if key not in self._answers:
            self._answers[key] = self.reference(key, None)
        return self._answers[key]

    def check(self, sample: List[dict], control: Optional[str] = None) -> Dict[str, float]:
        """The worst gaps between the sampled answers (or the control's
        answers in their place) and the reference's, and the root mean
        square of the translation gaps over them (`t_gap_rms_m`): a single
        answer that stops a few iterations off the reference's moves it by
        its gap over the square root of the sample's size, an answer
        altered where it is produced by as much."""
        numbers: Dict[str, float] = {}
        t_gaps = []
        for key, T, rmse in self.answers(sample):
            want = self.answer(key)
            if control is not None:
                got = self.answer(key, control)
                T, rmse = got.T, got.rmse
            rot, t = ref.gap(T, want.T)
            _worst(numbers, "rot_gap_rad", rot)
            _worst(numbers, "t_gap_m", t)
            _worst(numbers, "rmse_gap_m", abs(rmse - want.rmse))
            t_gaps.append(t if math.isfinite(t) else float("inf"))
        if t_gaps:
            numbers["t_gap_rms_m"] = math.sqrt(sum(t * t for t in t_gaps) / len(t_gaps))
        return numbers

    def _draw(self, items: list) -> list:
        """`check_answers` of `items`, drawn from the seed, in order."""
        rng = np.random.default_rng(gen.sub_seed(self.seed, 4))
        k = min(int(self.traffic.get("check_answers", 1)), len(items))
        return [items[int(a)] for a in sorted(rng.choice(len(items), size=k, replace=False))]


# ---- ground-truth pairs ------------------------------------------------------------------


def pool_gt(rule: dict, i: int) -> dict:
    """Pool pair i's ground truth, as bench.py's --batch pairs take it:
    angle + angle_step (i mod angle_cycle) about `axis`, the translation's
    y + t_y_step (i mod t_y_cycle)."""
    t = list(rule["translation"])
    t[1] += rule.get("t_y_step", 0.0) * (i % int(rule.get("t_y_cycle", 1)))
    angle = rule["angle"] + rule.get("angle_step", 0.0) * (i % int(rule.get("angle_cycle", 1)))
    return dict(axis=rule["axis"], angle=angle, translation=t)
