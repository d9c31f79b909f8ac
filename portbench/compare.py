"""The comparison that decides `correct`: each number against its limit."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

LIMITS_DIR = Path(__file__).resolve().parent / "reference"


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit  # NaN is never ok


def limits(workload: str) -> dict:
    """{number: limit} of a cell, from reference/<cell>.limits.json."""
    data = json.loads((LIMITS_DIR / f"{workload}.limits.json").read_text())
    return {k: float(v["limit"]) for k, v in data["limits"].items()}


def judge(workload: str, readings: dict) -> list:
    """Check of every number the cell's limits name; a number the run did
    not read reads as infinitely far off."""
    lim = limits(workload)
    return [Check(k, float(readings.get(k, float("inf"))), v) for k, v in lim.items()]
