"""The numbers a run compares with the plain reference, each against its
limit. A number is within its limit when it is finite and not above it."""
from __future__ import annotations

import math
import sys

import numpy as np


class Checks:
    def __init__(self, limits: dict):
        self.limits = limits
        self.values: dict = {}
        self.notes: dict = {}      # readings shown beside the numbers, compared with nothing

    def add(self, name: str, value: float) -> None:
        """Keep the worst reading of ``name``."""
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r}")
        old = self.values.get(name)
        bad = not math.isfinite(value)
        self.values[name] = 1e30 if bad else (value if old is None else max(old, value))

    def note(self, name: str, value: float) -> None:
        self.notes[name] = max(value, self.notes.get(name, value))

    @property
    def correct(self) -> bool:
        return bool(self.values) and all(v <= self.limits[k] for k, v in self.values.items())

    def table(self) -> dict:
        return {k: {"value": v, "limit": self.limits[k]} for k, v in self.values.items()}

    def print(self) -> None:
        """Each number beside its limit, as the last lines on standard error."""
        for k, v in self.values.items():
            print(f"check {k}: {v!r} (limit {self.limits[k]!r})"
                  f"{'' if v <= self.limits[k] else '  FAILED'}", file=sys.stderr)


class Sample:
    """The records a run compares once its window has closed: the first of
    the longest, and ``k`` of the others drawn uniformly with a generator
    seeded from the run's seed (reservoir sampling, as the window goes), so
    that only these keep the tensors the comparison reads."""

    def __init__(self, k: int, seed: int, heavy: tuple):
        self.k, self.heavy = k, heavy
        self.rng = np.random.default_rng(seed % 2 ** 63 + 7)
        self.longest = None
        self.drawn: list = []
        self.seen = 0

    def _drop(self, rec) -> None:
        for key in self.heavy:
            rec.pop(key, None)

    def offer(self, rec: dict) -> None:
        if self.longest is None or rec["L"] > self.longest["L"]:
            rec, self.longest = self.longest, rec
            if rec is None:
                return
        self.seen += 1
        if len(self.drawn) < self.k:
            self.drawn.append(rec)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            rec, self.drawn[j] = self.drawn[j], rec
        self._drop(rec)

    def records(self) -> list:
        return [self.longest] + self.drawn
