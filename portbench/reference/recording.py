"""A T4-mini recording read on its own: the benchmark's yardstick side.

Reads the gzip JSON file that ``python -m repro_torch bruteforce`` writes
(``format: T4-mini``) without any code of the program, and derives from
it what a free-running campaign replays:

  * the valid configs: every recorded config id (a brute force records
    each valid config once, failures included);
  * their rows: ascending flat index of the value indices over the
    tunables' Cartesian product in C order;
  * each row's recorded column, and the value and charge columns. A
    config's charge is ``compile_s + sum(times_s) + overhead_s``, added
    left to right as the recorder defines it.

Imports NumPy alone.
"""
from __future__ import annotations

import gzip
import hashlib
import json

import numpy as np


def sha256_of(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def _charge(d: dict) -> float:
    return d["compile_s"] + sum(d["times_s"]) + d.get("overhead_s", 0.0)


class Recording:
    """One recorded space: its columns in file order and its rows."""

    def __init__(self, doc: dict):
        if doc.get("format") != "T4-mini":
            raise ValueError(f"not a T4-mini recording: "
                             f"{doc.get('format')!r}")
        self.kernel = doc["kernel"]
        self.device = doc["device"]
        self.meta = doc.get("meta", {})
        self.tunables = {k: list(v) for k, v in doc["tunables"].items()}
        results = doc["results"]
        self.keys = list(results)
        recs = list(results.values())
        self.status = [r["status"] for r in recs]
        self.time_s = np.array([np.inf if r["time_s"] is None
                                else r["time_s"] for r in recs],
                               dtype=np.float64)
        self.charge_s = np.array([_charge(r) for r in recs],
                                 dtype=np.float64)
        self._rows()

    @staticmethod
    def load(path: str) -> "Recording":
        with open(path, "rb") as f:
            return Recording(json.loads(gzip.decompress(f.read())))

    def _rows(self) -> None:
        values = list(self.tunables.values())
        self.cards = np.array([len(v) for v in values], dtype=np.int64)
        strides = np.ones(len(values), dtype=np.int64)
        for i in range(len(values) - 2, -1, -1):
            strides[i] = strides[i + 1] * self.cards[i + 1]
        self.strides = strides
        self.cartesian = int(np.prod(self.cards))
        index = [{str(v): i for i, v in enumerate(vals)} for vals in values]
        vidx_col = np.array([[index[t][s] for t, s in
                              enumerate(key.split(","))]
                             for key in self.keys], dtype=np.int64)
        flat_col = vidx_col @ strides
        if len(np.unique(flat_col)) != len(flat_col):
            raise ValueError("recording lists a config twice")
        order = np.argsort(flat_col, kind="stable")
        self.valid_flat = flat_col[order]
        self.vidx = vidx_col[order]              # (n_valid, T)
        self.col_of_row = order                  # recorded column of a row
        self.row_of_flat = np.full(self.cartesian, -1, dtype=np.int64)
        self.row_of_flat[self.valid_flat] = np.arange(len(order))
        self.n_valid = len(order)
        self.x_hi = (self.cards - 1).astype(np.float64)
