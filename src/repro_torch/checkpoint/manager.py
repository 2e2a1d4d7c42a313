"""Checkpointing: atomic, async-capable, keep-k.

Port of ``src/repro/checkpoint/manager.py``, with its contract:
  * ``save`` writes to a temp file and atomically renames — a crash mid-write
    never corrupts the latest checkpoint;
  * ``restore`` + the stateless data pipeline reproduce training bit-exactly
    from the saved step;
  * ``AsyncCheckpointer`` overlaps serialization with the next train steps
    (the step only blocks if the previous write is still in flight): the
    snapshot (device→host copy) is taken on the caller's thread, the
    write runs on another.

Format: the reference's, so that each package restores the other's file:
one .npz of path-flattened arrays (``params/...``, ``opt/mu/...``,
``opt/nu/...``, ``opt/step``; each layer kind's tensors stacked along a
leading axis, through ``models.weights.to_reference``) + a JSON sidecar
(step, meta). What changed: the state is the port's ``{"params": Model,
"opt": {"mu", "nu", "step"}}`` (``training.train_step``), and
``restore`` copies the file into a template state of that form (on its
device, in its dtypes) and returns it; the reference's ``shardings``
(re-laying onto a mesh) has no counterpart. A bf16 ``mu`` is written as
float32 (exact; numpy has no bf16), and a reference file's bf16 arrays
are read bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import threading
from typing import Mapping

import numpy as np
import torch

from ..models.weights import _stacked, to_reference


def _put(flat: dict, prefix: str, tree: Mapping) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _put(flat, f"{prefix}/{key}", value)
        else:
            flat[f"{prefix}/{key}"] = value


def flatten_state(state: dict) -> dict:
    """Host (numpy) copies of a train state (copies on the CPU too, so
    that training may go on overwriting the state), keyed as the
    reference's checkpoint keys its leaves."""
    model = state["params"]
    opt = state["opt"]
    flat: dict = {}
    _put(flat, "params", to_reference(model.cfg,
                                      dict(model.named_parameters())))
    _put(flat, "opt/mu", to_reference(model.cfg, opt["mu"]))
    _put(flat, "opt/nu", to_reference(model.cfg, opt["nu"]))
    flat["opt/step"] = opt["step"].detach().to("cpu", copy=True).numpy()
    return flat


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor of a loaded array; a 2-byte float that numpy holds as a
    bf16 extension or raw void type becomes a bf16 tensor, bit for bit."""
    if arr.dtype.itemsize == 2 and arr.dtype.kind not in "fiu":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ io
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def save(self, step: int, state, meta: dict | None = None) -> str:
        """Write ``state`` (a train state, or ``flatten_state``'s host
        copy of one) as step ``step``."""
        flat = state if "params" not in state else flatten_state(state)
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)  # atomic publish
        with open(path + ".json", "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        self._gc()
        return path

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            for suffix in (".npz", ".npz.json"):
                p = os.path.join(self.directory, f"ckpt_{s:08d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)

    def all_steps(self) -> list:
        out = []
        for name in sorted(os.listdir(self.directory)):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, template: dict) -> dict:
        """Restore step ``step`` into ``template`` (a train state of the
        same config and optimizer: its structure, devices and dtypes) and
        return it."""
        with np.load(self._path(step)) as data:
            flat = {k: data[k] for k in data.files}

        def fill(prefix: str, named) -> None:
            for name, t in named:
                key, index = _stacked(name)
                path = f"{prefix}/{key.replace('.', '/')}"
                if path not in flat:
                    raise KeyError(f"checkpoint has no {path!r} for "
                                   f"{name!r}")
                src = _tensor(flat[path][index])
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"{path}{list(index)} is "
                                     f"{tuple(src.shape)}, the template's "
                                     f"{name} {tuple(t.shape)}")
                t.copy_(src.to(t.dtype))

        opt = template["opt"]
        fill("params", template["params"].named_parameters())
        fill("opt/mu", opt["mu"].items())
        fill("opt/nu", opt["nu"].items())
        opt["step"].copy_(torch.as_tensor(np.asarray(flat["opt/step"])))
        return template


class AsyncCheckpointer:
    """Background-thread writer: snapshot on the caller thread (device→host
    copy), serialize/write off-thread. ``wait()`` joins the in-flight write."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, state, meta: dict | None = None) -> None:
        self.wait()
        snapshot = flatten_state(state)  # host copy now

        def work():
            try:
                self.manager.save(step, snapshot, meta)
            except Exception as e:  # pragma: no cover
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise self._error
