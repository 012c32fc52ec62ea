"""Checkpoints: atomic, keep-k, restore onto a chosen device, async save.

The port of the reference's ``repro/checkpoint/manager.py``, with its
layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written into
``<dir>/.tmp_<N>`` and renamed, so a crash in the middle of a save never
corrupts the newest checkpoint and the restart driver (``ft/``) always
finds a whole step.  A state is a nested dict of tensors (or numbers); its
keys are ``/``-joined paths (``params/layers.0.attn.wq``,
``opt/step``).  ``restore`` loads on the host and
places each array on the device asked for, or on its template leaf's —
the one-card counterpart of the reference's reshard-on-load.  numpy has
no bfloat16: a bf16 tensor is stored as its ``int16`` bit pattern, its
key listed under ``"bfloat16"`` in the manifest, and viewed back on
restore (the reference's npz holds bf16 as raw void and cannot restore
it).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

SEP = "/"


def _flatten(tree, prefix: str = "", out: Optional[dict] = None) -> dict:
    out = {} if out is None else out
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            _flatten(v, key, out)
        else:
            out[key] = v
    return out


def _to_host(flat: dict):
    """(numpy arrays, the keys of the bf16 tensors among them, stored as
    their int16 bit patterns)."""
    arrays, bf16 = {}, []
    for k, v in flat.items():
        if not isinstance(v, torch.Tensor):
            arrays[k] = np.asarray(v)
            continue
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.view(torch.int16)
            bf16.append(k)
        arrays[k] = v.numpy()
    return arrays, bf16


def _unflatten_into(template, flat: dict, device, prefix: str = ""):
    out = {}
    for k, leaf in template.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(leaf, dict):
            out[k] = _unflatten_into(leaf, flat, device, key)
            continue
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if isinstance(leaf, torch.Tensor):
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"{tuple(leaf.shape)}")
            out[k] = arr.to(device=leaf.device if device is None else device,
                            dtype=leaf.dtype)
        else:
            out[k] = type(leaf)(arr.item()) if arr.dim() == 0 else arr
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: dict, extra: Optional[dict] = None):
        """Save ``tree`` as step ``step``.  The copy to the host happens
        here, before returning (a consistent state); with ``async_save``
        the files are written on a thread (:meth:`wait` joins it)."""
        arrays, bf16 = _to_host(_flatten(tree))
        extra = dict(extra or {}, bfloat16=bf16)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, extra)

    def _write(self, step: int, arrays: dict, extra: dict):
        tmp = os.path.join(self.dir, f".tmp_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "time": time.time(),
                       "n_arrays": len(arrays), **extra}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: dict, device=None) -> dict:
        """Step ``step`` in the structure, shapes and dtypes of
        ``template``, each tensor on ``device`` (None: its template leaf's
        device)."""
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        bf16 = set(self.manifest(step).get("bfloat16", ()))
        with np.load(path) as z:
            flat = {k: torch.from_numpy(z[k]) for k in z.files}
        for k in bf16:
            flat[k] = flat[k].view(torch.bfloat16)
        return _unflatten_into(template, flat,
                               None if device is None else torch.device(device))

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}", "manifest.json")) as f:
            return json.load(f)
