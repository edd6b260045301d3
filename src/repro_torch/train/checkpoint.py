"""Atomic, resumable checkpoints (port of ``repro/train/checkpoint.py``).

Layout: ``<dir>/step_<N>/state.pt`` (every tensor of the state, by name,
on the CPU, written with ``torch.save``) and ``manifest.json`` (the step,
names, shapes, dtypes and the file's sha256).  A save writes to a temporary
directory and publishes it with ``os.replace``, so a preempted save never
corrupts the newest checkpoint; ``keep`` bounds how many stay.  The format
is the port's own: it never reads ``repro``'s ``arrays.npz``.

The state's tensors are named by their path: a module's parameters by
``<key>/<parameter name>``, dict entries by key, list entries by index.
``restore`` copies the saved values into the tensors of a state of the
same structure (``like``), in place, so references to them (the model's
parameters) stay valid.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn


def named_tensors(obj: Any, prefix: str = ""
                  ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every tensor of a state with its path name (module docstring)."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif isinstance(obj, nn.Module):
        for name, p in obj.named_parameters():
            yield f"{prefix}/{name}", p
    elif isinstance(obj, dict):
        for key in sorted(obj):
            yield from named_tensors(obj[key], f"{prefix}/{key}")
    elif isinstance(obj, (list, tuple)):
        for i, item in enumerate(obj):
            yield from named_tensors(item, f"{prefix}/{i}")


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def save(ckpt_dir: str, step: int, state: Any, keep: int = 3) -> str:
    """Atomically persist ``state`` for ``step``; prune all but the newest
    ``keep`` checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {name: t.detach().cpu() for name, t in named_tensors(state)}
    torch.save(arrays, os.path.join(tmp, "state.pt"))
    manifest = {"step": step, "names": list(arrays),
                "shapes": {k: list(v.shape) for k, v in arrays.items()},
                "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
                "sha256": _digest(os.path.join(tmp, "state.pt"))}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    for s in latest_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def latest_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Copy checkpoint ``step`` (the newest by default) into ``like``'s
    tensors.  Returns (like, step); raises FileNotFoundError when there is
    none, IOError when the file fails its sha256, ValueError when the
    structure differs."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if _digest(os.path.join(path, "state.pt")) != manifest["sha256"]:
        raise IOError(f"checkpoint {path} fails its integrity check")
    data: Dict[str, torch.Tensor] = torch.load(
        os.path.join(path, "state.pt"), map_location="cpu",
        weights_only=True)
    targets = dict(named_tensors(like))
    if set(targets) != set(data):
        raise ValueError(f"checkpoint {path} holds {len(data)} tensors, the "
                         f"state {len(targets)}; they differ in "
                         f"{sorted(set(targets) ^ set(data))[:5]}")
    with torch.no_grad():
        for name, t in targets.items():
            if tuple(data[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: checkpoint "
                                 f"{tuple(data[name].shape)} vs state "
                                 f"{tuple(t.shape)}")
            t.copy_(data[name])
    return like, step
