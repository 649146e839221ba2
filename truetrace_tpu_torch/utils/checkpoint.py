"""Checkpoint and resume for long renders and optimisation loops.

Port of `truetrace_tpu/utils/checkpoint.py`'s npz path (the JAX
package's layout without orbax): `<path>/state.npz` holds the state's
leaves as arr_0, arr_1, ... in JAX's flatten order (dict keys sorted,
lists and tuples in order, a dataclass's tensor fields in field order,
None no leaf), `<path>/treedef.txt` a description of the structure.
Restoring needs a template of the same structure: the leaves go back
onto the template's devices and dtypes. The state is whatever a loop
carries: {"params": a diff/render_grad.py parameter dict, "sample": int,
"accum": Accumulator, "svgf": SVGFState, ...}.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _is_node(x) -> bool:
    return (x is None or isinstance(x, (dict, list, tuple))
            or dataclasses.is_dataclass(x))


def _children(x):
    """(keys, values) of a container, in JAX's flatten order. A
    dataclass's fields that hold no tensor and no container (a flax
    struct's static fields) are not children."""
    if isinstance(x, dict):
        keys = sorted(x)
        return keys, [x[k] for k in keys]
    if isinstance(x, (list, tuple)):
        return list(range(len(x))), list(x)
    keys = [f.name for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)
            or _is_node(getattr(x, f.name))]
    return keys, [getattr(x, k) for k in keys]


def _flatten(x, out: List) -> None:
    if x is None:
        return
    if not _is_node(x):
        out.append(x)
        return
    for v in _children(x)[1]:
        _flatten(v, out)


def _unflatten(template, it):
    if template is None:
        return None
    if not _is_node(template):
        leaf = next(it)
        if isinstance(template, torch.Tensor):
            return torch.from_numpy(np.asarray(leaf)).to(
                device=template.device, dtype=template.dtype)
        return type(template)(np.asarray(leaf)[()])
    keys, vals = _children(template)
    new = [_unflatten(v, it) for v in vals]
    if isinstance(template, dict):
        return dict(zip(keys, new))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*new)
    if isinstance(template, (list, tuple)):
        return type(template)(new)
    return dataclasses.replace(template, **dict(zip(keys, new)))


def _describe(x) -> str:
    if x is None:
        return "None"
    if not _is_node(x):
        return "*"
    keys, vals = _children(x)
    inner = ", ".join(f"{k}: {_describe(v)}" for k, v in zip(keys, vals))
    return f"{type(x).__name__}({inner})"


def save_render_state(path: str, state: Dict[str, Any]) -> None:
    """Write `state` (a tree of dicts, lists, dataclasses, tensors and
    Python numbers) to the directory `path`."""
    path = os.path.abspath(path)
    flat: List = []
    _flatten(state, flat)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "state.npz"),
             *[x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
               else np.asarray(x) for x in flat])
    with open(os.path.join(path, "treedef.txt"), "w") as f:
        f.write(_describe(state))


def restore_render_state(path: str, template: Dict[str, Any]
                         ) -> Optional[Dict[str, Any]]:
    """The state saved at `path`, in the structure of `template` (its
    leaves on the template's devices, in its dtypes), or None if there is
    no checkpoint."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        return None
    npz = np.load(os.path.join(path, "state.npz"))
    flat: List = []
    _flatten(template, flat)
    if len(npz.files) != len(flat):
        raise ValueError(f"{path} holds {len(npz.files)} leaves, the "
                         f"template {len(flat)}")
    return _unflatten(template, iter(npz[f"arr_{i}"]
                                     for i in range(len(flat))))
