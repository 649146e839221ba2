"""Helpers shared by the tests/test_torch_*.py files: carry JAX objects
across to the torch port as numpy leaves."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# The port's tests share the pytest-xdist workers with the JAX tests, and
# their tensors are small: torch's intra-op thread pool would only compete
# with XLA for the cores (its idle threads spin), so each worker keeps one.
torch.set_num_threads(1)


def leaves(obj):
    """A JAX dataclass / NamedTuple pytree -> nested dict of numpy leaves
    (Python scalars and None pass through)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: leaves(v) for k, v in obj._asdict().items()}
    return np.asarray(obj)
