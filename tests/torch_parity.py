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
    """A JAX dataclass / NamedTuple / dict pytree -> nested dict of numpy
    leaves (Python scalars and None pass through)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: leaves(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: leaves(v) for k, v in obj.items()}
    return np.asarray(obj)


def close_share(a, b, rtol, atol):
    """Share of pixels (rows of the last axis) whose every channel agrees
    within rtol/atol."""
    return np.isclose(a, b, rtol=rtol, atol=atol).all(-1).mean()


def check_sample(jr, jst, tr, tst, share):
    """One path-traced sample of the JAX package (radiance jr [R,3], stats
    jst) against the port's (tr, tst): >= `share` of pixels within rtol
    1e-4 / atol 1e-5 and of G-buffer texels within 1e-5 / 1e-6, the image
    means to rtol 1e-4, and the same ray counts."""
    jr, tr = np.asarray(jr), tr.numpy()
    n = jr.shape[0]
    assert np.isfinite(tr).all()
    assert close_share(jr, tr, 1e-4, 1e-5) >= share
    np.testing.assert_allclose(jr.mean(0), tr.mean(0), rtol=1e-4)
    for k in ("albedo", "normal", "depth", "emitted0"):
        assert close_share(np.asarray(jst[k]).reshape(n, -1),
                           tst[k].numpy().reshape(n, -1), 1e-5,
                           1e-6) >= share, k
    assert float(jst["n_trace"]) == float(tst["n_trace"])
    assert float(jst["n_shadow"]) == float(tst["n_shadow"])
