"""Helpers shared by the tests/test_torch_*.py files: carry JAX objects
across to the torch port as numpy leaves."""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import os
import shutil
import tempfile

import jax
import numpy as np
import torch
from jax._src import compilation_cache

# The port's tests share the pytest-xdist workers with the JAX tests, and
# their tensors are small: torch's intra-op thread pool would only compete
# with XLA for the cores (its idle threads spin), so each worker keeps one.
torch.set_num_threads(1)

# The eager JAX Renderer runs that the parity fixtures record compile their
# bounce loop again at every sample, and many of those programs repeat
# (within a run, across modules after conftest's jax.clear_caches(), and
# across workers). JAX's persistent compilation cache serves the repeats.
# The setting is process-wide: it reaches every JAX test that runs in the
# same worker after this module is imported (at collection). One directory
# per pytest-xdist run, shared by its workers, so every run starts cold; each
# process marks itself live beside it, and the last to exit removes both.
_RUN = os.environ.get("PYTEST_XDIST_TESTRUNUID", f"pid{os.getpid()}")
JAX_CACHE_DIR = os.path.join(tempfile.gettempdir(),
                             f"truetrace-jax-cache-{_RUN}")
_LIVE = JAX_CACHE_DIR + ".live"
_MARK = os.path.join(_LIVE, str(os.getpid()))


def _leave_cache():
    with contextlib.suppress(FileNotFoundError):
        os.remove(_MARK)
    with contextlib.suppress(OSError):
        os.rmdir(_LIVE)                 # only once no process is left
        shutil.rmtree(JAX_CACHE_DIR, ignore_errors=True)


os.makedirs(_LIVE, exist_ok=True)
open(_MARK, "w").close()
atexit.register(_leave_cache)
jax.config.update("jax_compilation_cache_dir", JAX_CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
# a compile before this point has already decided that the cache is off;
# reset_cache (a private module of jax, checked against jax 0.9.0) makes
# the next compile decide again
compilation_cache.reset_cache()


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
