"""vislam_tpu_torch's debugging switches (`utils/debug.py`) against
vislam_tpu's on the same inputs: the NaN check raises at the operator that
made a NaN, and only there; the profile is written; a checked step names
the first operator that made a NaN (the reference's checkify reports one
for the same function, and none for a clean one)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vislam_tpu.utils import debug as jdebug
from vislam_tpu_torch.utils import debug as tdebug

X = np.array([4.0, 1.0, -1.0, 9.0], np.float32)


def _step(x):
    """sqrt of x (NaN where x < 0), then a sum; the library's own op."""
    return (x.sqrt() * 2.0).sum() if isinstance(x, torch.Tensor) else jnp.sum(jnp.sqrt(x) * 2.0)


def test_debug_mode_raises_where_the_reference_does():
    with pytest.raises(FloatingPointError):
        with jdebug.debug_mode():
            _step(jnp.asarray(X)).block_until_ready()
    with pytest.raises(FloatingPointError, match="sqrt"):
        with tdebug.debug_mode():
            _step(torch.from_numpy(X))


def test_debug_mode_is_silent_on_clean_inputs_and_when_off():
    clean = np.abs(X)
    with tdebug.debug_mode(disable_jit=True):
        got = _step(torch.from_numpy(clean))
    with jdebug.debug_mode():
        want = _step(jnp.asarray(clean))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with tdebug.debug_mode(nan_checks=False):
        assert torch.isnan(_step(torch.from_numpy(X)))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tdebug.profile_trace(log_dir) as d:
        _step(torch.from_numpy(np.abs(X)))
    assert d == log_dir
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("sqrt" in e.get("name", "") for e in events)


def test_checkify_step_names_the_first_nan():
    err, out = tdebug.checkify_step(_step)(torch.from_numpy(X))
    assert torch.isnan(out) and "sqrt" in err.get()
    with pytest.raises(FloatingPointError, match="sqrt"):
        err.throw()
    j_err, _ = jdebug.checkify_step(_step)(jnp.asarray(X))
    assert j_err.get() is not None
    err, out = tdebug.checkify_step(_step)(torch.from_numpy(np.abs(X)))
    assert err.get() is None and torch.isfinite(out)
    err.throw()
    assert jdebug.checkify_step(_step)(jnp.asarray(np.abs(X)))[0].get() is None
