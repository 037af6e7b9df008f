"""Debugging switches (port of `vislam_tpu/utils/debug.py`): NaN checks on
every operator, a device profile, and a step wrapped to report the first
operator that made a NaN.

The reference switches JAX's `jax_debug_nans`, `disable_jit`, the
profiler and `checkify`; the port runs eagerly, so a NaN check is a
`TorchDispatchMode` that looks at every operator's floating-point outputs
(one host read per operator: for debugging only), and the profile is
`torch.profiler`'s Chrome trace.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _has_nan(out):
    """True when a floating-point tensor among out's leaves holds a NaN."""
    return any(isinstance(t, torch.Tensor) and t.is_floating_point() and bool(t.isnan().any())
               for t in tree_leaves(out))


class NanCheck(TorchDispatchMode):
    """Checks each operator's floating-point outputs for NaN. raise_on_nan:
    raise FloatingPointError at the first operator that made one (as
    jax_debug_nans does); else record it in `first` (the operator's name)
    and go on."""

    def __init__(self, raise_on_nan: bool = True):
        super().__init__()
        self.raise_on_nan = raise_on_nan
        self.first = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.first is None and _has_nan(out):
            self.first = str(func)
            if self.raise_on_nan:
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True, disable_jit: bool = False):
    """NaN-guarded execution for debugging engine steps: with nan_checks,
    the first operator whose output holds a NaN raises FloatingPointError,
    its traceback at the Python line that called it. disable_jit is the
    reference's switch to op-by-op execution; the port always runs op by
    op, so it changes nothing."""
    with NanCheck() if nan_checks else contextlib.nullcontext():
        yield


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU, and the card's kernels where
    there is one), written as a Chrome trace `log_dir/trace.json` (open it
    in chrome://tracing or Perfetto). Yields log_dir."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepError:
    """What checkify_step found: `get()` the message (None when no
    operator made a NaN), `throw()` raises it as FloatingPointError."""

    def __init__(self, message=None):
        self.message = message

    def get(self):
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checkify_step(step_fn):
    """step_fn wrapped to run under a recording NaN check: the wrapped
    function returns (StepError, out), the error naming the first operator
    that made a NaN. (The reference's checkify also checks indices; a
    PyTorch index out of range raises by itself.)"""

    def checked(*args, **kwargs):
        mode = NanCheck(raise_on_nan=False)
        with mode:
            out = step_fn(*args, **kwargs)
        return StepError(None if mode.first is None else
                         f"NaN in the output of {mode.first}"), out

    return checked
