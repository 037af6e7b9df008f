"""Convert engine state, sequence inputs and bundle-adjustment problems
between numpy trees and the port's tensors.

`state_from_numpy` takes the reference's EngineState after
`jax.tree.map(np.asarray, state)` (any NamedTuple with the same field
names) and returns the port's EngineState on `device`; `state_to_numpy`
goes back. Both take a batched state as well (a leading B on every leaf,
as the reference's run_batch_scan takes it), and `inputs_from_numpy`
batched inputs ((B, N, ...) leaves, use_gt_scale shared);
`batch_from_numpy` stacks B per-sequence reference states and inputs
into the port's batch. `ba_from_numpy` does the same for the BA trees
(BAState, BAProblem, ImuFactors): array fields become tensors, the camera
intrinsics of a BAProblem stay floats, absent optional fields stay None.
Dtypes are kept: the window descriptor bank stays bfloat16,
masks stay bool, counters stay int32. This module imports neither jax, the
reference package nor ml_dtypes; a bfloat16 array back to numpy needs
numpy's "bfloat16" dtype, which ml_dtypes registers when jax is loaded.
"""

from __future__ import annotations

import numpy as np
import torch

from vislam_tpu_torch.backend.ba import BAProblem, BAState
from vislam_tpu_torch.backend.vi_ba import ImuFactors
from vislam_tpu_torch.engine.batch import SequenceInputs, make_batch_inputs
from vislam_tpu_torch.engine.state import EngineState, KeyframeWindow, stack_states
from vislam_tpu_torch.frontend.features import Features

_NESTED = {("EngineState", "kf_feat"): Features, ("EngineState", "window"): KeyframeWindow}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy knows "bfloat16" once ml_dtypes has registered it (jax does,
        # in the tests that compare against the reference).
        return t.view(torch.int16).numpy().view(np.uint16).view(np.dtype("bfloat16"))
    return t.numpy()


def _from(cls, tree, device):
    vals = {}
    for name in cls._fields:
        sub = _NESTED.get((cls.__name__, name))
        v = getattr(tree, name)
        vals[name] = _from(sub, v, device) if sub else _tensor(v, device)
    return cls(**vals)


def _to(tree):
    return type(tree)(*[_to(v) if isinstance(v, tuple) else
                        _array(v) if isinstance(v, torch.Tensor) else v for v in tree])


def state_from_numpy(tree, device) -> EngineState:
    """Reference EngineState (numpy leaves) -> the port's, on `device`."""
    return _from(EngineState, tree, device)


def state_to_numpy(state: EngineState) -> EngineState:
    """The port's EngineState -> the same NamedTuples with numpy leaves."""
    return _to(state)


def inputs_from_numpy(tree, device) -> SequenceInputs:
    """Reference SequenceInputs (numpy leaves; batched or not) -> the
    port's, on `device`. A use_gt_scale per sequence must be one value."""
    flags = np.unique(np.asarray(tree.use_gt_scale))
    if flags.size != 1:
        raise ValueError("the sequences of a batch share use_gt_scale")
    return SequenceInputs(
        images=_tensor(tree.images, device), imu=_tensor(tree.imu, device),
        imu_dt=_tensor(tree.imu_dt, device), gt_pos=_tensor(tree.gt_pos, device),
        use_gt_scale=bool(flags[0]))


def batch_from_numpy(states, inputs, device):
    """B reference EngineStates and SequenceInputs of one length (numpy
    leaves), one per sequence -> the port's batched state and inputs
    (`engine/batch.py::run_batch_scan`), on `device`."""
    return (stack_states([state_from_numpy(s, device) for s in states]),
            make_batch_inputs([inputs_from_numpy(i, device) for i in inputs]))


def inputs_to_numpy(inputs: SequenceInputs) -> SequenceInputs:
    """The port's SequenceInputs -> numpy leaves (use_gt_scale a numpy bool)."""
    return SequenceInputs(images=_array(inputs.images), imu=_array(inputs.imu),
                          imu_dt=_array(inputs.imu_dt), gt_pos=_array(inputs.gt_pos),
                          use_gt_scale=np.asarray(inputs.use_gt_scale))


_BA = {"BAState": BAState, "BAProblem": BAProblem, "ImuFactors": ImuFactors}
_INTRINSICS = ("fx", "fy", "cx", "cy")


def ba_from_numpy(tree, device):
    """A reference BAState, BAProblem or ImuFactors (numpy leaves; chosen by
    the tree's type name) -> the port's, on `device`."""
    cls = _BA[type(tree).__name__]
    vals = {}
    for name in cls._fields:
        v = getattr(tree, name, None)
        vals[name] = None if v is None else float(v) if name in _INTRINSICS \
            else _tensor(v, device)
    return cls(**vals)


def ba_to_numpy(tree):
    """The port's BAState, BAProblem or ImuFactors -> numpy leaves."""
    return _to(tree)
