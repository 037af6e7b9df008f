"""Engine state, per-frame step, sequence loop and batched sequences (port of
vislam_tpu.engine)."""

from vislam_tpu_torch.engine.state import (
    EngineState,
    KeyframeWindow,
    init_state,
    stack_states,
    unstack_states,
)
from vislam_tpu_torch.engine.engine import (
    FrameKey,
    FrameResult,
    HostFrameResult,
    VIOEngine,
    frame_key,
    unpack_host_result,
)
from vislam_tpu_torch.engine.batch import (
    SequenceInputs,
    batch_keys,
    make_batch_inputs,
    make_sequence_inputs,
    run_batch_scan,
    run_sequence_scan,
    sequence_key,
    stage_dataset,
)

__all__ = [
    "EngineState",
    "KeyframeWindow",
    "init_state",
    "stack_states",
    "unstack_states",
    "VIOEngine",
    "FrameResult",
    "FrameKey",
    "HostFrameResult",
    "frame_key",
    "unpack_host_result",
    "SequenceInputs",
    "make_sequence_inputs",
    "stage_dataset",
    "run_sequence_scan",
    "run_batch_scan",
    "make_batch_inputs",
    "batch_keys",
    "sequence_key",
]
