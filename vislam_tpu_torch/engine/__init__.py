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
    FrameResult,
    HostFrameResult,
    VIOEngine,
    unpack_host_result,
)
from vislam_tpu_torch.engine.batch import (
    SequenceInputs,
    make_batch_inputs,
    make_sequence_inputs,
    run_batch_scan,
    run_sequence_scan,
    sequence_seed,
    stage_dataset,
)
