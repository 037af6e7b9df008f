"""Engine state, per-frame step and sequence loop (port of vislam_tpu.engine)."""

from vislam_tpu_torch.engine.state import EngineState, KeyframeWindow, init_state
from vislam_tpu_torch.engine.engine import FrameResult, VIOEngine
from vislam_tpu_torch.engine.batch import (
    SequenceInputs,
    make_sequence_inputs,
    run_sequence_scan,
)
