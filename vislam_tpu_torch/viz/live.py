"""Live run observability (port of `vislam_tpu/viz/live.py`): the runner
calls update() per frame, and a trajectory snapshot PNG is rewritten
atomically every `every_kf` keyframes, so any image viewer or file watcher
follows the run; nothing blocks, and a crashed run leaves its last
snapshot behind.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class LiveViz:
    """Accumulates per-frame positions; re-renders <prefix>_live.png every
    `every_kf` keyframe promotions (and on close())."""

    def __init__(self, prefix: str, every_kf: int = 5):
        self.prefix = prefix
        self.every_kf = max(int(every_kf), 1)
        self._est = []
        self._gt = []
        self._kf_idx = []
        self._frames = []
        self._kf_since_render = 0
        self._renders = 0
        os.makedirs(os.path.dirname(os.path.abspath(prefix)) or ".", exist_ok=True)

    def update(self, frame_index: int, p_est, p_gt=None, is_keyframe: bool = False) -> None:
        self._frames.append(int(frame_index))
        self._est.append(np.asarray(p_est, np.float64))
        self._gt.append(None if p_gt is None else np.asarray(p_gt, np.float64))
        if is_keyframe:
            self._kf_idx.append(len(self._est) - 1)
            self._kf_since_render += 1
            if self._kf_since_render >= self.every_kf:
                self.render()

    def render(self) -> Optional[str]:
        if len(self._est) < 2:
            return None
        from vislam_tpu_torch.viz.plots import _mpl

        plt = _mpl()
        est = np.stack(self._est)
        gt = (np.stack([g for g in self._gt if g is not None])
              if all(g is not None for g in self._gt) and self._gt else None)
        fig, axes = plt.subplots(1, 2, figsize=(11, 5))
        for ax, (i, j, name) in zip(axes, [(0, 1, "XY"), (0, 2, "XZ")]):
            ax.plot(est[:, i], est[:, j], "b-", lw=1.2, label="estimate")
            if gt is not None and len(gt) == len(est):
                ax.plot(gt[:, i], gt[:, j], "k--", lw=1.0, label="GT")
            if self._kf_idx:
                kf = est[self._kf_idx]
                ax.plot(kf[:, i], kf[:, j], "r.", ms=4, label="keyframes")
            ax.plot(est[-1, i], est[-1, j], "g*", ms=12, label="current")
            ax.set_title(f"{name} — frame {self._frames[-1]} ({len(self._kf_idx)} kf)")
            ax.set_aspect("equal", adjustable="datalim")
            ax.grid(True, alpha=0.3)
        axes[0].legend(loc="best", fontsize=8)
        fig.tight_layout()
        # Atomic replace: a watcher never sees a half-written PNG.
        out = f"{self.prefix}_live.png"
        tmp = f"{self.prefix}_live.tmp.png"
        fig.savefig(tmp, dpi=90)
        plt.close(fig)
        os.replace(tmp, out)
        self._kf_since_render = 0
        self._renders += 1
        return out

    def close(self) -> Optional[str]:
        return self.render()
