"""vislam_tpu_torch against vislam_tpu: keyframe maps (`backend/mapio.py`).
The format is the reference's (the same .npz keys, dtypes and version), so
a map written by either package loads in the other with every array equal,
and a map of another version is refused by both."""

import numpy as np
import pytest

from vislam_tpu.backend import mapio as jmap
from vislam_tpu.backend.trajectory_opt import KeyframeRecord as JRecord
from vislam_tpu_torch.backend import mapio as tmap
from vislam_tpu_torch.backend.trajectory_opt import KeyframeRecord as TRecord

KEYS = {"version": np.int64, "frame_index": np.int64, "R_wc": np.float32,
        "p_wc": np.float32, "uv": np.float32, "desc": np.float32, "kp_mask": np.bool_}


def _archive(rng, cls, n=5, K=40, D=128):
    return [cls(frame_index=3 * i + 1,
                R_wc=rng.normal(size=(3, 3)).astype(np.float32),
                p_wc=rng.normal(size=3).astype(np.float32),
                uv=rng.uniform(0, 700, (K, 2)).astype(np.float32),
                desc=rng.normal(size=(K, D)).astype(np.float32),
                kp_mask=rng.uniform(size=K) > 0.3) for i in range(n)]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.frame_index == y.frame_index and isinstance(y.frame_index, int)
        for k in ("R_wc", "p_wc", "uv", "desc", "kp_mask"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
            assert getattr(y, k).dtype == getattr(x, k).dtype


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_maps_cross_between_packages(tmp_path, rng, writer):
    """Written by one package, loaded by both: equal records; the file has
    the reference's keys and dtypes."""
    save, cls = (jmap.save_map, JRecord) if writer == "reference" else (tmap.save_map, TRecord)
    arch = _archive(rng, cls)
    path = str(tmp_path / "map.npz")
    save(path, arch)
    with np.load(path) as z:
        assert {k: z[k].dtype.type for k in z.files} == KEYS
        assert int(z["version"]) == 1
    _equal(arch, tmap.load_map(path))
    _equal(arch, jmap.load_map(path))
    assert all(isinstance(k, TRecord) for k in tmap.load_map(path))


def test_map_version_and_empty_archive_are_refused(tmp_path, rng):
    path = str(tmp_path / "v2.npz")
    tmap.save_map(path, _archive(rng, TRecord, n=2))
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    np.savez_compressed(path, **{**fields, "version": np.int64(2)})
    for load in (tmap.load_map, jmap.load_map):
        with pytest.raises(ValueError, match="version 2"):
            load(path)
    with pytest.raises(ValueError, match="empty"):
        tmap.save_map(str(tmp_path / "e.npz"), [])
