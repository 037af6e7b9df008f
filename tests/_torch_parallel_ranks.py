"""Rank-side functions of tests/test_torch_parallel.py, run in ranks that
`vislam_tpu_torch.parallel.mesh.Ranks` spawned on the CPU (gloo). Only
torch, numpy and the port: the ranks import no JAX. Problems arrive as
dicts of numpy arrays (or the port's NamedTuples of CPU tensors) and the
results go back as numpy."""

import numpy as np
import torch

from vislam_tpu_torch.backend.ba import BAProblem, BAState
from vislam_tpu_torch.backend.vi_ba import ImuFactors
from vislam_tpu_torch.parallel.dist_ba import (
    dist_bundle_adjust,
    dist_vi_bundle_adjust,
    shard_problem,
)
from vislam_tpu_torch.parallel.mesh import (
    axis_position,
    make_global_mesh,
    make_mesh,
    refine_window_rank,
)


def _problem(p):
    return (BAState(R=p["R"], t=p["t"], X=p["X"]),
            BAProblem(obs_uv=p["obs"], obs_mask=p["mask"], fx=p["fx"], fy=p["fy"],
                      cx=p["cx"], cy=p["cy"]))


def _result(out_state, info, index, extra=()):
    return dict(R=out_state.R.numpy(), t=out_state.t.numpy(), X=out_state.X.numpy(),
                index=index, costs=info["costs"].numpy(),
                final_cost=float(info["final_cost"]),
                initial_cost=float(info["initial_cost"]),
                **{k: v.numpy() for k, v in extra})


def dist_ba(p, iters, local=None):
    """dist_bundle_adjust of the whole problem p, the landmarks sharded
    over a "map" mesh of every rank, or with `local` ranks per machine over
    the ("host", "map") mesh of make_global_mesh."""
    if local is None:
        mesh, axis = make_mesh(device_type="cpu"), "map"
    else:
        axis = ("host", "map")
        mesh = make_global_mesh(axis, (local,), device_type="cpu")
    st, pr = shard_problem(*_problem(p), mesh, axis=axis)
    out, info = dist_bundle_adjust(st, pr, mesh, axis=axis, iters=iters)
    return _result(out, info, axis_position(mesh, axis)[0])


def dist_vi_ba(p, v, fac, g_w, iters, bias):
    """dist_vi_bundle_adjust of p (fac: ImuFactors' fields, None where
    absent), with the shared bias from zero when `bias`."""
    mesh = make_mesh(device_type="cpu")
    st, pr = shard_problem(*_problem(p), mesh)
    kw = dict(bg0=np.zeros(3, np.float32), ba0=np.zeros(3, np.float32)) if bias else {}
    out, info = dist_vi_bundle_adjust(st, pr, v, ImuFactors(**fac), g_w,
                                      np.eye(3, dtype=np.float32), mesh, iters=iters, **kw)
    extra = [("v", out[1])] + ([("bg", out[2]), ("ba", out[3])] if bias else [])
    return _result(out[0], info, axis_position(mesh, "map")[0], extra)


def sharded_batch(calib, cfg, states, inputs, kf0, seed, noises):
    """run_batch_sharded of the whole batch over a "seq" mesh of every
    rank, gathered: (p_wc, is_keyframe, num_matches, final kf_count)."""
    from vislam_tpu_torch.engine import VIOEngine
    from vislam_tpu_torch.parallel.batch_runner import gather_batch, run_batch_sharded

    mesh = make_mesh(axis_names=("seq",), device_type="cpu")
    eng = VIOEngine(calib, cfg, device="cpu")
    final, res = run_batch_sharded(eng, states, inputs, kf0, mesh, seed=seed, noises=noises)
    final, res = gather_batch((final, res), mesh)
    return (res.p_wc.numpy(), res.is_keyframe.numpy(), res.num_matches.numpy(),
            final.kf_count.numpy())


def process_local_batch(seeds, n_frames, size, seed):
    """Each rank makes and stages only its own sequences of `seeds`
    (process_shard_range), then run_batch_sharded(process_local=True) and
    the gather; returns what sharded_batch returns."""
    from vislam_tpu_torch.data import SyntheticConfig, make_synthetic_sequence
    from vislam_tpu_torch.data.synthetic import synthetic_calib
    from vislam_tpu_torch.engine import (
        VIOEngine, make_batch_inputs, make_sequence_inputs, stack_states,
    )
    from vislam_tpu_torch.parallel.batch_runner import gather_batch, run_batch_sharded
    from vislam_tpu_torch.parallel.mesh import process_shard_range

    mesh = make_mesh(axis_names=("seq",), device_type="cpu")
    lo, hi = process_shard_range(len(seeds), *axis_position(mesh, "seq"))
    calib = synthetic_calib(*size)
    seqs = [make_synthetic_sequence(SyntheticConfig(n_frames=n_frames, n_landmarks=80,
                                                    seed=s), calib) for s in seeds[lo:hi]]
    eng = VIOEngine(calib, device="cpu")
    states = stack_states([eng.initialize(q["images"][0], q_wb0=q["gt_quat"][0],
                                          v_w0=q["gt_vel"][0], p_w0=q["gt_pos"][0])
                           for q in seqs])
    inputs = make_batch_inputs([make_sequence_inputs(q, device="cpu") for q in seqs])
    kf0 = np.stack([q["gt_pos"][0] for q in seqs]).astype(np.float32)
    final, res = run_batch_sharded(eng, states, inputs, kf0, mesh, seed=seed,
                                   process_local=True)
    final, res = gather_batch((final, res), mesh)
    return (res.p_wc.numpy(), res.is_keyframe.numpy(), res.num_matches.numpy(),
            final.kf_count.numpy())


def refine_distributed(state, cfg, intrinsics, R_bc):
    """refine_window_distributed over a "map" mesh of every rank: the
    window's positions (W, 3) and the info."""
    new, info, _ = refine_window_rank(state, cfg, intrinsics, R_bc, "cpu")
    p = -torch.einsum("wji,wj->wi", new.window.R_cw, new.window.t_cw)
    return p.numpy(), info


def world(n_mesh=None):
    """This rank's view of the group: (rank, world size, backend, the rank
    distributed_init returns when called again with no arguments), and the
    error a mesh of n_mesh ranks raises (None if it builds)."""
    import torch.distributed as dist

    from vislam_tpu_torch.parallel.mesh import distributed_init

    err = None
    if n_mesh is not None:
        try:
            make_mesh(n_mesh, device_type="cpu")
        except ValueError as e:
            err = str(e)
    return dist.get_rank(), dist.get_world_size(), dist.get_backend(), distributed_init(), err


def fail_on_rank(rank):
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} refuses")
    return dist.get_rank()


def process_local_uneven(n_seq):
    """run_batch_sharded(process_local=True) with this rank's slice of
    n_seq sequences as process_shard_range gives it (placeholder inputs of
    that many sequences): the message of the ValueError every rank must
    raise before any step when the slices differ in size, else None."""
    from vislam_tpu_torch.data.synthetic import synthetic_calib
    from vislam_tpu_torch.engine import VIOEngine
    from vislam_tpu_torch.engine.batch import SequenceInputs
    from vislam_tpu_torch.parallel.batch_runner import run_batch_sharded
    from vislam_tpu_torch.parallel.mesh import process_shard_range

    mesh = make_mesh(axis_names=("seq",), device_type="cpu")
    lo, hi = process_shard_range(n_seq, *axis_position(mesh, "seq"))
    b = hi - lo
    inputs = SequenceInputs(torch.zeros(b, 1, 8, 8), torch.zeros(b, 1, 2, 6),
                            torch.zeros(b, 1, 2), torch.zeros(b, 1, 3), use_gt_scale=True)
    try:
        run_batch_sharded(VIOEngine(synthetic_calib(16, 8), device="cpu"), None, inputs,
                          np.zeros((b, 3), np.float32), mesh, process_local=True)
    except ValueError as e:
        return str(e)
    return None


def cli_under_torchrun(argv, out_dir):
    """cli.main(argv + --output out_dir/r<rank>.csv) in this rank with
    torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK) set, the group
    already up: (exit code, the rows' est_p (F, 3), the report's dist_ba
    info and backend, whether the group is still up after main)."""
    import os

    import torch.distributed as dist

    from vislam_tpu_torch import cli

    rank, world = dist.get_rank(), dist.get_world_size()
    env = dict(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        report = {}
        code = cli.main([*argv, "--output", os.path.join(out_dir, f"r{rank}.csv")],
                        report=report)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    d = report["dist_ba"]
    return (code, np.array([r["est_p"] for r in report["rows"]]), d["info"], d["backend"],
            dist.is_initialized())
