"""vislam_tpu_torch's `parallel/` (torch.distributed) against vislam_tpu's
(shard_map on the 8-device virtual CPU mesh of tests/conftest.py) and
against the port's own one-process paths.

The port's distributed cases run in one pool of 4 ranks spawned for this
file (gloo on the CPU, one thread each, every wait bounded), the problems
made here with numpy and handed to both packages. Tolerances:
- the landmark-sharded BA against the one-process solve and the
  reference's sharded one: tests/test_parallel.py's (final cost rtol
  1e-3, R 1e-4, t 1e-3, X 5e-3; VI at full convergence, 20 iterations:
  t and v 2e-3; with the online bias v 1e-2, bg 1e-3, ba 1e-2): gloo's
  ring sum, the psum over 8 devices and a one-process sum round
  differently, and the LM's accept decisions follow the round-off;
- the 2 x 2 ("host", "map") mesh: tests/test_multiprocess.py's (cost rtol
  1e-3, R 1e-4, t 1e-3);
- run_batch_sharded (4 ranks x 2 sequences) against the port's
  run_batch_scan of the 8 in one process: positions within 1e-5 m (a
  batch of 2 and one of 8 round their batched convolutions differently)
  and keyframes equal; against the reference's run_batch_sharded on the
  reference's draws: 2e-3 m and keyframes equal (tests/test_torch_batch.py's
  float32 bound);
- refine_window_distributed against the reference's: window positions
  within 1e-3 m (measured 5e-7 m; ROADMAP.md queue 3's stated VI-BA limit
  is 1e-2 m, since 1 ulp moves the reference's VI-BA by 3 mm on some
  windows) and final cost rtol 1e-3, on a window the reference's refine
  moves by more than 1e-2 m, so a refine that leaves it be fails;
- the CLI's --dist-ba 4 under torchrun's environment in the pool's ranks
  against its spawned ranks in this process (one thread, as a rank):
  every trajectory row equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rsp

import _torch_parallel_ranks as ranks_fns
from test_backend import CX, CY, FX, FY, _make_window
from test_torch_engine import _imu, _jax_noise
from test_vi_ba import G, _window
from vislam_tpu.backend import BAProblem as JProblem
from vislam_tpu.backend import BAState as JState
from vislam_tpu.data import SyntheticConfig, make_synthetic_sequence
from vislam_tpu.data.synthetic import synthetic_calib as j_calib
from vislam_tpu.engine import VIOEngine as JEngine
from vislam_tpu.engine import make_sequence_inputs as j_inputs
from vislam_tpu.engine.refine import refine_window_distributed as j_refine_distributed
from vislam_tpu.parallel import dist_bundle_adjust as j_dist_ba
from vislam_tpu.parallel import dist_vi_bundle_adjust as j_dist_vi_ba
from vislam_tpu.parallel import make_mesh as j_make_mesh
from vislam_tpu.parallel import shard_problem as j_shard_problem
from vislam_tpu.parallel.batch_runner import run_batch_sharded as j_run_batch_sharded
from vislam_tpu.parallel.mesh import process_shard_range as j_process_shard_range
from vislam_tpu.utils.config import SystemConfig as JSystem
from vislam_tpu_torch.backend import ba as tba
from vislam_tpu_torch.backend import vi_ba as tvi
from vislam_tpu_torch.data.synthetic import synthetic_calib
from vislam_tpu_torch.engine import (
    VIOEngine as TEngine,
    make_batch_inputs,
    make_sequence_inputs,
    run_batch_scan,
    stack_states,
)
from vislam_tpu_torch.parallel.dist_ba import shard_landmarks
from vislam_tpu_torch.parallel.mesh import (
    Ranks,
    backend_for,
    distributed_init,
    launch,
    process_shard_range,
)
from vislam_tpu_torch.utils import config as tconfig
from vislam_tpu_torch.utils.convert import batch_from_numpy, state_from_numpy

torch.set_num_threads(2)
N_RANKS = 4
BATCH = 8           # sequences of the sharded batch: 4 ranks x 2
BATCH_FRAMES = 4    # frames stepped per sequence
BATCH_SIZE = (160, 120)


@pytest.fixture(scope="module")
def ranks():
    with Ranks(N_RANKS, device="cpu", timeout_s=240) as r:
        yield r


def _perturbed_problem(rng, L=96):
    """tests/test_parallel.py's perturbed window (W = 5), as numpy."""
    X, R_cw, t_cw, obs, mask = _make_window(rng, W=5, L=L, noise_px=0.3)
    R_p, t_p = R_cw.copy(), t_cw.copy()
    for k in range(1, len(R_cw)):
        R_p[k] = Rsp.from_rotvec(rng.normal(scale=0.008, size=3)).as_matrix() @ R_cw[k]
        t_p[k] = t_cw[k] + rng.normal(scale=0.04, size=3)
    X_p = X + rng.normal(scale=0.15, size=X.shape)
    f32 = np.float32
    return dict(R=R_p.astype(f32), t=t_p.astype(f32), X=X_p.astype(f32), obs=obs.astype(f32),
                mask=mask, fx=FX, fy=FY, cx=CX, cy=CY)


def _jax(p):
    return (JState(R=jnp.asarray(p["R"]), t=jnp.asarray(p["t"]), X=jnp.asarray(p["X"])),
            JProblem(jnp.asarray(p["obs"]), jnp.asarray(p["mask"]),
                     p["fx"], p["fy"], p["cx"], p["cy"]))


def _torch(p):
    return (tba.BAState(*[torch.tensor(p[k]) for k in ("R", "t", "X")]),
            tba.BAProblem(torch.tensor(p["obs"]), torch.tensor(p["mask"]),
                          p["fx"], p["fy"], p["cx"], p["cy"]))


def _landmarks(results):
    """The ranks' landmark shards in shard order, concatenated."""
    return np.concatenate([r["X"] for r in sorted(results, key=lambda r: r["index"])])


def _hold(results, R, t, X, cost=None, t_tol=1e-3, other=()):
    """Every rank's poses (the same on every rank) and the shards'
    landmarks against a solve at tests/test_parallel.py's tolerances (the
    final cost too where given)."""
    for r in results:
        if cost is not None:
            np.testing.assert_allclose(r["final_cost"], cost, rtol=1e-3)
        np.testing.assert_allclose(r["R"], R, atol=1e-4)
        np.testing.assert_allclose(r["t"], t, atol=t_tol)
        for name, want, tol in other:
            np.testing.assert_allclose(r[name], want, atol=tol, err_msg=name)
    np.testing.assert_allclose(_landmarks(results)[:len(X)], X, atol=5e-3)


@pytest.mark.parametrize("n,p,c", [(10, p, 4) for p in range(4)] + [(8, 3, 8), (3, 2, 4),
                                                                      (7, 0, 3), (0, 1, 2)])
def test_process_shard_range_matches_reference(n, p, c):
    assert process_shard_range(n, p, c) == j_process_shard_range(n, p, c)


def test_process_shard_range_covers_every_item():
    spans = [process_shard_range(10, p, 4) for p in range(4)]
    assert spans == [(0, 3), (3, 6), (6, 8), (8, 10)]


def test_launch_reports_each_rank_and_a_failing_one():
    """launch starts fresh gloo ranks on the CPU (device "cpu"): each sees
    the group, distributed_init is idempotent there, a mesh larger than the
    group raises; a rank's exception reaches the caller with its
    traceback, and every rank is stopped."""
    out = launch(ranks_fns.world, 2, args=(4,), device="cpu", timeout_s=120)
    assert [o[:4] for o in out] == [(0, 2, "gloo", 0), (1, 2, "gloo", 1)]
    assert all("a 4-rank mesh needs a process group of 4 ranks" in o[4] for o in out)
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank 1 refuses"):
        launch(ranks_fns.fail_on_rank, 2, args=(1,), device="cpu", timeout_s=120)


def test_backend_rule_and_missing_rendezvous(monkeypatch):
    """gloo on the CPU; on the card NCCL when every rank has one, gloo when
    they share (without a card, asking for one raises); distributed_init
    with no address, size or rank anywhere raises instead of waiting."""
    assert backend_for("cpu", 4) == "gloo"
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert backend_for("cuda", n) == "nccl" and backend_for("cuda", n + 1) == "gloo"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            backend_for("cuda", 1)
    for name in ("VISLAM_COORDINATOR", "VISLAM_NUM_PROCESSES", "VISLAM_PROCESS_ID",
                 "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator address"):
        distributed_init(device="cpu")


@pytest.mark.parametrize("L,per", [(96, 12), (100, 13)])
def test_shard_landmarks_sizes_and_padding(rng, L, per):
    """L over 8 shards: 12 each (96), or padded to 104 with ones, masked
    zero observations (100); each shard equals the reference's shard on
    the 8-device mesh."""
    p = _perturbed_problem(rng, L=L)
    st, pr = _torch(p)
    j_st, j_pr = j_shard_problem(*_jax(p), j_make_mesh(8))
    j_X = {s.index[0].start or 0: np.asarray(s.data) for s in j_st.X.addressable_shards}
    j_obs = {s.index[1].start or 0: np.asarray(s.data) for s in j_pr.obs_uv.addressable_shards}
    for i in range(8):
        s, q = shard_landmarks(st, pr, i, 8, "cpu")
        assert s.X.shape == (per, 3) and q.obs_uv.shape == (5, per, 2)
        assert q.obs_mask.shape == (5, per) and torch.equal(s.R, st.R)
        np.testing.assert_array_equal(s.X.numpy(), j_X[i * per])
        np.testing.assert_array_equal(q.obs_uv.numpy(), j_obs[i * per])
        if i * per + per > L:
            assert (s.X[L - i * per:] == 1).all() and not q.obs_mask[:, L - i * per:].any()


def test_dist_ba_matches_single_and_reference(rng, ranks):
    """Vision only, 8 iterations on 4 ranks: the port's one-process
    bundle_adjust and the reference's dist_bundle_adjust on 8 devices."""
    p = _perturbed_problem(rng)
    res = ranks.run(ranks_fns.dist_ba, p, 8)
    assert res[0]["costs"].shape == (8,) and res[0]["final_cost"] < res[0]["initial_cost"]
    one, info = tba.bundle_adjust(*_torch(p), iters=8)
    _hold(res, one.R.numpy(), one.t.numpy(), one.X.numpy(), float(info["final_cost"]))
    st, pr = j_shard_problem(*_jax(p), j_make_mesh(8))
    ref, j_info = j_dist_ba(st, pr, j_make_mesh(8), iters=8)
    _hold(res, np.asarray(ref.R), np.asarray(ref.t), np.asarray(ref.X)[:96],
          float(j_info["final_cost"]))


def test_dist_ba_pads_uneven_landmarks(rng, ranks):
    """L = 98 over 4 ranks pads to 100: the cost falls, every value finite."""
    res = ranks.run(ranks_fns.dist_ba, _perturbed_problem(rng, L=98), 6)
    assert _landmarks(res).shape == (100, 3) and np.isfinite(_landmarks(res)).all()
    assert all(r["final_cost"] < r["initial_cost"] for r in res)


def test_dist_ba_on_host_map_mesh(ranks):
    """make_global_mesh's 2 x 2 ("host", "map") mesh (2 ranks per
    machine), the sum over both axes, on tests/test_multiprocess.py's
    problem (seed 1234): the one-process solve."""
    p = _perturbed_problem(np.random.default_rng(1234))
    res = ranks.run(ranks_fns.dist_ba, p, 8, 2)
    assert sorted(r["index"] for r in res) == [0, 1, 2, 3]
    one, info = tba.bundle_adjust(*_torch(p), iters=8)
    _hold(res, one.R.numpy(), one.t.numpy(), one.X.numpy(), float(info["final_cost"]))


def _vi_problem(rng, scale_err=0.7):
    """tests/test_parallel.py's VI window (W = 6, L = 96) with a global
    scale error, as numpy: the problem, velocities, factors."""
    R_cw, t_cw, v, p, X, fac, prob = _window(rng, W=6, L=96)
    p0 = np.asarray(p)[0]
    p_s = p0 + scale_err * (np.asarray(p) - p0)
    X_s = p0 + scale_err * (np.asarray(X) - p0)
    t_s = -np.einsum("wij,wj->wi", np.asarray(R_cw), p_s)
    f32 = np.float32
    problem = dict(R=np.asarray(R_cw, f32), t=t_s.astype(f32), X=X_s.astype(f32),
                   obs=np.asarray(prob.obs_uv, f32), mask=np.asarray(prob.obs_mask),
                   fx=prob.fx, fy=prob.fy, cx=prob.cx, cy=prob.cy)
    return problem, (scale_err * np.asarray(v)).astype(f32), fac


def _vi_fields(fac, bias, W):
    """The factors' fields as numpy (None where absent); with `bias`, the
    reference test's zero bias Jacobians (exact factors integrated at the
    reference bias)."""
    if bias:
        z, z3 = jnp.zeros((W, 3, 3), jnp.float32), jnp.zeros((W, 3), jnp.float32)
        fac = fac._replace(J_R_bg=z, J_v_bg=z, J_v_ba=z, J_p_bg=z, J_p_ba=z,
                           bg_ref=z3, ba_ref=z3)
    return fac, {k: None if x is None else np.asarray(x) for k, x in fac._asdict().items()}


def _reference_dist_vi(p, v, fac, iters, bias):
    mesh = j_make_mesh(8)
    zero = dict(bg0=jnp.zeros(3), ba0=jnp.zeros(3)) if bias else {}
    return j_dist_vi_ba(*j_shard_problem(*_jax(p), mesh), jnp.asarray(v), fac, jnp.asarray(G),
                        jnp.eye(3, dtype=jnp.float32), mesh, iters=iters, **zero)


def _vi_other(vel, b, bias):
    other = [("v", np.asarray(vel), 1e-2 if bias else 2e-3)]
    if bias:
        other += [("bg", np.asarray(b[0]), 1e-3), ("ba", np.asarray(b[1]), 1e-2)]
    return other


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "online_bias"])
def test_dist_vi_ba_matches_single_and_reference(rng, ranks, bias):
    """6 LM iterations of the landmark-sharded VI-BA on 4 ranks against the
    port's one-process vi_bundle_adjust (with the distributed form's bias
    prior weights, 1e4 and 3e3) and the reference's dist_vi_bundle_adjust
    on 8 devices. 6, not the reference test's 20: on this exact-data
    window the LM's accept decisions branch on round-off from the 8th
    iteration on (measured at 8: 2e-3 m between any two of the three
    solves; at 10: 0.2 m), while at 6 all three agree within 6e-5 m."""
    p, v, fac = _vi_problem(rng)
    fac, fields = _vi_fields(fac, bias, p["R"].shape[0])
    res = ranks.run(ranks_fns.dist_vi_ba, p, v, fields, G, 6, bias)
    prior = dict(bg0=torch.zeros(3), ba0=torch.zeros(3), w_bg_prior=1e4,
                 w_ba_prior=3e3) if bias else {}
    one, info = tvi.vi_bundle_adjust(
        *_torch(p), torch.tensor(v),
        tvi.ImuFactors(**{k: None if x is None else torch.tensor(x) for k, x in fields.items()}),
        torch.tensor(G), torch.eye(3), iters=6, **prior)
    assert int(info["iters_run"]) == 6
    ref, j_info = _reference_dist_vi(p, v, fac, 6, bias)
    for (st, vel, *b), cost in ((one, float(info["final_cost"])),
                                (ref, float(j_info["final_cost"]))):
        R, t, X = (np.asarray(x) for x in st)
        _hold(res, R, t, X[:96], cost, t_tol=2e-3, other=_vi_other(vel, b, bias))


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "online_bias"])
def test_dist_vi_ba_converges_like_reference(rng, ranks, bias):
    """tests/test_parallel.py's comparison at full convergence (20
    iterations, final cost < 1e-4 on every rank and in the reference's
    dist_vi_bundle_adjust): the state at its tolerances (R 1e-4, t 2e-3,
    X 5e-3, v 2e-3; with the online bias v 1e-2, bg 1e-3, ba 1e-2 and, as
    there, no bound on poses and landmarks: the bias priors leave the
    optimum flat)."""
    p, v, fac = _vi_problem(rng)
    fac, fields = _vi_fields(fac, bias, p["R"].shape[0])
    res = ranks.run(ranks_fns.dist_vi_ba, p, v, fields, G, 20, bias)
    ref, j_info = _reference_dist_vi(p, v, fac, 20, bias)
    assert float(j_info["final_cost"]) < 1e-4
    for r in res:
        assert r["final_cost"] < 1e-4
    st, vel, *b = ref
    if bias:
        for r in res:
            for name, want, tol in _vi_other(vel, b, bias):
                np.testing.assert_allclose(r[name], want, atol=tol, err_msg=name)
    else:
        R, t, X = (np.asarray(x) for x in st)
        _hold(res, R, t, X[:96], t_tol=2e-3, other=_vi_other(vel, b, bias))


def _batch_seqs():
    calib = j_calib(*BATCH_SIZE)
    return [make_synthetic_sequence(SyntheticConfig(n_frames=BATCH_FRAMES + 1,
                                                    n_landmarks=80, seed=s), calib)
            for s in range(BATCH)]


def test_run_batch_sharded_equals_one_process_batch(ranks):
    """4 ranks x 2 sequences, each rank making and staging only its own
    (process_local): the port's run_batch_scan of the 8 in one process, on
    each entry's global draws."""
    p, kf, nm, kfc = ranks.run(ranks_fns.process_local_batch, list(range(BATCH)),
                               BATCH_FRAMES + 1, BATCH_SIZE, 5)[0]
    from vislam_tpu_torch.data import SyntheticConfig as TConfig
    from vislam_tpu_torch.data import make_synthetic_sequence as t_make

    calib = synthetic_calib(*BATCH_SIZE)
    seqs = [t_make(TConfig(n_frames=BATCH_FRAMES + 1, n_landmarks=80, seed=s), calib)
            for s in range(BATCH)]
    eng = TEngine(calib, device="cpu")
    states = stack_states([eng.initialize(q["images"][0], q_wb0=q["gt_quat"][0],
                                          v_w0=q["gt_vel"][0], p_w0=q["gt_pos"][0])
                           for q in seqs])
    inputs = make_batch_inputs([make_sequence_inputs(q, device="cpu") for q in seqs])
    final, res = run_batch_scan(eng, states, inputs,
                                np.stack([q["gt_pos"][0] for q in seqs]).astype(np.float32),
                                seed=5)
    assert p.shape == (BATCH, BATCH_FRAMES, 3) and kf.any()
    np.testing.assert_array_equal(kf, res.is_keyframe.numpy())
    np.testing.assert_array_equal(nm, res.num_matches.numpy())
    np.testing.assert_array_equal(kfc, final.kf_count.numpy())
    np.testing.assert_allclose(p, res.p_wc.numpy(), rtol=0, atol=1e-5)


def test_run_batch_sharded_matches_reference(ranks):
    """The reference's run_batch_sharded of 8 sequences on a 4-device "seq"
    mesh, and the port's over 4 ranks from the reference's converted
    states, on the reference's draws (entry b's frame n: fold_in(split(
    PRNGKey(0), 8)[b], n), rescue fold_in 7), the float32 image pipeline."""
    seqs = _batch_seqs()
    jcfg = dataclasses.replace(JSystem(), frontend=dataclasses.replace(
        JSystem().frontend, image_dtype="float32"))
    jeng = JEngine(seqs[0]["calib"], jcfg)
    jstates = [jeng.initialize(q["images"][0], q_wb0=q["gt_quat"][0], v_w0=q["gt_vel"][0],
                               p_w0=q["gt_pos"][0]) for q in seqs]
    jins = [j_inputs(q) for q in seqs]
    kf0 = np.stack([q["gt_pos"][0] for q in seqs]).astype(np.float32)
    _, jres = j_run_batch_sharded(
        jeng, jax.tree.map(lambda *xs: jnp.stack(xs), *jstates),
        jax.tree.map(lambda *xs: jnp.stack(xs) if xs[0].ndim > 0 else xs[0], *jins),
        jnp.asarray(kf0), j_make_mesh(4, axis_names=("seq",)), axis="seq")

    states, inputs = batch_from_numpy([jax.tree.map(np.asarray, s) for s in jstates],
                                      [jax.tree.map(np.asarray, i) for i in jins], "cpu")
    M = states.kf_feat.uv.shape[-2]
    keys = jax.random.split(jax.random.PRNGKey(0), BATCH)
    noises = [[(_jax_noise(k, M), _jax_noise(jax.random.fold_in(k, 7), M))
               for k in (jax.random.fold_in(keys[b], n) for n in range(BATCH_FRAMES))]
              for b in range(BATCH)]
    tcfg = dataclasses.replace(tconfig.SystemConfig(), frontend=dataclasses.replace(
        tconfig.SystemConfig().frontend, image_dtype="float32"))
    p, kf, nm, _ = ranks.run(ranks_fns.sharded_batch, synthetic_calib(*BATCH_SIZE), tcfg,
                             states, inputs, kf0, 0, noises)[0]
    np.testing.assert_array_equal(kf, np.asarray(jres.is_keyframe))
    assert np.abs(nm - np.asarray(jres.num_matches)).max() <= 2
    np.testing.assert_allclose(p, np.asarray(jres.p_wc), atol=2e-3)


REFINE_FRAMES = 12


def test_refine_window_distributed_matches_reference(ranks):
    """The reference's GT-scale run with IMU factors in the window (12
    frames, seed 0), then refine_window_distributed of its final window:
    the reference's on a 4-device "map" mesh, the port's on 4 ranks from
    the converted state; both accept, window positions within 1e-2 m."""
    seq = make_synthetic_sequence(SyntheticConfig(n_frames=REFINE_FRAMES + 1,
                                                  n_landmarks=300, seed=0))
    jcfg = dataclasses.replace(JSystem(), backend=dataclasses.replace(
        JSystem().backend, vi_factors=True))
    eng = JEngine(seq["calib"], jcfg)
    state = eng.initialize(seq["images"][0], q_wb0=seq["gt_quat"][0],
                           v_w0=seq["gt_vel"][0], p_w0=seq["gt_pos"][0])
    last_kf = 0
    for j in range(1, REFINE_FRAMES + 1):
        imu, dt = _imu(seq, j)
        g = float(np.linalg.norm(seq["gt_pos"][j] - seq["gt_pos"][last_kf]))
        state, res = eng.step(state, seq["images"][j], imu, dt, g)
        last_kf = j if bool(res.is_keyframe) else last_kf
    tree = jax.tree.map(np.asarray, state)
    assert int(tree.window.count) >= 4
    c = seq["calib"]
    R_bc = np.asarray(c.T_body_cam[:3, :3], np.float32)
    j_new, j_info = j_refine_distributed(state, jcfg, c.fx, c.fy, c.cx, c.cy,
                                         mesh=j_make_mesh(4), R_bc=R_bc)
    tcfg = dataclasses.replace(tconfig.SystemConfig(), backend=dataclasses.replace(
        tconfig.SystemConfig().backend, vi_factors=True))
    out = ranks.run(ranks_fns.refine_distributed, state_from_numpy(tree, "cpu"), tcfg,
                    (c.fx, c.fy, c.cx, c.cy), torch.from_numpy(R_bc))
    j_p = -np.einsum("wji,wj->wi", np.asarray(j_new.window.R_cw), np.asarray(j_new.window.t_cw))
    p0 = -np.einsum("wji,wj->wi", tree.window.R_cw, tree.window.t_cw)
    assert j_info["accepted"] and np.abs(j_p - p0).max() > 1e-2
    for p, info in out:
        assert info["accepted"] and len(info["costs"]) == jcfg.backend.lm_iters
        for key in ("initial_cost", "final_cost"):
            np.testing.assert_allclose(info[key], float(j_info[key]), rtol=1e-3, err_msg=key)
        np.testing.assert_allclose(p, j_p, atol=1e-3)
        np.testing.assert_array_equal(p, out[0][0])


def test_run_batch_sharded_process_local_needs_even_slices(ranks):
    """10 sequences over 4 ranks: process_shard_range's slices of 3, 3, 2
    and 2 cannot form the batch (the reference requires B divisible by the
    axis), so every rank raises before any step instead of drawing from
    another entry's seed (8 over 4 runs in
    test_run_batch_sharded_equals_one_process_batch)."""
    for msg in ranks.run(ranks_fns.process_local_uneven, 10):
        assert msg is not None and "divisible by 4" in msg


CLI_ARGV = ["--cpu", "--synthetic", "12", "--imu-scale", "--vi-ba", "--dist-ba", "4"]


def test_cli_dist_ba_under_torchrun_equals_spawned_ranks(ranks, tmp_path, capsys):
    """The CLI's --dist-ba 4 in each of the pool's 4 ranks with torchrun's
    environment (the group already up): exit 0 everywhere, the refine on
    the existing gloo group and accepted, only rank 0 writes the
    trajectory, the caller's group survives main; every rank's rows equal
    the rows of the same run with spawned ranks in this process."""
    from vislam_tpu_torch import cli
    from vislam_tpu_torch.eval import read_trajectory_csv

    out = ranks.run(ranks_fns.cli_under_torchrun, CLI_ARGV, str(tmp_path))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        report = {}
        assert cli.main([*CLI_ARGV, "--output", str(tmp_path / "spawned.csv")],
                        report=report) == 0
    finally:
        torch.set_num_threads(threads)
    assert "distributed window BA: backend gloo, 4 ranks" in capsys.readouterr().out
    rows = np.array([r["est_p"] for r in report["rows"]])
    for code, est_p, info, backend, group_up in out:
        assert code == 0 and info["accepted"] and backend == "gloo" and group_up
        np.testing.assert_array_equal(est_p, rows)
    assert [p.name for p in sorted(tmp_path.glob("r*.csv"))] == ["r0.csv"]
    np.testing.assert_array_equal(read_trajectory_csv(str(tmp_path / "r0.csv"))["est_p"],
                                  read_trajectory_csv(str(tmp_path / "spawned.csv"))["est_p"])
