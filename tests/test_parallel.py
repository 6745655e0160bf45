"""Multi-device sharding semantics, run in subprocesses with a small virtual
device count (this 2-core host deadlocks XLA-CPU with 8 virtual devices —
see conftest; 2 devices is reliable enough and still exercises the psum
paths)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_in_subprocess(code: str, n_devices: int = 2, timeout: int = 560) -> str:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_devices}"
        + " --xla_cpu_max_isa=AVX2"  # see tests/conftest.py
    ).strip()
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
    )
    assert out.returncode == 0, f"stderr:\n{out.stderr[-3000:]}"
    return out.stdout


class TestShardedBA:
    def test_sharded_matches_local(self):
        """Distributed Schur BA must produce the same result as the
        single-device solver (same math, psum-reduced)."""
        code = """
import jax, numpy as np, jax.numpy as jnp
import sys; sys.path.insert(0, %r)
from tests.test_optim import make_ba_problem
from weiner_slamit_v2_tpu.optim.local_ba import solve_ba
from weiner_slamit_v2_tpu.parallel.sharded_ba import (
    make_ba_mesh, shard_problem, solve_ba_sharded)

prob, gt_poses, X_gt = make_ba_problem(n_cams=4, n_pts=64, max_obs=6, seed=0)
# gross outliers on a few observations: the final cost is then defined over
# more than the inlier set, in both solvers alike
prob = prob.replace(obs_uv=prob.obs_uv.at[::9, 0].add(40.0))
res_local = solve_ba(prob, 3, 3)
mesh = make_ba_mesh(jax.devices())
prob_s = shard_problem(prob, mesh)
res_shard = solve_ba_sharded(prob_s, mesh, iters1=3, iters2=3)
dp = float(jnp.abs(res_local.cam_pose - res_shard.cam_pose).max())
dx = float(jnp.abs(res_local.points - res_shard.points).max())
dc = abs(float(res_local.final_cost) - float(res_shard.final_cost))
dc /= float(res_local.final_cost)
di = int((res_local.obs_inlier != res_shard.obs_inlier).sum())
print("MAXDIFF", dp, dx, dc, di)
assert dp < 1e-3 and dx < 1e-2 and dc < 1e-4 and di == 0, (dp, dx, dc, di)
print("OK")
""" % (REPO,)
        out = run_in_subprocess(code, n_devices=2)
        assert "OK" in out, out

    def test_dryrun_multichip(self):
        """The driver-facing multi-chip dry run compiles and executes."""
        code = """
import sys; sys.path.insert(0, %r)
import importlib.util
spec = importlib.util.spec_from_file_location("ge", %r + "/__graft_entry__.py")
ge = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ge)
ge.dryrun_multichip(2)
print("OK")
""" % (REPO, REPO)
        out = run_in_subprocess(code, n_devices=2)
        assert "OK" in out, out


class TestGraftEntry:
    def test_entry_compiles(self):
        code = """
import sys; sys.path.insert(0, %r)
import jax
import importlib.util
spec = importlib.util.spec_from_file_location("ge", %r + "/__graft_entry__.py")
ge = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ge)
fn, args = ge.entry()
out = jax.jit(fn)(*args)
jax.block_until_ready(out)
print("OK", out[1])
""" % (REPO, REPO)
        out = run_in_subprocess(code, n_devices=1)
        assert "OK" in out, out


class TestMultiHost:
    def test_two_process_distributed_psum(self):
        """jax.distributed multi-host path: two OS processes join a
        coordinator and run a psum over the global mesh — the communication
        skeleton the distributed BA rides on real multi-host slices."""
        worker = """
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.environ["PYTHONPATH"].split(os.pathsep)[0])
from weiner_slamit_v2_tpu.parallel import multihost
multihost.initialize()
assert jax.process_count() == 2, jax.process_count()
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
mesh = multihost.global_mesh("d")
n = len(jax.devices())
assert n == 4, n  # 2 local devices x 2 processes

import functools
@functools.partial(jax.shard_map, mesh=mesh, in_specs=P("d"), out_specs=P())
def total(x):
    return jax.lax.psum(x.sum(), "d")

xs = jnp.arange(n * 3, dtype=jnp.float32)
out = total(xs)
expect = float(xs.sum())
assert abs(float(out) - expect) < 1e-5, (float(out), expect)
print("MULTIHOST_OK", jax.process_index())
"""
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=2"
            + " --xla_cpu_max_isa=AVX2"  # see tests/conftest.py
        ).strip()
        env["PYTHONPATH"] = REPO
        env["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:57731"
        env["JAX_NUM_PROCESSES"] = "2"
        procs = []
        for pid in range(2):
            e = dict(env)
            e["JAX_PROCESS_ID"] = str(pid)
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-c", worker],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, env=e,
                )
            )
        outs = [p.communicate(timeout=560) for p in procs]
        for p, (so, se) in zip(procs, outs):
            assert p.returncode == 0, f"stderr:\n{se[-3000:]}"
            assert "MULTIHOST_OK" in so


class TestShardedBAStereo:
    def test_sharded_matches_local_stereo(self):
        """A stereo problem sharded over the mesh must keep its 3-dof rows:
        result equality with the local solver (shard_problem previously
        dropped obs_ur/obs_has_ur/bf)."""
        code = """
import jax, numpy as np, jax.numpy as jnp
import sys; sys.path.insert(0, %r)
from tests.test_optim import make_ba_problem
from weiner_slamit_v2_tpu.geometry import se3
from weiner_slamit_v2_tpu.optim.local_ba import solve_ba
from weiner_slamit_v2_tpu.parallel.sharded_ba import (
    make_ba_mesh, shard_problem, solve_ba_sharded)

prob, gt_poses, X_gt = make_ba_problem(n_cams=4, n_pts=64, max_obs=6, seed=0)
bf = 50.0
cams = np.maximum(np.asarray(prob.obs_cam), 0)
Pc = np.asarray(se3.apply(gt_poses[jnp.asarray(cams)], jnp.asarray(X_gt)[:, None, :]))
z = np.maximum(Pc[..., 2], 1e-6)
ur = (500.0 * Pc[..., 0] / z + 320.0 - bf / z).astype(np.float32)
prob = prob.replace(
    obs_ur=jnp.asarray(ur),
    obs_has_ur=jnp.asarray(np.asarray(prob.obs_valid)),
    bf=jnp.asarray(bf, jnp.float32),
)
res_local = solve_ba(prob, 3, 3)
mesh = make_ba_mesh(jax.devices())
prob_s = shard_problem(prob, mesh)
assert prob_s.obs_ur is not None and prob_s.bf is not None
res_shard = solve_ba_sharded(prob_s, mesh, iters1=3, iters2=3)
dp = float(jnp.abs(res_local.cam_pose - res_shard.cam_pose).max())
dx = float(jnp.abs(res_local.points - res_shard.points).max())
di = int((res_local.obs_inlier != res_shard.obs_inlier).sum())
print("MAXDIFF", dp, dx, di)
assert dp < 1e-3 and dx < 1e-2 and di == 0, (dp, dx, di)
print("OK")
""" % (REPO,)
        out = run_in_subprocess(code, n_devices=2)
        assert "OK" in out, out


class TestSystemDistributedGBA:
    def test_live_map_gba_over_mesh_improves_ate(self):
        """Config-5 accuracy path: run the LIVE pipeline, perturb the map
        (accumulated-drift stand-in), then System.distributed_gba over a
        2-device virtual mesh must reduce the trajectory ATE and agree with
        the local solver (same math, psum-reduced)."""
        code = """
import jax, numpy as np, jax.numpy as jnp
import sys; sys.path.insert(0, %r)
from weiner_slamit_v2_tpu.config import (
    CameraConfig, MapCapacityConfig, OrbConfig, SlamConfig)
from weiner_slamit_v2_tpu.geometry.camera import Camera
from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
from weiner_slamit_v2_tpu.io.evaluation import ate_rmse
from weiner_slamit_v2_tpu.tracking.system import System
from weiner_slamit_v2_tpu.optim.ba_extract import extract_global_ba
from weiner_slamit_v2_tpu.optim.local_ba import solve_ba

H, W = 240, 320
K = np.array([[300.0, 0, 159.5], [0, 300.0, 119.5], [0, 0, 1]], np.float32)
cfg = SlamConfig(
    orb=OrbConfig(n_features=256),
    camera=CameraConfig(fx=300, fy=300, cx=159.5, cy=119.5, k1=0, k2=0,
                        p1=0, p2=0, k3=0, width=W, height=H),
    capacity=MapCapacityConfig(max_keyframes=32, max_map_points=2048,
                               max_obs_per_point=16, local_ba_window=8,
                               local_ba_points=512),
)
cam = Camera.create(300.0, 300.0, 159.5, 119.5, width=W, height=H)
seq = make_synthetic_sequence(n_frames=28, h=H, w=W, seed=11, motion="orbit", K=K)
sys_ = System(cfg, cam)
for f in seq.frames:
    sys_.track_monocular(f.image, f.timestamp)
sys_.finish()
t = sys_.tracker
assert t.n_kf_host >= 4

# perturb every non-gauge keyframe + all points (drift stand-in)
rng = np.random.default_rng(3)
m = t.m
nkf = m.kf_pose.shape[0]
noise_t = jnp.asarray(rng.normal(0, 0.01, (nkf, 3)), jnp.float32)
pose = m.kf_pose.at[:, :3, 3].add(
    jnp.where((jnp.arange(nkf) > 0)[:, None] & m.kf_valid[:, None], noise_t, 0.0))
pts = m.mp_pos + jnp.asarray(rng.normal(0, 0.01, m.mp_pos.shape), jnp.float32) * m.mp_valid[:, None]
t.m = m.replace(kf_pose=pose, mp_pos=pts)
ts, Twc = t.trajectory_Twc()
ate_before = ate_rmse(Twc, seq.gt_Twc[-len(Twc):])

# local reference solve on the SAME extraction
prob, cam_ids, point_ids = extract_global_ba(t.m, t.K, t.inv_sigma2, gauge_kf=0)
res_local = solve_ba(prob, 5, 10)

res = sys_.distributed_gba(iters=15)
ts, Twc2 = t.trajectory_Twc()
ate_after = ate_rmse(Twc2, seq.gt_Twc[-len(Twc2):])
dp = float(jnp.abs(res_local.cam_pose - jnp.asarray(np.asarray(res.cam_pose))).max())
print("ATE", ate_before, "->", ate_after, "maxdiff", dp)
assert np.isfinite(ate_after)
assert ate_after < ate_before, (ate_before, ate_after)
assert dp < 1e-3, dp
print("OK")
""" % (REPO,)
        out = run_in_subprocess(code, n_devices=2)
        assert "OK" in out, out
