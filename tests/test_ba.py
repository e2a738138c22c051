"""Bundle adjustment: synthetic convergence tests.

Builds a known world (random landmarks, circular camera ring), perturbs
poses+points, and asserts LM with Schur complement recovers them.  The
reference has nothing comparable to test against (its pose output is
identity, src/SlamGpuPipeline/buildStream.cpp:583-584), so the oracle is
the generating ground truth itself.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jetracer_orbslam2_tpu.config import BAConfig
from jetracer_orbslam2_tpu.models.backend.ba import BAProblem, bundle_adjust
from jetracer_orbslam2_tpu.ops import geometry as geo

INTR = jnp.array([500.0, 500.0, 320.0, 240.0], jnp.float32)


def make_problem(rng, P=6, L=200, noise_px=0.5, pose_noise=0.03,
                 point_noise=0.05):
    # landmarks in a box in front of the ring
    pts_gt = rng.uniform([-2, -2, 4], [2, 2, 8], size=(L, 3)).astype(np.float32)
    poses_gt = []
    for i in range(P):
        ang = 0.08 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)],
                      [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        t = np.array([0.4 * i, 0.05 * i, 0.0], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, t
        poses_gt.append(T)
    poses_gt = np.stack(poses_gt)  # T_wc

    # observations: every landmark seen from every pose (if in front)
    obs_kf, obs_lm, obs_uv = [], [], []
    for i in range(P):
        T_cw = np.linalg.inv(poses_gt[i])
        pc = pts_gt @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = pc[:, :2] / pc[:, 2:3] * 500.0 + np.array([320.0, 240.0])
        ok = pc[:, 2] > 0.5
        for j in np.nonzero(ok)[0]:
            obs_kf.append(i)
            obs_lm.append(j)
            obs_uv.append(uv[j] + rng.normal(0, noise_px, 2))
    E = len(obs_kf)

    # perturb initial guess (first pose fixed = gauge)
    poses0 = poses_gt.copy()
    for i in range(1, P):
        xi = rng.normal(0, pose_noise, 6).astype(np.float32)
        poses0[i] = np.asarray(geo.se3_exp(jnp.asarray(xi))) @ poses0[i]
    pts0 = pts_gt + rng.normal(0, point_noise, (L, 3)).astype(np.float32)

    fixed = np.zeros(P, bool)
    fixed[0] = True
    # pure reprojection problem (no depth residuals): exercises the mono
    # path; depth-anchored behavior is covered in test_ba_depth_residuals
    prob = BAProblem.without_depth(
        poses=jnp.asarray(poses0),
        points=jnp.asarray(pts0),
        obs_kf=jnp.asarray(obs_kf, jnp.int32),
        obs_lm=jnp.asarray(obs_lm, jnp.int32),
        obs_uv=jnp.asarray(np.stack(obs_uv), jnp.float32),
        obs_valid=jnp.ones(E, bool),
        fixed=jnp.asarray(fixed),
    )
    return prob, poses_gt, pts_gt


def test_ba_converges():
    rng = np.random.default_rng(0)
    prob, poses_gt, pts_gt = make_problem(rng)
    poses, points, stats = bundle_adjust(prob, INTR, BAConfig(iters=15))
    # cost must drop by a large factor
    assert float(stats.cost[-1]) < 0.05 * float(stats.cost[0])
    # pose translation error small
    err = np.linalg.norm(np.asarray(poses)[:, :3, 3] - poses_gt[:, :3, 3], axis=1)
    assert err.max() < 0.01, err
    rot_err = [np.linalg.norm(np.asarray(
        geo.so3_log(jnp.asarray(np.asarray(poses)[i, :3, :3] @ poses_gt[i, :3, :3].T))))
        for i in range(len(poses_gt))]
    assert max(rot_err) < 0.005


def test_ba_noise_free_exact():
    rng = np.random.default_rng(1)
    prob, poses_gt, pts_gt = make_problem(rng, noise_px=0.0)
    # reprojection-only BA has a scale gauge; fix two poses (at GT) to pin it
    prob = prob._replace(
        poses=prob.poses.at[1].set(jnp.asarray(poses_gt[1])),
        fixed=prob.fixed.at[1].set(True))
    poses, points, stats = bundle_adjust(prob, INTR, BAConfig(iters=15))
    assert float(stats.cost[-1]) < 1e-4
    err = np.linalg.norm(np.asarray(poses)[:, :3, 3] - poses_gt[:, :3, 3], axis=1)
    assert err.max() < 1e-3


def test_ba_respects_gauge():
    rng = np.random.default_rng(2)
    prob, poses_gt, _ = make_problem(rng)
    poses, _, _ = bundle_adjust(prob, INTR, BAConfig(iters=5))
    np.testing.assert_allclose(np.asarray(poses)[0], poses_gt[0], atol=1e-6)


def test_ba_depth_residuals_anchor_scale():
    """With depth measurements, ONE fixed pose suffices: the scale gauge
    that plagues reprojection-only BA (see test_ba_noise_free_exact) is
    pinned by the z residuals."""
    rng = np.random.default_rng(5)
    prob, poses_gt, pts_gt = make_problem(rng, noise_px=0.0)
    # attach perfect depth measurements from GT geometry
    Tcw = np.linalg.inv(poses_gt)
    pc = np.einsum("eij,ej->ei",
                   Tcw[np.asarray(prob.obs_kf)][:, :3, :3],
                   pts_gt[np.asarray(prob.obs_lm)]) \
        + Tcw[np.asarray(prob.obs_kf)][:, :3, 3]
    prob = prob._replace(
        obs_z=jnp.asarray(pc[:, 2].astype(np.float32)),
        obs_z_valid=jnp.ones(prob.obs_kf.shape[0], bool))
    poses, points, stats = bundle_adjust(prob, INTR, BAConfig(iters=15))
    err = np.linalg.norm(np.asarray(poses)[:, :3, 3] - poses_gt[:, :3, 3],
                         axis=1)
    assert err.max() < 1e-3, err
    assert float(stats.cost[-1]) < 1e-3


def test_ba_invalid_obs_ignored():
    rng = np.random.default_rng(3)
    prob, poses_gt, pts_gt = make_problem(rng, noise_px=0.0)
    # corrupt half the measurements but mark them invalid
    E = prob.obs_uv.shape[0]
    bad = np.zeros(E, bool)
    bad[::2] = True
    uv = np.asarray(prob.obs_uv).copy()
    uv[bad] += 500.0
    prob = prob._replace(
        obs_uv=jnp.asarray(uv), obs_valid=jnp.asarray(~bad))
    poses, points, stats = bundle_adjust(prob, INTR, BAConfig(iters=15))
    assert float(stats.cost[-1]) < 1e-4

def _numpy_normal_equations(poses_cw, pts, uv, z, zv, w, intr, delta):
    """Float64 reference for one LM linearization on the dense (P, L)
    grid: residuals and Jacobians by central differences of the residual
    under the solver's left se(3) increment (dp = dt + dw x p)."""
    fx, fy, cx, cy = intr
    P, L = w.shape

    def resid(p, u, v, zm, zok):
        wz = fx / max(zm, 0.1) if zok else 0.0
        return np.array([fx * p[0] / p[2] + cx - u,
                         fy * p[1] / p[2] + cy - v, wz * (p[2] - zm)])

    Hpp = np.zeros((P, 6, 6))
    bp = np.zeros((P, 6))
    Hll = np.zeros((3, 3, L))
    bl = np.zeros((3, L))
    G = np.zeros((P, 6, 3, L))
    cost = 0.0
    eps = 1e-6
    for a in range(P):
        R, t = poses_cw[a, :3, :3], poses_cw[a, :3, 3]
        for l in range(L):
            if w[a, l] == 0.0:
                continue
            p = R @ pts[l] + t
            args = (uv[0, a, l], uv[1, a, l], z[a, l], zv[a, l])
            r = resid(p, *args)
            Jp = np.zeros((3, 6))
            Jl = np.zeros((3, 3))
            for k in range(6):
                xi = np.zeros(6)
                xi[k] = eps
                dp = xi[:3] + np.cross(xi[3:], p)
                Jp[:, k] = (resid(p + dp, *args)
                            - resid(p - dp, *args)) / (2 * eps)
            for k in range(3):
                dX = np.zeros(3)
                dX[k] = eps
                Jl[:, k] = (resid(R @ (pts[l] + dX) + t, *args)
                            - resid(R @ (pts[l] - dX) + t, *args)) / (2 * eps)
            n = np.linalg.norm(r)
            cost += 0.5 * n * n if n <= delta else delta * (n - 0.5 * delta)
            s = np.sqrt(min(1.0, delta / max(n, 1e-12)))
            r, Jp, Jl = s * r, s * Jp, s * Jl
            Hpp[a] += Jp.T @ Jp
            bp[a] -= Jp.T @ r
            Hll[:, :, l] += Jl.T @ Jl
            bl[:, l] -= Jl.T @ r
            G[a, :, :, l] = Jp.T @ Jl
    return Hpp, Hll, G, bp, bl, cost


def test_dense_normal_equations_match_numpy():
    """The XLA normal-equation assembly (the only BA path) against an
    independent float64 NumPy linearization, depth residuals included."""
    from jetracer_orbslam2_tpu.models.backend import ba as ba_core

    rng = np.random.default_rng(11)
    prob, _, _ = make_problem(rng, P=3, L=7, noise_px=2.0)
    z = rng.uniform(4.0, 8.0, prob.obs_kf.shape[0]).astype(np.float32)
    zv = rng.random(prob.obs_kf.shape[0]) < 0.7
    P, L = 3, 7
    obs, _ = ba_core.edges_to_dense(
        P, L, prob.obs_kf, prob.obs_lm, prob.obs_uv, jnp.asarray(z),
        jnp.asarray(zv), prob.obs_valid)
    poses_cw = jax.vmap(geo.pose_inverse)(prob.poses)
    delta = BAConfig().huber_delta
    got = ba_core.dense_normal_equations(
        poses_cw, prob.points.T, obs, obs.w, INTR, delta)
    ref = _numpy_normal_equations(
        np.asarray(poses_cw, np.float64), np.asarray(prob.points, np.float64),
        np.asarray(obs.uv, np.float64), np.asarray(obs.z, np.float64),
        np.asarray(obs.z_valid), np.asarray(obs.w),
        np.asarray(INTR, np.float64),
        delta)
    for name, g, r in zip(("Hpp", "Hll", "G", "bp", "bl", "cost"), got, ref):
        g = np.asarray(g, np.float64)
        scale = max(np.max(np.abs(r)), 1e-9)
        assert np.max(np.abs(g - r)) < 2e-3 * scale, name


def test_ba_landmark_count_not_a_multiple_of_128():
    """No lane-tile padding anywhere: an odd landmark count solves and the
    solution moves every observed landmark."""
    rng = np.random.default_rng(12)
    prob, poses_gt, _ = make_problem(rng, P=5, L=301)
    poses, points, stats = bundle_adjust(prob, INTR, BAConfig(iters=10))
    assert points.shape == (301, 3)
    assert float(stats.cost[-1]) < 0.05 * float(stats.cost[0])
    err = np.linalg.norm(np.asarray(poses)[:, :3, 3] - poses_gt[:, :3, 3],
                         axis=1)
    assert err.max() < 0.02, err
