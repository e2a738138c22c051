"""Frame-to-frame visual odometry: one fused step, and a whole-sequence scan.

The reference dispatches ~10 kernels + 6 synchronizations per frame from
host threads (reference src/SlamGpuPipeline/buildStream.cpp:345-666).  Here
the unit of execution is ONE jitted step per frame — frontend + matching +
RANSAC pose, fused — and, for dataset replay, a `lax.scan` over the whole
sequence that keeps the entire odometry loop on device with zero host
round trips.

RNG: the RANSAC key is derived inside the step via `fold_in(base_key,
frame_idx)` — deterministic, and no host-side `jax.random.split` (one
dispatch each) per frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from jetracer_orbslam2_tpu.config import FrontendConfig, TrackingConfig
from jetracer_orbslam2_tpu.models import tracking
from jetracer_orbslam2_tpu.models.frontend import Features, frontend_gray_depth

Array = jax.Array


class OdomState(NamedTuple):
    T_wc: Array        # (4, 4) current world<-camera pose
    velocity: Array    # (4, 4) T_prev_curr motion model
    prev: Features     # features of the previous frame
    frame_idx: Array   # () int32
    base_key: Array    # jax PRNG key (folded with frame_idx per step)


def init_state(
    gray0: Array, depth0: Array, intrinsics: Array, fcfg: FrontendConfig,
    tcfg: TrackingConfig, seed: int = 0,
) -> OdomState:
    feats = frontend_gray_depth(
        gray0, depth0, intrinsics, fcfg,
        min_depth=tcfg.min_depth, max_depth=tcfg.max_depth)
    return OdomState(
        T_wc=jnp.eye(4, dtype=jnp.float32),
        velocity=jnp.eye(4, dtype=jnp.float32),
        prev=feats,
        frame_idx=jnp.int32(0),
        base_key=jax.random.PRNGKey(seed),
    )


def _step(
    state: OdomState, gray: Array, depth: Array, intrinsics: Array,
    fcfg: FrontendConfig, tcfg: TrackingConfig, live=None,
) -> tuple[OdomState, tracking.TrackResult]:
    """One odometry frame -> (state, TrackResult).

    `live` (scalar bool, optional): False marks chunk PADDING
    (ChunkedOdometry's partial tail) — the step is skipped under lax.cond
    so padded frames leave the state untouched."""
    if live is not None:
        k = fcfg.max_keypoints

        def run(st):
            return _step(st, gray, depth, intrinsics, fcfg, tcfg)

        def skip(st):
            return st, tracking.TrackResult(
                T_wc=st.T_wc, velocity=st.velocity,
                num_matches=jnp.int32(0), num_inliers=jnp.int32(0),
                tracked_ok=jnp.asarray(False),
                match_idx=jnp.zeros(k, jnp.int32),
                inlier_mask=jnp.zeros(k, bool))

        return jax.lax.cond(live, run, skip, state)

    feats = frontend_gray_depth(
        gray, depth, intrinsics, fcfg,
        min_depth=tcfg.min_depth, max_depth=tcfg.max_depth)
    key = jax.random.fold_in(state.base_key, state.frame_idx)
    res = tracking.track_rgbd(
        state.prev, feats, state.T_wc, state.velocity, intrinsics, key, tcfg)
    new_state = OdomState(
        T_wc=res.T_wc,
        velocity=res.velocity,
        prev=feats,
        frame_idx=state.frame_idx + 1,
        base_key=state.base_key,
    )
    return new_state, res


@functools.partial(jax.jit, static_argnames=("fcfg", "tcfg"))
def odometry_step(
    state: OdomState, gray: Array, depth: Array, intrinsics: Array,
    fcfg: FrontendConfig, tcfg: TrackingConfig,
) -> tuple[OdomState, tracking.TrackResult]:
    """One fused frontend+tracking step: exactly one dispatch per frame."""
    return _step(state, gray, depth, intrinsics, fcfg, tcfg)


@functools.partial(jax.jit, static_argnames=("fcfg", "tcfg"))
def odometry_scan(
    state: OdomState, grays: Array, depths: Array, intrinsics: Array,
    fcfg: FrontendConfig, tcfg: TrackingConfig, live: Array | None = None,
) -> tuple[OdomState, Array, Array]:
    """Run odometry over a whole (N, H, W) sequence on device.

    Returns (final state, (N,4,4) poses T_wc, (N,) tracked_ok).  This is the
    dataset-replay fast path: the reference's worker free-list pipelining
    (SlamGpuPipeline.cpp:41-50) becomes a single scanned device program.
    live: (N,) bool, optional — False rows are inert padding (chunk tails).
    """

    if live is None:
        def body(st, frame):
            g, d = frame
            st2, res = _step(st, g, d, intrinsics, fcfg, tcfg)
            return st2, (res.T_wc, res.tracked_ok)

        final, (poses, ok) = jax.lax.scan(body, state, (grays, depths))
    else:
        def body(st, frame):
            g, d, lv = frame
            st2, res = _step(st, g, d, intrinsics, fcfg, tcfg, live=lv)
            return st2, (res.T_wc, res.tracked_ok)

        final, (poses, ok) = jax.lax.scan(body, state, (grays, depths, live))
    return final, poses, ok


class ChunkedOdometry:
    """Constant-memory streaming odometry: frames run through
    `odometry_scan` in fixed-size chunks with `OdomState` carried across —
    device memory holds one chunk instead of the whole sequence (VERDICT
    round-3 item 8: `--mode odometry` used to materialize the full frame
    stack, ~8 GB for a KITTI-00-length run).  One host sync per chunk;
    the tail chunk is padded with live=False rows, so results are
    bit-identical to the whole-sequence scan."""

    def __init__(self, intrinsics, fcfg: FrontendConfig,
                 tcfg: TrackingConfig, chunk_size: int = 32, seed: int = 0):
        self.intr = jnp.asarray(intrinsics, jnp.float32)
        self.fcfg, self.tcfg = fcfg, tcfg
        self.chunk = chunk_size
        self.seed = seed
        self.state: OdomState | None = None
        self._pending_g: list = []
        self._pending_d: list = []
        self._poses: list = [np.eye(4, dtype=np.float32)[None]]
        self._ok: list = [np.ones(1, bool)]

    def process_frame(self, gray, depth) -> None:
        if self.state is None:
            self.state = init_state(
                jnp.asarray(gray), jnp.asarray(depth), self.intr,
                self.fcfg, self.tcfg, seed=self.seed)
            return
        # keep device-resident inputs on device: no per-frame host copy
        self._pending_g.append(gray)
        self._pending_d.append(depth)
        if len(self._pending_g) >= self.chunk:
            self.flush()

    def flush(self) -> None:
        n = len(self._pending_g)
        if n == 0:
            return
        pad = self.chunk - n
        g = jnp.stack(self._pending_g + [self._pending_g[-1]] * pad)
        d = jnp.stack(self._pending_d + [self._pending_d[-1]] * pad)
        self._pending_g.clear()
        self._pending_d.clear()
        live = jnp.arange(self.chunk) < n
        self.state, poses, ok = odometry_scan(
            self.state, g, d, self.intr, self.fcfg, self.tcfg, live=live)
        self._poses.append(np.asarray(poses)[:n])
        self._ok.append(np.asarray(ok)[:n])

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        """((N, 4, 4) poses, (N,) tracked) for all processed frames."""
        if self.state is None:
            return (np.zeros((0, 4, 4), np.float32), np.zeros(0, bool))
        return np.concatenate(self._poses), np.concatenate(self._ok)
