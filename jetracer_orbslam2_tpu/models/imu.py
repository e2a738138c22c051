"""IMU attitude estimation: gyro integration + accel complementary filter.

Array-program equivalent of the reference's CPU filter
(reference: src/SlamGpuPipeline/SlamGpuPipeline.cpp:179-239 —
`process_gyro` integrates angular rate into Euler angles `theta`;
`process_accel` extracts the gravity direction and blends with
alpha = 0.98).

The state update is a few scalar ops; it is expressed as a pure jnp function
so it can be fused into a jitted step or scanned over a whole IMU packet
batch (the 200 Hz gyro stream between two 60 fps frames is a `lax.scan`, one
dispatch per frame instead of one per sample — io/datasets.imu_packets
builds the fixed-size per-frame packets).

Timestamps are RELATIVE seconds since sequence start, never epoch seconds:
float32 resolution at EuRoC/TUM epoch magnitudes (~1.4e9 s) is ~128 s, which
would turn every dt into garbage.  Dataset loaders subtract the sequence
start in float64 on the host before anything reaches this module
(io/datasets.py), and `process_gyro` guards against absolute-looking inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array

ALPHA = 0.98  # complementary blend (reference SlamGpuPipeline.cpp:232-236)

# Relative timestamps beyond this are certainly a unit bug (a day-long
# sequence is 9e4 s; epoch seconds are 1e9).  Samples past the horizon are
# ignored rather than silently integrating a ~128 s-quantized dt.
MAX_REL_TS = 1e6


class ImuState(NamedTuple):
    theta: Array       # (3,) roll/pitch/yaw-ish Euler attitude [rad]
    last_ts: Array     # () float32 RELATIVE seconds since sequence start
    initialized: Array  # () bool — first accel sample seeds theta


def init_state() -> ImuState:
    return ImuState(
        theta=jnp.zeros(3, jnp.float32),
        last_ts=jnp.float32(-1.0),
        initialized=jnp.asarray(False),
    )


def process_gyro(state: ImuState, gyro: Array, ts: Array) -> ImuState:
    """Integrate angular rate (rad/s) over the timestamp delta.

    `ts` is relative seconds (see module docstring).  The first sample (and
    any non-monotonic or absolute-epoch timestamp) only latches `last_ts`
    without integrating.  Axis convention matches the reference's intent
    (SlamGpuPipeline.cpp:196-208): body rates integrate directly; datasets
    provide already-calibrated rates.
    """
    ok = (state.last_ts >= 0.0) & (ts > state.last_ts) & (ts < MAX_REL_TS)
    dt = jnp.where(ok, ts - state.last_ts, 0.0)
    theta = state.theta + gyro * dt
    new_ts = jnp.where(ts < MAX_REL_TS, ts, state.last_ts)
    return ImuState(theta=theta, last_ts=new_ts,
                    initialized=state.initialized)


def process_accel(state: ImuState, accel: Array) -> ImuState:
    """Blend gravity direction into roll/pitch (yaw unobservable from accel).

    accel: (3,) m/s^2 in body frame. First sample seeds the attitude
    directly (reference SlamGpuPipeline.cpp:222-228).
    """
    ax, ay, az = accel[0], accel[1], accel[2]
    roll = jnp.arctan2(ay, jnp.sqrt(ax * ax + az * az))
    pitch = jnp.arctan2(-ax, jnp.sqrt(ay * ay + az * az))
    accel_theta = jnp.stack([roll, pitch, state.theta[2]])
    blended = ALPHA * state.theta + (1.0 - ALPHA) * accel_theta
    theta = jnp.where(state.initialized, blended, accel_theta)
    return ImuState(
        theta=theta, last_ts=state.last_ts, initialized=jnp.asarray(True)
    )


@jax.jit
def process_packet_with_delta(
    state: ImuState,
    gyro: Array,       # (N, 3) rad/s
    gyro_ts: Array,    # (N,) relative s
    accel: Array,      # (M, 3) m/s^2
    gyro_valid: Array,   # (N,) bool (fixed-size packet with mask)
    accel_valid: Array,  # (M,) bool
) -> tuple[ImuState, Array]:
    """Fold a fixed-size batch of IMU samples into the state (one dispatch
    per camera frame; reference handled each 200 Hz event on the bus).

    Also returns delta_w (3,): the gyro-integrated body rotation vector
    over this packet, i.e. the rotation between the previous and current
    camera frame — the IMU-aided motion prior the tracker consumes
    (models/slam.track_and_associate).  The reference attaches attitude to
    every frame (SlamGpuPipeline.cpp:154) but never feeds it back into
    tracking; we do."""

    theta_before = state.theta

    def gyro_step(s, x):
        g, ts, v = x
        s2 = process_gyro(s, g, ts)
        s = jax.tree.map(lambda a, b: jnp.where(v, a, b), s2, s)
        return s, None

    state, _ = jax.lax.scan(gyro_step, state, (gyro, gyro_ts, gyro_valid))
    delta_w = state.theta - theta_before

    def accel_step(s, x):
        a, v = x
        s2 = process_accel(s, a)
        s = jax.tree.map(lambda p, q: jnp.where(v, p, q), s2, s)
        return s, None

    state, _ = jax.lax.scan(accel_step, state, (accel, accel_valid))
    return state, delta_w


def process_packet(state: ImuState, gyro, gyro_ts, accel, gyro_valid,
                   accel_valid) -> ImuState:
    """Attitude-only wrapper around process_packet_with_delta."""
    state, _ = process_packet_with_delta(
        state, gyro, gyro_ts, accel, gyro_valid, accel_valid)
    return state
