"""Fixed-capacity keyframe/landmark map store.

The reference DECLARED a map (unused `keyframe` member at
src/SlamGpuPipeline/SlamGpuPipeline.h:53, SLAM keyframe knobs at
src/Context.h:62-65) but never built one.  This is the real thing, designed
around fixed shapes: preallocated device arrays with validity masks and
monotonic counters; inserts are `dynamic_update_slice`s; queries are dense
batched ops.  No host-side per-landmark bookkeeping — the map IS a pytree
of arrays, which also makes it trivially checkpointable
(runtime/checkpoint.py) and shardable (parallel/).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jetracer_orbslam2_tpu.config import MapConfig
from jetracer_orbslam2_tpu.models.frontend import Features
from jetracer_orbslam2_tpu.ops import geometry as geo
from jetracer_orbslam2_tpu.utils.precision import f32_estimation

Array = jax.Array


class MapState(NamedTuple):
    # keyframes
    kf_pose: Array      # (Kf, 4, 4) T_wc
    kf_valid: Array     # (Kf,) bool
    kf_frame_id: Array  # (Kf,) int32 source frame index
    # per-keyframe raw features (for loop-closure retrieval + relocalization)
    kf_desc: Array      # (Kf, K, 8) uint32
    kf_xy: Array        # (Kf, K, 2) float32
    kf_points: Array    # (Kf, K, 3) float32 camera-frame 3D
    kf_has_point: Array  # (Kf, K) bool
    kf_global_desc: Array  # (Kf, 256) float32 mean-bit global descriptor
    # landmarks
    lm_pos: Array       # (L, 3) world positions
    lm_desc: Array      # (L, 8) uint32 representative descriptor
    lm_valid: Array     # (L,) bool
    lm_ref_kf: Array    # (L,) int32 keyframe slot that spawned the landmark
    # observations (flat edge list)
    obs_kf: Array       # (O,) int32 keyframe slot
    obs_lm: Array       # (O,) int32 landmark slot
    obs_uv: Array       # (O, 2) float32 pixel measurement
    obs_z: Array        # (O,) float32 measured camera-frame depth (0 = none)
    obs_valid: Array    # (O,) bool
    # retained loop-closure constraints: every accepted loop edge persists
    # so each pose-graph solve re-applies ALL of them (multi-loop sequences
    # — KITTI-00-class — would otherwise lose earlier loops' constraints)
    loop_i: Array       # (Le,) int32 query keyframe slot
    loop_j: Array       # (Le,) int32 matched keyframe slot
    loop_T: Array       # (Le, 4, 4) verified relative pose T_ij
    loop_valid: Array   # (Le,) bool
    # retired-keyframe ring (compact_keyframes): culled keyframes leave
    # behind (uid, anchor uid, pose relative to the anchor at cull time) so
    # trajectory segments anchored to them keep riding the live pose graph
    # — the anchor is a SURVIVING keyframe, so later loop closures still
    # correct retired segments exactly (resolve_kf_poses chains through
    # anchors that were themselves retired later).
    dead_uid: Array         # (D,) int32 frame_id of the culled keyframe
    dead_anchor_uid: Array  # (D,) int32 frame_id of its surviving anchor
    dead_rel: Array         # (D, 4, 4) inv(anchor_pose) @ culled_pose
    dead_seq: Array         # (D,) int32 monotonic cull sequence number
    dead_valid: Array       # (D,) bool
    # counters
    num_kf: Array       # () int32
    num_lm: Array       # () int32
    num_obs: Array      # () int32
    num_loop: Array     # () int32
    num_dead: Array     # () int32 total keyframes ever culled (ring head)


def init_map(cfg: MapConfig, num_keypoints: int, desc_words: int = 8) -> MapState:
    kf, lm, ob, k = cfg.max_keyframes, cfg.max_landmarks, cfg.max_obs, num_keypoints
    return MapState(
        kf_pose=jnp.tile(jnp.eye(4, dtype=jnp.float32), (kf, 1, 1)),
        kf_valid=jnp.zeros(kf, bool),
        kf_frame_id=jnp.zeros(kf, jnp.int32),
        kf_desc=jnp.zeros((kf, k, desc_words), jnp.uint32),
        kf_xy=jnp.zeros((kf, k, 2), jnp.float32),
        kf_points=jnp.zeros((kf, k, 3), jnp.float32),
        kf_has_point=jnp.zeros((kf, k), bool),
        kf_global_desc=jnp.zeros((kf, 256), jnp.float32),
        lm_pos=jnp.zeros((lm, 3), jnp.float32),
        lm_desc=jnp.zeros((lm, desc_words), jnp.uint32),
        lm_valid=jnp.zeros(lm, bool),
        lm_ref_kf=jnp.zeros(lm, jnp.int32),
        obs_kf=jnp.zeros(ob, jnp.int32),
        obs_lm=jnp.zeros(ob, jnp.int32),
        obs_uv=jnp.zeros((ob, 2), jnp.float32),
        obs_z=jnp.zeros(ob, jnp.float32),
        obs_valid=jnp.zeros(ob, bool),
        loop_i=jnp.zeros(cfg.max_loop_edges, jnp.int32),
        loop_j=jnp.zeros(cfg.max_loop_edges, jnp.int32),
        loop_T=jnp.tile(jnp.eye(4, dtype=jnp.float32),
                        (cfg.max_loop_edges, 1, 1)),
        loop_valid=jnp.zeros(cfg.max_loop_edges, bool),
        dead_uid=jnp.zeros(cfg.max_dead_keyframes, jnp.int32),
        dead_anchor_uid=jnp.zeros(cfg.max_dead_keyframes, jnp.int32),
        dead_rel=jnp.tile(jnp.eye(4, dtype=jnp.float32),
                          (cfg.max_dead_keyframes, 1, 1)),
        dead_seq=jnp.full(cfg.max_dead_keyframes, -1, jnp.int32),
        dead_valid=jnp.zeros(cfg.max_dead_keyframes, bool),
        num_kf=jnp.int32(0),
        num_lm=jnp.int32(0),
        num_obs=jnp.int32(0),
        num_loop=jnp.int32(0),
        num_dead=jnp.int32(0),
    )


def global_descriptor(desc: Array, valid: Array) -> Array:
    """(K, 8) packed -> (256,) mean bit vector over valid keypoints (a
    cheap whole-image retrieval signature; BoW-free loop-closure prefilter).
    Match with backend/loop._centered_sims, which strips the ~0.5 DC."""
    from jetracer_orbslam2_tpu.ops.orb import unpack_bits

    bits = unpack_bits(desc)  # (K, 256)
    w = valid.astype(jnp.float32)[:, None]
    return jnp.sum(bits * w, 0) / jnp.maximum(jnp.sum(w), 1.0)


@jax.jit
@f32_estimation
def insert_keyframe(
    m: MapState,
    feats: Features,
    T_wc: Array,
    frame_id: Array,
    new_lm_mask: Array,
    lm_match_idx: Array,
    lm_match_ok: Array,
) -> tuple[MapState, Array]:
    """Insert a keyframe; create landmarks for `new_lm_mask` keypoints and
    observations for both new and matched (`lm_match_ok`) landmarks.

    new_lm_mask: (K,) bool — keypoints that should spawn new landmarks
      (has_point and not associated to an existing landmark).
    lm_match_idx/ok: (K,) association of keypoints to EXISTING landmark slots.

    Returns (new_map, kf_slot). Fixed shapes throughout: each insert writes
    exactly K landmark slots and K observation slots (invalid ones masked).
    Capacity overflow drops the overflowing entries (mask stays False) —
    the same backpressure philosophy as the reference's queue drops
    (EventsThread.cpp:63).
    """
    k = feats.xy.shape[0]
    slot = m.num_kf
    kf_cap = m.kf_valid.shape[0]
    lm_cap = m.lm_valid.shape[0]
    obs_cap = m.obs_valid.shape[0]
    can_insert = slot < kf_cap
    slot_c = jnp.minimum(slot, kf_cap - 1)

    new_lm_mask = new_lm_mask & feats.has_point & can_insert

    # --- landmarks: compact new ones to the tail [num_lm, num_lm + n_new)
    order = jnp.argsort(~new_lm_mask)          # new ones first, stable
    new_rank = jnp.argsort(order)              # rank of each keypoint
    lm_slot = m.num_lm + new_rank              # target slot per keypoint
    lm_ok = new_lm_mask & (lm_slot < lm_cap)
    lm_slot_c = jnp.minimum(lm_slot, lm_cap - 1)
    world_pts = geo.transform_points(T_wc, feats.points[None])[0]
    lm_pos = m.lm_pos.at[lm_slot_c].set(
        jnp.where(lm_ok[:, None], world_pts, m.lm_pos[lm_slot_c]), mode="drop")
    lm_desc = m.lm_desc.at[lm_slot_c].set(
        jnp.where(lm_ok[:, None], feats.desc, m.lm_desc[lm_slot_c]), mode="drop")
    lm_valid = m.lm_valid.at[lm_slot_c].set(
        m.lm_valid[lm_slot_c] | lm_ok, mode="drop")
    lm_ref_kf = m.lm_ref_kf.at[lm_slot_c].set(
        jnp.where(lm_ok, slot_c, m.lm_ref_kf[lm_slot_c]), mode="drop")
    n_new = jnp.sum(lm_ok).astype(jnp.int32)

    # --- observations: one per keypoint that references a landmark
    # (either the newly created one or the matched existing one)
    obs_target = jnp.where(lm_ok, lm_slot_c, lm_match_idx)
    obs_ok = (lm_ok | (lm_match_ok & feats.valid & can_insert))
    obs_rank = jnp.argsort(jnp.argsort(~obs_ok))
    obs_slot = m.num_obs + obs_rank
    obs_ok = obs_ok & (obs_slot < obs_cap)
    obs_slot_c = jnp.minimum(obs_slot, obs_cap - 1)
    obs_kf = m.obs_kf.at[obs_slot_c].set(
        jnp.where(obs_ok, slot_c, m.obs_kf[obs_slot_c]), mode="drop")
    obs_lm = m.obs_lm.at[obs_slot_c].set(
        jnp.where(obs_ok, obs_target, m.obs_lm[obs_slot_c]), mode="drop")
    obs_uv = m.obs_uv.at[obs_slot_c].set(
        jnp.where(obs_ok[:, None], feats.xy, m.obs_uv[obs_slot_c]), mode="drop")
    z_meas = jnp.where(feats.has_point, feats.points[:, 2], 0.0)
    obs_z = m.obs_z.at[obs_slot_c].set(
        jnp.where(obs_ok, z_meas, m.obs_z[obs_slot_c]), mode="drop")
    obs_valid = m.obs_valid.at[obs_slot_c].set(
        m.obs_valid[obs_slot_c] | obs_ok, mode="drop")
    n_obs = jnp.sum(obs_ok).astype(jnp.int32)

    gdesc = global_descriptor(feats.desc, feats.valid)

    def upd(arr, val):
        return jnp.where(can_insert, arr.at[slot_c].set(val), arr)

    m2 = m._replace(
        kf_pose=upd(m.kf_pose, T_wc),
        kf_valid=jnp.where(can_insert, m.kf_valid.at[slot_c].set(True), m.kf_valid),
        kf_frame_id=upd(m.kf_frame_id, frame_id.astype(jnp.int32)),
        kf_desc=upd(m.kf_desc, feats.desc),
        kf_xy=upd(m.kf_xy, feats.xy),
        kf_points=upd(m.kf_points, feats.points),
        kf_has_point=upd(m.kf_has_point, feats.has_point),
        kf_global_desc=upd(m.kf_global_desc, gdesc),
        lm_pos=lm_pos,
        lm_desc=lm_desc,
        lm_valid=lm_valid,
        lm_ref_kf=lm_ref_kf,
        obs_kf=obs_kf,
        obs_lm=obs_lm,
        obs_uv=obs_uv,
        obs_z=obs_z,
        obs_valid=obs_valid,
        num_kf=jnp.where(can_insert, slot + 1, slot).astype(jnp.int32),
        num_lm=(m.num_lm + n_new).astype(jnp.int32),
        num_obs=(m.num_obs + n_obs).astype(jnp.int32),
    )
    return m2, slot_c


@jax.jit
def compact_map(m: MapState, min_obs: Array, min_age_kf: Array) -> MapState:
    """Landmark culling + observation recycling (fixed shapes, in place).

    Culls landmarks that are old enough (created >= min_age_kf keyframes
    ago) yet still weakly observed (< min_obs observations) — ORB-SLAM2's
    map-point culling policy adapted to the fixed-capacity store — then
    compacts both the landmark table and the observation edge list so freed
    slots are reusable by insert_keyframe (which allocates from num_lm /
    num_obs upward).  Without this, a long run saturates max_obs and
    mapping silently stops (round-1 VERDICT item 6: capacity-drop sites
    map.py:148-149).

    Everything is argsort/gather: one compiled program, no host work.
    """
    newest = m.num_kf - 1
    L = m.lm_valid.shape[0]

    nobs = jax.ops.segment_sum(
        m.obs_valid.astype(jnp.float32), m.obs_lm, num_segments=L)
    age = newest - m.lm_ref_kf
    cull = m.lm_valid & (nobs < min_obs) & (age >= min_age_kf)
    lm_keep = m.lm_valid & ~cull

    # --- landmark compaction: kept landmarks pack to the front ---
    order = jnp.argsort(~lm_keep, stable=True)          # kept first
    new_idx = jnp.cumsum(lm_keep) - 1                   # old slot -> new slot
    lm_pos = m.lm_pos[order]
    lm_desc = m.lm_desc[order]
    lm_ref_kf = m.lm_ref_kf[order]
    lm_valid = lm_keep[order]
    num_lm = jnp.sum(lm_keep).astype(jnp.int32)

    # --- observation compaction: drop edges of culled landmarks, remap ---
    obs_keep = m.obs_valid & lm_keep[m.obs_lm] & m.kf_valid[m.obs_kf]
    obs_lm_new = new_idx[m.obs_lm].astype(jnp.int32)
    oorder = jnp.argsort(~obs_keep, stable=True)
    obs_valid = obs_keep[oorder]
    obs_lm = jnp.where(obs_valid, obs_lm_new[oorder], 0)
    num_obs = jnp.sum(obs_keep).astype(jnp.int32)

    return m._replace(
        lm_pos=lm_pos, lm_desc=lm_desc, lm_ref_kf=lm_ref_kf,
        lm_valid=lm_valid, num_lm=num_lm,
        obs_kf=jnp.where(obs_valid, m.obs_kf[oorder], 0),
        obs_lm=obs_lm,
        obs_uv=jnp.where(obs_valid[:, None], m.obs_uv[oorder], 0.0),
        obs_z=jnp.where(obs_valid, m.obs_z[oorder], 0.0),
        obs_valid=obs_valid, num_obs=num_obs,
    )


@jax.jit
@f32_estimation
def compact_keyframes(
    m: MapState,
    redundancy: Array,      # f32: cull when >= this fraction of the KF's
    #                         observations see well-covered landmarks
    min_covisible: Array,   # i32: "well-covered" = seen by >= this many
    #                         OTHER keyframes
    protect_recent: Array,  # i32: newest slots never culled (BA window)
    target_kf: Array,       # i32: force-cull down to this count if above
    protect_loop_recent: Array | int = 8,  # i32: endpoints of only the
    #                         newest N loop edges are protected
) -> MapState:
    """Redundant-keyframe culling + keyframe slot recycling.

    The ORB-SLAM2 redundant-KF rule (a keyframe most of whose landmarks
    are observed by >= 3 other keyframes adds no information) adapted to
    the fixed-capacity store: scores and the cull set are computed with
    segment-sums, survivors stable-pack to the front (slot order remains
    temporal order, which the BA window and pose-graph chain rely on), and
    every slot reference (obs_kf, lm_ref_kf, loop_i/j) is remapped through
    one cumsum.  Under capacity pressure (num_kf > target_kf) the most
    redundant eligible keyframes are culled regardless of the threshold,
    so a multi-lap run NEVER hits the round-3 hard wall at max_keyframes
    (VERDICT round-3 missing item 3; map.py:137-139 `can_insert`).

    Culled keyframes push (uid, anchor uid, relative pose) into the
    retired ring so trajectory composition stays exact — see
    resolve_kf_poses.  Slot 0 (gauge), the newest `protect_recent` slots,
    and loop-edge endpoints are never culled.  Landmarks of a culled
    keyframe re-anchor (lm_ref_kf) to the nearest surviving earlier
    keyframe; its observations drop (obs_valid False) and the following
    compact_map packs them out.
    """
    Kf = m.kf_valid.shape[0]
    L = m.lm_valid.shape[0]
    D = m.dead_valid.shape[0]
    slots = jnp.arange(Kf)

    # redundancy score per keyframe
    nobs = jax.ops.segment_sum(
        m.obs_valid.astype(jnp.float32), m.obs_lm, num_segments=L)
    well = nobs[m.obs_lm] >= min_covisible.astype(jnp.float32) + 1.0
    kf_tot = jax.ops.segment_sum(
        m.obs_valid.astype(jnp.float32), m.obs_kf, num_segments=Kf)
    kf_well = jax.ops.segment_sum(
        (m.obs_valid & well).astype(jnp.float32), m.obs_kf, num_segments=Kf)
    # a keyframe with ZERO live observations carries no map information —
    # treat it as fully redundant so stale keyframes whose landmarks were
    # all culled by compact_map remain cullable (ADVICE round-4 low #1)
    red = jnp.where(kf_tot > 0.0, kf_well / jnp.maximum(kf_tot, 1.0), 1.0)

    # protect endpoints of only the NEWEST protect_loop_recent loop edges:
    # permanent protection of every edge ever accepted shrinks the
    # eligible set below n_force on long many-loop runs and re-creates the
    # capacity hard wall (ADVICE round-4 medium #2).  Ring slot r holds
    # the edge with age (num_loop - 1 - r) mod Le; edges older than the
    # window lose protection — when such an edge's endpoint is culled the
    # edge is RETIRED ONTO THE ANCHOR below (measurement composed with the
    # culled->anchor offset), so the constraint survives recycling.
    Le = m.loop_valid.shape[0]
    edge_age = jnp.mod(m.num_loop - 1 - jnp.arange(Le), Le)
    edge_protected = m.loop_valid & (edge_age < protect_loop_recent)
    in_loop = (jnp.zeros(Kf, jnp.int32)
               .at[m.loop_i].add(edge_protected.astype(jnp.int32))
               .at[m.loop_j].add(edge_protected.astype(jnp.int32))) > 0
    protected = ((slots == 0) | (slots >= m.num_kf - protect_recent)
                 | in_loop | ~m.kf_valid)
    eligible = ~protected
    cull = eligible & (red >= redundancy)
    # capacity pressure: force the most redundant out until target_kf fits
    n_force = jnp.maximum(m.num_kf - target_kf, 0)
    score = jnp.where(eligible, red, -jnp.inf)
    rank = jnp.argsort(jnp.argsort(-score))        # 0 = most redundant
    cull = cull | (eligible & (rank < n_force))
    keep = m.kf_valid & ~cull

    order = jnp.argsort(~keep, stable=True)        # kept first, slot order
    csum = jnp.cumsum(keep.astype(jnp.int32))
    # new index of the nearest kept slot at-or-before each old slot (for a
    # kept slot: its own new index; for a culled one: its anchor)
    before_idx = jnp.maximum(csum - 1, 0)
    anchor_old = order[before_idx]                 # old slot of that anchor

    # retired ring push (one slot per culled keyframe, non-culled rows
    # write out-of-range and drop)
    crank = jnp.cumsum(cull.astype(jnp.int32)) - 1
    pos = jnp.where(cull, jnp.mod(m.num_dead + crank, D), D)
    rel = jnp.matmul(jax.vmap(geo.pose_inverse)(m.kf_pose[anchor_old]),
                     m.kf_pose)
    m = m._replace(
        dead_uid=m.dead_uid.at[pos].set(m.kf_frame_id, mode="drop"),
        dead_anchor_uid=m.dead_anchor_uid.at[pos].set(
            m.kf_frame_id[anchor_old], mode="drop"),
        dead_rel=m.dead_rel.at[pos].set(rel, mode="drop"),
        dead_seq=m.dead_seq.at[pos].set(
            m.num_dead + crank, mode="drop"),
        dead_valid=m.dead_valid.at[pos].set(True, mode="drop"),
        num_dead=m.num_dead + jnp.sum(cull).astype(jnp.int32),
    )

    # pack keyframe arrays (payloads of invalid slots are stale but every
    # consumer masks by kf_valid).  Culled keyframes' observations drop,
    # and the obs list is stable-packed HERE (not deferred to compact_map)
    # so num_obs stays the exact allocation head and the sorted-prefix
    # invariant (_verify_world) holds standalone — a bare
    # compact_keyframes call no longer leaks obs slots or leaves valid
    # rows beyond num_obs for insert_keyframe to clobber (ADVICE round-4
    # medium #1).
    obs_keep = m.obs_valid & keep[m.obs_kf]
    obs_kf_new = jnp.where(obs_keep, before_idx[m.obs_kf], 0)
    oorder = jnp.argsort(~obs_keep, stable=True)
    obs_valid = obs_keep[oorder]
    # retire loop edges onto surviving anchors: an edge (i, j, T_ij) whose
    # endpoint i was culled becomes (anchor_i, j) with measurement
    # rel_i @ T_ij @ rel_j^-1 (rel_k = inv(T_anchor) T_k at cull time,
    # identity for kept endpoints) — the constraint T_i'^-1 T_j' ~ T_i'j'
    # is exact at cull time, so long many-loop runs keep EVERY accepted
    # loop's pull instead of silently dropping old ones (ADVICE round-4
    # medium #2, remap option).  Degenerate self-edges (both endpoints
    # collapse onto one anchor) are dropped.
    rel_i = rel[m.loop_i]
    rel_j_inv = jax.vmap(geo.pose_inverse)(rel[m.loop_j])
    loop_T = jnp.matmul(rel_i, jnp.matmul(m.loop_T, rel_j_inv))
    new_li = before_idx[m.loop_i]
    new_lj = before_idx[m.loop_j]
    loop_valid = m.loop_valid & (new_li != new_lj)
    return m._replace(
        kf_pose=m.kf_pose[order],
        kf_valid=keep[order],
        kf_frame_id=m.kf_frame_id[order],
        kf_desc=m.kf_desc[order],
        kf_xy=m.kf_xy[order],
        kf_points=m.kf_points[order],
        kf_has_point=m.kf_has_point[order],
        kf_global_desc=m.kf_global_desc[order],
        lm_ref_kf=jnp.where(m.lm_valid, before_idx[m.lm_ref_kf], 0),
        obs_kf=jnp.where(obs_valid, obs_kf_new[oorder], 0),
        obs_lm=jnp.where(obs_valid, m.obs_lm[oorder], 0),
        obs_uv=jnp.where(obs_valid[:, None], m.obs_uv[oorder], 0.0),
        obs_z=jnp.where(obs_valid, m.obs_z[oorder], 0.0),
        obs_valid=obs_valid,
        num_obs=jnp.sum(obs_keep).astype(jnp.int32),
        loop_i=jnp.where(loop_valid, new_li, 0),
        loop_j=jnp.where(loop_valid, new_lj, 0),
        loop_T=jnp.where(loop_valid[:, None, None], loop_T, m.loop_T),
        loop_valid=loop_valid,
        num_kf=jnp.sum(keep).astype(jnp.int32),
    )


def resolve_kf_poses(m: MapState) -> dict:
    """uid (keyframe frame_id) -> final optimized world pose, for live AND
    retired keyframes (host-side, at result time only).

    Retired entries resolve newest-cull-first: each anchor was alive at
    cull time, so it is either still live or was retired LATER (= already
    resolved).  Entries overwritten by ring wraparound are simply absent —
    callers fall back to the pose recorded at frame emission."""
    import numpy as np

    kf_valid = np.asarray(m.kf_valid)
    kf_uid = np.asarray(m.kf_frame_id)
    kf_pose = np.asarray(m.kf_pose)
    table = {int(u): kf_pose[i]
             for i, u in enumerate(kf_uid) if kf_valid[i]}
    dv = np.flatnonzero(np.asarray(m.dead_valid))
    if dv.size:
        seq = np.asarray(m.dead_seq)[dv]
        uid = np.asarray(m.dead_uid)[dv]
        anc = np.asarray(m.dead_anchor_uid)[dv]
        rel = np.asarray(m.dead_rel)[dv]
        for j in np.argsort(-seq):
            u, a = int(uid[j]), int(anc[j])
            if u not in table and a in table:
                table[u] = table[a] @ rel[j]
    return table


@functools.partial(jax.jit, static_argnames=("max_hamming", "window"))
@f32_estimation
def associate_landmarks(
    m: MapState,
    feats: Features,
    T_wc_pred: Array,
    intrinsics: Array,
    max_hamming: float = 64.0,
    window: float = 24.0,
) -> tuple[Array, Array]:
    """Match frame keypoints to map landmarks by projecting landmarks into
    the predicted view and Hamming-matching within a window.

    Returns (lm_idx (K,), ok (K,)).
    """
    from jetracer_orbslam2_tpu.ops import match as match_ops

    T_cw = geo.pose_inverse(T_wc_pred)
    pts_c = geo.transform_points(T_cw, m.lm_pos[None])[0]
    uv = geo.project(pts_c, intrinsics)
    in_front = pts_c[:, 2] > 0.05
    res = match_ops.match(
        feats.desc, m.lm_desc,
        feats.valid, m.lm_valid & in_front,
        xy_a_pred=feats.xy, xy_b=uv,
        window=window, max_hamming=max_hamming, mutual=True,
    )
    return res.idx, res.valid
