"""ORB front-end: one jitted function from image to features.

The reference's per-frame GPU worker loop runs ~10 kernels over 3 CUDA
streams with manual synchronization (reference:
src/SlamGpuPipeline/buildStream.cpp:345-666).  Here the whole front-end —
gray -> blur -> pyramid -> FAST -> grid NMS -> top-K -> patches ->
orientation -> BRIEF-256 -> backprojection — is ONE `jax.jit` graph: XLA
fuses the elementwise stages, overlaps independent subgraphs (what the CUDA
streams did by hand), and there is exactly one host<->device round trip per
frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jetracer_orbslam2_tpu.config import FrontendConfig
from jetracer_orbslam2_tpu.ops import (
    align, fast, geometry as geo, nms, orb, patches, preprocess)
from jetracer_orbslam2_tpu.ops.nms import Keypoints

Array = jax.Array


class Features(NamedTuple):
    """Fixed-K per-frame feature set (the slam_frame_t analogue,
    reference src/SlamGpuPipeline/types.h:25-65 — minus the JPEG).

    `xy` is in IDEAL-PINHOLE pixel coordinates: when the camera has
    distortion (FrontendConfig.dist), detection runs on the raw image and
    the keypoint coords are undistorted here, once — every downstream
    consumer (tracking windows, BA reprojection residuals, map
    association) then works in the same rectified measurement space."""

    xy: Array       # (K, 2) float32 level-0 ideal-pinhole pixel coords
    level: Array    # (K,) int32
    score: Array    # (K,) float32
    angle: Array    # (K,) float32 radians
    desc: Array     # (K, 8) uint32 packed BRIEF-256
    valid: Array    # (K,) bool detection validity
    points: Array   # (K, 3) float32 camera-frame 3D (0 if no depth)
    has_point: Array  # (K,) bool valid AND has usable depth


def extract_features(
    gray: Array,
    cfg: FrontendConfig,
) -> tuple[Keypoints, Array, Array]:
    """Detect + describe on a grayscale image.

    Returns (keypoints, angles, descriptors). Pure function of fixed shapes;
    call under jit.
    """
    blurred = preprocess.gaussian_blur_3x3(gray)
    levels = preprocess.build_pyramid(blurred, cfg.num_levels)

    def cell_winners(img, threshold):
        resp = fast.fast_score_map(
            img, threshold, cfg.fast_arc_length, cfg.fast_border)
        return nms.grid_nms(resp, cfg.cell_size)

    winners = []
    for img in levels:
        hi = cell_winners(img, cfg.fast_threshold)
        if cfg.fast_min_threshold > 0.0:
            # two-threshold adaptive detection (ORB-SLAM2 iniThFAST /
            # minThFAST): cells empty at the primary epsilon take the
            # low-epsilon winner, so texture-poor views keep features.
            # Strong cells are untouched, and top-K selection still
            # prefers higher scores, so weak corners only fill leftover
            # keypoint budget.
            lo = cell_winners(img, cfg.fast_min_threshold)
            use_hi = hi.score > cfg.min_score
            hi = nms.CellWinners(
                score=jnp.where(use_hi, hi.score, lo.score),
                y=jnp.where(use_hi, hi.y, lo.y),
                x=jnp.where(use_hi, hi.x, lo.x))
        winners.append(hi)
    kp = nms.select_keypoints(
        winners, cfg.level_shapes, cfg.max_keypoints, cfg.min_score, cfg.fast_border
    )
    patch = patches.extract_patches(levels, kp, cfg.patch_size)
    angles = orb.orientation(patch)
    desc = orb.describe(patch, angles, cfg.descriptor_bits, cfg.num_angle_bins)
    return kp, angles, desc


@functools.partial(jax.jit, static_argnames=("cfg", "min_depth", "max_depth"))
def frontend_rgbd(
    rgb: Array,
    depth: Array,
    intrinsics: Array,
    cfg: FrontendConfig,
    min_depth: float = 0.05,
    max_depth: float = 8.0,
) -> Features:
    """Full RGB-D front-end: (H, W, 3) rgb + (H, W) depth [m] -> Features."""
    gray = preprocess.rgb_to_gray(rgb)
    return frontend_gray_depth(gray, depth, intrinsics, cfg, min_depth, max_depth)


@functools.partial(jax.jit, static_argnames=("cfg", "min_depth", "max_depth"))
def frontend_gray_depth(
    gray: Array,
    depth: Array,
    intrinsics: Array,
    cfg: FrontendConfig,
    min_depth: float = 0.05,
    max_depth: float = 8.0,
) -> Features:
    kp, angles, desc = extract_features(gray.astype(jnp.float32), cfg)
    # camera distortion (cfg.dist): depth is registered to the RAW image,
    # so sampling happens at raw coords; deprojection undistorts the ray
    # (reference applies the same models per pixel in its align kernels,
    # src/cuda/cuda-align.cu:23-109) and the published keypoint coords are
    # ideal-pinhole (see Features docstring).
    dist = None if cfg.dist is None else jnp.asarray(cfg.dist, jnp.float32)
    if cfg.depth_intrinsics is not None:
        # UNREGISTERED depth camera: re-render the depth map into the
        # color frame first — the reference's per-frame production align
        # kernel (src/cuda/cuda-align.cu:366-399) as an on-device
        # scatter-min, fused into this jitted frontend.
        depth = align.align_depth_to_color(
            depth,
            jnp.asarray(cfg.depth_intrinsics, jnp.float32),
            intrinsics,
            jnp.asarray(cfg.T_color_depth, jnp.float32).reshape(4, 4),
            gray.shape,
            depth_dist=(None if cfg.depth_dist is None
                        else jnp.asarray(cfg.depth_dist, jnp.float32)),
            color_dist=dist)
    pts, has_depth = align.backproject_keypoints(
        kp.xy, depth, intrinsics, dist=dist, model=cfg.dist_model,
        min_depth=min_depth, max_depth=max_depth
    )
    xy = kp.xy if dist is None else geo.undistort_pixels(
        kp.xy, intrinsics, dist, cfg.dist_model)
    has_point = kp.valid & has_depth
    return Features(
        xy=xy,
        level=kp.level,
        score=kp.score,
        angle=angles,
        desc=desc,
        valid=kp.valid,
        points=jnp.where(has_point[:, None], pts, 0.0),
        has_point=has_point,
    )
