"""jetracer_orbslam2_tpu — a stereo/RGB-D visual SLAM framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
CUDA pipeline dsvua/jetracer-orbslam2 (surveyed in SURVEY.md):

- ORB front-end: image pyramid, FAST detection, grid non-max suppression,
  oriented 256-bit BRIEF descriptors (reference: src/cuda/{fast,nms,orb}.cu)
- depth/RGB alignment + (de)projection (reference: src/cuda/cuda-align.cu)
- reprojection-gated Hamming matching (reference: src/cuda/post_processing.cu)
- SVD/Kabsch + ICP pose tracking — actually closing the loop the reference
  left disabled (reference: src/SlamGpuPipeline/buildStream.cpp:29-188,572-584)
- IMU complementary filter (reference: src/SlamGpuPipeline/SlamGpuPipeline.cpp:179-239)
- and the back-end the reference only stubbed: keyframe/landmark map, local
  bundle adjustment (Schur-complement Levenberg–Marquardt), loop closure and
  pose-graph optimization, shardable over device meshes (`parallel/`).

Everything on the compute path is fixed-shape, batch-first JAX; hot kernels
have Pallas implementations; the host runtime (event bus, pipeline executor,
dataset prefetch) lives in `runtime/` and `native/`.
"""

__version__ = "0.1.0"

from jetracer_orbslam2_tpu.config import (  # noqa: F401
    FrontendConfig,
    TrackingConfig,
    MapConfig,
    BAConfig,
    SystemConfig,
)
