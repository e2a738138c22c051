"""Device kernels (L1): fixed-shape, batch-first JAX/Pallas ops.

Each module is the Array-program equivalent of one reference CUDA kernel family
(see SURVEY.md §2.4):

- preprocess: rgb_to_gray / gaussian_blur_3x3 / pyramid
- fast:       FAST corner response (branchless ring test)
- nms:        3x3 + grid non-max suppression, fixed-K selection
- patches:    batched keypoint patch gather
- orb:        orientation + rotated BRIEF-256
- match:      matmul Hamming matching
- align:      depth->color alignment, backprojection
- geometry:   SE(3), camera models, Kabsch
"""

from jetracer_orbslam2_tpu.ops import (  # noqa: F401
    align,
    fast,
    geometry,
    match,
    nms,
    orb,
    patches,
    preprocess,
)
