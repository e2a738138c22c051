"""GPU-only checks: the front-end and BA on the card against the CPU in the
same process.  Skipped without a GPU; run them on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -m gpu`."""

import pytest

import chip_smoke as cs


@pytest.mark.gpu
def test_gpu_frontend_matches_cpu(gpu):
    r = cs.phase_frontend(480, 640, 4, 1024)
    assert all(v["kp_diff"] == 0 for v in r.values())


@pytest.mark.gpu
def test_gpu_bundle_adjust_matches_cpu(gpu):
    r = cs.phase_ba(8, 4096, 6, 10)
    assert r["cost_rel_diff_vs_cpu"] < cs.BA_COST_RTOL
