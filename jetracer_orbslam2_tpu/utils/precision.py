"""Matmul precision control and audit.

On the GPU, a float32 matmul at default precision may run in TF32 on the
tensor cores: operands keep a 10-bit mantissa, about three decimal digits.
Each contraction in this program either tolerates that or names its
precision:

- Front-end contractions are exact by construction or set per op: the
  Hamming matcher contracts +-1 operands in bf16 with f32 accumulation
  (ops/match.py), and the one-hot patch and BRIEF selections run at
  Precision.HIGHEST (ops/patches.py, ops/orb.py) so pixel values pass
  through unrounded.
- The ESTIMATION path (pose composition chains, Kabsch covariances, RANSAC
  scoring, BA Jacobian products, pose graph, trajectory evaluation) runs
  under `f32_estimation`.  TF32's ~1e-3 relative rounding is centimeters
  at scene scale, the order of the RANSAC inlier gate (0.05 m), and it
  compounds over hundreds of chained frames.  These matmuls are tiny
  (3x3/4x4/Kx3), so full f32 costs nothing.

`f32_estimation` wraps a function body in jax.default_matmul_precision
("float32") AT TRACE TIME: apply it under `jax.jit` so every matmul/einsum
traced inside the estimation graph gets f32 precision, while the fused
front-end graphs keep their explicit per-op choices.

`tf32_eligible_dots` lists the contractions of a traced function that the
GPU may run in TF32; tests/test_precision.py pins the main path's list.
"""

from __future__ import annotations

import functools

import jax
import jax.extend
import jax.numpy as jnp


def f32_estimation(fn):
    """Decorator: trace `fn` with float32 matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for item in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(item, jax.extend.core.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jax.extend.core.Jaxpr):
                yield item


def _walk(jaxpr, found):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            prec = eqn.params.get("precision")
            dtypes = {v.aval.dtype for v in eqn.invars}
            highest = (isinstance(prec, tuple) and all(
                p == jax.lax.Precision.HIGHEST for p in prec))
            if jnp.dtype(jnp.float32) in dtypes and not highest:
                found.append(" x ".join(
                    str(tuple(v.aval.shape)) for v in eqn.invars))
        for sub in _sub_jaxprs(eqn):
            _walk(sub, found)


def tf32_eligible_dots(fn, *args, **kwargs) -> list[str]:
    """Operand shapes of every float32 dot_general in `fn(*args)` whose
    precision is below HIGHEST once traced with the GPU default
    (DEFAULT precision).  Static arguments go in `kwargs`."""
    found: list[str] = []
    with jax.default_matmul_precision("default"):
        closed = jax.make_jaxpr(functools.partial(fn, **kwargs))(*args)
    _walk(closed.jaxpr, found)
    return found
