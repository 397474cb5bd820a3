"""Differentiable bridge for the chord kernel.

Pallas calls have no automatic AD rules, so the differentiable tier
wires the permeation kernel into JAX autodiff explicitly:

- ``multi_chord_loss``: jax.custom_vjp whose forward is the fused chord
  kernel and whose backward is ``jax.vjp`` of the plain chunked chord
  fold (ops.backend.DenseBackend.multi_permeation_loss): the
  per-primitive density sum over rays is a plain XLA reduction, and the
  fold's rematerialised chunks keep the backward at O(R) memory per
  chunk. Gradients reach ray origins/directions (source and listener
  poses) and every material leaf of the scene.
- Closest-hit distances are differentiated by the winner-recompute trick
  instead (ops.intersect.primitive_t_per_ray), in
  ops.pallas.backend.PallasBackend(differentiable=True).
- Occlusion/visibility booleans carry no tangents by construction
  (straight-through, matching models.differentiable's convention).
"""

from __future__ import annotations

from functools import partial

import jax

from audio_raytracer_tpu.ops.backend import DenseBackend
from audio_raytracer_tpu.ops.pallas import kernels as K


@partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def multi_chord_loss(skips, interpret, o, dirs, scene):
    """Differentiable fused permeation loss over S target ray sets.

    skips/interpret are static; o: [R, 3]; dirs: tuple of S [R, 3]
    (normalized); scene: the Scene whose materials receive gradients.
    Returns [R, S]."""
    return K.run_multi_chord(K.pack_tables(scene), o, list(dirs), skips,
                             interpret=interpret)


def _fwd(skips, interpret, o, dirs, scene):
    return multi_chord_loss(skips, interpret, o, dirs, scene), (o, dirs,
                                                                scene)


def _bwd(skips, interpret, res, g):
    def plain(o, dirs, scene):
        # The kernel's output is f32 even for an f64 scene.
        return DenseBackend(scene).multi_permeation_loss(
            o, list(dirs), skips).astype(g.dtype)

    _, vjp = jax.vjp(plain, *res)
    return vjp(g)


multi_chord_loss.defvjp(_fwd, _bwd)
