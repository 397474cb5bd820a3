"""PallasBackend: the plain engine with its hot stages on kernels.

Drop-in replacement for ops.backend.DenseBackend behind the same
protocol. It IS a DenseBackend: every stage without a kernel runs the
plain path, and the kernel stages (closest hit, fused occlusion, fused
chords; ops.pallas.kernels) are compared against it. Table packing
happens at trace time inside jit — it is O(P) and fuses away.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from audio_raytracer_tpu.ops import intersect
from audio_raytracer_tpu.ops.backend import DenseBackend
from audio_raytracer_tpu.ops.pallas import kernels as K
from audio_raytracer_tpu.types import Scene

Array = jnp.ndarray


class PallasBackend(DenseBackend):
    """All primitives visible locally, hot stages on the kernel tier.

    ``interpret=True`` runs the kernels in the Pallas interpreter
    (CPU-testable parity path).

    ``differentiable=True`` enables gradient flow at O(R) memory per
    primitive chunk: closest-hit distances are recomputed differentiably
    for the kernel's winner (ops.intersect.primitive_t_per_ray —
    gradients to poses and winner geometry); permeation runs the chord
    kernel forward and the VJP of the plain chunked chord fold backward
    (ops.pallas.diff — gradients to material density and ray
    origins/directions); material absorption/echo flow through the
    unified-attribute gathers as always. Occlusion booleans stay
    straight-through (no tangents), matching models.differentiable.

    - ``pose_grads=False`` (materials-only training) stops the gradient
      on the permeation rays, so XLA prunes the ray cotangents of the
      chord backward. Only set it when ray positions are independent of
      the differentiated parameters (true for material optimization;
      NOT for source or listener pose optimization).

    ``compute_dtype`` (f32 or bf16) applies to the forward kernels; the
    differentiable tier runs f32.
    """

    supports_block_skip = True
    fused_sets = True

    def __init__(self, scene: Scene, interpret: bool = False,
                 differentiable: bool = False,
                 compute_dtype=jnp.float32, pose_grads: bool = True):
        super().__init__(scene)
        self.interpret = interpret
        self.differentiable = differentiable
        self.pose_grads = pose_grads
        self.compute_dtype = (jnp.float32 if differentiable
                              else jnp.dtype(compute_dtype).type)
        self.total = scene.num_primitives
        # Kernel inputs never carry tangents: closest hit is
        # differentiated by winner recompute, occlusion is
        # straight-through, chords by the custom VJP in ops.pallas.diff.
        self._tabs = K.pack_tables(jax.lax.stop_gradient(scene))

    @property
    def recompute_winner_t(self) -> bool:
        """Kernel t values are stop-gradded; a PrimShardedBackend wrapper
        must recompute the merged winner's t differentiably."""
        return self.differentiable

    def _kernel_closest(self, o, d, alive=None):
        sg = jax.lax.stop_gradient
        t, rank = K.run_closest_hit(
            self._tabs, sg(o.astype(jnp.float32)), sg(d.astype(jnp.float32)),
            alive=alive, interpret=self.interpret, dtype=self.compute_dtype)
        return t, jnp.minimum(rank, self.total - 1)

    def local_closest(self, o: Array, d: Array, alive: Array | None = None):
        """(t [R] (+inf miss), idx [R] clamped local winner index)."""
        return self._kernel_closest(o, d, alive)

    def closest_hit(self, o: Array, d: Array, alive: Array | None = None):
        if self.total == 0:
            return super().closest_hit(o, d)
        t, idx = self._kernel_closest(o, d, alive)
        # Geometry columns gather from a stop-gradded table: pose
        # gradients flow through the o/d winner recompute, materials
        # through their own gather (the BASELINE gradient surface).
        u = self._uni
        sg = jax.lax.stop_gradient
        attrs = dict(kind=u["kind"][idx], center=sg(u["center"])[idx],
                     half_extents=sg(u["half_extents"])[idx],
                     inv_rot=sg(u["inv_rot"])[idx],
                     absorption=u["absorption"][idx], echo=u["echo"][idx])
        hit = jnp.isfinite(t)
        if self.differentiable:
            t_rec = intersect.primitive_t_per_ray(
                o.astype(jnp.float32), d.astype(jnp.float32), attrs["kind"],
                attrs["center"], attrs["half_extents"], attrs["inv_rot"])
            t = jnp.where(hit, t_rec, jnp.inf)
        return hit, t, attrs

    def closest_t(self, o: Array, d: Array) -> Array:
        return self.closest_hit(o, d)[1]

    def multi_occluded(self, o, dirs, limits, skips, init_occ) -> Array:
        """Fused S-ray-set occlusion: one primitive stream per ray block
        (kernels.run_multi_any_hit); booleans are straight-through."""
        if self.total == 0:
            return init_occ
        sg = jax.lax.stop_gradient
        return K.run_multi_any_hit(
            self._tabs, sg(o.astype(jnp.float32)),
            [sg(d.astype(jnp.float32)) for d in dirs],
            sg(limits.astype(jnp.float32)), tuple(skips), init_occ,
            interpret=self.interpret, dtype=self.compute_dtype)

    def multi_permeation_loss(self, o, dirs, skips) -> Array:
        """Fused S-target permeation (kernels.run_multi_chord); with
        ``differentiable=True`` the VJP of the plain chord fold supplies
        gradients to o, each direction set and the scene's materials."""
        if self.total == 0:
            return jnp.zeros(o.shape[:-1] + (len(dirs),), o.dtype)
        o = o.astype(jnp.float32)
        dirs = tuple(d.astype(jnp.float32) for d in dirs)
        if self.differentiable:
            from audio_raytracer_tpu.ops.pallas.diff import multi_chord_loss

            if not self.pose_grads:
                o = jax.lax.stop_gradient(o)
                dirs = tuple(jax.lax.stop_gradient(d) for d in dirs)
            return multi_chord_loss(tuple(skips), self.interpret, o, dirs,
                                    self.scene)
        sg = jax.lax.stop_gradient
        return K.run_multi_chord(self._tabs, sg(o), [sg(d) for d in dirs],
                                 tuple(skips), interpret=self.interpret,
                                 dtype=self.compute_dtype)
