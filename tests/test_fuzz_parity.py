"""Randomized parity sweep: pallas_interpret vs dense across shape
edges (zero-count types, zero targets, non-power-of-two ray counts,
single primitives, random bounce depths, compaction on/off).

Each draw is tiny; the value is coverage of padding/masking edges the
structured tests don't enumerate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from audio_raytracer_tpu.models.raytracer import forward, random_scene
from audio_raytracer_tpu.ops.backend import CHUNK
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.types import TraceConfig

CASES = [
    # (ns, na, no, targets, rays, bounces, compact, unordered)
    (0, 12, 0, 2, 97, 2, False, False),   # AABB-only, odd ray count
    (7, 0, 0, 1, 33, 1, False, False),    # sphere-only, tiny
    (0, 0, 9, 3, 130, 3, True, False),    # OBB-only, compaction
    (1, 1, 1, 2, 64, 4, False, False),    # single prim of each type
    (5, 9, 4, 0, 50, 2, False, False),    # ZERO targets (echo set only)
    (6, 8, 6, 5, 201, 3, True, False),    # many targets, odd rays, compact
    (0, 0, 9, 3, 130, 3, True, True),     # unordered tier
    (6, 8, 6, 5, 201, 3, True, True),     # unordered, many targets
    (5, 9, 4, 0, 50, 2, True, True),      # unordered, ZERO targets
    (0, 12, 0, 2, 97, 2, True, True),     # unordered, odd ray count
]


def test_random_shape_parity():
    for i, (ns, na, no, T, R, B, compact, unordered) in enumerate(CASES):
        scene = random_scene(jax.random.key(100 + i), num_spheres=ns,
                             num_aabbs=na, num_obbs=no, num_targets=T,
                             extent=20.0, size_range=(1.0, 4.0))
        cfg = TraceConfig(ray_count=R, max_bounces=B, max_ray_life=80.0,
                          num_accum_batches=2, compact_rays=compact,
                          compact_unordered=unordered)
        origin = jnp.asarray([0.3, -0.2, 0.1])
        dirs = fibonacci_directions(R)
        r_d, s_d = forward(origin, dirs, scene, cfg, backend="jnp")
        r_p, s_p = forward(origin, dirs, scene, cfg,
                           backend="pallas_interpret")
        if unordered:
            # The unordered tier permutes echo rows within each bounce
            # column (by design); compare columns as multisets.
            import dataclasses as _dc
            r_p = _dc.replace(r_p, echo_distances=jnp.sort(
                r_p.echo_distances, axis=0))
            r_d = _dc.replace(r_d, echo_distances=jnp.sort(
                r_d.echo_distances, axis=0))
        # Tolerance contract, not bit-equality: a closest-hit near-TIE
        # between two primitives can resolve differently under the
        # kernels' Newton-refined reciprocal (~1 ulp) vs XLA's divide,
        # and the whole bounce path of that ray then diverges (chaotic
        # reflection). Random draws do hit such ties (case 2, seed 102:
        # one of 130 rays). Allow a couple of rays' worth of drift;
        # anything structural (padding, masking, accumulation) would
        # blow well past it.
        R_, H_ = np.asarray(r_d.echo_distances).shape
        mh_d = np.asarray(r_d.muffle_hits).astype(np.int64)
        mh_p = np.asarray(r_p.muffle_hits).astype(np.int64)
        assert np.abs(mh_d - mh_p).sum() <= 3 * H_, (
            f"case {i}: muffle_hits drift {np.abs(mh_d - mh_p).sum()}")
        echo_mismatch = (np.abs(np.asarray(r_d.echo_distances)
                                - np.asarray(r_p.echo_distances))
                         > 1e-3).mean()
        assert echo_mismatch <= 3.0 / R_, f"case {i}: echo {echo_mismatch}"
        np.testing.assert_allclose(
            np.asarray(s_d.muffle), np.asarray(s_p.muffle),
            rtol=1e-3, atol=3.0 * H_ / max(R_ * H_, 1),
            err_msg=f"case {i}: muffle")
        np.testing.assert_allclose(
            np.asarray(r_d.permeation), np.asarray(r_p.permeation),
            rtol=1e-3, atol=1e-2, err_msg=f"case {i}: permeation")


def test_gradient_shape_edges():
    """Materials-gradient parity (dense AD vs the kernel tier) at
    adversarial shapes: zero-count types, single prims, odd ray counts —
    guards the kernels' padding edges and the custom VJP's wiring."""
    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        SceneParams,
        loudness_loss,
    )
    from audio_raytracer_tpu.ops.pallas import PallasBackend

    grad_cases = [
        (0, 10, 0, 2, 65, 2),   # AABB-only, odd rays
        (5, 0, 3, 1, 40, 2),    # no AABBs
        (1, 1, 1, 3, 96, 3),    # single prim each
        # Edges of the plain fold's primitive chunks (ops.backend.CHUNK),
        # whose VJP is the kernel tier's chord backward: exactly one
        # chunk (one grid), and one sphere past it (two sphere chunks,
        # the second padded with inactive slots).
        (0, CHUNK, 0, 1, 40, 1),      # exactly one full chunk
        (CHUNK + 1, 3, 2, 2, 48, 2),  # sphere stream crosses the boundary
    ]
    for i, (ns, na, no, T, R, B) in enumerate(grad_cases):
        scene = random_scene(jax.random.key(200 + i), num_spheres=ns,
                             num_aabbs=na, num_obbs=no, num_targets=T,
                             extent=15.0, size_range=(1.5, 4.0))
        cfg = TraceConfig(ray_count=R, max_bounces=B, max_ray_life=90.0)
        origin = jnp.asarray([0.2, 0.1, -0.3])
        dirs = fibonacci_directions(R)
        params = SceneParams.from_scene(scene)
        target = Loudness(muffle=jnp.full((T,), 0.4),
                          permeation=jnp.full((T,), 0.3),
                          reverb_energy=jnp.asarray(0.1))

        g_dense = jax.grad(loudness_loss)(params, scene, origin, dirs,
                                          cfg, target)
        g_pal = jax.grad(loudness_loss)(
            params, scene, origin, dirs, cfg, target,
            backend_fn=lambda s: PallasBackend(
                s, interpret=True, differentiable=True))
        for a, b in zip(jax.tree.leaves(g_dense), jax.tree.leaves(g_pal)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=5e-4, atol=5e-6,
                err_msg=f"grad case {i}")


def test_dens_only_adjoint_matches_full_for_materials():
    """pose_grads=False (ray gradients of the chord backward stopped)
    must give IDENTICAL material gradients to the full backward — only
    the (dead) ray-pose cotangents differ. This is the invariant that justifies
    benching materials training with the cheap backward."""
    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        SceneParams,
        loudness_loss,
    )
    from audio_raytracer_tpu.ops.pallas import PallasBackend

    scene = random_scene(jax.random.key(77), num_spheres=5, num_aabbs=8,
                         num_obbs=5, num_targets=2, extent=15.0,
                         size_range=(1.5, 4.0))
    cfg = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=90.0)
    origin = jnp.asarray([0.2, 0.1, -0.3])
    dirs = fibonacci_directions(64)
    params = SceneParams.from_scene(scene)
    target = Loudness(muffle=jnp.full((2,), 0.4),
                      permeation=jnp.full((2,), 0.3),
                      reverb_energy=jnp.asarray(0.1))

    def grad_with(pose_grads):
        return jax.grad(loudness_loss)(
            params, scene, origin, dirs, cfg, target,
            backend_fn=lambda s: PallasBackend(
                s, interpret=True, differentiable=True,
                pose_grads=pose_grads))

    g_full = grad_with(True)
    g_dens = grad_with(False)
    for a, b in zip(jax.tree.leaves(g_full), jax.tree.leaves(g_dens)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


def test_pose_grads_across_chunk_boundary():
    """Pose gradients of the kernel tier (ray cotangents of the chord
    backward kept) vs dense autodiff with an AABB stream that crosses a
    chunk boundary of the plain fold — guards the carry threading of the
    fold's scan in the custom VJP's backward."""
    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        SceneParams,
        loudness_loss,
    )
    from audio_raytracer_tpu.ops.pallas import PallasBackend

    scene = random_scene(jax.random.key(88), num_spheres=3,
                         num_aabbs=CHUNK + 10,
                         num_obbs=2, num_targets=2, extent=15.0,
                         size_range=(1.5, 4.0))
    cfg = TraceConfig(ray_count=48, max_bounces=2, max_ray_life=90.0)
    dirs = fibonacci_directions(48)
    params = SceneParams.from_scene(scene)
    target = Loudness(muffle=jnp.full((2,), 0.4),
                      permeation=jnp.full((2,), 0.3),
                      reverb_energy=jnp.asarray(0.1))

    def loss(params, origin):
        return loudness_loss(
            params, scene, origin, dirs, cfg, target,
            backend_fn=lambda s: PallasBackend(
                s, interpret=True, differentiable=True, pose_grads=True))

    origin = jnp.asarray([0.2, 0.1, -0.3])
    g_p, g_o = jax.grad(loss, argnums=(0, 1))(params, origin)
    g_p_ref, g_o_ref = jax.grad(
        lambda p, o: loudness_loss(p, scene, o, dirs, cfg, target),
        argnums=(0, 1))(params, origin)
    np.testing.assert_allclose(np.asarray(g_o), np.asarray(g_o_ref),
                               rtol=5e-4, atol=5e-6)
    for a, b in zip(jax.tree.leaves(g_p_ref), jax.tree.leaves(g_p)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=5e-6)
