"""Gradient parity for the differentiable Pallas tier.

The custom_vjp chord kernel + winner-recompute closest-hit must give the
same gradients as plain jax.grad through the dense jnp backend — for
material parameters (absorption/density/echo), the listener/ray origin,
and audio target positions (BASELINE: "gradients to material
absorption/permeation/echo and source/listener poses").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_raytracer_tpu.models.differentiable import (
    Loudness,
    SceneParams,
    loudness_loss,
    loudness_map,
)
from audio_raytracer_tpu.models.raytracer import random_scene
from audio_raytracer_tpu.ops.backend import DenseBackend
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.ops.pallas import PallasBackend
from audio_raytracer_tpu.types import TraceConfig


def _pallas_diff(scene):
    return PallasBackend(scene, interpret=True, differentiable=True)


@pytest.fixture(scope="module")
def setup():
    scene = random_scene(jax.random.key(7), num_spheres=7, num_aabbs=9,
                         num_obbs=8, num_targets=2, extent=14.0,
                         size_range=(1.0, 4.0), target_owned_colliders=True)
    cfg = TraceConfig(ray_count=48, max_bounces=3, max_ray_life=200.0)
    origin = jnp.zeros(3)
    dirs = fibonacci_directions(48)
    target = Loudness(muffle=jnp.full((2,), 0.3),
                      permeation=jnp.full((2,), 0.2),
                      reverb_energy=jnp.asarray(0.05))
    return scene, cfg, origin, dirs, target


def _assert_tree_allclose(a, b, rtol=2e-4, atol=2e-6):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=rtol, atol=atol)


class TestMaterialGradParity:
    def test_param_grads_match_dense(self, setup):
        scene, cfg, origin, dirs, target = setup
        params = SceneParams.from_scene(scene)

        g_dense = jax.grad(loudness_loss)(params, scene, origin, dirs, cfg,
                                          target)
        g_pal = jax.grad(loudness_loss)(params, scene, origin, dirs, cfg,
                                        target, backend_fn=_pallas_diff)
        # Gradients must be non-trivial and match the jnp AD path.
        total = sum(float(jnp.sum(jnp.abs(g))) for g in jax.tree.leaves(g_pal))
        assert total > 0.0
        _assert_tree_allclose(g_dense, g_pal)

    def test_density_grad_fd(self, setup):
        """Finite differences directly through the custom_vjp chord path."""
        scene, cfg, origin, dirs, target = setup
        params = SceneParams.from_scene(scene)

        def f(dens_a):
            p = SceneParams(
                sphere=params.sphere,
                aabb=type(params.aabb)(params.aabb.absorption, dens_a,
                                       params.aabb.echo),
                obb=params.obb)
            return loudness_loss(p, scene, origin, dirs, cfg, target,
                                 backend_fn=_pallas_diff)

        dens = params.aabb.density
        g = jax.grad(f)(dens)
        # Probe the largest-|grad| entries: tiny gradients fall below f32
        # central-difference resolution and would compare against FD noise.
        top = np.argsort(-np.abs(np.asarray(g)))[:3]
        eps = 1e-3
        for i in top:
            e = jnp.zeros_like(dens).at[i].set(eps)
            fd = (f(dens + e) - f(dens - e)) / (2 * eps)
            np.testing.assert_allclose(float(g[i]), float(fd),
                                       rtol=5e-2, atol=1e-6)


class TestPoseGradParity:
    def test_origin_grad_matches_dense(self, setup):
        scene, cfg, origin, dirs, target = setup
        params = SceneParams.from_scene(scene)

        def loss_o(o, backend_fn):
            return loudness_loss(params, scene, o, dirs, cfg, target,
                                 backend_fn=backend_fn)

        g_dense = jax.grad(loss_o)(origin, None)
        g_pal = jax.grad(loss_o)(origin, _pallas_diff)
        assert float(jnp.sum(jnp.abs(g_pal))) > 0.0
        np.testing.assert_allclose(np.asarray(g_dense), np.asarray(g_pal),
                                   rtol=5e-4, atol=1e-6)

    def test_target_position_grad_matches_dense(self, setup):
        scene, cfg, origin, dirs, target = setup
        params = SceneParams.from_scene(scene)

        def loss_tp(tp, backend_fn):
            sc = scene.replace(target_positions=tp)
            return loudness_loss(params, sc, origin, dirs, cfg, target,
                                 backend_fn=backend_fn)

        tp = scene.target_positions
        g_dense = jax.grad(loss_tp)(tp, None)
        g_pal = jax.grad(loss_tp)(tp, _pallas_diff)
        assert float(jnp.sum(jnp.abs(g_pal))) > 0.0
        np.testing.assert_allclose(np.asarray(g_dense), np.asarray(g_pal),
                                   rtol=5e-4, atol=1e-6)


class TestForwardValueUnchanged:
    def test_diff_mode_forward_matches_plain_pallas(self, setup):
        scene, cfg, origin, dirs, _ = setup
        plain = loudness_map(origin, dirs, scene, cfg,
                             backend=PallasBackend(scene, interpret=True))
        diff = loudness_map(origin, dirs, scene, cfg,
                            backend=_pallas_diff(scene))
        _assert_tree_allclose(plain, diff, rtol=1e-5, atol=1e-6)

    def test_diff_mode_matches_dense_forward(self, setup):
        scene, cfg, origin, dirs, _ = setup
        dense = loudness_map(origin, dirs, scene, cfg,
                             backend=DenseBackend(scene))
        diff = loudness_map(origin, dirs, scene, cfg,
                            backend=_pallas_diff(scene))
        _assert_tree_allclose(dense, diff, rtol=1e-4, atol=1e-5)


class TestDensOnlyAdjoint:
    def test_dens_only_matches_full_adjoint(self, setup):
        """pose_grads=False stops the chord backward's ray gradients;
        material gradients must match the full backward (ray
        cotangents are dead in materials-only training)."""
        scene, cfg, origin, dirs, target = setup
        params = SceneParams.from_scene(scene)

        def be_full(s):
            return PallasBackend(s, interpret=True, differentiable=True)

        def be_dens(s):
            return PallasBackend(s, interpret=True, differentiable=True,
                                 pose_grads=False)

        g_full = jax.grad(loudness_loss)(params, scene, origin, dirs, cfg,
                                         target, backend_fn=be_full)
        g_dens = jax.grad(loudness_loss)(params, scene, origin, dirs, cfg,
                                         target, backend_fn=be_dens)
        total = sum(float(jnp.sum(jnp.abs(g)))
                    for g in jax.tree.leaves(g_dens))
        assert total > 0.0
        _assert_tree_allclose(g_full, g_dens, rtol=1e-5, atol=1e-7)
