"""Finite-difference gradient checks for the differentiable loudness model.

BASELINE.md gate: "per-ray attenuation gradients match finite differences;
grads to material absorption/permeation/echo and source/listener poses".
We check directional derivatives of the scalar loss against central
differences at perturbation scales where the discrete trajectory
(closest-hit selection, visibility booleans) is stable.
"""

import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest

from audio_raytracer_tpu.models.differentiable import (
    Loudness,
    SceneParams,
    loudness_loss,
    loudness_map,
    make_train_step,
)
from audio_raytracer_tpu.models.raytracer import random_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.types import TraceConfig


@pytest.fixture(autouse=True, scope="module")
def enable_x64():
    """FD checks need f64: at f32, central differences on a ~1e-2 loss are
    dominated by rounding noise. Scoped to this module so the rest of the
    suite keeps canonical f32."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def setup(enable_x64):
    cfg = TraceConfig(ray_count=64, max_bounces=3, max_ray_life=150.0)
    # Dense scene (rays average >3 bounces) with near-listener targets so
    # every gradient path (energy, visibility, chords) is exercised.
    scene = random_scene(jax.random.key(11), num_spheres=10, num_aabbs=14,
                         num_obbs=10, num_targets=2, extent=12.0,
                         size_range=(1.5, 5.0), dtype=jnp.float64)
    scene = scene.replace(target_positions=jnp.asarray(
        [[2.0, 1.0, 0.5], [-1.5, 2.5, 1.0]]))
    origin = jnp.zeros(3)
    dirs = fibonacci_directions(cfg.ray_count, jnp.float64)
    params = SceneParams.from_scene(scene)
    # A reachable target map: the loudness field of the same scene with
    # perturbed materials (the BASELINE config-4 workload shape).
    def perturb(m):
        return dataclasses.replace(
            m, absorption=jnp.clip(m.absorption + 0.15, 0, 1),
            density=m.density * 0.6, echo=m.echo * 1.4)

    target_params = SceneParams(sphere=perturb(params.sphere),
                                aabb=perturb(params.aabb),
                                obb=perturb(params.obb))
    target = loudness_map(origin, dirs, target_params.into_scene(scene), cfg)
    return cfg, scene, origin, dirs, params, target


def fd_check(f, x0, key, rel_tol=0.05, n_dirs=3, eps=1e-3):
    """Directional-derivative FD check: grad . v vs (f(x+h v)-f(x-h v))/2h."""
    g = jax.grad(f)(x0)
    flat_g, unravel = jax.flatten_util.ravel_pytree(g)
    flat_x, _ = jax.flatten_util.ravel_pytree(x0)
    checked = 0
    for i in range(n_dirs):
        v = jax.random.normal(jax.random.fold_in(key, i), flat_x.shape)
        v = v / jnp.linalg.norm(v)
        fp = f(unravel_like(x0, flat_x + eps * v))
        fm = f(unravel_like(x0, flat_x - eps * v))
        fd = (fp - fm) / (2 * eps)
        an = jnp.dot(flat_g, v)
        if abs(float(fd)) < 1e-7 and abs(float(an)) < 1e-7:
            continue
        np.testing.assert_allclose(float(an), float(fd), rtol=rel_tol,
                                   atol=1e-6)
        checked += 1
    assert checked >= 1, "all FD probes degenerate"


def unravel_like(tree, flat):
    _, unravel = jax.flatten_util.ravel_pytree(tree)
    return unravel(flat)


class TestMaterialGradients:
    def test_echo_gradient(self, setup):
        cfg, scene, origin, dirs, params, target = setup

        def f(echo_flat):
            p = dataclasses.replace(
                params,
                aabb=dataclasses.replace(params.aabb, echo=echo_flat))
            return loudness_loss(p, scene, origin, dirs, cfg, target)

        fd_check(f, params.aabb.echo, jax.random.key(0))

    def test_absorption_gradient(self, setup):
        cfg, scene, origin, dirs, params, target = setup

        def f(absorp):
            p = dataclasses.replace(
                params,
                aabb=dataclasses.replace(params.aabb, absorption=absorp))
            return loudness_loss(p, scene, origin, dirs, cfg, target)

        fd_check(f, params.aabb.absorption, jax.random.key(1))

    def test_density_gradient(self, setup):
        cfg, scene, origin, dirs, params, target = setup

        def f(density):
            p = dataclasses.replace(
                params,
                obb=dataclasses.replace(params.obb, density=density))
            return loudness_loss(p, scene, origin, dirs, cfg, target)

        fd_check(f, params.obb.density, jax.random.key(2))

    def test_all_params_gradient(self, setup):
        cfg, scene, origin, dirs, params, target = setup

        def f(p):
            return loudness_loss(p, scene, origin, dirs, cfg, target)

        fd_check(f, params, jax.random.key(3))


class TestPoseGradients:
    def test_target_position_gradient(self, setup):
        cfg, scene, origin, dirs, params, target = setup

        def f(tp):
            s = scene.replace(target_positions=tp)
            return loudness_loss(params, s, origin, dirs, cfg, target)

        fd_check(f, scene.target_positions, jax.random.key(4), rel_tol=0.08,
                 eps=1e-5)

    def test_listener_origin_gradient(self, setup):
        cfg, scene, origin, dirs, params, target = setup

        def f(o):
            return loudness_loss(params, scene, o, dirs, cfg, target)

        fd_check(f, origin, jax.random.key(5), rel_tol=0.08, eps=1e-5)


class TestTraining:
    def test_loss_decreases(self, setup):
        cfg, scene, origin, dirs, params, target = setup
        train_step, opt = make_train_step(cfg)
        opt_state = opt.init(params)
        losses = []
        p = params
        for _ in range(25):
            p, opt_state, loss = train_step(p, opt_state, scene, origin,
                                            dirs, target)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.7, losses

    def test_self_target_zero_loss_and_grad(self, setup):
        cfg, scene, origin, dirs, params, _ = setup
        self_map = loudness_map(origin, dirs, scene, cfg)
        loss = loudness_loss(params, scene, origin, dirs, cfg, self_map)
        assert float(loss) < 1e-10


@pytest.fixture(scope="module")
def room_scene(enable_x64):
    """A pose-observable scene: a closed room (first hits in every
    direction), one target behind a thick dense wall (permeation chords
    from many hit points triangulate its position)."""
    from audio_raytracer_tpu.runtime.registry import SceneRegistry

    reg = SceneRegistry()
    reg.add_aabb([0, -2, 0], [20, 0.5, 20], material=(0.2, 0.5, 1.0))
    reg.add_aabb([0, 8, 0], [20, 0.5, 20], material=(0.2, 0.5, 1.0))
    reg.add_aabb([20, 3, 0], [0.5, 6, 20], material=(0.2, 0.5, 1.0))
    reg.add_aabb([-20, 3, 0], [0.5, 6, 20], material=(0.2, 0.5, 1.0))
    reg.add_aabb([0, 3, 20], [20, 6, 0.5], material=(0.2, 0.5, 1.0))
    reg.add_aabb([0, 3, -20], [20, 6, 0.5], material=(0.2, 0.5, 1.0))
    reg.add_aabb([0, 3, 6], [8, 6, 1.5], material=(0.0, 2.0, 1.0))
    reg.add_target([0.0, 2.0, 10.0])
    scene = reg.snapshot()
    scene = jax.tree.map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
        scene)
    yield scene
    reg.close()


class TestPoseRecovery:
    """North star: "gradients flow to source/listener poses" — recovery
    is the proof they are USEFUL, not just finite.
    A single recording's scalars cannot pin a 3-D pose (measured: the
    optimizer matches them ~1.3 units from truth), so source recovery
    triangulates from multiple known listener positions and listener
    recovery adds the IR histogram (distance-resolved observables)."""

    ORIGINS = np.asarray([[0.0, 0.0, 0.0], [6.0, 1.0, -4.0],
                          [-7.0, 2.0, 2.0], [3.0, 0.5, -10.0]])

    def test_source_position_recovery_jnp(self, room_scene):
        import optax

        from audio_raytracer_tpu.models.differentiable import (
            loudness_map,
            make_source_recovery_step,
            stack_loudness,
        )

        cfg = TraceConfig(ray_count=256, max_bounces=2,
                          max_ray_life=150.0)
        dirs = fibonacci_directions(cfg.ray_count, jnp.float64)
        origins = jnp.asarray(self.ORIGINS)
        recs = stack_loudness([
            loudness_map(origins[i], dirs, room_scene, cfg)
            for i in range(len(origins))])
        true_tp = room_scene.target_positions

        tp = true_tp + jnp.asarray([[0.8, -0.4, 0.6]])
        step, opt = make_source_recovery_step(
            cfg, num_listeners=len(origins), optimizer=optax.adam(2e-2))
        opt_state = opt.init(tp)
        d0 = float(jnp.linalg.norm(tp[0] - true_tp[0]))
        for _ in range(300):
            tp, opt_state, loss = step(tp, opt_state, room_scene,
                                       origins, dirs, recs)
        d1 = float(jnp.linalg.norm(tp[0] - true_tp[0]))
        assert np.isfinite(float(loss))
        # Triangulation recovers most of the perturbation (measured:
        # 1.08 -> ~0.32 at 300 steps, still descending).
        assert d1 < 0.5 * d0, (d0, d1)

    def test_listener_origin_recovery_with_ir(self, room_scene):
        import optax

        from audio_raytracer_tpu.models.differentiable import (
            PoseParams,
            loudness_map,
            make_pose_recovery_step,
        )

        # The IR histogram gives distance-resolved observables, making
        # the listener position well-determined from ONE recording.
        cfg = TraceConfig(ray_count=256, max_bounces=2,
                          max_ray_life=150.0, num_reverb_bins=48,
                          ir_max_distance=80.0)
        dirs = fibonacci_directions(cfg.ray_count, jnp.float64)
        o_true = jnp.zeros(3, jnp.float64)
        rec = loudness_map(o_true, dirs, room_scene, cfg)

        pose = PoseParams(origin=o_true + jnp.asarray([0.6, 0.4, -0.5]),
                          target_positions=room_scene.target_positions)
        step, opt = make_pose_recovery_step(
            cfg, optimizer=optax.adam(2e-2), recover=("origin",))
        opt_state = opt.init(pose)
        o0 = float(jnp.linalg.norm(pose.origin - o_true))
        for _ in range(150):
            pose, opt_state, loss = step(pose, opt_state, room_scene,
                                         dirs, rec)
        o1 = float(jnp.linalg.norm(pose.origin - o_true))
        assert np.isfinite(float(loss))
        # Measured: 0.88 -> ~0.14 by step 150.
        assert o1 < 0.3 * o0, (o0, o1)
        # Untouched leaves stay put (grads masked, not just small).
        np.testing.assert_allclose(
            np.asarray(pose.target_positions),
            np.asarray(room_scene.target_positions))

    def test_source_recovery_kernel_tier(self, room_scene):
        import optax

        from audio_raytracer_tpu.models.differentiable import (
            loudness_map,
            make_source_recovery_step,
            stack_loudness,
        )

        # Shorter run on the interpret-mode kernel tier (full adjoint,
        # pose_grads=True): the recovery direction must match.
        cfg = TraceConfig(ray_count=128, max_bounces=2,
                          max_ray_life=150.0)
        dirs = fibonacci_directions(cfg.ray_count, jnp.float64)
        origins = jnp.asarray(self.ORIGINS)
        recs = stack_loudness([
            loudness_map(origins[i], dirs, room_scene, cfg)
            for i in range(len(origins))])
        true_tp = room_scene.target_positions

        tp = true_tp + jnp.asarray([[0.8, -0.4, 0.6]])
        step, opt = make_source_recovery_step(
            cfg, num_listeners=len(origins), optimizer=optax.adam(2e-2),
            backend="pallas_interpret")
        opt_state = opt.init(tp)
        d0 = float(jnp.linalg.norm(tp[0] - true_tp[0]))
        for _ in range(60):
            tp, opt_state, loss = step(tp, opt_state, room_scene,
                                       origins, dirs, recs)
        d1 = float(jnp.linalg.norm(tp[0] - true_tp[0]))
        assert np.isfinite(float(loss))
        assert d1 < 0.8 * d0, (d0, d1)


class TestMaterialRecovery:
    """BASELINE config 4 end-to-end: optimize material coefficients to
    match a target loudness map PRODUCED BY known materials — training
    must recover toward the truth, not merely decrease the loss."""

    def test_recovers_target_loudness(self, setup):
        import optax

        from audio_raytracer_tpu.models.differentiable import (
            SceneParams,
            loudness_map,
            make_train_step,
        )

        cfg, scene, origin, dirs, _, _ = setup
        true_params = SceneParams.from_scene(scene)
        target = loudness_map(origin, dirs, scene, cfg)

        # Perturb every material away from the truth.
        perturbed = jax.tree.map(
            lambda x: jnp.clip(x * 0.6 + 0.15, 0.05, None), true_params)
        step, opt = make_train_step(cfg, optimizer=optax.adam(3e-2))
        params, opt_state = perturbed, opt.init(perturbed)

        def loudness_err(p):
            pred = loudness_map(origin, dirs, p.into_scene(scene), cfg)
            return (float(jnp.abs(pred.muffle - target.muffle).max())
                    + float(jnp.abs(pred.permeation
                                    - target.permeation).max()))

        err0 = loudness_err(params)
        for _ in range(60):
            params, opt_state, loss = step(params, opt_state, scene,
                                           origin, dirs, target)
        err1 = loudness_err(params)
        assert np.isfinite(float(loss))
        # The predicted loudness map moved most of the way back to the
        # target's (material recovery up to observability).
        assert err1 < 0.35 * err0, (err0, err1)
