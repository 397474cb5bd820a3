"""Shard-invariance tests on an 8-virtual-device CPU mesh.

The contract (SURVEY.md §4e, BASELINE.md scaling rows): an N-device
sharded run must produce the same results as the single-device dense run
— rays-only sharding and 2-D rays x prims sharding both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_raytracer_tpu.models.raytracer import forward, random_scene
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
from audio_raytracer_tpu.parallel import (
    make_mesh,
    make_sharded_forward,
    pad_scene_for_prim_shards,
)
from audio_raytracer_tpu.types import TraceConfig


@pytest.fixture(scope="module")
def scene():
    return random_scene(jax.random.key(7), num_spheres=6, num_aabbs=10,
                        num_obbs=8, num_targets=3)


def dense_reference(scene, cfg):
    origin = jnp.zeros((3,), jnp.float32)
    dirs = fibonacci_directions(cfg.ray_count)
    return forward(origin, dirs, scene, cfg)


def assert_settings_close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a.muffle), np.asarray(b.muffle),
                               rtol=1e-5, atol=atol)
    np.testing.assert_allclose(float(a.reverb_strength),
                               float(b.reverb_strength), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(float(a.reverb_volume),
                               float(b.reverb_volume), rtol=1e-5, atol=atol)


class TestRayShardInvariance:
    def test_8way_ray_sharding_matches_dense(self, scene):
        n = len(jax.devices())
        # Dense run with accum batches matching the shard count so the
        # permeation overwrite quirk maps identically.
        cfg = TraceConfig(ray_count=128, max_bounces=3, max_ray_life=150.0,
                          num_accum_batches=n)
        _, dense_settings = dense_reference(scene, cfg)
        dense_result, _ = dense_reference(scene, cfg)

        mesh = make_mesh(ray_shards=n, prim_shards=1)
        step = make_sharded_forward(cfg, mesh, return_result=True)
        origin = jnp.zeros((3,), jnp.float32)
        dirs = fibonacci_directions(cfg.ray_count)
        result, settings = step(origin, dirs, scene)

        assert_settings_close(settings, dense_settings)
        np.testing.assert_allclose(
            np.asarray(result.echo_distances),
            np.asarray(dense_result.echo_distances), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(result.muffle_hits),
                                      np.asarray(dense_result.muffle_hits))
        np.testing.assert_allclose(np.asarray(result.permeation),
                                   np.asarray(dense_result.permeation),
                                   rtol=1e-5, atol=1e-3)


class TestPrimShardInvariance:
    def test_2d_rays_x_prims_matches_dense(self, scene):
        cfg = TraceConfig(ray_count=64, max_bounces=3, max_ray_life=150.0,
                          num_accum_batches=4)
        _, dense_settings = dense_reference(scene, cfg)
        dense_result, _ = dense_reference(scene, cfg)

        mesh = make_mesh(ray_shards=4, prim_shards=2)
        padded = pad_scene_for_prim_shards(scene, 2)
        step = make_sharded_forward(cfg, mesh, return_result=True)
        origin = jnp.zeros((3,), jnp.float32)
        dirs = fibonacci_directions(cfg.ray_count)
        result, settings = step(origin, dirs, padded)

        assert_settings_close(settings, dense_settings)
        np.testing.assert_allclose(
            np.asarray(result.echo_distances),
            np.asarray(dense_result.echo_distances), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(result.muffle_hits),
                                      np.asarray(dense_result.muffle_hits))

    def test_prim_padding_preserves_dense_result(self, scene):
        cfg = TraceConfig(ray_count=32, max_bounces=2)
        padded = pad_scene_for_prim_shards(scene, 4)
        assert padded.spheres.count % 4 == 0
        assert padded.aabbs.count % 4 == 0
        assert padded.obbs.count % 4 == 0
        _, a = dense_reference(scene, cfg)
        _, b = dense_reference(padded, cfg)
        assert_settings_close(a, b)


class TestPallasEngineSharded:
    """The per-shard Pallas engine (interpret mode on the CPU mesh) must
    match the dense jnp forward under both 1-D and 2-D sharding."""

    def test_ray_sharded_pallas_engine_matches_dense(self, scene):
        n = len(jax.devices())
        cfg = TraceConfig(ray_count=128, max_bounces=3, max_ray_life=150.0,
                          num_accum_batches=n)
        _, dense_settings = dense_reference(scene, cfg)

        mesh = make_mesh(ray_shards=n, prim_shards=1)
        step = make_sharded_forward(cfg, mesh, backend="pallas_interpret")
        settings = step(jnp.zeros(3), fibonacci_directions(cfg.ray_count),
                        scene)
        assert_settings_close(settings, dense_settings)

    def test_2d_sharded_pallas_engine_matches_dense(self, scene):
        cfg = TraceConfig(ray_count=64, max_bounces=3, max_ray_life=150.0,
                          num_accum_batches=4)
        _, dense_settings = dense_reference(scene, cfg)

        mesh = make_mesh(ray_shards=4, prim_shards=2)
        padded = pad_scene_for_prim_shards(scene, 2)
        step = make_sharded_forward(cfg, mesh, backend="pallas_interpret")
        settings = step(jnp.zeros(3), fibonacci_directions(cfg.ray_count),
                        padded)
        assert_settings_close(settings, dense_settings)

    def test_sharded_loss_with_ir_matches_single_device(self, scene):
        """The sharded loss must include the IR term exactly like the
        single-device loudness_loss: same scalar on
        a 4x2 mesh as on one device when num_reverb_bins > 0."""
        from audio_raytracer_tpu.models.differentiable import (
            Loudness,
            SceneParams,
            loudness_loss,
        )
        from audio_raytracer_tpu.parallel.train import make_sharded_train_step
        import optax

        cfg = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=150.0,
                          num_accum_batches=4, num_reverb_bins=8,
                          ir_max_distance=80.0)
        mesh = make_mesh(ray_shards=4, prim_shards=2)
        padded = pad_scene_for_prim_shards(scene, 2)
        params = SceneParams.from_scene(padded)
        T = padded.num_targets
        target = Loudness(muffle=jnp.full((T,), 0.4),
                          permeation=jnp.full((T,), 0.3),
                          reverb_energy=jnp.asarray(0.1),
                          reverb_ir=jnp.linspace(0.5, 0.0, 8))
        dirs = fibonacci_directions(cfg.ray_count)
        step, opt = make_sharded_train_step(cfg, mesh,
                                            optimizer=optax.sgd(0.0))
        _, _, loss_sh = step(params, opt.init(params), padded,
                             jnp.zeros(3), dirs, target)
        loss_1 = loudness_loss(params, padded, jnp.zeros(3), dirs, cfg,
                               target)
        assert float(loss_1) > 0.0
        np.testing.assert_allclose(float(loss_sh), float(loss_1),
                                   rtol=1e-5, atol=1e-6)

    def test_2d_sharded_pallas_train_step_runs(self, scene):
        from audio_raytracer_tpu.models.differentiable import (
            Loudness,
            SceneParams,
        )
        from audio_raytracer_tpu.parallel.train import (
            make_sharded_train_step,
            params_pspec,
        )
        import optax

        cfg = TraceConfig(ray_count=32, max_bounces=2, max_ray_life=150.0,
                          num_accum_batches=4)
        mesh = make_mesh(ray_shards=4, prim_shards=2)
        padded = pad_scene_for_prim_shards(scene, 2)
        params = SceneParams.from_scene(padded)
        T = padded.num_targets
        target = Loudness(muffle=jnp.full((T,), 0.4),
                          permeation=jnp.full((T,), 0.3),
                          reverb_energy=jnp.asarray(0.1))
        step, opt = make_sharded_train_step(cfg, mesh,
                                            backend="pallas_interpret")
        opt_state = opt.init(params)
        dirs = fibonacci_directions(cfg.ray_count)
        p1, opt_state, loss1 = step(params, opt_state, padded,
                                    jnp.zeros(3), dirs, target)
        p2, _, loss2 = step(p1, opt_state, padded, jnp.zeros(3), dirs, target)
        assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
        # Gradients must actually move the learnable materials.
        moved = any(
            not np.allclose(np.asarray(a), np.asarray(b))
            for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p1)))
        assert moved


class TestTieBreakAcrossShards:
    def test_scan_rank_tie_break_matches_dense(self):
        # Two identical overlapping AABBs that would tie on every hit,
        # with different materials: dense argmin picks the first; the
        # prim-sharded merge must pick the same one even when they land
        # on different shards.
        from audio_raytracer_tpu.types import Aabbs, Materials, Scene

        mats = Materials(absorption=jnp.asarray([0.1, 0.4]),
                         density=jnp.ones(2), echo=jnp.asarray([2.0, 0.5]))
        aabbs = Aabbs.build([[0, 0, 6], [0, 0, 6]],
                            [[2, 2, 1], [2, 2, 1]], material=mats)
        scene = Scene.build(None, aabbs, None, [[0, 8, 0]])
        cfg = TraceConfig(ray_count=32, max_bounces=2, max_ray_life=100.0,
                          num_accum_batches=4)
        dense_result, dense_settings = dense_reference(scene, cfg)

        mesh = make_mesh(ray_shards=4, prim_shards=2)
        step = make_sharded_forward(cfg, mesh, return_result=True)
        result, settings = step(jnp.zeros(3), fibonacci_directions(32), scene)

        np.testing.assert_allclose(
            np.asarray(result.echo_distances),
            np.asarray(dense_result.echo_distances), rtol=1e-5, atol=1e-5)
        assert_settings_close(settings, dense_settings)


class TestChunkedEngineUnderPrimSharding:
    """The plain engine's chunked fold (DenseBackend with more than CHUNK
    primitives per shard) composing under the 2-D mesh with shard_map's
    vma checking on: the fold's scan carries enter with the shard's
    varying type and the cross-shard scan-rank merge still picks the
    dense winner."""

    def test_2d_mesh_with_chunked_local_engine(self, scene, monkeypatch):
        from audio_raytracer_tpu.ops import backend as B
        from audio_raytracer_tpu.parallel import sharded as sh

        cfg = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=150.0,
                          num_accum_batches=4)
        _, dense_settings = dense_reference(scene, cfg)

        monkeypatch.setattr(B, "CHUNK", 4)
        mesh = make_mesh(ray_shards=4, prim_shards=2)
        padded = pad_scene_for_prim_shards(scene, 2)
        step = sh.make_sharded_forward(cfg, mesh)
        settings = step(jnp.zeros(3), fibonacci_directions(cfg.ray_count),
                        padded)
        assert_settings_close(settings, dense_settings)
