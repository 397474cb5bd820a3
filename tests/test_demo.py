"""Demo layer tests: scene format, sample scene, player loop, checkpoint."""

import json

import jax
import numpy as np
import pytest

from audio_raytracer_tpu.demo.sample_scene import sample_scene_dict
from audio_raytracer_tpu.demo.scene_format import (
    _euler_deg_to_inv_quat_xyzw,
    build_registry,
    load_scene_file,
)
from audio_raytracer_tpu.demo.scene_player import render_wav, simulate


class TestSceneFormat:
    def test_sample_scene_builds(self):
        loaded = build_registry(sample_scene_dict(ray_count=32))
        loaded.registry.snapshot()  # publish the job batch
        counts = loaded.registry.counts()
        assert counts[3] == 2
        assert counts[0] == 4  # spheres (2 + 2 target-owned)
        assert counts[1] == 10  # aabbs incl. platform
        assert counts[2] == 3
        # Platform mover + the orbiting "radio" source (whose owned
        # collider rides the target animation automatically).
        assert len(loaded.animations) == 2
        assert len(loaded.animations[1].owned) == 1
        assert loaded.cfg.ray_count == 32
        loaded.registry.close()

    def test_roundtrip_via_file(self, tmp_path):
        doc = sample_scene_dict(ray_count=16)
        path = tmp_path / "scene.json"
        path.write_text(json.dumps(doc))
        loaded = load_scene_file(str(path))
        assert loaded.target_names == ["radio", "speaker"]
        loaded.registry.close()

    def test_euler_quat_matches_quaternion_module(self):
        from audio_raytracer_tpu.ops import quaternion
        import jax.numpy as jnp

        euler = [30.0, 45.0, -20.0]
        got = np.asarray(_euler_deg_to_inv_quat_xyzw(euler))
        expect = np.asarray(quaternion.inverse(quaternion.from_euler_zxy(
            jnp.radians(jnp.asarray(euler)))))
        np.testing.assert_allclose(got, expect, atol=1e-6)

    def test_single_waypoint_animation_holds(self):
        # A one-waypoint mover is valid (reference MoveTowards semantics:
        # go there, then hold) — regression for the r4 advisor's
        # IndexError finding.
        doc = {
            "trace": {"ray_count": 8},
            "colliders": [{"type": "sphere", "center": [0, 0, 4],
                           "radius": 1}],
            "targets": [{"position": [0, 3, 0]}],
            "animations": [{"collider": 0, "speed": 2.0,
                            "waypoints": [[0, 0, 8]]}],
        }
        loaded = build_registry(doc)
        anim = loaded.animations[0]
        for _ in range(6):
            anim.step(loaded.registry, 0.5)
        np.testing.assert_allclose(anim.position, [0, 0, 8], atol=1e-6)
        anim.step(loaded.registry, 0.5)  # holds, no IndexError
        np.testing.assert_allclose(anim.position, [0, 0, 8], atol=1e-6)
        loaded.registry.close()

    def test_mover_starts_from_authored_position(self):
        # The mover moves FROM the authored center toward waypoints[0]
        # (PlatformMover.cs:18-27 moves the transform from where it is),
        # never teleporting to waypoints[0] first.
        doc = {
            "trace": {"ray_count": 8},
            "colliders": [{"type": "aabb", "center": [0, 0, 0],
                           "half_extents": [1, 1, 1]}],
            "targets": [{"position": [0, 3, 0]}],
            "animations": [{"collider": 0, "speed": 1.0,
                            "waypoints": [[10, 0, 0], [0, 10, 0]]}],
        }
        loaded = build_registry(doc)
        anim = loaded.animations[0]
        anim.step(loaded.registry, 1.0)
        # One unit along +x from the AUTHORED center, not from [10,0,0].
        np.testing.assert_allclose(anim.position, [1, 0, 0], atol=1e-6)
        loaded.registry.close()

    def test_material_resolution(self):
        doc = {
            "materials": {"custom": {"absorption": 0.5, "density": 2.0,
                                     "echo": 0.1}},
            "colliders": [
                {"type": "sphere", "center": [0, 0, 5], "radius": 1,
                 "material": "custom"},
                {"type": "sphere", "center": [0, 0, 9], "radius": 1,
                 "material": "concrete"},
                {"type": "sphere", "center": [0, 0, 13], "radius": 1,
                 "material": [0.9, 0.8, 0.7]},
            ],
            "targets": [{"position": [0, 5, 0]}],
        }
        loaded = build_registry(doc)
        scene = loaded.registry.snapshot()
        ab = np.asarray(scene.spheres.material.absorption[:3])
        np.testing.assert_allclose(sorted(ab), [0.25, 0.5, 0.9], atol=1e-6)
        loaded.registry.close()


class TestShippedScenes:
    """The example scene gallery (demo/scenes/*.json) must validate,
    load, and simulate — these are the user-facing documents."""

    def test_gallery_loads_and_simulates(self):
        import glob
        import os

        import audio_raytracer_tpu.demo as demo_pkg

        gallery = sorted(glob.glob(os.path.join(
            os.path.dirname(demo_pkg.__file__), "scenes", "*.json")))
        assert len(gallery) >= 2, gallery
        for path in gallery:
            loaded = load_scene_file(path)
            history = simulate(loaded, frames=4, dt=0.1, verbose=False)
            assert np.isfinite(history["muffle"]).all(), path
            loaded.registry.close()

    def test_corridor_door_occludes_and_listener_walks(self):
        import os

        import audio_raytracer_tpu.demo as demo_pkg

        path = os.path.join(os.path.dirname(demo_pkg.__file__),
                            "scenes", "corridor.json")
        loaded = load_scene_file(path)
        assert loaded.listener_animation is not None
        history = simulate(loaded, frames=10, dt=0.2, verbose=False)
        # The listener walked down the corridor (+z from -18).
        assert history["listener"][-1][2] > history["listener"][0][2] + 3
        loaded.registry.close()


class TestSceneValidation:
    """Authoring-time failsafe (AudioCollider.cs:95-118):
    malformed scene documents fail fast with a path-precise error."""

    def _base(self):
        return {
            "trace": {"ray_count": 16},
            "colliders": [{"type": "sphere", "center": [0, 0, 4],
                           "radius": 1, "material": "concrete"}],
            "targets": [{"position": [0, 3, 0], "name": "t"}],
        }

    def _expect(self, doc, fragment):
        from audio_raytracer_tpu.demo.scene_schema import (
            SceneValidationError,
        )

        with pytest.raises(SceneValidationError) as e:
            build_registry(doc)
        assert fragment in str(e.value), str(e.value)

    def test_valid_doc_passes(self):
        loaded = build_registry(self._base())
        loaded.registry.close()

    def test_unknown_top_level_key(self):
        doc = self._base()
        doc["colliderz"] = []
        self._expect(doc, "scene.colliderz")

    def test_typod_trace_key(self):
        doc = self._base()
        doc["trace"]["ray_cout"] = 5
        self._expect(doc, "scene.trace.ray_cout")

    def test_out_of_range_trace_value(self):
        doc = self._base()
        doc["trace"]["max_ray_life"] = -10.0
        self._expect(doc, "scene.trace.max_ray_life")

    def test_unknown_material_name(self):
        doc = self._base()
        doc["colliders"][0]["material"] = "concrete_typo"
        self._expect(doc, "scene.colliders[0].material")

    def test_absorption_out_of_range(self):
        doc = self._base()
        doc["materials"] = {"hot": {"absorption": 1.5}}
        self._expect(doc, "scene.materials.hot.absorption")

    def test_negative_radius(self):
        doc = self._base()
        doc["colliders"][0]["radius"] = -1.0
        self._expect(doc, "scene.colliders[0].radius")

    def test_unknown_collider_key(self):
        doc = self._base()
        doc["colliders"][0]["half_extents"] = [1, 1, 1]  # sphere key typo
        self._expect(doc, "scene.colliders[0].half_extents")

    def test_bad_quat_norm(self):
        doc = self._base()
        doc["colliders"].append({"type": "obb", "center": [3, 0, 0],
                                 "half_extents": [1, 1, 1],
                                 "quat_xyzw": [1, 1, 1, 1]})
        self._expect(doc, "scene.colliders[1].quat_xyzw")

    def test_target_index_out_of_range(self):
        doc = self._base()
        doc["colliders"][0]["target"] = 3
        self._expect(doc, "scene.colliders[0].target")

    def test_animation_bad_reference(self):
        doc = self._base()
        doc["animations"] = [{"collider": 7, "waypoints": [[0, 0, 0]]}]
        self._expect(doc, "scene.animations[0].collider")

    def test_animation_empty_waypoints(self):
        doc = self._base()
        doc["animations"] = [{"collider": 0, "waypoints": []}]
        self._expect(doc, "scene.animations[0].waypoints")

    def test_bad_vector_shape(self):
        doc = self._base()
        doc["targets"][0]["position"] = [0, 3]
        self._expect(doc, "scene.targets[0].position")

    def test_listener_waypoints_validated(self):
        doc = self._base()
        doc["listener"] = {"position": [0, 0, 0], "speed": 2.0,
                           "waypoints": [[1, 2]]}
        self._expect(doc, "scene.listener.waypoints[0]")
        doc["listener"] = {"position": [0, 0, 0], "speed": -1.0,
                           "waypoints": [[1, 2, 3]]}
        self._expect(doc, "scene.listener.speed")


class TestScenePlayer:
    def test_simulation_runs_and_platform_moves(self):
        loaded = build_registry(sample_scene_dict(ray_count=48,
                                                  max_bounces=2))
        history = simulate(loaded, frames=12, dt=0.1, verbose=False)
        assert history["muffle"].shape == (12, 2)
        # Settings populated after the first harvest.
        assert np.any(history["muffle"][2:] > 0) or np.any(
            history["reverb_volume"] > 0)
        # The animated platform actually moved.
        anim = loaded.animations[0]
        assert not np.allclose(anim.position, anim.waypoints[0])
        loaded.registry.close()

    def test_listener_waypoint_path(self):
        # "listener.waypoints" scripts the listener's movement (the
        # headless PlayerController analog).
        doc = {
            "trace": {"ray_count": 32, "max_bounces": 1},
            "listener": {"position": [0, 0, 0], "speed": 10.0,
                         "waypoints": [[10, 0, 0], [10, 0, 10]]},
            "colliders": [{"type": "aabb", "center": [0, -2, 0],
                           "half_extents": [30, 0.5, 30]}],
            "targets": [{"position": [0, 0, 5]}],
        }
        loaded = build_registry(doc)
        assert loaded.listener_animation is not None
        history = simulate(loaded, frames=8, dt=0.1, verbose=False)
        # 8 frames x 10 u/s x 0.1 s = 8 units along +x from the origin.
        np.testing.assert_allclose(history["listener"][-1], [8, 0, 0],
                                   atol=1e-5)
        assert not np.allclose(history["listener"][0],
                               history["listener"][-1])
        loaded.registry.close()

    def test_viz_every_dumps_live_frames(self, tmp_path):
        # In-loop gizmo dumps while the sim runs (the reference's gizmos
        # render live, AudioRayTracer.cs:291-355).
        loaded = build_registry(sample_scene_dict(ray_count=32,
                                                  max_bounces=1))
        out = tmp_path / "live.png"
        simulate(loaded, frames=5, dt=0.05, verbose=False,
                 viz_every=2, viz_path=str(out))
        for f in (0, 2, 4):
            p = tmp_path / f"live_{f:04d}.png"
            assert p.stat().st_size > 10_000, p
        loaded.registry.close()

    def test_simulate_over_mesh(self):
        # The demo player composed with the meshed serving loop
        # (scene_player --mesh): settings come back finite and the
        # animations still drive the registry. NB muffle values are
        # num_accum_batches-dependent by reference semantics (the
        # permeation overwrite quirk writes one slot per thread batch),
        # and the meshed loop uses one batch per ray shard.
        from audio_raytracer_tpu.parallel.mesh import make_mesh

        loaded = build_registry(sample_scene_dict(ray_count=64,
                                                  max_bounces=1))
        history = simulate(loaded, frames=6, dt=0.1, verbose=False,
                           mesh=make_mesh(ray_shards=4, prim_shards=2))
        assert np.isfinite(history["muffle"]).all()
        assert (history["reverb_volume"][2:] > 0).any()
        anim = loaded.animations[0]
        assert not np.allclose(anim.position, anim.waypoints[0])
        loaded.registry.close()

    def test_wav_render(self, tmp_path):
        loaded = build_registry(sample_scene_dict(ray_count=32,
                                                  max_bounces=1))
        history = simulate(loaded, frames=4, dt=0.05, verbose=False)
        # The sample scene records an impulse response, so the render
        # goes through the convolution reverb-tail stage.
        assert "reverb_ir" in history
        out = tmp_path / "demo.wav"
        render_wav(loaded, history, str(out), sample_rate=8000, dt=0.05)
        data = out.read_bytes()
        assert len(data) > 44  # non-empty PCM payload
        assert data[:4] == b"RIFF"
        loaded.registry.close()

    def test_wav_reverb_tail_audible(self, tmp_path):
        """The IR-driven tail must actually change the rendered audio
        vs a tail-less render of the same history (the reference
        delegates its audible reverb to Unity's AudioReverbFilter; this
        framework renders it from the traced impulse response)."""
        import wave

        loaded = build_registry(sample_scene_dict(ray_count=64,
                                                  max_bounces=2))
        history = simulate(loaded, frames=6, dt=0.05, verbose=False)
        assert history["reverb_ir"].sum() > 0  # echoes landed in bins

        def pcm(path):
            with wave.open(str(path)) as w:
                return np.frombuffer(w.readframes(w.getnframes()),
                                     np.int16).astype(np.float64)

        out_wet = tmp_path / "wet.wav"
        render_wav(loaded, history, str(out_wet), sample_rate=8000,
                   dt=0.05)
        history_dry = dict(history)
        history_dry.pop("reverb_ir")
        out_dry = tmp_path / "dry.wav"
        render_wav(loaded, history_dry, str(out_dry), sample_rate=8000,
                   dt=0.05)
        wet, dry = pcm(out_wet), pcm(out_dry)
        assert wet.shape == dry.shape
        # The tail adds correlated-but-delayed energy: the waveforms
        # must differ by well over quantization noise.
        diff_rms = np.sqrt(((wet - dry) ** 2).mean())
        assert diff_rms > 50.0, diff_rms
        loaded.registry.close()


class TestMovingTarget:
    """Moving audio source, end to end (TargetAnimation):
    a TargetAnimation drives registry.set_target_position each frame,
    the traced perceived_position follows, and the rendered WAV audibly
    pans as the source crosses the listener."""

    def _crossing_scene(self):
        # One source sweeps left (-x) to right (+x) in front of the
        # listener; a floor gives the bounce rays something to hit.
        return {
            "trace": {"ray_count": 64, "max_bounces": 1,
                      "max_ray_life": 100.0},
            "listener": {"position": [0, 0, 0]},
            "colliders": [
                {"type": "aabb", "center": [0, -2, 0],
                 "half_extents": [30, 0.5, 30], "material": "concrete"},
            ],
            "targets": [{"position": [-10, 0, 2], "name": "mover"}],
            "animations": [
                {"target": 0, "speed": 20.0,
                 "waypoints": [[-10, 0, 2], [10, 0, 2]]},
            ],
        }

    def test_target_animation_moves_perceived_position(self):
        loaded = build_registry(self._crossing_scene())
        history = simulate(loaded, frames=10, dt=0.1, verbose=False)
        pp = history["perceived_position"][:, 0, :]
        # The source swept +x at 2 units/frame (speed 20 x dt 0.1) and
        # the traced perceived_position followed (one-frame harvest lag).
        assert pp[-1, 0] > pp[2, 0] + 5.0
        np.testing.assert_allclose(pp[:, 2], 2.0, atol=1e-5)
        anim = loaded.animations[0]
        np.testing.assert_allclose(anim.position, [10, 0, 2], atol=1e-5)
        loaded.registry.close()

    def test_owned_collider_rides_target_animation(self):
        # A target-owned collider authored at an OFFSET from its target
        # must track the moving source with that offset preserved (the
        # co-located GameObject transform moving both components).
        doc = {
            "trace": {"ray_count": 16, "max_bounces": 1},
            "colliders": [
                {"type": "sphere", "center": [1.0, 0.5, 2.0],
                 "radius": 0.4, "target": 0},
            ],
            "targets": [{"position": [0.0, 0.0, 2.0]}],
            "animations": [
                {"target": 0, "speed": 4.0,
                 "waypoints": [[0, 0, 2], [8, 0, 2]]},
            ],
        }
        loaded = build_registry(doc)
        anim = loaded.animations[0]
        assert len(anim.owned) == 1
        for _ in range(4):  # 4 steps x 4 u/s x 0.5 s = reaches [8,0,2]
            anim.step(loaded.registry, 0.5)
        scene = loaded.registry.snapshot()
        np.testing.assert_allclose(np.asarray(scene.target_positions[0]),
                                   [8, 0, 2], atol=1e-5)
        # Collider center = target position + authored offset [1,.5,0].
        np.testing.assert_allclose(np.asarray(scene.spheres.center[0]),
                                   [9, 0.5, 2], atol=1e-5)
        loaded.registry.close()

    def test_wav_pans_left_to_right(self, tmp_path):
        import wave

        loaded = build_registry(self._crossing_scene())
        history = simulate(loaded, frames=10, dt=0.1, verbose=False)
        out = tmp_path / "pan.wav"
        render_wav(loaded, history, str(out), sample_rate=8000, dt=0.1)
        with wave.open(str(out)) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()),
                                np.int16).astype(np.float64).reshape(-1, 2)
        q = len(pcm) // 4
        def lr_energy(seg):
            return (seg[:, 0] ** 2).sum(), (seg[:, 1] ** 2).sum()
        l_early, r_early = lr_energy(pcm[:q])
        l_late, r_late = lr_energy(pcm[-q:])
        # Source left of listener early -> left channel louder; right
        # late -> right channel louder (equal-power pan,
        # BinauralDSP.cs:28-30).
        assert l_early > 1.5 * r_early, (l_early, r_early)
        assert r_late > 1.5 * l_late, (l_late, r_late)
        loaded.registry.close()


class TestVisualize:
    """The gizmo-layer analog (Audio/AudioRayTracer.cs:291-355): traced
    hits + geometry render headlessly to PNG, and --npz histories plot."""

    def test_trace_and_history_pngs(self, tmp_path):
        from audio_raytracer_tpu.demo.visualize import (
            plot_history,
            plot_trace,
        )

        loaded = build_registry(sample_scene_dict(ray_count=48,
                                                  max_bounces=2))
        out = plot_trace(loaded, str(tmp_path / "trace.png"), rays=48,
                         trails=8)
        assert (tmp_path / "trace.png").stat().st_size > 10_000
        history = simulate(loaded, frames=4, dt=0.05, verbose=False)
        np.savez(tmp_path / "h.npz", **history)
        plot_history(str(tmp_path / "h.npz"),
                     str(tmp_path / "hist.png"),
                     target_names=loaded.target_names)
        assert (tmp_path / "hist.png").stat().st_size > 10_000
        loaded.registry.close()


class TestTrainMaterialsCLI:
    """The material-calibration CLI (BASELINE config 4 as a tool):
    loss must descend, the summary JSON must parse, and --resume must
    continue from the checkpointed step."""

    def test_trains_and_resumes(self, tmp_path, monkeypatch, capsys):
        import runpy
        import sys

        ck = str(tmp_path / "ck")
        base = ["train_materials", "--steps", "6", "--rays", "64",
                "--init", "noisy", "--log-every", "3", "--ckpt-every",
                "3", "--checkpoint", ck]
        monkeypatch.setattr(sys, "argv", base)
        runpy.run_module("audio_raytracer_tpu.demo.train_materials",
                         run_name="__main__")
        out1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out1["final_loss"] < 0.1
        assert set(out1["material_mae"]) == {"absorption", "density",
                                             "echo"}

        monkeypatch.setattr(sys, "argv",
                            base[:2] + ["12"] + base[3:] + ["--resume"])
        runpy.run_module("audio_raytracer_tpu.demo.train_materials",
                         run_name="__main__")
        captured = capsys.readouterr()
        assert "resumed from step 6" in captured.err
        out2 = json.loads(captured.out.strip().splitlines()[-1])
        assert out2["final_loss"] <= out1["final_loss"] * 1.5  # kept going


class TestRecoverPoseCLI:
    """--recover-pose: the pose-gradient workload as a tool. Convergence
    itself is pinned in tests/test_gradients.py::TestPoseRecovery; here
    the CLI must run, descend, and report."""

    def test_listener_mode_descends(self, monkeypatch, capsys):
        import runpy
        import sys

        monkeypatch.setattr(sys, "argv", [
            "train_materials", "--recover-pose", "listener", "--steps",
            "40", "--rays", "128", "--lr", "0.03", "--log-every", "10"])
        runpy.run_module("audio_raytracer_tpu.demo.train_materials",
                         run_name="__main__")
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["mode"] == "recover_pose_listener"
        assert out["pose_error_final"] < out["pose_error_initial"]


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        from audio_raytracer_tpu.models.differentiable import SceneParams
        from audio_raytracer_tpu.models.raytracer import random_scene
        from audio_raytracer_tpu.utils.checkpoint import (
            restore_checkpoint,
            save_checkpoint,
        )

        scene = random_scene(jax.random.key(1), 3, 3, 3, num_targets=1)
        params = SceneParams.from_scene(scene)
        kind = save_checkpoint(tmp_path / "ckpt", {"scene": scene,
                                                   "params": params})
        restored = restore_checkpoint(tmp_path / "ckpt",
                                      {"scene": scene, "params": params})
        np.testing.assert_allclose(
            np.asarray(restored["scene"].spheres.center),
            np.asarray(scene.spheres.center))
        np.testing.assert_allclose(
            np.asarray(restored["params"].aabb.echo),
            np.asarray(params.aabb.echo))


class TestTrainingResume:
    """Checkpoint/resume of the FULL training state (params + optimizer
    moments): interrupted training must continue exactly where it left
    off (SURVEY §5 checkpoint/resume, applied to the gradient
    workload)."""

    def test_resume_continues_identically(self, tmp_path):
        import jax
        import jax.numpy as jnp

        from audio_raytracer_tpu.models.differentiable import (
            Loudness,
            SceneParams,
            make_train_step,
        )
        from audio_raytracer_tpu.models.raytracer import random_scene
        from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
        from audio_raytracer_tpu.types import TraceConfig
        from audio_raytracer_tpu.utils.checkpoint import (
            restore_checkpoint,
            save_checkpoint,
        )

        cfg = TraceConfig(ray_count=48, max_bounces=2, max_ray_life=80.0)
        scene = random_scene(jax.random.key(4), 4, 6, 4, num_targets=2,
                             extent=12.0, size_range=(1.5, 4.0))
        origin = jnp.zeros(3)
        dirs = fibonacci_directions(48)
        target = Loudness(muffle=jnp.full((2,), 0.4),
                          permeation=jnp.full((2,), 0.3),
                          reverb_energy=jnp.asarray(0.1))
        step, opt = make_train_step(cfg)
        params = SceneParams.from_scene(scene)
        opt_state = opt.init(params)

        # Train 3 steps, checkpoint, train 2 more (reference run).
        for _ in range(3):
            params, opt_state, _ = step(params, opt_state, scene, origin,
                                        dirs, target)
        save_checkpoint(tmp_path / "ck", {"params": params,
                                          "opt_state": opt_state})
        ref_p, ref_o = params, opt_state
        for _ in range(2):
            ref_p, ref_o, ref_loss = step(ref_p, ref_o, scene, origin,
                                          dirs, target)

        # Restore into fresh structures and continue: identical result.
        restored = restore_checkpoint(
            tmp_path / "ck",
            {"params": SceneParams.from_scene(scene),
             "opt_state": opt.init(SceneParams.from_scene(scene))})
        r_p, r_o = restored["params"], restored["opt_state"]
        for _ in range(2):
            r_p, r_o, r_loss = step(r_p, r_o, scene, origin, dirs, target)
        np.testing.assert_allclose(float(r_loss), float(ref_loss),
                                   rtol=1e-6, atol=1e-8)
        for a, b in zip(jax.tree.leaves(ref_p), jax.tree.leaves(r_p)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-7)
