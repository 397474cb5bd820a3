"""Headless scene player: the demo-app layer as a CLI.

Reproduces the Unity demo semantics without an engine: a frame loop
(UpdateScheduler analog) ticks waypoint animations (PlatformMover),
publishes scene mutations through the double-buffered registry, runs the
async raytrace loop, feeds per-target settings into the spatializer DSP
chain, and optionally renders the result to a stereo WAV.

Usage:
  python -m audio_raytracer_tpu.demo.scene_player            # sample scene
  python -m audio_raytracer_tpu.demo.scene_player --scene my.json \
      --frames 120 --render-wav out.wav --npz trace.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import wave

import numpy as np


def simulate(loaded, frames=60, dt=1.0 / 60.0, backend="jnp",
             listener_path=None, verbose=True, viz_every=0,
             viz_path=None, mesh=None):
    """Run the frame loop; returns per-frame settings history.

    listener_path: optional callable t -> [3] position (the
    PlayerController analog). Falls back to the scene's
    "listener.waypoints" scripted path (scene_format.ListenerAnimation)
    when present, else a stationary listener.

    viz_every: dump a gizmo-layer PNG of the live scene every N frames
    (the in-loop equivalent of the reference's editor gizmos drawing
    WHILE the sim runs, Audio/AudioRayTracer.cs:291-355); frame index is
    appended to ``viz_path`` (default "frame.png" -> frame_0042.png).

    mesh: optional ('rays','prims') jax.sharding.Mesh — the live loop
    then serves through the sharded step (AsyncRaytraceLoop(mesh=)).
    """
    import jax

    from audio_raytracer_tpu.runtime.orchestrator import AsyncRaytraceLoop

    loop = AsyncRaytraceLoop(loaded.registry, loaded.cfg, backend=backend,
                             compute_async=False, mesh=mesh)
    if listener_path is None and loaded.listener_animation is not None:
        anim = loaded.listener_animation

        def listener_path(_t, _anim=anim, _dt=dt):
            return _anim.step(_dt)
    T = len(loaded.target_names)
    n_bins = loaded.cfg.num_reverb_bins
    history = dict(muffle=np.zeros((frames, T)),
                   reverb_strength=np.zeros(frames),
                   reverb_volume=np.zeros(frames),
                   listener=np.zeros((frames, 3)),
                   perceived_position=np.zeros((frames, T, 3)),
                   frame_ms=np.zeros(frames))
    if n_bins > 0:
        history["reverb_ir"] = np.zeros((frames, n_bins))

    for f in range(frames):
        t0 = time.perf_counter()
        sim_t = f * dt
        pos = (listener_path(sim_t) if listener_path
               else loaded.listener_position)
        for anim in loaded.animations:
            anim.step(loaded.registry, dt)
        settings = loop.tick(pos)
        if settings is not None:
            jax.block_until_ready(settings)
            history["muffle"][f] = np.asarray(settings.muffle)
            history["reverb_strength"][f] = float(settings.reverb_strength)
            history["reverb_volume"][f] = float(settings.reverb_volume)
            # The position the completed trace actually used — the
            # PercievedAudioPosition the DSP pans with
            # (AudioTargetRTSettings.cs:8-16; moving sources via
            # TargetAnimation land here a harvest later).
            history["perceived_position"][f] = np.asarray(
                settings.perceived_position)
            if n_bins > 0 and loop.reverb_ir is not None:
                history["reverb_ir"][f] = np.asarray(loop.reverb_ir)
        else:
            history["perceived_position"][f] = np.asarray(
                loaded.registry.snapshot().target_positions)
        history["listener"][f] = np.asarray(pos)
        history["frame_ms"][f] = (time.perf_counter() - t0) * 1e3
        if viz_every and f % viz_every == 0:
            from audio_raytracer_tpu.demo.visualize import plot_trace

            base = viz_path or "frame.png"
            root, ext = os.path.splitext(base)
            out = f"{root}_{f:04d}{ext or '.png'}"
            if os.path.dirname(out):
                os.makedirs(os.path.dirname(out), exist_ok=True)
            plot_trace(loaded, out, rays=min(loaded.cfg.ray_count, 256),
                       backend=backend, listener=pos)
            if verbose:
                print(f"frame {f:4d}: wrote {out}", file=sys.stderr)
        if verbose and f % max(1, frames // 10) == 0:
            m = history["muffle"][f]
            print(f"frame {f:4d}: muffle={np.round(m, 3)} "
                  f"reverb={history['reverb_strength'][f]:.3f} "
                  f"({history['frame_ms'][f]:.1f} ms)", file=sys.stderr)
    return history


def render_wav(loaded, history, path, sample_rate=48000, dt=1.0 / 60.0):
    """Render each target as a distinct tone through the DSP chain, using
    the per-frame ray-traced settings; mix to stereo 16-bit WAV.

    When the trace recorded an impulse response
    (cfg.num_reverb_bins > 0), the IR-driven convolution tail is
    rendered too — the audible reverb the reference delegated to
    Unity's AudioReverbFilter."""
    import dataclasses

    import jax.numpy as jnp

    from audio_raytracer_tpu.models.spatializer import (
        DSPState,
        SpatializerSettings,
        ir_kernel_length,
        spatialize,
    )
    from audio_raytracer_tpu.types import TargetSettings

    frames = len(history["reverb_strength"])
    T = history["muffle"].shape[1]
    n_per_frame = int(sample_rate * dt)
    settings = SpatializerSettings.default()
    ir_hist = history.get("reverb_ir")
    tail_len = None
    if ir_hist is not None:
        settings = dataclasses.replace(
            settings, render_reverb_tail=True,
            reverb_ir_max_distance=jnp.float32(loaded.cfg.ir_max_distance))
        tail_len = ir_kernel_length(ir_hist.shape[1],
                                    float(loaded.cfg.ir_max_distance),
                                    float(sample_rate)) - 1
    freqs = [220.0 * (1.5 ** i) for i in range(T)]
    states = [DSPState.zero(tail_len=tail_len) for _ in range(T)]
    # Per-frame perceived positions (moving sources pan audibly);
    # histories from older captures without the key fall back to the
    # registry's static target positions.
    static_targets = np.asarray(loaded.registry.snapshot().target_positions)
    pos_hist = history.get(
        "perceived_position",
        np.broadcast_to(static_targets, (frames,) + static_targets.shape))

    # One compiled DSP step (shapes are frame-invariant) instead of
    # eager per-op dispatch.
    import jax

    jit_spatialize = jax.jit(
        spatialize, static_argnames=("sample_rate", "volume_multiplier"))

    mix = np.zeros((frames * n_per_frame, 2), np.float32)
    phase = np.zeros(T)
    for f in range(frames):
        targets = np.asarray(pos_hist[f])
        rt = TargetSettings(
            muffle=jnp.asarray(history["muffle"][f]),
            reverb_strength=jnp.asarray(history["reverb_strength"][f]),
            reverb_volume=jnp.asarray(history["reverb_volume"][f]),
            perceived_position=jnp.asarray(targets),
        )
        listener = history["listener"][f]
        for ti in range(T):
            n = n_per_frame
            tt = (np.arange(n) + phase[ti]) / sample_rate
            phase[ti] += n
            tone = 0.25 * np.sin(2 * np.pi * freqs[ti] * tt)
            buf = jnp.asarray(np.stack([tone, tone], -1), jnp.float32)
            rel = targets[ti] - listener
            dist = float(np.linalg.norm(rel))
            local = jnp.asarray(rel / max(dist, 1e-6), jnp.float32)
            ir = (jnp.asarray(ir_hist[f], jnp.float32)
                  if ir_hist is not None else None)
            out, states[ti], _ = jit_spatialize(
                buf, states[ti], settings, rt, jnp.int32(ti), local,
                jnp.asarray(dist), sample_rate=float(sample_rate),
                reverb_ir=ir)
            mix[f * n:(f + 1) * n] += np.asarray(out)

    peak = np.abs(mix).max() or 1.0
    pcm = np.clip(mix / max(peak, 1.0), -1, 1)
    pcm16 = (pcm * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", help="scene JSON (default: built-in sample)")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--dt", type=float, default=1.0 / 60.0)
    p.add_argument("--backend", default="jnp",
                   choices=["jnp", "pallas", "pallas_interpret"])
    p.add_argument("--render-wav", metavar="PATH")
    p.add_argument("--npz", metavar="PATH", help="save settings history")
    p.add_argument("--viz", metavar="PATH",
                   help="render the final frame's traced hits + scene "
                        "geometry to PNG (demo.visualize)")
    p.add_argument("--viz-every", type=int, default=0, metavar="N",
                   help="ALSO dump a gizmo PNG every N frames while the "
                        "sim runs (live view; frame index appended to "
                        "the --viz path)")
    p.add_argument("--orbit", action="store_true",
                   help="listener orbits the origin (PlayerController stand-in)")
    p.add_argument("--mesh", metavar="RxP",
                   help="serve through a ('rays','prims') device mesh "
                        "(needs R*P attached devices)")
    args = p.parse_args()

    from audio_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from audio_raytracer_tpu.demo.scene_format import (
        build_registry,
        load_scene_file,
    )
    from audio_raytracer_tpu.demo.sample_scene import sample_scene_dict

    loaded = (load_scene_file(args.scene) if args.scene
              else build_registry(sample_scene_dict()))

    listener_path = None
    if args.orbit:
        base = np.asarray(loaded.listener_position)

        def listener_path(t):
            return base + np.asarray(
                [6.0 * np.sin(0.5 * t), 0.0, 6.0 * np.cos(0.5 * t)])

    mesh = None
    if args.mesh:
        import dataclasses

        from audio_raytracer_tpu.parallel.mesh import make_mesh

        rs, ps = (int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(ray_shards=rs, prim_shards=ps)
        if loaded.cfg.ray_count % rs:
            rc = -(-loaded.cfg.ray_count // rs) * rs
            print(f"rounding ray_count {loaded.cfg.ray_count} -> {rc} "
                  f"for {rs} ray shards", file=sys.stderr)
            loaded.cfg = dataclasses.replace(loaded.cfg, ray_count=rc)

    history = simulate(loaded, frames=args.frames, dt=args.dt,
                       backend=args.backend, listener_path=listener_path,
                       viz_every=args.viz_every, viz_path=args.viz,
                       mesh=mesh)

    print(json.dumps({
        "frames": args.frames,
        "targets": loaded.target_names,
        "muffle_mean": np.round(history["muffle"].mean(axis=0), 4).tolist(),
        "muffle_range": [np.round(history["muffle"].min(axis=0), 4).tolist(),
                         np.round(history["muffle"].max(axis=0), 4).tolist()],
        "reverb_strength_mean": round(float(
            history["reverb_strength"].mean()), 4),
        "reverb_volume_mean": round(float(
            history["reverb_volume"].mean()), 4),
        "frame_ms_median": round(float(np.median(history["frame_ms"])), 2),
    }))

    if args.npz:
        np.savez(args.npz, **history)
        print(f"saved history to {args.npz}", file=sys.stderr)
    if args.render_wav:
        render_wav(loaded, history, args.render_wav, dt=args.dt)
        print(f"rendered {args.render_wav}", file=sys.stderr)
    if args.viz:
        from audio_raytracer_tpu.demo.visualize import plot_trace

        # Trace from where the listener ENDED (the scene geometry is
        # already at its final animated state in the registry).
        plot_trace(loaded, args.viz, rays=max(loaded.cfg.ray_count, 256),
                   backend=args.backend, listener=history["listener"][-1])
        print(f"wrote {args.viz}", file=sys.stderr)


if __name__ == "__main__":
    main()
