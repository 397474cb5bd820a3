"""Material calibration CLI: learn audio materials from a loudness map.

The reference's materials are hand-authored ScriptableObject assets
(Assets/ScriptableObjects/AudioMaterials/*.asset — Concrete, Wood,
Steel, Echo) tuned by ear. This framework makes them LEARNABLE
(BASELINE config 4): trace the target loudness map with the scene's
authored materials, reinitialize (or perturb) the material parameters,
and recover them by gradient descent through the differentiable tracer
(models/differentiable.py — straight-through trajectories, chord
gradients through the plain fold's VJP on the kernel tier).

Usage:
  python -m audio_raytracer_tpu.demo.train_materials            # sample
  python -m audio_raytracer_tpu.demo.train_materials --scene my.json \
      --steps 300 --rays 512 --lr 0.02 --init noisy \
      --checkpoint /tmp/calib --mesh 4x2
Prints a JSON summary line; with --checkpoint, training is resumable
(params + optimizer moments + step counter round-trip, --resume).

--recover-pose switches from materials to POSES (the north star's
"gradients flow to source/listener poses", made useful):
  --recover-pose source    perturb the audio-target positions, then
      triangulate them back from loudness recordings at several known
      listener positions (models.differentiable.make_source_recovery_step)
  --recover-pose listener  perturb the listener origin, then recover it
      from one recording with the IR histogram enabled (distance
      -resolved observables; make_pose_recovery_step)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _material_errors(params, truth, active_counts=None):
    """Mean |learned - authored| per material field, ACTIVE prims only.

    ``active_counts``: {"sphere": n, "aabb": n, "obb": n} pre-pad counts
    captured before pad_scene_for_prim_shards — mesh runs pad each
    primitive type with inactive entries whose params start equal to
    truth and receive zero gradient, so averaging over them would dilute
    the reported MAE relative to the same run without --mesh."""
    errs = {}
    for field in ("absorption", "density", "echo"):
        num, den = 0.0, 0
        for tname in ("sphere", "aabb", "obb"):
            a = np.asarray(getattr(getattr(params, tname), field))
            b = np.asarray(getattr(getattr(truth, tname), field))
            n = a.size if active_counts is None else active_counts[tname]
            num += np.abs(a[:n] - b[:n]).sum()
            den += n
        errs[field] = float(num / max(den, 1))
    return errs


def _recover_pose(args):
    """--recover-pose driver: perturb poses with a seeded offset, then
    recover them by gradient descent through the chord/echo paths."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from audio_raytracer_tpu.demo.sample_scene import sample_scene_dict
    from audio_raytracer_tpu.demo.scene_format import (
        build_registry,
        load_scene_file,
    )
    from audio_raytracer_tpu.models.differentiable import (
        PoseParams,
        loudness_map,
        make_pose_recovery_step,
        make_source_recovery_step,
        stack_loudness,
    )
    from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions

    loaded = (load_scene_file(args.scene) if args.scene
              else build_registry(sample_scene_dict()))
    scene = loaded.registry.snapshot()
    cfg = dataclasses.replace(loaded.cfg, ray_count=args.rays)
    origin = jnp.asarray(loaded.listener_position, jnp.float32)
    dirs = fibonacci_directions(args.rays)
    key = jax.random.key(args.seed)
    true_tp = scene.target_positions

    if args.recover_pose == "source":
        # Recordings at the authored listener + 3 offset vantage points
        # (acoustic triangulation; one vantage point is unobservable —
        # see make_source_recovery_step).
        origins = jnp.stack([
            origin,
            origin + jnp.asarray([5.0, 0.5, -3.0]),
            origin + jnp.asarray([-5.0, 1.0, 3.0]),
            origin + jnp.asarray([2.0, 0.0, -6.0]),
        ])
        recs = stack_loudness([
            loudness_map(origins[i], dirs, scene, cfg)
            for i in range(origins.shape[0])])
        tp = true_tp + args.pose_perturbation * jax.random.normal(
            key, true_tp.shape)
        step, opt = make_source_recovery_step(
            cfg, num_listeners=origins.shape[0],
            optimizer=optax.adam(args.lr), backend=args.backend)
        opt_state = opt.init(tp)
        err0 = float(jnp.linalg.norm(tp - true_tp, axis=-1).mean())
        loss = float("nan")
        for i in range(args.steps):
            tp, opt_state, loss = step(tp, opt_state, scene, origins,
                                       dirs, recs)
            if i % args.log_every == 0 or i == args.steps - 1:
                err = float(jnp.linalg.norm(tp - true_tp, axis=-1).mean())
                print(f"step {i:4d}: loss {float(loss):.3e} "
                      f"pose_err {err:.4f}", file=sys.stderr)
        err1 = float(jnp.linalg.norm(tp - true_tp, axis=-1).mean())
    else:  # listener
        # One recording, IR histogram on (distance-resolved bins make
        # the origin well-determined).
        if cfg.num_reverb_bins == 0:
            cfg = dataclasses.replace(cfg, num_reverb_bins=48,
                                      ir_max_distance=cfg.max_ray_life)
        rec = loudness_map(origin, dirs, scene, cfg)
        pose = PoseParams(
            origin=origin + args.pose_perturbation * jax.random.normal(
                key, (3,)),
            target_positions=true_tp)
        step, opt = make_pose_recovery_step(
            cfg, optimizer=optax.adam(args.lr), backend=args.backend,
            recover=("origin",))
        opt_state = opt.init(pose)
        err0 = float(jnp.linalg.norm(pose.origin - origin))
        loss = float("nan")
        for i in range(args.steps):
            pose, opt_state, loss = step(pose, opt_state, scene, dirs,
                                         rec)
            if i % args.log_every == 0 or i == args.steps - 1:
                err = float(jnp.linalg.norm(pose.origin - origin))
                print(f"step {i:4d}: loss {float(loss):.3e} "
                      f"pose_err {err:.4f}", file=sys.stderr)
        err1 = float(jnp.linalg.norm(pose.origin - origin))

    print(json.dumps({
        "mode": f"recover_pose_{args.recover_pose}",
        "steps": args.steps,
        "final_loss": float(loss),
        "pose_error_initial": round(err0, 4),
        "pose_error_final": round(err1, 4),
        "backend": args.backend,
    }))
    loaded.registry.close()


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", help="scene JSON (default: built-in sample)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--rays", type=int, default=512)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--backend", default="jnp",
                   choices=["jnp", "pallas", "pallas_interpret"])
    p.add_argument("--init", default="default",
                   choices=["default", "noisy"],
                   help="start from AudioMaterialProperties.Default "
                        "{0,1,1} or from the authored values + noise")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", metavar="RxP",
                   help="train sharded over an R x P ('rays','prims') "
                        "device mesh (params tensor-parallel over prims)")
    p.add_argument("--checkpoint", metavar="DIR",
                   help="save {params, opt_state, step} here")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="restore from --checkpoint and continue")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--recover-pose", choices=["source", "listener"],
                   help="recover poses instead of materials (see module "
                        "docstring)")
    p.add_argument("--pose-perturbation", type=float, default=0.8,
                   help="seeded perturbation magnitude for --recover-pose")
    args = p.parse_args()

    from audio_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.recover_pose:
        _recover_pose(args)
        return

    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from audio_raytracer_tpu.demo.sample_scene import sample_scene_dict
    from audio_raytracer_tpu.demo.scene_format import (
        build_registry,
        load_scene_file,
    )
    from audio_raytracer_tpu.models.differentiable import (
        SceneParams,
        loudness_map,
        make_train_step,
    )
    from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu.types import Materials

    loaded = (load_scene_file(args.scene) if args.scene
              else build_registry(sample_scene_dict()))
    scene = loaded.registry.snapshot()
    cfg = dataclasses.replace(loaded.cfg, ray_count=args.rays)
    origin = jnp.asarray(loaded.listener_position, jnp.float32)
    dirs = fibonacci_directions(args.rays)

    # Target = the authored materials' loudness map (the "recording").
    truth = SceneParams.from_scene(scene)
    target = loudness_map(origin, dirs, scene, cfg)
    jax.block_until_ready(target.muffle)

    # Initial parameters.
    if args.init == "default":
        def default_like(m):
            n = m.count
            return Materials.default(n)

        params = SceneParams(sphere=default_like(truth.sphere),
                             aabb=default_like(truth.aabb),
                             obb=default_like(truth.obb))
    else:
        keys = jax.random.split(jax.random.key(args.seed), 9)
        ki = iter(keys)

        def noisy(m):
            def jitter(x, lo=0.0):
                return jnp.maximum(
                    x + 0.3 * jax.random.normal(next(ki), x.shape), lo)
            return Materials(absorption=jnp.clip(
                jitter(m.absorption), 0.0, 1.0),
                density=jitter(m.density), echo=jitter(m.echo))

        params = SceneParams(sphere=noisy(truth.sphere),
                             aabb=noisy(truth.aabb), obb=noisy(truth.obb))

    active_counts = {"sphere": scene.spheres.count,
                     "aabb": scene.aabbs.count, "obb": scene.obbs.count}
    optimizer = optax.adam(args.lr)
    if args.mesh:
        from audio_raytracer_tpu.parallel.mesh import (
            make_mesh,
            pad_scene_for_prim_shards,
        )
        from audio_raytracer_tpu.parallel.train import (
            make_sharded_train_step,
        )

        rs, ps = (int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(ray_shards=rs, prim_shards=ps,
                         devices=jax.devices()[: rs * ps])
        scene = pad_scene_for_prim_shards(scene, ps)
        # Re-derive params/target on the padded scene so shapes agree.
        truth = SceneParams.from_scene(scene)
        params = jax.tree.map(
            lambda t, p: jnp.concatenate(
                [p, t[p.shape[0]:]]) if t.shape != p.shape else p,
            truth, params)
        assert cfg.ray_count % rs == 0, (
            f"--rays {cfg.ray_count} must divide by {rs} ray shards")
        step, optimizer = make_sharded_train_step(
            cfg, mesh, optimizer=optimizer, backend=args.backend)
    else:
        step, optimizer = make_train_step(cfg, optimizer=optimizer,
                                          backend=args.backend)

    opt_state = optimizer.init(params)
    start = 0
    if args.resume and args.checkpoint:
        from audio_raytracer_tpu.utils.checkpoint import restore_checkpoint

        state = restore_checkpoint(
            args.checkpoint, {"params": params, "opt_state": opt_state,
                              "step": jnp.asarray(0)})
        params, opt_state = state["params"], state["opt_state"]
        start = int(state["step"])
        print(f"resumed from step {start}", file=sys.stderr)

    loss = float("nan")
    for i in range(start, args.steps):
        params, opt_state, loss = step(params, opt_state, scene, origin,
                                       dirs, target)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d}: loss {float(loss):.3e}", file=sys.stderr)
        if args.checkpoint and ((i + 1) % args.ckpt_every == 0
                                or i == args.steps - 1):
            from audio_raytracer_tpu.utils.checkpoint import save_checkpoint

            save_checkpoint(args.checkpoint,
                            {"params": params, "opt_state": opt_state,
                             "step": jnp.asarray(i + 1)})

    errs = _material_errors(params, truth, active_counts)
    print(json.dumps({
        "steps": args.steps,
        "final_loss": float(loss),
        "material_mae": {k: round(v, 4) for k, v in errs.items()},
        "backend": args.backend,
        "mesh": args.mesh,
    }))
    loaded.registry.close()


if __name__ == "__main__":
    main()
