"""Smoke test of the audio ray tracer on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One card, at the BASELINE width (1M rays x 4K mixed colliders: 1K
spheres, 2K AABBs, 1K OBBs, as bench.build_inputs; 5 hits; 4 sources):

1. device: the card's name and power limit, ``jax.devices()``; fails
   unless JAX's platform is ``gpu``.
2. parity: every Pallas kernel, compiled for the card, against the plain
   chunked fold (ops.backend.DenseBackend), and the fold against the
   one-grid form at 64K rays; ``memory_analysis()`` of each program.
3. main path through the user entry points: ``make_forward`` (production
   config, max_ray_life 125 and 300) on both engines, ``make_train_step``
   and ``make_pose_recovery_step``, kernel gradients against the plain
   engine's autodiff at 64K rays, ``AsyncRaytraceLoop`` over the native
   registry on the sample scene, ``scene_player.simulate``, and
   conformance configs 1-4 on the device.
4. timing: each kernel against the plain fold it replaces, and the
   forward step with each engine (median of several runs after warm-up).
5. the GPU test lane (``pytest -m gpu``) in this process.

``--four-cards`` runs only the sharded forward on 4x1 and 2x2
('rays','prims') meshes at 1M rays x 4K colliders x 8 sources and the
2x2 materials train step, each against one card.

Any failed check raises and the script exits non-zero. Without a GPU it
exits non-zero before printing a result. The last line of standard
output is one JSON object with the device JAX ran on.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

R_FULL = 1 << 20
P_FULL = 4096
R_GRID = 1 << 16  # one [R, P] f32 grid = 1 GB at 4K primitives
TARGETS = 4
BOUNCES = 4
ITERS = 5


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the first card, read without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return out.strip().splitlines()[0]


def compiled(name, fn, *args):
    """jit + compile ``fn`` for ``args`` and print its memory analysis."""
    import jax

    c = jax.jit(fn).lower(*args).compile()
    m = c.memory_analysis()
    gib = 1 << 30
    if m is None:
        log(f"  [{name}] memory_analysis: not reported")
    else:
        log(f"  [{name}] memory_analysis: args "
            f"{m.argument_size_in_bytes / gib:.3f} GiB, outputs "
            f"{m.output_size_in_bytes / gib:.3f} GiB, temps "
            f"{m.temp_size_in_bytes / gib:.3f} GiB")
    return c


def median_ms(fn, *args, iters=ITERS):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


# ---------------------------------------------------------------------------
# Workload
# ---------------------------------------------------------------------------


def baseline(targets=TARGETS):
    import bench

    return bench.build_inputs(R_FULL, P_FULL, targets, BOUNCES)


def bounce_sets(scene, origin, dirs):
    """The first bounce's secondary rays, as ops.trace builds them: from
    the epsilon-offset hit points, an echo set back to the listener and
    one muffle set per source. Returns (off, occ dirs, limits, skips)."""
    import jax
    import jax.numpy as jnp

    from audio_raytracer_tpu.ops import intersect
    from audio_raytracer_tpu.ops.backend import NO_SKIP, DenseBackend

    o = jnp.broadcast_to(origin, dirs.shape)
    hit, t, _ = jax.jit(DenseBackend(scene).closest_hit)(o, dirs)
    p = o + dirs * jnp.where(hit, t, 10.0)[:, None]
    off = p - dirs * 1e-4
    ends = [origin] + [scene.target_positions[i]
                       for i in range(scene.num_targets)]
    sets = [intersect.safe_normalize(e - off) for e in ends]
    limits = jnp.stack([intersect.safe_norm(e - off) for e in ends], -1)
    skips = (NO_SKIP,) + tuple(range(scene.num_targets))
    return off, sets, limits, skips


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device(count):
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {platform})",
              file=sys.stderr)
        return None
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__} devices: {jax.devices()}")
    if len(jax.devices()) < count:
        print(f"chip_smoke: need {count} GPUs, JAX found "
              f"{len(jax.devices())}", file=sys.stderr)
        return None
    return jax.devices()[0]


def kernel_pairs(scene, origin, dirs):
    """[(name, kernel fn, plain fn, args)] for the three kernel stages at
    the given width: closest hit, occlusion (S = 1 + T), chords (S = T).
    Every array, the scene included, is an argument of the programs."""
    import jax.numpy as jnp

    from audio_raytracer_tpu.ops.backend import DenseBackend
    from audio_raytracer_tpu.ops.pallas import PallasBackend

    o = jnp.broadcast_to(origin, dirs.shape)
    off, sets, limits, skips = bounce_sets(scene, origin, dirs)

    def occlusion(engine):
        return lambda sc, off, s, li: engine(sc).multi_occluded(
            off, s, li, skips, jnp.zeros(li.shape, bool))

    def chords(engine):
        return lambda sc, off, s: engine(sc).multi_permeation_loss(
            off, s, skips[1:])

    T = scene.num_targets
    return [
        ("closest_hit",
         lambda sc, o, d: PallasBackend(sc).local_closest(o, d),
         lambda sc, o, d: DenseBackend(sc).local_closest(o, d),
         (scene, o, dirs)),
        (f"occlusion_S{1 + T}", occlusion(PallasBackend),
         occlusion(DenseBackend), (scene, off, sets, limits)),
        (f"chords_S{T}", chords(PallasBackend), chords(DenseBackend),
         (scene, off, sets[1:])),
    ]


def compare_pair(name, got, want):
    """Kernel vs plain fold. Tolerances: both sides compile to f32 code
    with different fma contraction and a different summation order
    (sequential in the kernel, per-chunk trees added across chunks in
    the fold), so distances and sums agree to rounding and a decision
    may flip only on razor-edge lanes."""
    import numpy as np

    if name == "closest_hit":
        (tk, ik), (tp, ip) = got, want
        tk, ik, tp, ip = map(np.asarray, (tk, ik, tp, ip))
        hk, hp = np.isfinite(tk), np.isfinite(tp)
        flips = np.mean((hk != hp) | (hk & (ik != ip)))
        check(flips <= 1e-4, f"{name}: hit/rank razor-edge lanes "
              f"{flips:.2e} <= 1e-4")
        m = hk & hp & (ik == ip)
        rel = np.abs(tk[m] - tp[m]) / np.abs(tp[m])
        # Grazing OBB lanes amplify the rounding difference between the
        # kernel's baked rotation matrix and the fold's quaternion.
        wide = np.mean(rel > 1e-5)
        check(wide <= 1e-4 and rel.max() <= 1e-3,
              f"{name}: t within rtol 1e-5 on all but {wide:.2e} <= 1e-4 "
              f"of hit lanes (max rel {rel.max():.2e} <= 1e-3)")
    elif name.startswith("occlusion"):
        agree = np.mean(np.asarray(got) == np.asarray(want))
        check(agree >= 0.9999, f"{name}: agreement {agree:.6f} >= 0.9999")
    else:
        got, want = np.asarray(got), np.asarray(want)
        diff = np.abs(got - want)
        # Grazing rays amplify rounding (1 / local direction) in the
        # slab entry/exit distances; chord length stays continuous.
        wide = np.mean(diff > 1e-3 + 1e-4 * np.abs(want))
        check(wide <= 1e-3, f"{name}: within rtol 1e-4 atol 1e-3 on all "
              f"but {wide:.2e} <= 1e-3 of lanes (max abs diff "
              f"{diff.max():.2e})")


def phase_parity(scene, origin, dirs):
    import jax.numpy as jnp

    from audio_raytracer_tpu.ops import intersect
    from audio_raytracer_tpu.ops.backend import DenseBackend

    log("phase parity: kernels vs plain fold @ "
        f"{dirs.shape[0]} rays x {scene.num_primitives} prims")
    progs = {}
    for name, kern, plain, args in kernel_pairs(scene, origin, dirs):
        ck = compiled(f"{name} kernel", kern, *args)
        cp = compiled(f"{name} fold", plain, *args)
        compare_pair(name, ck(*args), cp(*args))
        progs[name] = (ck, cp, args)

    log(f"phase parity: fold vs one [R, P] grid @ {R_GRID} rays")
    d = dirs[:R_GRID]
    o = jnp.zeros_like(d)
    check(DenseBackend(scene).chunked, "fold engine streams primitive "
          "chunks")
    t_f, i_f = compiled("closest fold", lambda sc, o, d: DenseBackend(
        sc).local_closest(o, d), scene, o, d)(scene, o, d)
    _, t_g, i_g = compiled("closest grid", intersect.closest_hit, o, d,
                           scene)(o, d, scene)
    compare_pair("closest_hit", (t_f, i_f), (t_g, i_g))
    off, sets, limits, skips = bounce_sets(scene, jnp.zeros(3), d)

    def occ_fold(sc, off, sets, limits):
        return DenseBackend(sc).multi_occluded(
            off, sets, limits, skips, jnp.zeros(limits.shape, bool))

    def occ_grid(sc, off, sets, limits):
        return jnp.stack([intersect.any_hit_within(
            off, s, limits[:, i], sc, None if i == 0 else i - 1)
            for i, s in enumerate(sets)], -1)

    def ch_fold(sc, off, sets):
        return DenseBackend(sc).multi_permeation_loss(off, sets, skips[1:])

    def ch_grid(sc, off, sets):
        return jnp.stack([intersect.permeation_loss(off, x, sc, i)
                          for i, x in enumerate(sets)], -1)

    args = (scene, off, sets, limits)
    compare_pair("occlusion", compiled("occlusion fold", occ_fold,
                                       *args)(*args),
                 compiled("occlusion grid", occ_grid, *args)(*args))
    args = (scene, off, sets[1:])
    ch_f = compiled("chords fold", ch_fold, *args)(*args)
    ch_g = compiled("chords grid", ch_grid, *args)(*args)
    compare_pair("chords", ch_f, ch_g)
    return progs


def production(cfg, life):
    return dataclasses.replace(cfg, max_ray_life=life, compact_rays=True,
                               compact_unordered=True)


def phase_forward(cfg, scene, origin, dirs):
    import numpy as np

    from audio_raytracer_tpu.models.raytracer import make_forward

    log(f"phase forward: make_forward @ {dirs.shape[0]} rays x "
        f"{scene.num_primitives} prims x {cfg.max_hits_per_ray} hits x "
        f"{scene.num_targets} sources")
    steps = {}
    for life in (125.0, 300.0):
        out = {}
        for engine in ("pallas", "jnp"):
            fwd = make_forward(production(cfg, life), backend=engine)
            c = compiled(f"forward {engine} life {life:g}", fwd, origin,
                         dirs, scene)
            for i in range(3):
                _, settings = c(origin + 1e-6 * i, dirs, scene)
            mu = np.asarray(settings.muffle)
            check(np.isfinite(mu).all() and (mu >= 0).all()
                  and (mu <= 1).all(),
                  f"forward {engine} life {life:g}: muffle "
                  f"{np.round(mu, 4).tolist()} finite in [0, 1]")
            out[engine] = settings
            steps[(engine, life)] = c
        for k in ("muffle", "reverb_strength", "reverb_volume"):
            a = np.asarray(getattr(out["pallas"], k))
            b = np.asarray(getattr(out["jnp"], k))
            check(np.allclose(a, b, rtol=1e-3, atol=1e-3),
                  f"life {life:g}: {k} kernel engine == plain engine "
                  f"(max diff {np.abs(a - b).max():.2e})")
    return steps


def phase_training(cfg, scene, origin, dirs):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        PoseParams,
        SceneParams,
        loudness_loss,
        make_pose_recovery_step,
        make_train_step,
    )
    from audio_raytracer_tpu.ops.pallas import PallasBackend

    T = scene.num_targets
    target = Loudness(muffle=jnp.full((T,), 0.3),
                      permeation=jnp.full((T,), 0.2),
                      reverb_energy=jnp.asarray(0.05))
    params = SceneParams.from_scene(scene)
    log(f"phase training: materials and pose steps @ {dirs.shape[0]} "
        f"rays x {scene.num_primitives} prims")
    for engine in ("pallas", "jnp"):
        step, opt = make_train_step(cfg, backend=engine)
        state = opt.init(params)
        p = params
        for _ in range(2):
            p, state, loss = step(p, state, scene, origin, dirs, target)
        check(np.isfinite(float(loss)), f"materials step {engine}: loss "
              f"{float(loss):.6e} finite")
        pstep, popt = make_pose_recovery_step(cfg, backend=engine)
        pose = PoseParams(origin=origin,
                          target_positions=scene.target_positions)
        pstate = popt.init(pose)
        for _ in range(2):
            pose, pstate, loss = pstep(pose, pstate, scene, dirs, target)
        check(np.isfinite(float(loss)), f"pose step {engine}: loss "
              f"{float(loss):.6e} finite")

    n = R_GRID
    log(f"phase training: kernel gradients vs plain autodiff @ {n} rays")
    d = dirs[:n]
    cfg_n = dataclasses.replace(cfg, ray_count=n)
    for pose_grads in (False, True):
        argnums = (0, 2) if pose_grads else 0

        def grads(backend_fn, argnums=argnums):
            return jax.jit(lambda p, o: jax.grad(
                loudness_loss, argnums=argnums)(
                    p, scene, o, d, cfg_n, target,
                    backend_fn=backend_fn))(params, origin)

        g_k = grads(lambda s, pg=pose_grads: PallasBackend(
            s, differentiable=True, pose_grads=pg))
        g_p = grads(None)
        for a, b in zip(jax.tree.leaves(g_p), jax.tree.leaves(g_k)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=2e-3, atol=2e-5)
        check(True, f"gradients (pose_grads={pose_grads}): "
              f"{len(jax.tree.leaves(g_p))} leaves within rtol 2e-3 "
              f"atol 2e-5")


def phase_live(engine):
    import numpy as np

    from audio_raytracer_tpu.demo.sample_scene import sample_scene_dict
    from audio_raytracer_tpu.demo.scene_format import build_registry
    from audio_raytracer_tpu.demo.scene_player import simulate
    from audio_raytracer_tpu.runtime import AsyncRaytraceLoop

    log("phase live: AsyncRaytraceLoop on the sample scene")
    loaded = build_registry(sample_scene_dict())
    loop = AsyncRaytraceLoop(loaded.registry, loaded.cfg, backend=engine,
                             compute_async=True)
    settings = None
    for _ in range(60):
        settings = loop.tick(np.asarray(loaded.listener_position))
        time.sleep(0.005)
    check(loop.frames_harvested >= 2,
          f"live loop: 60 ticks, {loop.frames_dispatched} dispatched, "
          f"{loop.frames_harvested} harvested, raytracer "
          f"{loop.raytracer_ms:.2f} ms")
    mu = np.asarray(settings.muffle)
    check(np.isfinite(mu).all() and (mu >= 0).all() and (mu <= 1).all(),
          f"live loop muffle {np.round(mu, 4).tolist()} in [0, 1]")
    loaded = build_registry(sample_scene_dict())
    hist = simulate(loaded, frames=8, backend=engine, verbose=False)
    check(np.isfinite(hist["muffle"]).all(),
          f"scene_player.simulate: 8 frames, median frame "
          f"{np.median(hist['frame_ms']):.2f} ms")
    loaded.registry.close()


def phase_conformance(engine):
    from audio_raytracer_tpu import conformance

    log("phase conformance: configs 1-4 on the device")
    rc = conformance.main(["--only", "1", "--only", "2", "--only", "3",
                           "--only", "4", "--backend", engine])
    check(rc == 0, "conformance configs 1-4 pass")


def phase_timing(progs, fwd_steps, cfg, scene, origin, dirs):
    log(f"phase timing: median of {ITERS} runs after warm-up, ms "
        f"(card: {card_line()})")
    for name, (ck, cp, args) in progs.items():
        tk, _ = median_ms(ck, *args)
        tp, _ = median_ms(cp, *args)
        log(f"  time {name}: kernel {tk:.3f} ms, plain fold {tp:.3f} ms, "
            f"plain/kernel {tp / tk:.2f}x")
    for life in (125.0, 300.0):
        tk, _ = median_ms(fwd_steps[("pallas", life)], origin, dirs, scene)
        tp, _ = median_ms(fwd_steps[("jnp", life)], origin, dirs, scene)
        log(f"  time forward life {life:g}: kernel engine {tk:.3f} ms, "
            f"plain engine {tp:.3f} ms, plain/kernel {tp / tk:.2f}x")


def phase_gpu_lane():
    import pytest

    log("phase gpu lane: pytest -m gpu")
    os.environ["ART_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(os.path.dirname(os.path.abspath(
                          __file__)), "tests", "test_gpu_lane.py")])
    check(rc == 0, "gpu test lane passes")


def four_cards():
    import jax
    import numpy as np
    import optax

    from audio_raytracer_tpu.models.differentiable import (
        Loudness,
        SceneParams,
        make_train_step,
    )
    from audio_raytracer_tpu.models.raytracer import forward
    from audio_raytracer_tpu.parallel.mesh import (
        make_mesh,
        pad_scene_for_prim_shards,
    )
    from audio_raytracer_tpu.parallel.sharded import make_sharded_forward
    from audio_raytracer_tpu.parallel.train import make_sharded_train_step

    cfg, scene, origin, dirs = baseline(targets=8)
    devs = jax.devices()[:4]
    for rs, ps in ((4, 1), (2, 2)):
        log(f"four cards: sharded forward {rs}x{ps} @ {dirs.shape[0]} rays "
            f"x {scene.num_primitives} prims x {scene.num_targets} sources")
        cfg_m = dataclasses.replace(cfg, num_accum_batches=rs)
        mesh = make_mesh(ray_shards=rs, prim_shards=ps, devices=devs)
        step = make_sharded_forward(cfg_m, mesh, backend="pallas")
        got = step(origin, dirs, pad_scene_for_prim_shards(scene, ps))
        want = jax.jit(lambda o, d, s: forward(o, d, s, cfg_m,
                                               backend="pallas")[1])(
            origin, dirs, scene)
        for k in ("muffle", "reverb_strength", "reverb_volume"):
            a, b = np.asarray(getattr(got, k)), np.asarray(getattr(want, k))
            check(np.allclose(a, b, rtol=1e-5, atol=1e-5),
                  f"{rs}x{ps} {k} == one card (max diff "
                  f"{np.abs(a - b).max():.2e})")
        tm, _ = median_ms(step, origin, dirs,
                          pad_scene_for_prim_shards(scene, ps), iters=3)
        log(f"  time sharded forward {rs}x{ps}: {tm:.3f} ms")

    log("four cards: sharded materials train step 2x2 vs one card")
    T = scene.num_targets
    target = Loudness(muffle=np.full((T,), 0.3, np.float32),
                      permeation=np.full((T,), 0.2, np.float32),
                      reverb_energy=np.float32(0.05))
    params = SceneParams.from_scene(scene)
    sgd = optax.sgd(1.0)  # new params = params - grad
    mesh = make_mesh(ray_shards=2, prim_shards=2, devices=devs)
    sstep, _ = make_sharded_train_step(cfg, mesh, optimizer=sgd,
                                       backend="pallas")
    scene_p = pad_scene_for_prim_shards(scene, 2)
    params_p = SceneParams.from_scene(scene_p)
    new_s, _, loss_s = sstep(params_p, sgd.init(params_p), scene_p, origin,
                             dirs, target)
    ostep, _ = make_train_step(cfg, optimizer=sgd, backend="pallas")
    new_o, _, loss_o = ostep(params, sgd.init(params), scene, origin, dirs,
                             target)
    # The differentiable tier recomputes each winner's distance in
    # programs compiled per mesh; a grazing lane can amplify their
    # last-bit differences into a flipped visibility (one ray-bounce
    # moves the loss by ~1e-7 at 1M rays).
    check(np.isclose(float(loss_s), float(loss_o), rtol=1e-4, atol=1e-6),
          f"2x2 loss {float(loss_s):.6e} == one card {float(loss_o):.6e}")
    for name in ("sphere", "aabb", "obb"):
        for field in ("absorption", "density", "echo"):
            n = getattr(scene, name + "s").count
            gs = (np.asarray(getattr(getattr(params_p, name), field))[:n]
                  - np.asarray(getattr(getattr(new_s, name), field))[:n])
            go = (np.asarray(getattr(getattr(params, name), field))
                  - np.asarray(getattr(getattr(new_o, name), field)))
            np.testing.assert_allclose(gs, go, rtol=2e-3, atol=2e-5)
    check(True, "2x2 train-step gradients == one card (rtol 2e-3, "
          "atol 2e-5)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded path on four cards")
    args = p.parse_args(argv)

    import jax

    count = 4 if args.four_cards else 1
    device = phase_device(count)
    if device is None:
        return 1
    from audio_raytracer_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards()
    else:
        cfg, scene, origin, dirs = baseline()
        progs = phase_parity(scene, origin, dirs)
        fwd_steps = phase_forward(cfg, scene, origin, dirs)
        phase_training(cfg, scene, origin, dirs)
        phase_live("pallas")
        phase_conformance("pallas")
        phase_timing(progs, fwd_steps, cfg, scene, origin, dirs)
        phase_gpu_lane()
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
