"""Multi-process worker for the distributed shard-invariance check.

Launched by parallel.distributed.run_two_process_check (and through it by
the driver's ``dryrun_multichip``) via a ``python -c`` bootstrap that
pins the CPU platform and calls jax.distributed.initialize BEFORE this
module is imported (package import creates jnp constants, which would
initialize the XLA backend too early — ``python -m`` cannot work here).
Each process:

1. pins the CPU platform with N virtual devices (a stand-in for one
   host's accelerators),
2. joins the jax.distributed cluster (Gloo collectives over localhost —
   the same code path DCN collectives take on a real multi-host slice),
3. builds the hosts-major ('rays', 'prims') mesh
   (distributed.make_distributed_mesh: prims confined to local devices),
4. runs the full sharded forward on a deterministic scene with its local
   ray shard, and
5. (process 0) saves the TargetSettings to ``ART_OUT`` for the parent to
   compare against the single-process result.
"""

from __future__ import annotations

import os
import types


def run():
    """Body of one cluster process; jax.distributed must be live."""
    args = types.SimpleNamespace(
        num_processes=int(os.environ["ART_NUM_PROCESSES"]),
        process_id=int(os.environ["ART_PROCESS_ID"]),
        prim_shards=int(os.environ.get("ART_PRIM_SHARDS", "2")),
        ray_count=int(os.environ.get("ART_RAY_COUNT", "64")),
        # Per-shard intersection engine: "jnp" (fast default) or
        # "pallas_interpret" — the kernel-tier cluster composition
        # (multi-host x Pallas, the production pairing of BASELINE
        # config 5 with the kernel engines).
        backend=os.environ.get("ART_BACKEND", "jnp"),
        out=os.environ.get("ART_OUT"),
    )

    from audio_raytracer_tpu.parallel import distributed

    import jax
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions
    from audio_raytracer_tpu.parallel.sharded import (
        make_sharded_forward,
        scene_pspec,
    )

    mesh = distributed.make_distributed_mesh(prim_shards=args.prim_shards)
    ray_shards = mesh.shape["rays"]

    # The one shared workload definition (distributed.check_workload):
    # the parent compares this run against dense_check_reference on the
    # identical cfg + scene.
    cfg, scene = distributed.check_workload(args.ray_count,
                                            args.prim_shards, ray_shards)
    dirs = np.asarray(fibonacci_directions(args.ray_count))

    def globalize(local_np, spec):
        sharding = NamedSharding(mesh, spec)
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(local_np))

    # Ray axis: this process contributes its local slice; everything else
    # is replicated (scene prim leaves are sharded over the within-host
    # 'prims' axis, which make_array handles from the full local copy).
    rs = distributed.local_ray_slice(args.ray_count)
    dirs_g = globalize(dirs[rs], P("rays"))
    origin_g = globalize(np.zeros((3,), np.float32), P())
    prim_sharded = args.prim_shards > 1
    scene_g = jax.tree.map(globalize, scene, scene_pspec(prim_sharded))

    step = make_sharded_forward(cfg, mesh, backend=args.backend)
    settings = step(origin_g, dirs_g, scene_g)
    jax.block_until_ready(settings)

    if args.process_id == 0 and args.out:
        np.savez(args.out,
                 muffle=np.asarray(settings.muffle),
                 reverb_strength=np.asarray(settings.reverb_strength),
                 reverb_volume=np.asarray(settings.reverb_volume))
    print(f"dist worker {args.process_id}/{args.num_processes}: ok "
          f"(mesh {ray_shards}x{args.prim_shards}, "
          f"{jax.device_count()} devices)", flush=True)
