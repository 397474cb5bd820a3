"""Multi-host bootstrap: jax.distributed + DCN x ICI mesh construction.

The reference is a single-process shared-memory program; its scaling axis
is rays over job-worker threads (Audio/AudioRayTracer.cs:161). At pod
scale (BASELINE config 5) the ray axis spans *hosts*: each host process
owns a ray shard, primitive sharding stays within a host's local devices,
and the accumulator reduces ride the right fabric for their size:

- 'rays' axis across hosts (DCN): the psum payloads are the tiny
  per-target accumulators ([T] floats — muffle counts, permeation,
  reverb stats/IR bins), exactly the per-thread-batch rows the reference
  reduces serially (Jobs/ProcessAudioDataJob.cs:61-65).
- 'prims' axis within a host (ICI): the closest-hit pmin/psum merge
  carries O(R_local) per bounce — it must stay on chip interconnect.

Usage (one call per host process, before any backend use):

    from audio_raytracer_tpu.parallel import distributed
    distributed.initialize()          # reads JAX_* / ART_* env vars
    mesh = distributed.make_distributed_mesh(prim_shards=2)
    step = make_sharded_forward(cfg, mesh)

Environment (either the standard JAX variables or these explicit ones):
    ART_COORDINATOR   host:port of process 0      (default 127.0.0.1:9911)
    ART_NUM_PROCESSES total host processes
    ART_PROCESS_ID    this process's index
"""

from __future__ import annotations

import os

import numpy as np


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> bool:
    """Initialize jax.distributed from args or environment.

    Returns True if multi-process mode was initialized, False when
    running single-process (no env configured) — callers can treat False
    as "use the local devices only". Safe to call twice (second call is
    a no-op).
    """
    import jax

    coordinator = coordinator or os.environ.get("ART_COORDINATOR")
    if num_processes is None and "ART_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["ART_NUM_PROCESSES"])
    if process_id is None and "ART_PROCESS_ID" in os.environ:
        process_id = int(os.environ["ART_PROCESS_ID"])

    if num_processes is None or num_processes <= 1:
        # Single process; jax.distributed is unnecessary.
        return False

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator or "127.0.0.1:9911",
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:  # already initialized
        if "already initialized" not in str(e):
            raise
    return True


def make_distributed_mesh(prim_shards: int = 1,
                          devices=None) -> "jax.sharding.Mesh":
    """('rays', 'prims') mesh with the prims axis confined to one host.

    Rows (ray shards) enumerate hosts-major so the 'rays' axis is the
    only one crossing DCN; every 'prims' group is a set of co-located
    devices whose closest-hit merge collectives ride ICI.
    """
    import jax

    if devices is None:
        devices = jax.devices()
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    n_procs = len(by_proc)
    per_host = len(devices) // n_procs
    assert per_host * n_procs == len(devices), "uneven devices per host"
    assert per_host % prim_shards == 0, (
        f"prim_shards {prim_shards} must divide the {per_host} local "
        f"devices of each host (the 'prims' axis must not cross DCN)")
    rows_per_host = per_host // prim_shards
    blocks = []
    for pi in sorted(by_proc):
        local = np.asarray(by_proc[pi], dtype=object)
        blocks.append(local.reshape(rows_per_host, prim_shards))
    dev_array = np.concatenate(blocks, axis=0)
    return jax.sharding.Mesh(dev_array, ("rays", "prims"))


def check_workload(ray_count: int, prim_shards: int, ray_shards: int,
                   muffle_effectiveness: float = 0.15,
                   permeation_effectiveness: float = 0.1):
    """The deterministic scene + config of the 2-process cluster check.

    One definition shared by the worker (_dist_worker), the in-process
    dense reference (dense_check_reference) and the pytest
    shard-invariance lane, so the compared runs cannot drift apart.
    The default effectiveness values put muffle strictly inside (0, 1)
    on this scene at every accum-batch count the checks use (1-4; the
    per-batch permeation overwrite quirk scales the permeation term with
    the batch count) — a saturated-to-zero muffle would make the
    comparison non-discriminating (a broken psum that clamps to zero
    prints the same thing).
    """
    import jax

    from audio_raytracer_tpu.models.raytracer import random_scene
    from audio_raytracer_tpu.parallel.mesh import pad_scene_for_prim_shards
    from audio_raytracer_tpu.types import TraceConfig

    cfg = TraceConfig(ray_count=ray_count, max_bounces=3,
                      max_ray_life=150.0, num_accum_batches=ray_shards,
                      num_reverb_bins=8, ir_max_distance=80.0,
                      muffle_effectiveness=muffle_effectiveness,
                      permeation_effectiveness=permeation_effectiveness)
    scene = pad_scene_for_prim_shards(
        random_scene(jax.random.key(42), num_spheres=6, num_aabbs=10,
                     num_obbs=8, num_targets=2, extent=14.0,
                     size_range=(1.0, 4.0)), prim_shards)
    return cfg, scene


def dense_check_reference(ray_count: int, prim_shards: int,
                          ray_shards: int) -> dict:
    """Single-process dense forward on the cluster-check workload — the
    ground truth the 2-process cluster's collective outcome must match
    (the reduce being verified: Jobs/ProcessAudioDataJob.cs:61-76)."""
    import jax.numpy as jnp

    from audio_raytracer_tpu.models.raytracer import forward
    from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions

    cfg, scene = check_workload(ray_count, prim_shards, ray_shards)
    _, settings = forward(jnp.zeros(3), fibonacci_directions(ray_count),
                          scene, cfg)
    return {"muffle": np.asarray(settings.muffle),
            "reverb_strength": np.asarray(settings.reverb_strength),
            "reverb_volume": np.asarray(settings.reverb_volume)}


def run_two_process_check(ray_count: int = 64, local_devices: int = 4,
                          prim_shards: int = 2, timeout: float = 600.0,
                          port: int = 9931, backend: str = "jnp"):
    """Spawn a 2-process CPU cluster running the sharded forward and
    return process 0's TargetSettings fields as a dict of numpy arrays.

    This exercises the REAL multi-process path — jax.distributed
    coordination, cross-process (DCN-analog) collectives over the 'rays'
    axis, within-host collectives over 'prims' — without accelerators.
    Raises on worker failure or result mismatch between the processes'
    collective outcome and expectations; the caller compares against a
    single-process run for shard invariance.
    """
    import subprocess
    import sys
    import tempfile

    # The bootstrap must pin the platform and join the cluster BEFORE the
    # package is imported (package import creates jnp constants, which
    # initializes the XLA backend — after that, jax.distributed refuses).
    bootstrap = (
        "import os, jax;"
        "jax.config.update('jax_platforms', 'cpu');"
        "jax.distributed.initialize("
        "  coordinator_address=os.environ['ART_COORDINATOR'],"
        "  num_processes=int(os.environ['ART_NUM_PROCESSES']),"
        "  process_id=int(os.environ['ART_PROCESS_ID']));"
        "from audio_raytracer_tpu.parallel import _dist_worker;"
        "_dist_worker.run()"
    )

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "settings.npz")
        procs = []
        for pid in range(2):
            env = dict(os.environ)
            env.pop("JAX_PLATFORMS", None)  # bootstrap pins cpu itself
            env["XLA_FLAGS"] = (
                env.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={local_devices}"
            ).strip()
            env.update(
                ART_COORDINATOR=f"127.0.0.1:{port}",
                ART_NUM_PROCESSES="2",
                ART_PROCESS_ID=str(pid),
                ART_PRIM_SHARDS=str(prim_shards),
                ART_RAY_COUNT=str(ray_count),
                ART_BACKEND=backend,
                ART_OUT=out,
            )
            procs.append(subprocess.Popen([sys.executable, "-c", bootstrap],
                                          env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        logs = []
        for p in procs:
            try:
                stdout, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise RuntimeError("distributed worker timed out")
            logs.append(stdout)
            if p.returncode != 0:
                raise RuntimeError(
                    f"distributed worker failed:\n{stdout[-2000:]}")
        data = np.load(out)
        return {k: data[k] for k in data.files}


def local_ray_slice(ray_count: int) -> slice:
    """This host's slice of the global ray axis (for building per-host
    input shards with jax.make_array_from_process_local_data)."""
    import jax

    n = jax.process_count()
    assert ray_count % n == 0, f"ray_count {ray_count} % {n} processes != 0"
    per = ray_count // n
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)
