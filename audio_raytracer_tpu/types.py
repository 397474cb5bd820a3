"""Core data model: scenes as arrays, configs as static dataclasses.

The reference represents the scene as C# component objects baked into POD
structs held in double-buffered NativeArrays (DataTypes/Collider Structs/*.cs,
Audio/AudioColliderManager.cs). Here the scene IS the arrays: a pytree of
struct-of-array primitives, so every transform (jit/vmap/grad/shard_map)
applies directly and sharding a scene = sharding its arrays.

Conventions
-----------
- float32 canonical precision (the oracle contract); bfloat16 is an opt-in
  compute precision for the Pallas kernels. The reference stores half and
  computes float (Utility/HalfDataTypesUtility.cs); we define the canonical
  semantics in f32 and treat reduced precision as an accuracy/perf knob.
- Quaternions are xyzw, matching Unity.Mathematics layout. OBBs store the
  INVERSE rotation, mirroring the reference's bake-time optimization
  (Audio/Colliders/AudioOBBCollider.cs:59, ColliderOBBStruct.cs).
- ``target_id`` is int32, -1 = "not owned by any audio target"
  (ColliderAABBStruct.cs: short AudioTargetId, -1 sentinel).
- Primitive arrays are fixed-size; ``active`` masks support padding so
  dynamic scenes keep static shapes under jit.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax.numpy as jnp
import numpy as np

from audio_raytracer_tpu.tree import pytree_dataclass

Array = jnp.ndarray


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------


@pytree_dataclass
class Materials:
    """Per-primitive audio material properties (struct-of-arrays).

    These are the learnable parameters of the differentiable tracer.
    Reference: DataTypes/Collider Structs/AudioMaterialProperties.cs
    (Absorption: ray-life drain per bounce; Density: permeation loss per
    meter; Echo: echo-distance multiplier; Default = {0, 1, 1}).
    """

    absorption: Array  # [N] in [0, 1]
    density: Array  # [N] >= 0
    echo: Array  # [N] >= 0

    @staticmethod
    def default(n: int, dtype=jnp.float32) -> "Materials":
        return Materials(
            absorption=jnp.zeros((n,), dtype),
            density=jnp.ones((n,), dtype),
            echo=jnp.ones((n,), dtype),
        )

    @property
    def count(self) -> int:
        return self.absorption.shape[-1]


# ---------------------------------------------------------------------------
# Primitive sets
# ---------------------------------------------------------------------------


@pytree_dataclass
class Spheres:
    """Reference: ColliderSphereStruct.cs (Center, Radius, material, target)."""

    center: Array  # [N, 3]
    radius: Array  # [N]
    material: Materials  # [N]
    target_id: Array  # [N] int32, -1 = none
    active: Array  # [N] bool; padding support

    @staticmethod
    def empty(dtype=jnp.float32) -> "Spheres":
        return Spheres.build(np.zeros((0, 3)), np.zeros((0,)), dtype=dtype)

    @staticmethod
    def build(center, radius, material=None, target_id=None, active=None,
              dtype=jnp.float32) -> "Spheres":
        center = jnp.asarray(center, dtype).reshape(-1, 3)
        n = center.shape[0]
        radius = jnp.asarray(radius, dtype).reshape(n)
        if material is None:
            material = Materials.default(n, dtype)
        if target_id is None:
            target_id = jnp.full((n,), -1, jnp.int32)
        else:
            target_id = jnp.asarray(target_id, jnp.int32).reshape(n)
        if active is None:
            active = jnp.ones((n,), bool)
        else:
            active = jnp.asarray(active, bool).reshape(n)
        return Spheres(center, radius, material, target_id, active)

    @property
    def count(self) -> int:
        return self.center.shape[0]


@pytree_dataclass
class Aabbs:
    """Reference: ColliderAABBStruct.cs (Center, Size = half-extents)."""

    center: Array  # [N, 3]
    half_extents: Array  # [N, 3]
    material: Materials  # [N]
    target_id: Array  # [N] int32
    active: Array  # [N] bool

    @staticmethod
    def empty(dtype=jnp.float32) -> "Aabbs":
        return Aabbs.build(np.zeros((0, 3)), np.zeros((0, 3)), dtype=dtype)

    @staticmethod
    def build(center, half_extents, material=None, target_id=None, active=None,
              dtype=jnp.float32) -> "Aabbs":
        center = jnp.asarray(center, dtype).reshape(-1, 3)
        n = center.shape[0]
        half_extents = jnp.asarray(half_extents, dtype).reshape(n, 3)
        if material is None:
            material = Materials.default(n, dtype)
        if target_id is None:
            target_id = jnp.full((n,), -1, jnp.int32)
        else:
            target_id = jnp.asarray(target_id, jnp.int32).reshape(n)
        if active is None:
            active = jnp.ones((n,), bool)
        else:
            active = jnp.asarray(active, bool).reshape(n)
        return Aabbs(center, half_extents, material, target_id, active)

    @property
    def count(self) -> int:
        return self.center.shape[0]


@pytree_dataclass
class Obbs:
    """Reference: ColliderOBBStruct.cs. ``inv_rot`` is the inverse of the
    box orientation quaternion (xyzw), pre-inverted at bake time exactly as
    the reference stores it (AudioOBBCollider.cs:59)."""

    center: Array  # [N, 3]
    half_extents: Array  # [N, 3]
    inv_rot: Array  # [N, 4] quaternion xyzw (inverse of orientation)
    material: Materials  # [N]
    target_id: Array  # [N] int32
    active: Array  # [N] bool

    @staticmethod
    def empty(dtype=jnp.float32) -> "Obbs":
        return Obbs.build(
            np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 4)), dtype=dtype
        )

    @staticmethod
    def build(center, half_extents, inv_rot, material=None, target_id=None,
              active=None, dtype=jnp.float32) -> "Obbs":
        center = jnp.asarray(center, dtype).reshape(-1, 3)
        n = center.shape[0]
        half_extents = jnp.asarray(half_extents, dtype).reshape(n, 3)
        inv_rot = jnp.asarray(inv_rot, dtype).reshape(n, 4)
        if material is None:
            material = Materials.default(n, dtype)
        if target_id is None:
            target_id = jnp.full((n,), -1, jnp.int32)
        else:
            target_id = jnp.asarray(target_id, jnp.int32).reshape(n)
        if active is None:
            active = jnp.ones((n,), bool)
        else:
            active = jnp.asarray(active, bool).reshape(n)
        return Obbs(center, half_extents, inv_rot, material, target_id, active)

    @property
    def count(self) -> int:
        return self.center.shape[0]


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------


@pytree_dataclass
class Scene:
    """The full static-shape scene: primitives + audio target positions.

    Replaces the reference's registry layer (AudioColliderManager /
    AudioTargetManager NativeJobBatch arrays) with a single immutable pytree.
    """

    spheres: Spheres
    aabbs: Aabbs
    obbs: Obbs
    target_positions: Array  # [T, 3]

    @property
    def num_targets(self) -> int:
        return self.target_positions.shape[0]

    @property
    def num_primitives(self) -> int:
        return self.spheres.count + self.aabbs.count + self.obbs.count

    @staticmethod
    def build(spheres=None, aabbs=None, obbs=None, target_positions=None,
              dtype=jnp.float32) -> "Scene":
        if spheres is None:
            spheres = Spheres.empty(dtype)
        if aabbs is None:
            aabbs = Aabbs.empty(dtype)
        if obbs is None:
            obbs = Obbs.empty(dtype)
        if target_positions is None:
            target_positions = jnp.zeros((0, 3), dtype)
        else:
            target_positions = jnp.asarray(target_positions, dtype).reshape(-1, 3)
        return Scene(spheres, aabbs, obbs, target_positions)

    def replace(self, **kwargs) -> "Scene":
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Static trace configuration (hashable; closed over at jit time).

    Mirrors the orchestrator's inspector fields, defaults from the demo
    Player.prefab (Audio/AudioRayTracer.cs:9-35; SURVEY.md section 2.6).

    ``num_accum_batches`` is the analog of the reference's thread-batch
    count (AudioRaytracingManager.ToUseThreadCount): muffle / permeation
    accumulators are kept per-batch and reduced afterwards, and the
    reference's per-batch permeation overwrite quirk (see
    ops/permeation.py) depends on it.
    """

    ray_count: int = 500
    max_bounces: int = 4
    max_ray_life: float = 125.0
    max_muffle_hit_distance: float = 250.0
    muffle_effectiveness: float = 1.0
    permeation_effectiveness: float = 0.5
    permeation_strength_per_ray: float = 1.0
    max_reverb_distance: float = 35.0
    num_accum_batches: int = 1
    # Numerics: the reference's EPSILON hit-point offset
    # (AudioRaytracerJobBatched.cs:57).
    epsilon: float = 1e-4
    # Compute dtype for the hot kernels (storage/compute precision knob;
    # the reference uses half storage + float compute).
    compute_dtype: str = "float32"
    # Reverb impulse-response accumulation (BASELINE config 3): number of
    # arrival-time bins (0 = disabled) and the echo-distance window the
    # bins span (converted to delay via ops.reverb.SPEED_OF_SOUND;
    # default = the reference's maxRayLife distance scale).
    num_reverb_bins: int = 0
    ir_max_distance: float = 125.0
    # Sort rays alive-first between bounces (a stable partition) so dead
    # lanes pool into ray blocks the kernel tier can skip outright — the
    # block analog of the reference's per-ray early exit
    # (AudioRaytracerJobBatched.cs:104). Results are identical (each
    # ray's math is per-lane; outputs are gathered back to original ray
    # order). Engaged by ops.trace (the inference path) on backends with
    # supports_block_skip; the differentiable loudness path
    # (models.differentiable.loudness_map) uses only the free dead-block
    # skip — no reorder: the backward of a permutation gather is a
    # scatter. Default OFF: the reorder moves the ray state every bounce,
    # which pays only when rays die fast (short max_ray_life /
    # absorptive scenes).
    compact_rays: bool = False
    # With compact_rays, additionally SKIP the per-bounce inverse
    # -permutation restore of the outputs: TraceResult.echo_distances
    # rows arrive permuted within each bounce column (and hit-order
    # -dependent debug fields are unavailable), but everything the
    # reduce/DSP stage consumes — muffle_hits, echo sums/zero counts,
    # the reverb IR histogram, first_hit_t (bounce 0 is never permuted:
    # all rays start alive, so its partition is the identity) — is
    # bit-identical: those are permutation-invariant reductions, exactly
    # like the reference's EchoRayDistances buffer that only ever feeds
    # ProcessAudioDataJob's sums (Jobs/ProcessAudioDataJob.cs:38-51).
    # Saves the restore gather + the inverse-permutation cumsums per
    # bounce. Ignored when collect_debug needs ordered rows.
    compact_unordered: bool = False

    @property
    def max_hits_per_ray(self) -> int:
        # Reference: MaxHitsPerRay => maxBounces + 1 (AudioRayTracer.cs:16).
        return self.max_bounces + 1

    @property
    def compute_jnp_dtype(self):
        """compute_dtype resolved to a jnp dtype for the kernel tier."""
        import jax.numpy as jnp

        return {"float32": jnp.float32,
                "bfloat16": jnp.bfloat16}[self.compute_dtype]


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@pytree_dataclass
class TraceResult:
    """Raw kernel outputs, pre-reduce.

    ``echo_distances``  [R, H]  — distance x material.Echo per (ray, hit slot)
                                  if the echo ray back to the listener is
                                  unoccluded, else 0
                                  (AudioRaytracerJobBatched.cs:121-147).
    ``muffle_hits``     [B, T]  — per-accum-batch visible-ray counts per
                                  target (AudioRaytracerJobBatched.cs:150-175).
    ``permeation``      [B, T]  — per-accum-batch permeation power remains
                                  (AudioPermeationJobBatched.cs:57-89).
    ``first_hit_t``     [R]     (optional) — primary-ray first-hit distance
                                  (+inf = miss), shared with the permeation
                                  job so it needs no second scene scan.
    ``reverb_ir``       [n_bins] (optional) — echo-energy impulse response
                                  over arrival-time bins (ops/reverb.py;
                                  cfg.num_reverb_bins > 0 enables it).
    ``hit_points``      [R, H, 3] (optional, debug) — bounce positions
                                  (editor-only RayHitResults analog).
    ``hit_counts``      [R]     (optional, debug) — bounces per ray.
    """

    echo_distances: Array
    muffle_hits: Array
    permeation: Array
    first_hit_t: Array | None = None
    reverb_ir: Array | None = None
    hit_points: Array | None = None
    hit_counts: Array | None = None


@pytree_dataclass
class TargetSettings:
    """The kernel -> DSP contract, one entry per audio target.

    Reference: DataTypes/AudioTargetRTSettings.cs — MuffleStrength,
    ReverbStrength, ReverbVolume in [0,1] + PercievedAudioPosition.
    Reverb stats are listener-global (scalar), muffle is per-target.
    """

    muffle: Array  # [T]
    reverb_strength: Array  # [] scalar
    reverb_volume: Array  # [] scalar
    perceived_position: Array  # [T, 3]
