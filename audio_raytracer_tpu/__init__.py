"""audio_raytracer_tpu — a differentiable audio ray tracing framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
FirePixel8422/Audio-Raytracer (a Unity Burst/Jobs CPU audio ray tracer):

- batched ray-collider intersection over AABB / OBB / sphere primitives
  (reference: Assets/C# Scripts/Jobs/AudioRaytracerJobBatched.cs)
- multi-bounce reflection with material absorption draining ray life
- echo rays back to the listener driving reverb statistics
- muffle (occlusion) rays to registered audio targets
- through-wall permeation attenuation
  (reference: Assets/C# Scripts/Jobs/AudioPermeationJobBatched.cs)
- the reduce step producing per-target settings
  (reference: Assets/C# Scripts/Jobs/ProcessAudioDataJob.cs)
- a muffle/binaural/reverb DSP chain
  (reference: Assets/C# Scripts/Audio/AudioTarget/*.cs)

The compute path is pure-functional JAX (scene = arrays, kernels = pure
functions, bounce loop = lax.scan) with Pallas kernels (Triton route,
for NVIDIA GPUs) on the hot rays x primitives loops, sharded across
device meshes with shard_map and XLA collectives. See SURVEY.md for the full design rationale.
"""

from audio_raytracer_tpu.types import (
    Materials,
    Spheres,
    Aabbs,
    Obbs,
    Scene,
    TraceConfig,
    TargetSettings,
    TraceResult,
)
from audio_raytracer_tpu.ops.fibonacci import fibonacci_directions

__version__ = "0.4.0"

__all__ = [
    "Materials",
    "Spheres",
    "Aabbs",
    "Obbs",
    "Scene",
    "TraceConfig",
    "TargetSettings",
    "TraceResult",
    "fibonacci_directions",
]
