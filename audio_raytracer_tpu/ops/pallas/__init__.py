from audio_raytracer_tpu.ops.pallas.backend import PallasBackend

__all__ = ["PallasBackend"]
