"""Per-source DSP chain: muffle low-pass -> reverb dry-boost -> binaural.

Functional JAX re-design of the reference audio-thread chain
(Audio/AudioTarget/AudioSpatializer.cs:70-87, MuffleDSP.cs, ReverbDSP.cs,
BinauralDSP.cs). Each one-pole IIR is a *linear recurrence*
y_i = a*y_{i-1} + b_i, evaluated with ``jax.lax.associative_scan`` —
log-depth on the device instead of a sample-serial loop — and the filter
state threads across buffers exactly like the C# structs' fields.

Semantics replicated:
- Muffle LP: cutoff = lerp(cutoff_MAX, cutoff_MIN, curve(muffleStrength)),
  applied only when muffleStrength > 0 (MuffleDSP.cs:13-45).
- Reverb: dry-boost gain = lerp(min, max, curve(reverbVolume))
  (ReverbDSP.cs:10-24); the Unity AudioReverbFilter dryLevel mapping
  (AudioSpatializer.cs:58) is exposed as ``reverb_dry_level``.
- Binaural: equal-power pan from azimuth (optionally distance-scaled),
  rear attenuation, elevation volume, then below-horizon LP or
  above-horizon HP with distance-scaled cutoffs (BinauralDSP.cs:15-105).
  Per the reference, only the active branch's filter state advances.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from audio_raytracer_tpu.tree import pytree_dataclass, static_field
from audio_raytracer_tpu.types import TargetSettings
from audio_raytracer_tpu.utils.curves import SampledCurve

Array = jnp.ndarray

TWO_PI = 2.0 * jnp.pi


@pytree_dataclass
class MinMax:
    min: Array
    max: Array

    @staticmethod
    def of(lo, hi):
        return MinMax(jnp.asarray(lo, jnp.float32),
                      jnp.asarray(hi, jnp.float32))

    def lerp(self, t):
        return self.min + (self.max - self.min) * t


@pytree_dataclass
class SpatializerSettings:
    """All DSP tunables (DataTypes/AudioSpatializerSettings.cs:4-44)."""

    pan_strength: Array
    rear_attenuation_strength: Array
    # Static (jit-specializing) toggles, mirroring the serialized bools.
    distance_based_panning: bool = static_field(default=True)
    max_pan_distance: Array = None
    distance_based_rear_attenuation: bool = static_field(default=True)
    max_rear_attenuation_distance: Array = None
    max_elevation_effect_distance: Array = None
    low_pass_cutoff: MinMax = None
    low_pass_volume: Array = None
    high_pass_cutoff: MinMax = None
    high_pass_volume: Array = None
    muffle_curve: SampledCurve = None
    muffle_cutoff: MinMax = None
    reverb_dry_level: MinMax = None
    reverb_strength_curve: SampledCurve = None
    reverb_dry_boost: MinMax = None
    reverb_volume_curve: SampledCurve = None
    # --- IR-driven reverb tail (this framework's upgrade of the
    # reference's delegation to Unity's AudioReverbFilter:
    # Audio/AudioTarget/ReverbDSP.cs:10-24 only computes a dry boost and
    # AudioSpatializer.cs:58 maps ReverbStrength onto the filter's
    # dryLevel — the audible tail lives inside the engine's black-box
    # reverb unit. Here the tracer already produces a physical impulse
    # response (ops/reverb.py), so the tail is rendered by convolving
    # the source with that IR — audible, scene-driven, and honest.) ---
    render_reverb_tail: bool = static_field(default=False)
    # Wet level = reverb_wet_level.lerp(strength_curve(reverb_strength)):
    # the tail analog of the dryLevel mapping (AudioSpatializer.cs:58).
    reverb_wet_level: MinMax = None
    # Echo-distance window the IR bins span (must match the tracer's
    # TraceConfig.ir_max_distance so bin -> arrival-time mapping agrees).
    reverb_ir_max_distance: Array = None

    @staticmethod
    def default() -> "SpatializerSettings":
        """The shipped Default asset values
        (AudioSpatializerSettings.Default, cs:47-73)."""
        f = lambda v: jnp.asarray(v, jnp.float32)
        return SpatializerSettings(
            pan_strength=f(0.8),
            rear_attenuation_strength=f(0.2),
            distance_based_panning=True,
            max_pan_distance=f(5.0),
            distance_based_rear_attenuation=True,
            max_rear_attenuation_distance=f(15.0),
            max_elevation_effect_distance=f(12.0),
            low_pass_cutoff=MinMax.of(5000.0, 22000.0),
            low_pass_volume=f(0.85),
            high_pass_cutoff=MinMax.of(25.0, 150.0),
            high_pass_volume=f(1.15),
            muffle_curve=SampledCurve.linear(),
            muffle_cutoff=MinMax.of(75.0, 8000.0),
            reverb_dry_level=MinMax.of(0.0, -2000.0),
            reverb_strength_curve=SampledCurve.linear(),
            reverb_dry_boost=MinMax.of(1.0, 3.0),
            reverb_volume_curve=SampledCurve.linear(),
            reverb_wet_level=MinMax.of(0.0, 0.5),
            reverb_ir_max_distance=f(125.0),
        )


@pytree_dataclass
class DSPState:
    """Per-source filter memories (the C# struct fields), stereo pairs.

    ``reverb_tail`` is the overlap-add carry of the IR convolution
    stage: the last L-1 convolved samples that extend past the current
    buffer ([L-1, 2]; None when the tail stage is off). Size it with
    ``DSPState.zero(tail_len=ir_kernel_length(...) - 1)``.
    """

    muffle_prev: Array  # [2]
    lp_prev: Array  # [2]
    hp_prev_out: Array  # [2]
    hp_prev_in: Array  # [2]
    reverb_tail: Array | None = None  # [L-1, 2]

    @staticmethod
    def zero(tail_len: int | None = None) -> "DSPState":
        z = jnp.zeros((2,), jnp.float32)
        # tail_len == 0 is a valid 1-tap FIR (L = 1): keep the [0, 2]
        # carry so the tail stage still runs; only None disables it.
        tail = (jnp.zeros((tail_len, 2), jnp.float32)
                if tail_len is not None else None)
        return DSPState(z, z, z, z, tail)


def _one_pole_lp(x: Array, prev: Array, alpha: Array):
    """y_i = y_{i-1} + alpha (x_i - y_{i-1}) over axis 0 via associative
    scan on the affine maps y -> (1-alpha) y + alpha x_i.
    x: [N, 2], prev: [2]. Returns (y [N, 2], new_prev [2])."""
    a = jnp.broadcast_to(1.0 - alpha, x.shape)
    b = alpha * x
    # Fold the initial state into the first input.
    b = b.at[0].add(a[0] * prev)

    def combine(l, r):
        return (l[0] * r[0], r[0] * l[1] + r[1])

    _, y = jax.lax.associative_scan(combine, (a, b), axis=0)
    return y, y[-1]


def _one_pole_hp(x: Array, prev_out: Array, prev_in: Array, alpha: Array):
    """y_i = alpha (y_{i-1} + x_i - x_{i-1}) (BinauralDSP.cs:97-105)."""
    x_prev = jnp.concatenate([prev_in[None, :], x[:-1]], axis=0)
    a = jnp.broadcast_to(alpha, x.shape)
    b = alpha * (x - x_prev)
    b = b.at[0].add(a[0] * prev_out)

    def combine(l, r):
        return (l[0] * r[0], r[0] * l[1] + r[1])

    _, y = jax.lax.associative_scan(combine, (a, b), axis=0)
    return y, y[-1], x[-1]


def ir_kernel_length(num_bins: int, ir_max_distance: float,
                     sample_rate: float) -> int:
    """FIR length L covering the last IR bin's center arrival time.

    Static (Python ints) so buffer/tail shapes stay jit-stable."""
    from audio_raytracer_tpu.ops.reverb import SPEED_OF_SOUND

    width = ir_max_distance / SPEED_OF_SOUND / num_bins
    return int(round((num_bins - 0.5) * width * sample_rate)) + 1


def ir_to_fir(reverb_ir: Array, ir_max_distance, sample_rate,
              length: int) -> Array:
    """[L] amplitude-domain FIR from the tracer's energy IR histogram
    (ops/reverb.impulse_response): each bin's energy becomes a sqrt
    -amplitude tap at its center arrival time, and the whole FIR is
    normalized to unit energy (sum h^2 = 1, guarding empty IRs) so the
    wet level is controlled solely by the settings gain."""
    from audio_raytracer_tpu.ops.reverb import SPEED_OF_SOUND

    n = reverb_ir.shape[0]
    width = ir_max_distance / SPEED_OF_SOUND / n
    times = (jnp.arange(n, dtype=jnp.float32) + 0.5) * width
    idx = jnp.clip(jnp.round(times * sample_rate).astype(jnp.int32),
                   0, length - 1)
    energy = jnp.maximum(reverb_ir.astype(jnp.float32), 0.0)
    amp = jnp.sqrt(energy)
    h = jnp.zeros((length,), jnp.float32).at[idx].add(amp)
    norm = jnp.sqrt(jnp.sum(h * h))
    return h / jnp.maximum(norm, 1e-12)


def convolve_tail(x: Array, h: Array, tail: Array):
    """Overlap-add FFT convolution of one stereo buffer with the IR FIR.

    x: [N, 2]; h: [L]; tail: [L-1, 2] carry from previous buffers.
    Returns (wet [N, 2], new_tail [L-1, 2]). Per-frame IR updates
    crossfade naturally: the carried tail was produced by the previous
    frame's FIR and decays out while new input convolves with the new
    one.
    """
    N = x.shape[0]
    L = h.shape[0]
    M = N + L - 1
    nfft = 1 << (M - 1).bit_length()
    X = jnp.fft.rfft(x, n=nfft, axis=0)
    H = jnp.fft.rfft(h, n=nfft)[:, None]
    y = jnp.fft.irfft(X * H, n=nfft, axis=0)[:M]
    y = y.at[: L - 1].add(tail)
    return y[:N], y[N:]


def _alpha_lp(cutoff, sample_rate):
    rc = 1.0 / (cutoff * TWO_PI)
    dt = 1.0 / sample_rate
    return dt / (rc + dt)


def _alpha_hp(cutoff, sample_rate):
    rc = 1.0 / (cutoff * TWO_PI)
    dt = 1.0 / sample_rate
    return rc / (rc + dt)


def spatialize(buffer: Array, state: DSPState,
               settings: SpatializerSettings, rt: TargetSettings,
               target_index: int | Array, local_dir: Array, distance: Array,
               sample_rate: float, volume_multiplier: float = 1.0,
               reverb_ir: Array | None = None):
    """Process one stereo buffer [N, 2] for one audio target.

    rt: TargetSettings from the tracer (muffle per target, reverb global).
    local_dir: [3] listener-local unit direction to the source.
    reverb_ir: optional [n_bins] impulse-response histogram from the
    tracer (TraceResult.reverb_ir); with
    ``settings.render_reverb_tail`` and a tail-carrying state
    (DSPState.zero(tail_len=...)), an audible convolution tail is mixed
    in after the binaural stage.
    Returns (out [N, 2], new_state, reverb_dry_level scalar).
    """
    muffle_strength = rt.muffle[target_index]
    saturate = lambda v: jnp.clip(v, 0.0, 1.0)

    # --- Muffle LP (MuffleDSP.cs) ---
    m = settings.muffle_curve.evaluate(muffle_strength)
    muffle_cutoff = settings.muffle_cutoff.max + (
        settings.muffle_cutoff.min - settings.muffle_cutoff.max) * m
    alpha_m = _alpha_lp(muffle_cutoff, sample_rate)
    filtered, new_muffle_prev = _one_pole_lp(buffer, state.muffle_prev,
                                             alpha_m)
    apply_muffle = muffle_strength > 0.0
    x = jnp.where(apply_muffle, filtered, buffer)
    new_muffle_prev = jnp.where(apply_muffle, new_muffle_prev,
                                state.muffle_prev)

    # --- Reverb dry boost (ReverbDSP.cs) ---
    t = settings.reverb_volume_curve.evaluate(rt.reverb_volume)
    dry_boost = settings.reverb_dry_boost.lerp(t)
    x = x * dry_boost

    # --- Binaural (BinauralDSP.cs) ---
    azimuth = jnp.arctan2(local_dir[0], local_dir[2])
    pan_strength = settings.pan_strength
    if settings.distance_based_panning:
        pan_strength = pan_strength * saturate(
            distance / settings.max_pan_distance)
    pan = jnp.sin(azimuth) * pan_strength
    left_gain = jnp.sqrt(0.5 * (1.0 - pan))
    right_gain = jnp.sqrt(0.5 * (1.0 + pan))

    front = jnp.maximum(0.0, jnp.cos(azimuth))
    rear_floor = 1.0 - settings.rear_attenuation_strength
    rear = rear_floor + (1.0 - rear_floor) * front
    if settings.distance_based_rear_attenuation:
        dist_factor = saturate(
            1.0 - distance / settings.max_rear_attenuation_distance)
        rear = jnp.clip(rear * dist_factor, rear_floor, 1.0)

    y = local_dir[1]
    below = y <= 0.0
    elev_vol = jnp.where(
        below,
        1.0 + (settings.low_pass_volume - 1.0) * saturate(-y),
        1.0 + (settings.high_pass_volume - 1.0) * saturate(y))

    gains = jnp.stack([left_gain, right_gain]) * rear * elev_vol
    x = x * gains[None, :]

    dist_elev = saturate(distance / settings.max_elevation_effect_distance)
    lp_cutoff = settings.low_pass_cutoff.lerp(saturate(-y)) * (
        1.0 - 0.5 * dist_elev)
    hp_cutoff = settings.high_pass_cutoff.lerp(saturate(y)) * (
        1.0 + 0.5 * dist_elev)

    lp_out, lp_prev = _one_pole_lp(x, state.lp_prev,
                                   _alpha_lp(lp_cutoff, sample_rate))
    hp_out, hp_prev_out, hp_prev_in = _one_pole_hp(
        x, state.hp_prev_out, state.hp_prev_in,
        _alpha_hp(hp_cutoff, sample_rate))

    x = jnp.where(below, lp_out, hp_out)
    new_state = DSPState(
        muffle_prev=new_muffle_prev,
        lp_prev=jnp.where(below, lp_prev, state.lp_prev),
        hp_prev_out=jnp.where(below, state.hp_prev_out, hp_prev_out),
        hp_prev_in=jnp.where(below, state.hp_prev_in, hp_prev_in),
        # Carry the tail even when the tail stage doesn't run this call
        # (e.g. no IR harvested yet): dropping it would truncate ringing
        # audio AND permanently disable the stage (None thereafter),
        # besides changing the state pytree structure under jit.
        reverb_tail=state.reverb_tail,
    )

    # --- Final volume (AudioSpatializer.cs:79-86) ---
    x = x * volume_multiplier

    # --- IR-driven reverb tail (replaces the reference's black-box
    # AudioReverbFilter; see SpatializerSettings.render_reverb_tail) ---
    if (settings.render_reverb_tail and reverb_ir is not None
            and state.reverb_tail is not None):
        L = state.reverb_tail.shape[0] + 1
        h = ir_to_fir(reverb_ir, settings.reverb_ir_max_distance,
                      sample_rate, L)
        wet_gain = settings.reverb_wet_level.lerp(
            settings.reverb_strength_curve.evaluate(rt.reverb_strength))
        # Gain is folded into the FIR so the carried tail is already
        # scaled (adding it raw next frame would double-apply the gain).
        wet, new_tail = convolve_tail(x, wet_gain * h, state.reverb_tail)
        x = x + wet
        new_state = dataclasses.replace(new_state, reverb_tail=new_tail)

    # Unity AudioReverbFilter dryLevel mapping (AudioSpatializer.cs:58).
    dry_level = settings.reverb_dry_level.lerp(rt.reverb_strength)
    return x, new_state, dry_level
