"""The fused per-block render graph — the engine's "forward pass".

One jitted function replaces the reference's ~30 cooperating JACK clients
(SURVEY.md §2 "Distributed communication backend"): voice rendering
(SamplerSynthVoice), additive channel mixdown (the JACK port graph), the
passthrough strip fabric (JackPassthrough), and metering (AudioLevels scans)
all execute as one XLA program per audio block.

Dataflow:
    sound_data [N,2] HBM  ─┐
    VoiceProgram [V,...]  ─┼─> render_voices ─> lane mix [12,B,2] ─> Σ master
    StripParams [11,...]  ─┘        │                  │
                              voice_peaks [V]    channel strips 1..10
                                                 global strip on master
                                                 peaks (free reductions)

Everything is static-shaped: voice count, block size and strip count are
compile-time constants; per-block variation is carried entirely in array
*values* (active masks, segment tables), so the graph compiles once.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

from ..constants import DEFAULT_BLOCK_FRAMES
from ..ops import meters as meter_ops
from ..ops import mixer as mixer_ops
from ..ops import voice as voice_ops

NUM_STRIPS = 11  # GlobalPlayback + FXPassthrough-Channel1..10 (MidiRouter.cpp:876-883)
# Lane layout reminder (constants.channel_to_lane): 0 = global uneffected,
# 1 = global effected, 2..11 = sketchpad channels 1..10.
FIRST_CHANNEL_LANE = 2


class RenderOutputs(NamedTuple):
    master: Any        # [B, 2] final mix (global strip dry output)
    lane_mix: Any      # [12, B, 2] raw per-sampler-channel sums
    strip_dry: Any     # [11, B, 2] strip dry sends (0=global, 1..10=channels)
    strip_wet1: Any    # [11, B, 2]
    strip_wet2: Any    # [11, B, 2]
    lane_peaks: Any    # [12, 2] per-lane abs peaks
    lane_rms: Any      # [12, 2] per-lane RMS
    master_peak: Any   # [2]
    voice_peaks: Any   # [V] reference peak metric: max(l+r, 0)


def finish_block(xp, lane_mix, strips, voice_peaks) -> RenderOutputs:
    """Everything downstream of the additive lane mixdown: strips, master,
    meters. Shared by the single-device path and the shard_map path (where
    lane_mix arrives as a psum over voice shards)."""
    master_raw = lane_mix.sum(axis=0)  # the JACK system:playback additive sum

    # Channel strips act on sketchpad-channel lanes 2..11; the global strip
    # acts on the summed master. Stack them so one op applies all 11.
    strip_in = xp.concatenate(
        [master_raw[None], lane_mix[FIRST_CHANNEL_LANE:]], axis=0
    )
    dry, wet1, wet2 = mixer_ops.apply_strips(xp, strip_in, strips)
    master = dry[0]

    lane_peaks = meter_ops.block_peaks(xp, lane_mix)
    lane_rms = meter_ops.block_rms(xp, lane_mix)
    master_peak = meter_ops.block_peaks(xp, master)
    return RenderOutputs(
        master=master,
        lane_mix=lane_mix,
        strip_dry=dry,
        strip_wet1=wet1,
        strip_wet2=wet2,
        lane_peaks=lane_peaks,
        lane_rms=lane_rms,
        master_peak=master_peak,
        voice_peaks=voice_peaks,
    )


def render_block_math(
    xp,
    sound_data,
    prog: voice_ops.VoiceProgram,
    strips: mixer_ops.StripParams,
    block_frames: int,
    quirk_gain: bool = False,
) -> RenderOutputs:
    """Backend-generic render math (numpy golden mirror + jax device path)."""
    lane_mix, voice_peaks = voice_ops.render_voices(
        xp, sound_data, prog, block_frames, quirk_gain=quirk_gain,
    )
    return finish_block(xp, lane_mix, strips, voice_peaks)


def _pad_voice_peaks(outs, pad_voices_to: int, v_in: int):
    """Pad voice_peaks [v_in] -> [pad_voices_to] inside the jit (bucketed
    prefix dispatch; shared by every jitted wrapper so the padding rule
    cannot drift). Accepts one RenderOutputs or a tuple of them."""
    import jax.numpy as jnp

    if pad_voices_to <= v_in:
        return outs
    pad = pad_voices_to - v_in
    if isinstance(outs, RenderOutputs):  # NamedTuple: check BEFORE tuple
        return outs._replace(voice_peaks=jnp.pad(outs.voice_peaks, (0, pad)))
    return tuple(
        o._replace(voice_peaks=jnp.pad(o.voice_peaks, (0, pad)))
        for o in outs
    )


@functools.partial(
    __import__("jax").jit,
    static_argnames=("block_frames", "quirk_gain", "pad_voices_to"),
)
def render_block_packed(
    sound_data,
    prog_ints,
    prog_floats,
    strips_packed,
    block_frames: int = DEFAULT_BLOCK_FRAMES,
    quirk_gain: bool = False,
    pad_voices_to: int = 0,
) -> RenderOutputs:
    """Packed-argument variant: exactly three host->device buffers per block
    (program ints, program floats, strip params) — the hot dispatch path.

    `pad_voices_to` (static): bucketed prefix dispatch (engine
    voice_buckets) renders a pool prefix but consumers expect voice_peaks
    at the full pool size; padding INSIDE the jit keeps the output shape
    stable without an eager per-block concatenate on the host (one more
    dispatch per block)."""
    import jax.numpy as jnp

    prog = voice_ops.unpack_program(prog_ints, prog_floats)
    strips = voice_ops.unpack_strips(strips_packed)
    out = render_block_math(
        jnp, sound_data, prog, strips, block_frames, quirk_gain=quirk_gain,
    )
    return _pad_voice_peaks(out, pad_voices_to, prog_ints.shape[0])


def render_horizon_math(
    xp,
    sound_data,
    progs,                      # sequence of `slices` VoicePrograms
    strips: mixer_ops.StripParams,
    block_frames: int,
    quirk_gain: bool = False,
) -> tuple:
    """Render a lookahead horizon of consecutive blocks, one per program.

    Each slice runs the SAME per-block math as render_block_math on that
    slice's own program, so a committed schedule's horizon output equals
    per-block dispatch (bit for bit on the CPU backend, to float32
    rounding on the GPU, where the graphs fuse differently) — the host
    builds the H programs
    by simulating its per-block advance (engine._start_horizon), instead
    of a single window-wide program whose in-window f32 position/envelope
    extrapolation would only be ~1e-5-close. ONE upload + ONE dispatch per
    horizon amortizes the fixed per-dispatch cost H-fold, and total device
    work is the same."""
    return tuple(
        render_block_math(
            xp, sound_data, prog, strips, block_frames,
            quirk_gain=quirk_gain,
        )
        for prog in progs
    )


@functools.partial(
    __import__("jax").jit,
    static_argnames=("block_frames", "slices", "quirk_gain", "pad_voices_to"),
)
def render_horizon_fused(
    sound_data,
    prog_stack,
    strips_packed,
    block_frames: int,
    slices: int,
    quirk_gain: bool = False,
    pad_voices_to: int = 0,
) -> tuple:
    """Stacked-program horizon render: `prog_stack` is `slices` fused
    per-block programs (ops/voice.fuse_packed) concatenated on axis 1 —
    [V, slices*K]. NOT the engine's hot path: the full stack is ~4.5x the
    bytes of the compact form, so the engine dispatches
    render_horizon_onebuf below. Kept as the
    explicit-program oracle for differential tests and probes (compact
    output must equal stacked output bit for bit)."""
    import jax.numpy as jnp

    K = prog_stack.shape[1] // slices
    strips = voice_ops.unpack_strips(strips_packed)
    progs = []
    for h in range(slices):
        pi, pf = voice_ops.split_fused(prog_stack[:, h * K:(h + 1) * K])
        progs.append(voice_ops.unpack_program(pi, pf))
    outs = render_horizon_math(
        jnp, sound_data, progs, strips, block_frames,
        quirk_gain=quirk_gain,
    )
    return _pad_voice_peaks(outs, pad_voices_to, prog_stack.shape[0])


@functools.partial(
    __import__("jax").jit,
    static_argnames=("block_frames", "slices", "quirk_gain", "pad_voices_to"),
)
def render_horizon_compact(
    sound_data,
    base_fused,
    dyn,
    strips_packed,
    block_frames: int,
    slices: int,
    quirk_gain: bool = False,
    pad_voices_to: int = 0,
) -> tuple:
    """The hot horizon dispatch: ONE upload of (base program [V, K] +
    compact dynamics [V, 1+(H-1)*D]) + ONE dispatch produce `slices`
    blocks of outputs, bit-identical to render_horizon_fused on the full
    stacked programs (ops/voice.pack_horizon_dynamics extracts the host's
    own per-block values; unpack_horizon_slice re-materializes each
    slice's program inside the jit where the bit-twiddling is free).

    This replaces the full [V, H*K] stack on the live path: the compact
    form is ~4.5x fewer bytes to upload per horizon."""
    import jax.numpy as jnp

    return _horizon_compact_outs(
        jnp, sound_data, base_fused, dyn, strips_packed, block_frames,
        slices, quirk_gain, pad_voices_to,
    )


def _horizon_compact_outs(jnp, sound_data, base_fused, dyn, strips_packed,
                          block_frames, slices, quirk_gain, pad_voices_to):
    progs = voice_ops.horizon_programs(
        jnp, base_fused, dyn, slices, block_frames
    )
    strips = voice_ops.unpack_strips(strips_packed)
    outs = render_horizon_math(
        jnp, sound_data, progs, strips, block_frames,
        quirk_gain=quirk_gain,
    )
    return _pad_voice_peaks(outs, pad_voices_to, base_fused.shape[0])


@functools.partial(
    __import__("jax").jit,
    static_argnames=("block_frames", "slices", "base_cols", "quirk_gain",
                     "pad_voices_to"),
)
def render_horizon_onebuf(
    sound_data,
    hz_fused,
    strips_packed,
    block_frames: int,
    slices: int,
    base_cols: int,
    quirk_gain: bool = False,
    pad_voices_to: int = 0,
) -> tuple:
    """render_horizon_compact with base program and compact dynamics
    CONCATENATED into one int32 buffer [V, base_cols + 1+(H-1)*D]
    (ops/voice.fused_cols gives the split point).

    This is what the engine dispatches: shipping ONE buffer instead of
    (base, dyn) saves one transfer's fixed cost every horizon. The split is a free slice inside the jit; outputs are
    bit-identical to render_horizon_compact on the pair."""
    import jax.numpy as jnp

    return _horizon_compact_outs(
        jnp, sound_data, hz_fused[:, :base_cols], hz_fused[:, base_cols:],
        strips_packed, block_frames, slices, quirk_gain, pad_voices_to,
    )


@functools.partial(
    __import__("jax").jit,
    static_argnames=("block_frames", "quirk_gain", "pad_voices_to"),
)
def render_block_fused(
    sound_data,
    prog_fused,
    strips_packed,
    block_frames: int = DEFAULT_BLOCK_FRAMES,
    quirk_gain: bool = False,
    pad_voices_to: int = 0,
) -> RenderOutputs:
    """Single-buffer variant of render_block_packed: the program pair
    arrives as ONE int32 matrix (ops/voice.fuse_packed), so the live path
    pays one transfer's fixed cost per block — the split/bitcast is free
    inside the jit."""
    import jax.numpy as jnp

    prog_ints, prog_floats = voice_ops.split_fused(prog_fused)
    prog = voice_ops.unpack_program(prog_ints, prog_floats)
    strips = voice_ops.unpack_strips(strips_packed)
    out = render_block_math(
        jnp, sound_data, prog, strips, block_frames, quirk_gain=quirk_gain,
    )
    return _pad_voice_peaks(out, pad_voices_to, prog_fused.shape[0])
