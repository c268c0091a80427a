"""Multi-device scaling: shard the voice axis over a device mesh.

The reference scales by handing each sampler channel its own JACK client so
the OS can schedule them in parallel (lib/SamplerSynth.cpp:88-114). The
equivalent here (SURVEY.md §2 "Distributed communication backend") shards
the *voice axis* of the render grid across devices with jax.sharding: every
device renders V/n voices, and the only cross-device traffic is the
per-lane mixdown contraction — a local one-hot [C,V] x [V,B*2] matmul +
psum (NCCL over NVLink on a multi-GPU host), the moral equivalent of JACK's
additive port mixing. The mesh is 1-D over jax.devices().

Sound memory is replicated (every device may need any sample); per-voice
program arrays are sharded; mixes/meters come back replicated; per-voice
peaks stay sharded.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import DEFAULT_BLOCK_FRAMES
from ..engine import render as render_mod
from ..ops import mixer as mixer_ops
from ..ops import voice as voice_ops

VOICE_AXIS = "voices"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh: asked for {n_devices} devices, only "
                f"{len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (VOICE_AXIS,))


def program_sharding(mesh: Mesh) -> voice_ops.VoiceProgram:
    """NamedShardings for each VoiceProgram leaf: sharded on the voice axis."""
    v = NamedSharding(mesh, P(VOICE_AXIS))
    vs = NamedSharding(mesh, P(VOICE_AXIS, None))
    from ..ops.adsr import AdsrProgram

    env = AdsrProgram(
        stage0=v, env0=v, a_rate=v, d_rate=v, sustain=v, rel_rate=v,
        inv_rel=v, rel_log2=v, release_frame=v, rel_mode=v,
    )
    return voice_ops.VoiceProgram(
        active=v, base=v, len_minus1=v,
        seg_start=vs, seg_pos_int=vs, seg_pos_frac=vs,
        rate_int=v, rate_frac=v, start_frame=v, stop_frame=v,
        gain=v, clip_volume=v, pan=v, lane=v,
        loop_period=v, bq_reset=vs, env=env,
    )


def make_sharded_render(
    mesh: Mesh,
    block_frames: int = DEFAULT_BLOCK_FRAMES,
    quirk_gain: bool = False,
):
    """A jitted render_block with the voice axis sharded over `mesh`.

    Outputs: mixes/meters replicated; voice_peaks sharded on the voice axis.
    """
    repl = NamedSharding(mesh, P())
    vshard = NamedSharding(mesh, P(VOICE_AXIS))

    prog_in = program_sharding(mesh)
    strips_in = mixer_ops.StripParams(
        dry=repl, wet1=repl, wet2=repl, pan=repl, muted=repl
    )
    out_shardings = render_mod.RenderOutputs(
        master=repl, lane_mix=repl, strip_dry=repl, strip_wet1=repl,
        strip_wet2=repl, lane_peaks=repl, lane_rms=repl, master_peak=repl,
        voice_peaks=vshard,
    )

    import jax.numpy as jnp

    def fn(sound_data, prog, strips):
        return render_mod.render_block_math(
            jnp, sound_data, prog, strips, block_frames, quirk_gain=quirk_gain
        )

    return jax.jit(
        fn,
        in_shardings=(repl, prog_in, strips_in),
        out_shardings=out_shardings,
    )


def make_shardmap_packed_render(
    mesh: Mesh,
    block_frames: int = DEFAULT_BLOCK_FRAMES,
    quirk_gain: bool = False,
):
    """shard_map variant of the packed render: each device renders its local
    voice shard (the same render_voices as single-device), the additive
    lane mixdown is an explicit psum, and the strip/meter tail runs
    replicated. Bit-equal to the unsharded engine because the per-lane
    reduction tree (local one-hot matmul, then psum over ordered shards) is
    mesh-invariant for these values (test_sharding.py asserts it)."""
    import jax.numpy as jnp
    from jax import shard_map

    def local_fn(sound_data, prog_fused, strips_packed):
        # ONE sharded program buffer per block (ops/voice.fuse_packed);
        # the split/bitcast runs per shard inside the jit
        prog_i, prog_f = voice_ops.split_fused(prog_fused)
        prog = voice_ops.unpack_program(prog_i, prog_f)
        strips = voice_ops.unpack_strips(strips_packed)
        lane_mix, voice_peaks = voice_ops.render_voices(
            jnp, sound_data, prog, block_frames,
            quirk_gain=quirk_gain,
        )
        lane_mix = jax.lax.psum(lane_mix, VOICE_AXIS)
        return render_mod.finish_block(jnp, lane_mix, strips, voice_peaks)

    Pv = P(VOICE_AXIS, None)
    out_specs = render_mod.RenderOutputs(
        master=P(), lane_mix=P(), strip_dry=P(), strip_wet1=P(),
        strip_wet2=P(), lane_peaks=P(), lane_rms=P(), master_peak=P(),
        voice_peaks=P(VOICE_AXIS),
    )
    fn = shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), Pv, P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(fn)


def make_shardmap_horizon_render(
    mesh: Mesh,
    block_frames: int = DEFAULT_BLOCK_FRAMES,
    slices: int = 16,
    quirk_gain: bool = False,
    base_cols: int = 0,
):
    """shard_map lookahead-horizon render: the compact horizon upload
    (base program [V, K] and dynamics [V, 1+(H-1)*D] concatenated into
    ONE voice-sharded buffer when `base_cols` > 0, mirroring the
    single-device render_horizon_onebuf — one host->device transfer per
    horizon) reconstructs each slice's per-block program locally per
    device, the additive lane mixdown of ALL slices rides ONE psum (a
    stacked [slices, C, B, 2] collective — per-horizon traffic, not
    per-block), and the strip/meter tail runs replicated per slice. Each
    slice's math is identical to the single-device horizon, so mesh output
    equals the unsharded engine's — the lookahead and the mesh compose
    instead of forking. base_cols=0 keeps the two-buffer (base, dyn)
    signature for oracle tests."""
    import jax.numpy as jnp
    from jax import shard_map

    def local_fn(sound_data, base_fused, dyn, strips_packed):
        strips = voice_ops.unpack_strips(strips_packed)
        progs = voice_ops.horizon_programs(
            jnp, base_fused, dyn, slices, block_frames
        )
        lane_mixes, peaks = [], []
        for prog in progs:
            lm, vp = voice_ops.render_voices(
                jnp, sound_data, prog, block_frames,
                quirk_gain=quirk_gain,
            )
            lane_mixes.append(lm)
            peaks.append(vp)
        mixes = jax.lax.psum(jnp.stack(lane_mixes), VOICE_AXIS)
        return tuple(
            render_mod.finish_block(jnp, mixes[h], strips, peaks[h])
            for h in range(slices)
        )

    def onebuf_fn(sound_data, hz_fused, strips_packed):
        return local_fn(sound_data, hz_fused[:, :base_cols],
                        hz_fused[:, base_cols:], strips_packed)

    Pv = P(VOICE_AXIS, None)
    out_one = render_mod.RenderOutputs(
        master=P(), lane_mix=P(), strip_dry=P(), strip_wet1=P(),
        strip_wet2=P(), lane_peaks=P(), lane_rms=P(), master_peak=P(),
        voice_peaks=P(VOICE_AXIS),
    )
    if base_cols:
        fn = shard_map(
            onebuf_fn, mesh=mesh,
            in_specs=(P(), Pv, P()),
            out_specs=tuple([out_one] * slices),
            check_vma=False,
        )
    else:
        fn = shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(), Pv, Pv, P()),
            out_specs=tuple([out_one] * slices),
            check_vma=False,
        )
    return jax.jit(fn)


def make_sharded_packed_render(
    mesh: Mesh,
    block_frames: int = DEFAULT_BLOCK_FRAMES,
    quirk_gain: bool = False,
):
    """Voice-sharded render over the engine's packed dispatch format
    (ops/voice.pack_program): program matrices shard on their voice axis,
    the sound bank and strips replicate, mixes/meters return replicated.
    This is what AudioEngine(mesh=...) dispatches each block."""
    repl = NamedSharding(mesh, P())
    vshard = NamedSharding(mesh, P(VOICE_AXIS, None))
    vvec = NamedSharding(mesh, P(VOICE_AXIS))
    out_shardings = render_mod.RenderOutputs(
        master=repl, lane_mix=repl, strip_dry=repl, strip_wet1=repl,
        strip_wet2=repl, lane_peaks=repl, lane_rms=repl, master_peak=repl,
        voice_peaks=vvec,
    )

    import jax.numpy as jnp

    def fn(sound_data, prog_i, prog_f, strips_packed):
        prog = voice_ops.unpack_program(prog_i, prog_f)
        strips = voice_ops.unpack_strips(strips_packed)
        return render_mod.render_block_math(
            jnp, sound_data, prog, strips, block_frames,
            quirk_gain=quirk_gain,
        )

    return jax.jit(
        fn,
        in_shardings=(repl, vshard, vshard, repl),
        out_shardings=out_shardings,
    )
