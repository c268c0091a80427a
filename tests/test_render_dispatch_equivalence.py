"""The two jitted dispatch surfaces must render bit-identically.

`render_block_fused` (one int32 buffer; the production live path) and
`render_block_packed` (the two-buffer variant) share `render_block_math`;
what differs is the packing/bitcast plumbing around it. A drift between
them would silently invalidate any comparison of the two, so pin
bit-equality — including the
in-jit voice_peaks padding used by the bucketed prefix dispatch.

Reference analog: the single per-sample render loop the two paths both
stand in for (SamplerSynthVoice.cpp:174-270).
"""

import numpy as np

from libzl_tpu.engine import render as render_mod
from libzl_tpu.engine.voicestate import VoicePool
from libzl_tpu.ops import mixer as mixer_ops
from libzl_tpu.ops import voice as voice_ops

SR = 48000.0
BLOCK = 128


def _workload(num_voices=32, sound_frames=1 << 13):
    pool = VoicePool(num_voices, BLOCK, SR)
    rng = np.random.default_rng(11)
    t = np.arange(sound_frames) / SR
    sound = np.stack(
        [0.5 * np.sin(2 * np.pi * 220 * t), 0.5 * np.sin(2 * np.pi * 330 * t)],
        axis=0,
    ).astype(np.float32)
    for v in range(num_voices // 2):
        pool.note_on(
            v, clip_id=v % 4, midi_note=int(rng.integers(48, 73)),
            midi_channel=v % 10, lane=2 + v % 10, base=0,
            length=sound_frames, source_rate=SR, root_note=60,
            start_sec=0.0, stop_sec=sound_frames / SR,
            gain=float(rng.uniform(0.2, 1.0)), clip_volume=0.8,
            pan=float(rng.uniform(-1, 1)), attack=0.005, decay=0.05,
            sustain=0.7, release=0.05, looping=bool(v % 2),
            length_beats=1.0 + 0.25 * (v % 3), start_tick=0,
        )
    prog = pool.build_program(
        block_start_sample=0.0, tick_anchor_sample=0.0,
        tick_anchor=0, samples_per_tick=250.0,
    )
    strips = mixer_ops.default_strip_params(11)
    return sound, prog, strips


def test_fused_and_packed_dispatch_bit_identical():
    sound, prog, strips = _workload()
    prog_i, prog_f = voice_ops.pack_program(prog)
    strips_packed = voice_ops.pack_strips(strips)
    fused = voice_ops.fuse_packed(prog_i, prog_f)

    out_packed = render_mod.render_block_packed(
        sound, prog_i, prog_f, strips_packed, block_frames=BLOCK,
        pad_voices_to=48,
    )
    out_fused = render_mod.render_block_fused(
        sound, fused, strips_packed, block_frames=BLOCK, pad_voices_to=48,
    )

    assert out_packed._fields == out_fused._fields
    for name, a, b in zip(out_packed._fields, out_packed, out_fused):
        a = np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the in-jit pad took effect on both
    assert np.asarray(out_fused.voice_peaks).shape == (48,)
    assert not np.asarray(out_fused.voice_peaks[:32]).max() == 0.0


def test_fuse_split_roundtrip_exact():
    """fuse_packed/split_fused must round-trip f32 columns bit-exactly
    (the fused buffer bit-casts them through int32)."""
    _, prog, _ = _workload(num_voices=8)
    prog_i, prog_f = voice_ops.pack_program(prog)
    # make the float block exercise signs, subnormal-ish and large values
    prog_f = prog_f.copy()
    prog_f[0, 0] = -0.0
    prog_f[-1, -1] = 3.4e38
    fused = voice_ops.fuse_packed(prog_i, prog_f)
    ints2, floats2 = voice_ops.split_fused(fused)
    np.testing.assert_array_equal(ints2, prog_i)
    assert floats2.dtype == np.float32
    np.testing.assert_array_equal(
        floats2.view(np.int32), prog_f.view(np.int32)
    )
