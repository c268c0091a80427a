"""Golden tests: block renderer vs the scalar per-frame oracle."""

import numpy as np
import pytest

from libzl_tpu.engine.voicestate import VoicePool, pitch_ratio
from libzl_tpu.ops.voice import render_voices

from _oracle import ScalarVoiceSim

SR = 48000.0
B = 128


def make_sound(frames=24000, freq=440.0, stereo_phase=0.0):
    t = np.arange(frames) / SR
    l = 0.5 * np.sin(2 * np.pi * freq * t)
    r = 0.5 * np.sin(2 * np.pi * freq * t + stereo_phase)
    return np.stack([l, r], axis=1).astype(np.float32)


def run_engine(pool, data, n_blocks, spt=250.0, quirk=False):
    planar = np.ascontiguousarray(data.T)
    out = []
    for b in range(n_blocks):
        prog = pool.build_program(
            block_start_sample=b * B,
            tick_anchor_sample=0.0,
            tick_anchor=0,
            samples_per_tick=spt,
        )
        mix, peaks, contrib = render_voices(
            np, planar, prog, B, quirk_gain=quirk, return_contrib=True
        )
        out.append(contrib[0])
        pool.advance(prog)
    return np.concatenate(out, axis=0)


def start_voice(pool, sound, *, midi_note=60, root=60, looping=False,
                length_beats=2.0, gain=1.0, clip_volume=0.8, pan=0.3,
                adsr=(0.0, 0.1, 1.0, 0.05), start_sec=0.0, stop_sec=None):
    frames = sound.shape[0]
    stop_sec = frames / SR if stop_sec is None else stop_sec
    pool.note_on(
        0,
        clip_id=1, midi_note=midi_note, midi_channel=0, lane=2,
        base=0, length=frames, source_rate=SR, root_note=root,
        start_sec=start_sec, stop_sec=stop_sec,
        gain=gain, clip_volume=clip_volume, pan=pan,
        attack=adsr[0], decay=adsr[1], sustain=adsr[2], release=adsr[3],
        looping=looping, length_beats=length_beats, start_tick=0,
    )


def make_oracle(pool, sound, *, looping=False, beat_quantized=False,
                spt=250.0, quirk=False, adsr=(0.0, 0.1, 1.0, 0.05)):
    v = 0
    ratio = float(pool.rate_int[v]) + float(pool.rate_frac[v])
    return ScalarVoiceSim(
        sound,
        ratio=ratio,
        istart=int(pool.istart[v]),
        stop=int(pool.stop[v]),
        gain=float(pool.gain[v]),
        clip_volume=float(pool.clip_volume[v]),
        pan=float(pool.pan[v]),
        adsr=adsr,
        source_rate=SR,
        looping=looping,
        beat_quantized=beat_quantized,
        loop_samples=float(pool.loop_len_ticks[v]) * spt,
        first_loop_sample=float(pool.next_loop_tick[v]) * spt,
        quirk_gain=quirk,
    )


@pytest.mark.parametrize("quirk", [False, True])
def test_oneshot_default_adsr(quirk):
    """Non-looping playback at unity rate: auto-release tail then hard stop."""
    sound = make_sound(frames=6000, stereo_phase=0.5)
    pool = VoicePool(4, B, SR)
    start_voice(pool, sound)
    got = run_engine(pool, sound, n_blocks=50, quirk=quirk)
    oracle = make_oracle(pool_copy := pool, sound, quirk=quirk)
    # re-init oracle position state from scratch (voice may be dead in pool)
    want = oracle.render(50 * B)
    np.testing.assert_allclose(got, want, atol=3e-4)
    # voice must be dead after the clip end
    assert not pool.active[0]


def test_pitched_positional_loop():
    """Looping at +7 semitones, non-integer beat length -> positional wraps."""
    sound = make_sound(frames=5000)
    pool = VoicePool(4, B, SR)
    start_voice(pool, sound, midi_note=67, looping=True, length_beats=1.3,
                stop_sec=4500 / SR)
    oracle = make_oracle(pool, sound, looping=True)
    got = run_engine(pool, sound, n_blocks=100)
    want = oracle.render(100 * B)
    np.testing.assert_allclose(got, want, atol=3e-4)
    assert pool.active[0]


def test_beat_quantized_loop():
    """Integer-beat loop wraps on the musical clock, not the sample count."""
    spt = 60.0 / (120 * 96) * SR  # 250 samples per tick at 120 bpm
    sound = make_sound(frames=30000)
    pool = VoicePool(4, B, SR)
    # 1 beat = 96 ticks = 24000 samples; clip shorter than its musical length
    # would leave a gap; clip longer gets cut by the wrap. Use 30000 frames.
    start_voice(pool, sound, looping=True, length_beats=1.0)
    oracle = make_oracle(pool, sound, looping=True, beat_quantized=True, spt=spt)
    got = run_engine(pool, sound, n_blocks=400, spt=spt)
    want = oracle.render(400 * B)
    np.testing.assert_allclose(got, want, atol=3e-4)
    # the wrap must have happened at the beat boundary: frame 24001 restarts
    # the waveform (reset lands on the fetch after the threshold frame)
    np.testing.assert_allclose(got[24001], want[24001], atol=3e-4)
    assert pool.active[0]


def test_explicit_noteoff_linear_release():
    sound = make_sound(frames=48000)
    pool = VoicePool(4, B, SR)
    start_voice(pool, sound, adsr=(0.005, 0.05, 0.6, 0.02))
    oracle = make_oracle(pool, sound, adsr=(0.005, 0.05, 0.6, 0.02))

    out = []
    release_block, release_offset = 10, 37
    n_blocks = 30
    for b in range(n_blocks):
        if b == release_block:
            pool.note_off(0, tail=True, frame_offset=release_offset)
        prog = pool.build_program(
            block_start_sample=b * B, tick_anchor_sample=0.0,
            tick_anchor=0, samples_per_tick=250.0,
        )
        _, _, contrib = render_voices(
            np, np.ascontiguousarray(sound.T), prog, B, return_contrib=True)
        out.append(contrib[0])
        pool.advance(prog)
    got = np.concatenate(out, axis=0)

    want = np.concatenate([
        oracle.render(release_block * B + release_offset),
        (oracle.note_off(), oracle.render(
            n_blocks * B - release_block * B - release_offset,
            block_start_sample=release_block * B + release_offset))[1],
    ], axis=0)
    np.testing.assert_allclose(got, want, atol=3e-4)
    # release of 0.02s = 960 frames after trigger; voice must be dead
    assert not pool.active[0]


def test_mixdown_and_peaks():
    """Multiple voices on different lanes mix additively into their lanes."""
    sound = make_sound(frames=10000)
    pool = VoicePool(8, B, SR)
    for v, lane in [(0, 2), (1, 2), (2, 5)]:
        pool.note_on(
            v, clip_id=v, midi_note=60 + v, midi_channel=lane - 2, lane=lane,
            base=0, length=10000, source_rate=SR, root_note=60,
            start_sec=0.0, stop_sec=10000 / SR, gain=0.5, clip_volume=1.0,
            pan=0.0, attack=0.0, decay=0.1, sustain=1.0, release=0.05,
            looping=True, length_beats=1.0, start_tick=0,
        )
    prog = pool.build_program(
        block_start_sample=0, tick_anchor_sample=0.0, tick_anchor=0,
        samples_per_tick=250.0,
    )
    mix, peaks, contrib = render_voices(
        np, np.ascontiguousarray(sound.T), prog, B, return_contrib=True)
    np.testing.assert_allclose(
        mix[2], contrib[0] + contrib[1], atol=1e-6
    )
    np.testing.assert_allclose(mix[5], contrib[2], atol=1e-6)
    assert np.abs(mix[[0, 1, 3, 4, 6, 7, 8, 9, 10, 11]]).max() == 0
    # reference peak metric: max(l+r), not abs
    assert peaks[0] == pytest.approx(
        max((contrib[0][:, 0] + contrib[0][:, 1]).max(), 0), abs=1e-7
    )


def test_numpy_jax_render_bit_exact():
    import jax.numpy as jnp

    sound = make_sound(frames=8000)
    pool = VoicePool(16, B, SR)
    rng = np.random.default_rng(1)
    for v in range(12):
        pool.note_on(
            v, clip_id=v, midi_note=int(rng.integers(48, 72)),
            midi_channel=v % 10, lane=2 + v % 10,
            base=0, length=8000, source_rate=SR,
            root_note=60, start_sec=0.0, stop_sec=8000 / SR,
            gain=float(rng.uniform(0.2, 1)), clip_volume=float(rng.uniform(0.5, 1)),
            pan=float(rng.uniform(-1, 1)),
            attack=float(rng.uniform(0, 0.01)), decay=0.05,
            sustain=float(rng.uniform(0.3, 1)), release=0.05,
            looping=bool(v % 2), length_beats=1.0 + (v % 3) * 0.25,
            start_tick=0,
        )
    prog = pool.build_program(
        block_start_sample=0, tick_anchor_sample=0.0, tick_anchor=0,
        samples_per_tick=250.0,
    )
    planar = np.ascontiguousarray(sound.T)
    mix_np, peak_np, c_np = render_voices(np, planar, prog, B, return_contrib=True)
    mix_j, peak_j, c_j = render_voices(jnp, planar, prog, B, return_contrib=True)
    # per-voice contributions: identical elementwise f32 math -> bit-exact
    # (except exp2-based lanes, which may differ by an ulp)
    np.testing.assert_allclose(np.asarray(c_j), c_np, rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(peak_j), peak_np, rtol=2e-6)
    # mixdown accumulates in a backend-specific order -> allclose
    np.testing.assert_allclose(np.asarray(mix_j), mix_np, rtol=1e-5, atol=1e-7)


def test_short_positional_loop_superblock():
    """Regression: a loop needing more wraps per block than the segment
    schedule can express (loop < block/(S-1) frames) must stay inside the
    loop body — the device containment wraps positions modulo the loop
    (the reference wraps per sample without limit,
    lib/SamplerSynthVoice.cpp:243-247). 300-frame loop at B=1024 needs
    ~3.4 wraps/block."""
    B_SUPER = 1024
    sound = make_sound(frames=5000)
    pool = VoicePool(4, B_SUPER, SR)
    start_voice(pool, sound, midi_note=60, looping=True, length_beats=1.3,
                stop_sec=300 / SR)
    oracle = make_oracle(pool, sound, looping=True)
    planar = np.ascontiguousarray(sound.T)
    out = []
    for b in range(30):
        prog = pool.build_program(
            block_start_sample=b * B_SUPER, tick_anchor_sample=0.0,
            tick_anchor=0, samples_per_tick=250.0,
        )
        mix, peaks, contrib = render_voices(
            np, planar, prog, B_SUPER, return_contrib=True
        )
        out.append(contrib[0])
        pool.advance(prog)
    got = np.concatenate(out, axis=0)
    want = oracle.render(30 * B_SUPER)
    np.testing.assert_allclose(got, want, atol=3e-4)
    assert pool.active[0]
    # the voice's position must have stayed inside the loop body
    assert int(pool.pos_int[0]) < 300


def test_even_shorter_loop_multi_wrap_block():
    """64-frame loop at B=1024: 16 wraps per block, far past the segment
    horizon; containment must hold over a long run."""
    B_SUPER = 1024
    sound = make_sound(frames=5000)
    pool = VoicePool(4, B_SUPER, SR)
    start_voice(pool, sound, midi_note=60, looping=True, length_beats=1.3,
                stop_sec=64 / SR)
    oracle = make_oracle(pool, sound, looping=True)
    planar = np.ascontiguousarray(sound.T)
    out = []
    for b in range(20):
        prog = pool.build_program(
            block_start_sample=b * B_SUPER, tick_anchor_sample=0.0,
            tick_anchor=0, samples_per_tick=250.0,
        )
        _, _, contrib = render_voices(
            np, planar, prog, B_SUPER, return_contrib=True
        )
        out.append(contrib[0])
        pool.advance(prog)
    got = np.concatenate(out, axis=0)
    want = oracle.render(20 * B_SUPER)
    np.testing.assert_allclose(got, want, atol=3e-4)


def _run_superblock(pool, sound, n_blocks, spt, B_frames=1024):
    planar = np.ascontiguousarray(sound.T)
    out = []
    for b in range(n_blocks):
        prog = pool.build_program(
            block_start_sample=b * B_frames, tick_anchor_sample=0.0,
            tick_anchor=0, samples_per_tick=spt,
        )
        _, _, contrib = render_voices(
            np, planar, prog, B_frames, return_contrib=True
        )
        out.append(contrib[0])
        pool.advance(prog)
    return np.concatenate(out, axis=0)


def test_short_bq_loop_superblock():
    """A zero-length_beats clip is beat-quantized with a 1-tick loop
    (SamplerSynthVoice.cpp:227's whole-beats rule admits 0; note_on floors
    loop_len_ticks at 1) — at B=1024 that is ~5 wall-clock wraps per block,
    past the segment horizon. The reference wraps per sample without limit
    (lib/SamplerSynthVoice.cpp:225-242); the explicit bq_reset columns must
    reproduce it exactly."""
    spt = 250.0  # 120 bpm at 48 kHz
    sound = make_sound(frames=30000)
    pool = VoicePool(4, 1024, SR)
    start_voice(pool, sound, looping=True, length_beats=0.0)
    assert pool.beat_quantized[0] and pool.loop_len_ticks[0] == 1
    oracle = make_oracle(pool, sound, looping=True, beat_quantized=True,
                         spt=spt)
    got = _run_superblock(pool, sound, n_blocks=40, spt=spt)
    want = oracle.render(40 * 1024)
    np.testing.assert_allclose(got, want, atol=3e-4)
    assert pool.active[0]
    # containment: position stays within one loop span of the start
    assert int(pool.pos_int[0]) <= int(np.ceil(spt)) * 2


@pytest.mark.parametrize("seed", range(8))
def test_short_bq_loop_fuzz(seed):
    """Hostile bq corner fuzz: 1-3-tick beat-quantized
    loops at B=1024 under random BPMs (non-integer samples-per-tick) and
    pitch ratios, bit-green vs the scalar oracle."""
    rng = np.random.default_rng(100 + seed)
    bpm = float(rng.uniform(60.0, 200.0))
    spt = SR * 60.0 / (bpm * 96.0)
    ticks = int(rng.integers(1, 4))
    sound = make_sound(frames=30000, freq=float(rng.uniform(100, 900)))
    pool = VoicePool(4, 1024, SR)
    start_voice(
        pool, sound, midi_note=int(rng.integers(55, 67)),
        looping=True, length_beats=1.0,
        start_sec=float(rng.uniform(0, 0.01)),
        stop_sec=float(rng.uniform(0.2, 0.6)),
    )
    # inject the short bq loop state directly (the note-on API only reaches
    # it via length_beats=0; the voice machine must be exact regardless)
    pool.beat_quantized[0] = True
    pool.loop_len_ticks[0] = ticks
    pool.next_loop_tick[0] = ticks
    oracle = make_oracle(pool, sound, looping=True, beat_quantized=True,
                         spt=spt)
    got = _run_superblock(pool, sound, n_blocks=30, spt=spt)
    want = oracle.render(30 * 1024)
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_unbounded_pitch_ratio_oracle():
    """Full-range pitch: ratio 8 (note 36 above root) renders bit-green vs
    the scalar oracle — the reference computes pitchRatio with NO ceiling
    (lib/SamplerSynthVoice.cpp:115-116) and the rebuild does not clamp;
    the gather fetch serves any ratio."""
    sound = make_sound(frames=24000)
    pool = VoicePool(4, B, SR)
    start_voice(pool, sound, midi_note=96, looping=True, length_beats=1.3,
                stop_sec=23000 / SR)
    ratio = float(pool.rate_int[0]) + float(pool.rate_frac[0])
    assert ratio == 8.0, "note_on must not clamp the pitch ratio"
    oracle = make_oracle(pool, sound, looping=True)
    got = run_engine(pool, sound, n_blocks=60)
    want = oracle.render(60 * B)
    np.testing.assert_allclose(got, want, atol=3e-4)
    assert pool.active[0]


def test_very_high_pitch_ratio_oneshot():
    """Ratio ~32 (note 60 above root): the voice eats the sound in a few
    blocks and must die exactly like the scalar oracle says."""
    sound = make_sound(frames=24000)
    pool = VoicePool(4, B, SR)
    start_voice(pool, sound, midi_note=120, root=60)
    assert float(pool.rate_int[0]) + float(pool.rate_frac[0]) == 32.0
    oracle = make_oracle(pool, sound)
    got = run_engine(pool, sound, n_blocks=12)
    want = oracle.render(12 * B)
    np.testing.assert_allclose(got, want, atol=3e-4)
    assert not pool.active[0]


def _make_pool_with_wraps():
    frames = 5000
    t = np.arange(frames) / SR
    sound = np.stack(
        [0.5 * np.sin(2 * np.pi * 440 * t), 0.5 * np.sin(2 * np.pi * 441 * t)],
        axis=1,
    ).astype(np.float32)
    # pad like the soundbank would (guard + block alignment)
    padded = np.zeros((2, 8192), np.float32)
    padded[:, :frames] = sound.T
    pool = VoicePool(16, B, SR)
    rng = np.random.default_rng(3)
    for v in range(12):
        pool.note_on(
            v, clip_id=v, midi_note=int(rng.integers(48, 73)),
            midi_channel=v % 10, lane=2 + v % 10,
            base=1024, length=frames, source_rate=SR, root_note=60,
            start_sec=0.0, stop_sec=frames / SR,
            gain=0.8, clip_volume=0.9, pan=float(rng.uniform(-1, 1)),
            attack=0.002, decay=0.05, sustain=0.6, release=0.05,
            looping=bool(v % 2), length_beats=1.0 + (v % 3) * 0.3,
            start_tick=0,
        )
    return padded, pool


def test_interleaved_rows_gather_matches_planar():
    """The device bank layout (interleaved [N, 2] rows, one row gather per
    tap) renders exactly what the host's planar [2, N] layout does."""
    import jax.numpy as jnp

    padded, pool = _make_pool_with_wraps()
    inter = np.ascontiguousarray(padded.T)
    for b in range(10):
        prog = pool.build_program(
            block_start_sample=b * B, tick_anchor_sample=0.0,
            tick_anchor=0, samples_per_tick=250.0,
        )
        _, _, c_p = render_voices(jnp, padded, prog, B, return_contrib=True)
        _, _, c_i = render_voices(jnp, inter, prog, B, return_contrib=True)
        np.testing.assert_array_equal(np.asarray(c_i), np.asarray(c_p))
        pool.advance(prog)
