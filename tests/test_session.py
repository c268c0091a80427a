"""Session checkpoint/resume + profiling tests."""

import numpy as np

from libzl_tpu.engine.engine import AudioEngine
from libzl_tpu.io.wav import write_wav
from libzl_tpu.midi.router import Destination
from libzl_tpu.models.clip import ClipAudioSource
from libzl_tpu.models.session import load_session, save_session

SR = 48000


def test_session_roundtrip(tmp_path):
    wav = tmp_path / "src.wav"
    t = np.arange(SR // 2) / SR
    write_wav(wav, (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), SR)

    e1 = AudioEngine(sample_rate=SR, backend="numpy", num_voices=16)
    clip = ClipAudioSource(e1, filepath=str(wav))
    clip.set_pan(-0.4)
    clip.set_volume(-6.0)
    clip.adsr_attack = 0.02
    clip.keyzone_start, clip.keyzone_end = 48, 72
    clip.root_note = 57
    e1.set_bpm(93)
    e1.set_strip(3, dry=0.7, pan=0.25)
    e1.lane_enabled[5] = False
    e1.router.set_channel_destination(
        2, Destination.EXTERNAL, external_channel=7
    )
    save_session(e1, tmp_path / "take.zlsession")

    e2 = AudioEngine(sample_rate=SR, backend="numpy", num_voices=16)
    id_map = load_session(e2, tmp_path / "take.zlsession")
    assert len(id_map) == 1
    c2 = id_map[clip.id]
    assert c2.pan == clip.pan
    assert abs(c2.volume_absolute - clip.volume_absolute) < 1e-9
    assert c2.adsr_attack == 0.02
    assert (c2.keyzone_start, c2.keyzone_end, c2.root_note) == (48, 72, 57)
    assert e2.bpm == 93
    assert e2.get_strip(3, "dry") == np.float32(0.7)
    assert not e2.lane_enabled[5]
    out2 = e2.router.outputs[2]
    assert out2.destination == Destination.EXTERNAL
    assert out2.external_channel == 7
    # the restored session renders
    c2.play(loop=True, midi_channel=0)
    res = e2.process_block()
    assert np.abs(np.asarray(res.outputs.master)).max() > 0.01


def test_session_restores_transport_position_and_looping(tmp_path):
    """Regression: tick_position was saved but never restored,
    and the clip looping flag was not serialized."""
    wav = tmp_path / "src.wav"
    t = np.arange(SR // 4) / SR
    write_wav(wav, (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32), SR)

    e1 = AudioEngine(sample_rate=SR, backend="numpy", num_voices=16)
    clip = ClipAudioSource(e1, filepath=str(wav))
    clip.set_looping(False)
    e1.start_transport(bpm=120)
    for _ in range(50):
        e1.process_block()
    saved_tick = int(e1.clock.tick_position)
    assert saved_tick > 0
    save_session(e1, tmp_path / "mid.zlsession")

    e2 = AudioEngine(sample_rate=SR, backend="numpy", num_voices=16)
    id_map = load_session(e2, tmp_path / "mid.zlsession")
    assert int(e2.clock.tick_position) == saved_tick
    assert e2.transport_running
    c2 = id_map[clip.id]
    assert c2.get_looping() is False
    # the restored clock keeps advancing consistently from the saved tick
    before = int(e2.clock.tick_position)
    e2.process_block()
    assert int(e2.clock.tick_position) > before


def test_recorder_survives_writer_failure(tmp_path):
    """Regression: a writeframes failure must not wedge push()
    or stop() — the writer marks itself failed and drains."""
    from libzl_tpu.engine.recorder import DiskRecorder

    rec = DiskRecorder()
    rec.start(tmp_path / "take.wav", SR)

    def boom(_raw):
        raise OSError("disk full")

    rec._wave.writeframes = boom
    block = np.zeros((128, 2), np.float32)
    # far more blocks than the queue holds: push must never block
    for _ in range(2000):
        rec.push(block)
    rec.stop()
    assert rec.failed
    assert not rec.is_recording
    # a fresh start on the same object works again
    rec.start(tmp_path / "take2.wav", SR)
    rec.push(block)
    rec.stop()
    assert not rec.failed
    assert rec.frames_written == 128


def test_profiler_and_slo_counters():
    engine = AudioEngine(sample_rate=SR, backend="numpy", num_voices=16)
    for _ in range(20):
        engine.process_block()
    s = engine.profiler.summary()
    assert "process_block" in s and s["process_block"]["count"] == 20
    assert engine.slo.total_blocks == 20
    assert 0.0 <= engine.dsp_load.load


def test_in_memory_clip_roundtrips_through_checkpoint(tmp_path):
    """Clips created from AudioData (no filepath) must restore: the
    checkpoint embeds their source audio."""
    import numpy as np

    from libzl_tpu.engine.engine import AudioEngine
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource
    from libzl_tpu.models.session import load_session, save_session

    eng = AudioEngine(sample_rate=48000, backend="numpy", num_voices=16)
    t = np.arange(4800) / 48000.0
    src = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)[:, None]
    clip = ClipAudioSource(eng, audio=AudioData(src, 48000))
    clip.set_volume(-3.0)
    p = tmp_path / "mem.zlsession"
    save_session(eng, p)

    eng2 = AudioEngine(sample_rate=48000, backend="numpy", num_voices=16)
    load_session(eng2, p)
    restored = [c for c in eng2.clips.values()]
    assert len(restored) == 1
    np.testing.assert_allclose(
        np.asarray(restored[0].source.samples), src, atol=1e-7
    )


def test_load_rejects_sample_rate_mismatch(tmp_path):
    """Every seconds-based clip parameter and the resumed tick position
    were computed against the saving engine's rate; restoring into a
    different-rate engine silently retimes the whole session — raise."""
    import pytest

    e1 = AudioEngine(sample_rate=SR, backend="numpy", num_voices=16)
    e1.set_bpm(120)
    save_session(e1, tmp_path / "rate.zlsession")
    e2 = AudioEngine(sample_rate=44100, backend="numpy", num_voices=16)
    with pytest.raises(ValueError, match="44100"):
        load_session(e2, tmp_path / "rate.zlsession")


def test_load_with_missing_sample_file_restores_placeholder(tmp_path):
    """A checkpoint referencing a moved/deleted WAV must not abort the
    load half-mutated: the clip comes back as a polling silent
    placeholder (lib/SamplerSynthSound.cpp:55-58) and attaches the real
    audio when the file reappears."""
    import time

    wav = tmp_path / "src.wav"
    t = np.arange(SR // 2) / SR
    body = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    write_wav(wav, body, SR)
    e1 = AudioEngine(sample_rate=SR, backend="numpy", num_voices=16)
    ClipAudioSource(e1, filepath=str(wav))
    e1.set_bpm(77)
    save_session(e1, tmp_path / "missing.zlsession")

    moved = tmp_path / "moved.wav"
    wav.rename(moved)
    e2 = AudioEngine(sample_rate=SR, backend="numpy", num_voices=16)
    id_map = load_session(e2, tmp_path / "missing.zlsession")
    assert e2.bpm == 77  # the rest of the session restored
    (clip2,) = id_map.values()
    assert clip2.pending_file
    # the file lands again: the watcher attaches the real audio
    moved.rename(wav)
    deadline = time.monotonic() + 5
    while clip2.pending_file and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not clip2.pending_file
    assert clip2.source.num_frames == body.shape[0]


def test_negative_schedule_delay_raises():
    """A negative delay would wrap modulo the 32768-tick ring into the
    far future (the event fires minutes late) — surface the bug."""
    import pytest

    eng = AudioEngine(sample_rate=SR, backend="numpy", num_voices=16)
    from libzl_tpu.engine.commands import ClipCommand

    cmd = ClipCommand.channel(0, 0)
    with pytest.raises(ValueError, match=">= 0"):
        eng.schedule_clip_command(cmd, -1)
