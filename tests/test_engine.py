"""Integration tests for the AudioEngine host runtime (numpy backend)."""

import numpy as np
import pytest

from libzl_tpu.engine.commands import (
    ClipCommand,
    Operation,
    TimerCommand,
)
from libzl_tpu.engine.engine import AudioEngine
from libzl_tpu.io.wav import AudioData
from libzl_tpu.models.clip import ClipAudioSource

SR = 48000


def make_engine(**kw):
    kw.setdefault("backend", "numpy")
    kw.setdefault("num_voices", 32)
    return AudioEngine(sample_rate=SR, **kw)


def make_clip(engine, seconds=0.5, freq=440.0):
    t = np.arange(int(SR * seconds)) / SR
    samples = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None]
    return ClipAudioSource(engine, audio=AudioData(samples, SR))


def render_seconds(engine, seconds):
    blocks = []
    n = int(seconds * SR) // engine.block_frames
    for _ in range(n):
        res = engine.process_block()
        blocks.append(np.asarray(res.outputs.master))
    return np.concatenate(blocks, axis=0)


def test_play_produces_audio_and_stop_silences():
    engine = make_engine()
    clip = make_clip(engine)
    clip.play(loop=True, midi_channel=0)
    audio = render_seconds(engine, 0.25)
    assert np.abs(audio).max() > 0.05
    # one voice active on lane 2 (channel 0)
    assert engine.pool.active.sum() == 1
    assert engine.pool.lane[engine.pool.active.argmax()] == 2

    clip.stop(0)
    # default release is 50 ms -> tail then silence
    render_seconds(engine, 0.2)
    tail = render_seconds(engine, 0.1)
    assert np.abs(tail).max() == 0.0
    assert engine.pool.active.sum() == 0


def test_looping_clip_keeps_playing_past_length():
    engine = make_engine()
    clip = make_clip(engine, seconds=0.1)
    clip.play(loop=True, midi_channel=1)
    audio = render_seconds(engine, 1.0)
    # still audible in the last 100 ms
    assert np.abs(audio[-4800:]).max() > 0.05


def test_oneshot_clip_ends():
    engine = make_engine()
    clip = make_clip(engine, seconds=0.1)
    clip.play(loop=False, midi_channel=0)
    audio = render_seconds(engine, 0.5)
    assert np.abs(audio[:2400]).max() > 0.05
    assert np.abs(audio[-4800:]).max() == 0.0
    assert engine.pool.active.sum() == 0


def test_equivalent_play_coalesces_and_replaces():
    engine = make_engine()
    clip = make_clip(engine)
    clip.play(loop=True, midi_channel=0)
    clip.play(loop=True, midi_channel=0)  # same step: coalesces to one command
    engine.process_block()
    assert engine.pool.active.sum() == 1
    # a later looped play stops the old voice and claims a new one
    clip.play(loop=True, midi_channel=0)
    render_seconds(engine, 0.2)
    assert engine.pool.active.sum() == 1


def test_queue_clip_to_start_waits_for_bar():
    engine = make_engine()
    clip = make_clip(engine)
    engine.start_transport(bpm=120)
    # one bar = 384 ticks = 2 s at 120bpm -> 96000 samples
    engine.queue_clip_to_start(clip, midi_channel=0)
    pre = render_seconds(engine, 1.9)
    assert np.abs(pre).max() == 0.0
    post = render_seconds(engine, 0.3)
    assert np.abs(post).max() > 0.05


def test_set_bpm_via_timer_command():
    engine = make_engine()
    engine.start_transport()
    engine.schedule_timer_command(
        TimerCommand(operation=Operation.SET_BPM, parameter=73), 0
    )
    engine.process_block()
    assert engine.bpm == 73
    # clamped
    engine.schedule_timer_command(
        TimerCommand(operation=Operation.SET_BPM, parameter=999), 0
    )
    render_seconds(engine, 0.05)
    assert engine.bpm == 200


def test_passthrough_command_and_mute():
    engine = make_engine()
    clip = make_clip(engine)
    clip.play(loop=True, midi_channel=0)
    render_seconds(engine, 0.1)
    # mute the global strip -> master goes silent, lane mix still live
    engine.schedule_timer_command(
        TimerCommand(
            operation=Operation.PASSTHROUGH_CLIENT,
            parameter=-1, parameter2=4, parameter3=1,
        ),
        0,
    )
    res = engine.process_block()
    assert np.abs(np.asarray(res.outputs.master)).max() == 0.0
    assert np.abs(np.asarray(res.outputs.lane_mix)).max() > 0.05
    assert engine.get_strip(-1, "muted") == 1.0


def test_channel_disable_freezes_voices():
    engine = make_engine()
    clip = make_clip(engine)
    clip.play(loop=True, midi_channel=3)
    render_seconds(engine, 0.1)
    pos_before = engine.pool.pos_int.copy()
    engine.schedule_timer_command(
        TimerCommand(
            operation=Operation.SAMPLER_CHANNEL_ENABLED_STATE,
            parameter=3, parameter2=0,
        ),
        0,
    )
    audio = render_seconds(engine, 0.1)
    assert np.abs(audio).max() == 0.0
    assert (engine.pool.pos_int == pos_before).all()  # frozen, not advanced
    # re-enable: playback resumes from where it froze
    engine.schedule_timer_command(
        TimerCommand(
            operation=Operation.SAMPLER_CHANNEL_ENABLED_STATE,
            parameter=3, parameter2=1,
        ),
        0,
    )
    audio = render_seconds(engine, 0.1)
    assert np.abs(audio).max() > 0.05


def test_stop_transport_flushes_ring_with_zero_volume():
    engine = make_engine()
    clip = make_clip(engine)
    engine.start_transport(bpm=120)
    engine.queue_clip_to_start(clip, midi_channel=0)  # a bar away
    engine.stop_transport()
    # the queued start is re-issued at delay 0 with volume forced to 0
    audio = render_seconds(engine, 0.2)
    assert np.abs(audio).max() == 0.0
    # the voice exists but renders silently (gain 0), like the reference
    assert engine.pool.active.sum() == 1
    assert engine.pool.gain[engine.pool.active.argmax()] == 0.0


def test_positions_and_progress_callbacks():
    engine = make_engine()
    clip = make_clip(engine, seconds=1.0)
    seen = []
    clip.progress_callback = seen.append
    clip.play(loop=True, midi_channel=0)
    for _ in range(40):
        res = engine.process_block()
        engine.update_session(res)
    assert len(clip.positions_model) == 1
    assert clip.positions_model.first_progress() > 0
    assert seen and seen[-1] > 0


def test_midi_clock_emitted_every_third_tick():
    engine = make_engine()
    engine.start_transport(bpm=120)
    clocks = 0
    ticks = 0
    for _ in range(100):
        res = engine.process_block()
        ticks += res.tick_count
        clocks += sum(
            1 for _, data in res.midi_out if data == bytes([0xF8])
        )
    assert clocks == (ticks + 2) // 3


def test_voices_per_lane_cap():
    engine = make_engine(voices_per_lane=2)
    clips = [make_clip(engine) for _ in range(4)]
    for c in clips:
        c.play(loop=True, midi_channel=0)
    engine.process_block()
    assert engine.pool.active.sum() == 2


def test_no_retracing_across_blocks():
    """Per-block variation must be array values, never shapes: the packed
    render compiles exactly once per block size."""
    from libzl_tpu.engine import render as render_mod

    engine = AudioEngine(sample_rate=SR, backend="jax", num_voices=16)
    clip = make_clip(engine, seconds=0.3)
    engine.start_transport(bpm=97)
    clip.play(loop=True, midi_channel=0)
    engine.process_block()
    before = render_mod.render_block_fused._cache_size()
    # vary everything that may vary at runtime: commands, tempo, strips,
    # channel toggles, voice churn
    clip2 = make_clip(engine, seconds=0.1, freq=200.0)
    clip2.play(loop=False, midi_channel=3)
    engine.set_bpm(181)
    engine.set_strip(2, dry=0.3, pan=-0.5)
    for _ in range(50):
        engine.process_block()
    assert render_mod.render_block_fused._cache_size() == before


def test_strip_device_cache_reuses_and_invalidates():
    """Strips upload to the device once, are reused while unchanged, and
    re-upload (taking effect) on any strip mutation (jax backend)."""
    engine = AudioEngine(sample_rate=SR, backend="jax", num_voices=16)
    clip = make_clip(engine)
    clip.play(loop=True, midi_channel=0)
    engine.process_block()
    cached = engine._device_strips
    assert cached is not None
    for _ in range(5):
        engine.process_block()
    assert engine._device_strips is cached  # no re-upload while unchanged

    loud = np.abs(np.asarray(engine.process_block().outputs.master)).max()
    engine.set_strip(-1, muted=1.0)  # mute the global strip
    res = engine.process_block()
    assert engine._device_strips is not cached  # mutation re-uploaded
    assert loud > 0.05
    assert np.abs(np.asarray(res.outputs.master)).max() == 0.0


def test_int16_bank_backend_equality():
    """bank_dtype="int16" halves the gather's HBM bytes; the numpy mirror
    quantizes identically so backends stay bit-equal, and the output sits
    within 16-bit-WAV precision of the f32 bank."""
    import numpy as np

    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource

    def run(backend, dtype):
        # per-block: bank quantization is a fetch-path property
        e = AudioEngine(sample_rate=SR, backend=backend, num_voices=16,
                        bank_dtype=dtype, lookahead=0)
        t = np.arange(12000) / SR
        c = ClipAudioSource(e, audio=AudioData(
            (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)[:, None],
            SR))
        e.start_transport(bpm=120)
        c.play(loop=True, midi_channel=1)
        return np.concatenate([
            np.asarray(e.process_block().outputs.master) for _ in range(20)
        ])

    f32n = run("numpy", "float32")
    i16n = run("numpy", "int16")
    i16j = run("jax", "int16")
    np.testing.assert_array_equal(i16n, i16j)
    assert np.abs(f32n - i16n).max() < 1e-4


def test_bank_capacity_check():
    """A replicated sound bank past 60% of per-device memory fails loudly
    at upload time with actionable guidance (PARITY.md round-3 table);
    within budget it passes silently. Every device of a mesh must hold the
    bank, so the smallest one decides. Exercised against stub devices so
    the test does not depend on the host's real memory stats."""
    import types

    e = AudioEngine(sample_rate=SR, backend="jax", num_voices=8)
    bank_bytes = e.bank.data.size * 4  # float32 default

    def dev(limit):
        return types.SimpleNamespace(
            memory_stats=lambda: {"bytes_limit": limit})

    tight = int(bank_bytes / 0.6) - 1
    # bank is 60%+ of a tiny device: loud failure naming the remedy
    with pytest.raises(RuntimeError, match="int16"):
        e._check_bank_capacity([dev(tight)])
    # one small device in a mesh is enough to fail
    with pytest.raises(RuntimeError, match="int16"):
        e._check_bank_capacity([dev(bank_bytes * 4), dev(tight)])
    # plenty of room: no-op
    e._check_bank_capacity([dev(int(bank_bytes * 4))])
    # devices that report no stats (the CPU): check is skipped
    e._check_bank_capacity([types.SimpleNamespace(memory_stats=lambda: None)])
    assert len(e._render_devices()) == 1  # single-device engine

    # int16 banks count 2 bytes/sample: the same limit that fails f32
    # passes at half the bytes
    e16 = AudioEngine(sample_rate=SR, backend="jax", num_voices=8,
                      bank_dtype="int16")
    e16._check_bank_capacity([dev(tight)])
def test_compile_cache_env(tmp_path, monkeypatch):
    """The persistent XLA compile cache follows JAX_COMPILATION_CACHE_DIR
    when it is set (libzl_tpu.device.use_compile_cache): a jax engine in a
    process with no cache configured writes its compiles there."""
    import glob

    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    # a fresh process: no directory configured yet (the suite's conftest
    # configured one, and jax initializes the persistent cache ONCE — reset
    # so the engine's directory takes effect for this process)
    jax.config.update("jax_compilation_cache_dir", None)
    from jax.experimental.compilation_cache import compilation_cache as cc

    try:
        # a block size no other test uses: the persistent cache only
        # writes on a FRESH XLA compile, so a shape already in the
        # in-process jit cache (any earlier test at the default geometry)
        # would make this assertion order-dependent
        e = AudioEngine(sample_rate=SR, num_voices=8, backend="jax",
                        block_frames=352)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        cc.reset_cache()  # re-init at the engine-configured directory
        x = (0.3 * np.sin(2 * np.pi * 220 * np.arange(SR // 10) / SR)
             ).astype(np.float32)[:, None]
        clip = ClipAudioSource(e, audio=AudioData(x, SR))
        clip.play(loop=True, midi_channel=0)
        e.start_transport(bpm=120)
        e.process_block()
        assert len(glob.glob(str(tmp_path) + "/*")) >= 1
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)
        jax.config.update("jax_compilation_cache_dir", old_dir)
        cc.reset_cache()  # back to the suite-wide cache (conftest)
def test_play_honors_clip_looping_flag():
    """clip.play() with no argument consults set_looping (the reference's
    transport.looping, lib/ClipAudioSource.cpp:243-253)."""
    import numpy as np

    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource

    eng = AudioEngine(sample_rate=48000, backend="numpy", num_voices=16)
    t = np.arange(2400) / 48000.0
    clip = ClipAudioSource(
        eng, audio=AudioData(
            (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[:, None],
            48000,
        ),
    )
    clip.set_looping(False)
    clip.play(midi_channel=0)
    eng.start_transport(bpm=120)
    eng.process_block()
    assert not bool(eng.pool.looping[np.flatnonzero(eng.pool.active)[0]])
    # explicit override still wins
    clip.play(loop=True, midi_channel=1)
    eng.process_block()
    act = np.flatnonzero(eng.pool.active)
    assert any(bool(eng.pool.looping[v]) for v in act)


def test_rerender_rebases_live_voices_midnote():
    """A playback re-render landing mid-note switches LIVE voices to the
    new audio at the next block, like the reference's per-block buffer
    re-read (lib/SamplerSynthVoice.cpp:189-191) — they must not keep
    playing the old region until the note ends."""
    from libzl_tpu.io.wav import AudioData

    engine = make_engine()
    clip = make_clip(engine)
    clip.play(loop=True, midi_channel=0)
    engine.start_transport(bpm=120)
    loud = render_seconds(engine, 0.1)
    assert np.abs(loud).max() > 0.05
    assert engine.pool.active.sum() == 1
    # the re-render lands (playbackFileChanged): silence of the same length
    clip._finish_playback_update(
        np.zeros_like(np.asarray(clip.playback_audio.samples))
    )
    assert engine.pool.active.sum() == 1  # note survives the swap
    after = render_seconds(engine, 0.1)
    assert np.abs(after).max() == 0.0, "live voice still playing old region"


def test_start_without_change_volume_is_silent_parity():
    """The reference passes clipCommand->volume as the start velocity
    unconditionally (lib/SamplerSynth.cpp:211); the struct default is 0.0,
    so a start command without change_volume starts silent."""
    from libzl_tpu.engine.commands import ClipCommand

    engine = make_engine()
    clip = make_clip(engine)
    engine.start_transport(bpm=120)
    cmd = ClipCommand.channel(clip.id, 0)
    cmd.midi_note = 60
    cmd.start_playback = True
    engine.schedule_clip_command(cmd, 0)
    out = render_seconds(engine, 0.05)
    assert engine.pool.active.sum() == 1  # voice claimed, just silent
    assert np.abs(out).max() == 0.0


def test_soundbank_lifecycle_invariants():
    """unload is idempotent (no double free-list entries) and replace on
    an unloaded slot raises instead of resurrecting a freed id."""
    import pytest

    from libzl_tpu.engine.soundbank import SoundBank
    from libzl_tpu.io.wav import AudioData

    bank = SoundBank(capacity_frames=1 << 16)
    a = bank.load(AudioData(np.ones((100, 1), np.float32), 48000))
    bank.unload(a.slot)
    bank.unload(a.slot)  # idempotent: must not push the id twice
    with pytest.raises(ValueError, match="unloaded"):
        bank.replace(a.slot, AudioData(np.ones((50, 1), np.float32), 48000))
    b = bank.load(AudioData(np.ones((10, 1), np.float32), 48000))
    c = bank.load(AudioData(np.ones((20, 1), np.float32), 48000))
    assert b.slot != c.slot, "recycled id handed out twice"


# ---- coverage-driven API edges (tools/cov.py round 3) ----------------------


def test_constructor_validation_errors():
    """Misconfigurations fail at construction, never mid-render."""
    with pytest.raises(ValueError, match="bank_dtype"):
        AudioEngine(sample_rate=SR, backend="numpy", num_voices=8,
                    bank_dtype="int8")
    with pytest.raises(ValueError, match="backend"):
        AudioEngine(sample_rate=SR, backend="cuda", num_voices=8)
    with pytest.raises(ValueError, match="voice_buckets"):
        AudioEngine(sample_rate=SR, backend="numpy", num_voices=8,
                    voice_buckets="fine")
    with pytest.raises(ValueError, match="lookahead"):
        AudioEngine(sample_rate=SR, backend="numpy", num_voices=8,
                    lookahead=4)
    with pytest.raises(RuntimeError, match="native host core"):
        from libzl_tpu.engine import hostcore as hc

        avail = hc.available
        hc.available = lambda: False
        try:
            AudioEngine(sample_rate=SR, backend="numpy", num_voices=8,
                        host_core="native")
        finally:
            hc.available = avail


def test_mesh_validation_errors():
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices("cpu")[:2])
    mesh = Mesh(devs, ("voices",))
    with pytest.raises(ValueError, match="mesh sharding requires"):
        AudioEngine(sample_rate=SR, backend="numpy", num_voices=8, mesh=mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        AudioEngine(sample_rate=SR, backend="jax", num_voices=9, mesh=mesh)


def test_send_note_immediately_and_schedule_midi():
    """sendNoteImmediately lands in the CURRENT block (zero delay,
    lib/SyncTimer.cpp:1096-1105); raw schedule_midi flows to midi_out."""
    engine = make_engine(num_voices=8)
    engine.start_transport(bpm=120)
    engine.send_note_immediately(64, 5, set_on=True, velocity=100)
    engine.schedule_midi(bytes([0xB0, 7, 99]), delay=0)
    res = engine.process_block()
    sent = [d for _, d in res.midi_out]
    assert bytes([0x95, 64, 100]) in sent
    assert bytes([0xB0, 7, 99]) in sent


def test_queue_clip_to_stop_waits_for_bar():
    """queueClipToStop: while the transport runs, the stop quantizes to the
    next bar like the start path (lib/SyncTimer.cpp 'queueClipToStop')."""
    engine = make_engine()
    clip = make_clip(engine, seconds=2.0)
    engine.start_transport(bpm=120)
    engine.queue_clip_to_start(clip)
    # roll to the bar so the clip starts
    blocks_per_bar = int(2.0 * SR) // engine.block_frames  # 1 bar @120 = 2 s
    for _ in range(blocks_per_bar + 2):
        engine.process_block()
    assert engine.pool.active.sum() == 1
    engine.queue_clip_to_stop(clip)
    engine.process_block()
    assert engine.pool.active.sum() == 1  # still playing until the next bar
    # the stop lands at the bar, then the 50 ms default release tail rings
    for _ in range(blocks_per_bar + 30):
        engine.process_block()
    assert engine.pool.active.sum() == 0


def test_stop_all_clips_and_strip_index_bounds():
    """stopClips C API analog (lib/libzl.cpp:441-449); strip_index guards
    the -1..9 convention (lib/libzl.cpp:476-575)."""
    engine = make_engine()
    c1, c2 = make_clip(engine), make_clip(engine, freq=330.0)
    c1.play(loop=True)
    c2.play(loop=True)
    engine.process_block()
    assert engine.pool.active.sum() == 2
    engine.stop_all_clips()
    render_seconds(engine, 0.3)  # 50 ms default release tail, then silence
    assert engine.pool.active.sum() == 0
    assert engine.strip_index(-1) == 0 and engine.strip_index(9) == 10
    with pytest.raises(ValueError, match="passthrough channel"):
        engine.strip_index(10)


def test_schedule_ahead_tracks_latency():
    """scheduleAheadAmount analog (lib/SyncTimer.cpp:711-715): more output
    latency means more ticks of lead."""
    engine = make_engine()
    engine.start_transport(bpm=120)
    base = engine.schedule_ahead_amount()
    engine.output_latency_blocks = 8
    assert engine.schedule_ahead_amount() > base


def test_timer_command_playback_callbacks_and_register_cas():
    """START/STOP_PLAYBACK fan out to callbacks and drive the transport;
    REGISTER_CAS/UNREGISTER_CAS register clips through the scheduler
    (lib/TimerCommand.h:13-28 operations)."""
    engine = make_engine()
    events = []
    engine.start_playback_callbacks.append(lambda: events.append("start"))
    engine.stop_playback_callbacks.append(lambda: events.append("stop"))

    engine.schedule_timer_command(
        TimerCommand(operation=Operation.START_PLAYBACK), 0)
    engine.process_block()
    assert events == ["start"] and engine.transport_running

    # a clip created detached (engine=None) registers via the scheduled
    # command — the RegisterCAS path (lib/TimerCommand.h:26)
    t = np.arange(SR // 4) / SR
    audio = AudioData(
        (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[:, None], SR)
    clip = ClipAudioSource(None, audio=audio)
    assert clip.id not in engine.clips and clip.slot is None
    engine.schedule_timer_command(
        TimerCommand(operation=Operation.REGISTER_CAS,
                     data_parameter=clip), 0)
    # a delay-0 command lands on the NEXT tick boundary and a 128-frame
    # block advances only ~0.5 tick at 120 BPM — walk far enough to fire
    render_seconds(engine, 0.05)
    assert clip.id in engine.clips and clip.slot is not None
    engine.schedule_timer_command(
        TimerCommand(operation=Operation.UNREGISTER_CAS,
                     data_parameter=clip), 0)
    render_seconds(engine, 0.05)
    assert clip.id not in engine.clips and clip.slot is None

    engine.schedule_timer_command(
        TimerCommand(operation=Operation.STOP_PLAYBACK), 0)
    engine.process_block()
    assert events[-1] == "stop" and not engine.transport_running


def test_passthrough_command_out_of_range_ignored():
    """A scheduled passthrough command with a bad channel is ignored (the
    reference's switches bounds-check) — the tick walk must not abort."""
    engine = make_engine()
    engine.start_transport(bpm=120)
    cmd = TimerCommand(operation=Operation.PASSTHROUGH_CLIENT,
                       parameter=99, parameter2=0, parameter3=50)
    engine.schedule_timer_command(cmd, 0)
    engine.process_block()  # no exception, strips untouched
    assert float(engine.strips.dry[1]) == 1.0


def test_timer_command_observer_and_embedded_clip_command():
    """Every scheduled TimerCommand fans to timer_command_callbacks
    (lib/SyncTimer.cpp:563 `Q_EMIT timerCommand`), and a
    ClipCommandOperation carries its ClipCommand payload into the sampler
    (lib/TimerCommand.h:18); clip_command_sent_callbacks is the
    clipCommandSent analog (lib/SyncTimer.cpp:415-419)."""
    engine = make_engine()
    clip = make_clip(engine)
    ops_seen = []
    engine.timer_command_callbacks.append(lambda c: ops_seen.append(c.operation))
    sent = []
    engine.clip_command_sent_callbacks.append(lambda c: sent.append(c))
    engine.start_transport(bpm=120)

    inner = ClipCommand.channel(clip.id, 0)
    inner.midi_note = 60
    inner.looping = True
    inner.start_playback = True
    engine.schedule_timer_command(
        TimerCommand(operation=Operation.CLIP_COMMAND, data_parameter=inner),
        0,
    )
    render_seconds(engine, 0.05)  # walk past the next tick boundary
    assert Operation.CLIP_COMMAND in ops_seen
    assert inner in sent
    assert engine.pool.active.any()


def test_lookahead_one_block_collapses_to_plain_path():
    """A 1-block horizon IS the plain per-block path: auto at
    block_frames=2048 resolves to H=1 and collapses to 0, and an explicit
    lookahead=1 does the same (docs/API.md LIBZL_TPU_LOOKAHEAD)."""
    e_auto = AudioEngine(sample_rate=SR, block_frames=2048, num_voices=16,
                         backend="jax", lookahead="auto")
    assert e_auto._lookahead == 0
    e_one = make_engine(lookahead=1)
    assert e_one._lookahead == 0


def test_python_host_core_renders_identically():
    """The numpy voice machine (host_core="python") is the reference
    implementation the native core must mirror; the engine's legacy
    program-build path must produce the same audio as the native-host
    path on the same session (CLAUDE.md golden rule)."""
    outs = {}
    for hc in ("native", "python"):
        engine = make_engine(host_core=hc, num_voices=16)
        assert engine.use_native_host == (hc == "native")
        clip = make_clip(engine)
        engine.start_transport(bpm=120)
        clip.play(loop=True, midi_channel=0)
        blocks = [engine.process_block().outputs.master for _ in range(4)]
        outs[hc] = np.concatenate(blocks, axis=0)
    np.testing.assert_array_equal(outs["native"], outs["python"])
    assert np.abs(outs["python"]).max() > 0


def test_python_host_core_jax_backend_matches_numpy():
    """The jax dispatch through the legacy (non-native-host) program build:
    same session, numpy vs jax backends, equal audio."""
    outs = {}
    for backend in ("numpy", "jax"):
        engine = AudioEngine(sample_rate=SR, block_frames=128,
                             num_voices=16, backend=backend,
                             host_core="python")
        clip = make_clip(engine)
        engine.start_transport(bpm=120)
        clip.play(loop=True, midi_channel=0)
        blocks = [np.asarray(engine.process_block().outputs.master)
                  for _ in range(3)]
        outs[backend] = np.concatenate(blocks, axis=0)
    np.testing.assert_allclose(outs["jax"], outs["numpy"],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("note,ratio", [(90, 2 ** 2.5), (96, 8.0),
                                         (120, 32.0)])
def test_over_envelope_note_gather_fallback_bit_equal(note, ratio):
    """High pitch ratios (5.66, 8, 32 — notes 30, 36 and 60 above root)
    render through the gather fetch on the device, per-block and in the
    lookahead horizon, and match the numpy mirror at the established
    backend tolerance: the engine accepts any MIDI note/root pair like
    the reference, whose pitchRatio has no ceiling
    (lib/SamplerSynthVoice.cpp:115-116)."""
    import numpy as np

    from libzl_tpu.engine.commands import ClipCommand
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource

    def run(backend):
        e = AudioEngine(sample_rate=SR, backend=backend, num_voices=16)
        t = np.arange(30000) / SR
        c = ClipAudioSource(e, audio=AudioData(
            (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[:, None],
            SR))
        e.start_transport(bpm=120)
        cmd = ClipCommand.channel(c.id, 1)
        cmd.midi_note = note
        cmd.change_volume = True
        cmd.volume = 1.0
        cmd.looping = True
        cmd.change_looping = True
        cmd.start_playback = True
        e.schedule_clip_command(cmd, 0)
        # 24 blocks: the horizon engages at block 3 (clean-run gate) and a
        # second one starts at 19, so both dispatch kinds are covered
        out = np.concatenate([
            np.asarray(e.process_block().outputs.master) for _ in range(24)
        ])
        return out, e

    dev, e_dev = run("jax")
    ref, _ = run("numpy")
    v = int(e_dev.pool.active.argmax())
    got = float(e_dev.pool.rate_int[v] + e_dev.pool.rate_frac[v])
    assert got == pytest.approx(ratio, rel=1e-6)
    assert e_dev._h_slices, "horizon should engage on the high-ratio session"
    assert np.abs(dev).max() > 0
    np.testing.assert_allclose(dev, ref, rtol=1e-5, atol=1e-7)


def test_quirk_gain_strict_reference_mode_end_to_end():
    """AudioEngine(quirk_gain=True) is the engine-level 'strict reference
    audio' mode: every block renders with the interpolation-gain quirk of
    lib/SamplerSynthVoice.cpp:204-205 (gain folded into one tap), for A/B
    captures against a real zynthbox unit. The jax engine must match the
    quirked numpy mirror exactly, and differ from the corrected default
    at a fractional-position pitch ratio."""
    def run(backend, quirk):
        # lookahead=0: the quirk lives in the per-sample interpolation
        # math, identical in every dispatch path (horizon bit-exactness
        # has its own differentials); per-block keeps the suite fast
        e = AudioEngine(sample_rate=SR, backend=backend, num_voices=16,
                        quirk_gain=quirk, lookahead=0)
        c = make_clip(e)
        c.root_note = 57  # note 60 -> ratio 2^(3/12): fractional positions
        e.start_transport(bpm=120)
        cmd = ClipCommand.channel(c.id, 0)
        cmd.midi_note = 60
        cmd.change_volume = True
        cmd.volume = 0.5  # g != 1: the quirk folds the gain into ONE tap
        cmd.looping = True
        cmd.change_looping = True
        cmd.start_playback = True
        e.schedule_clip_command(cmd, 0)
        return np.concatenate([
            np.asarray(e.process_block().outputs.master) for _ in range(30)
        ])

    quirk_jax = run("jax", True)
    quirk_np = run("numpy", True)
    corrected = run("jax", False)
    # the quirked un-parenthesized expression (a*ia + b*al*g) fuses
    # differently under XLA than numpy's left-assoc chain (FMA), so the
    # cross-backend check is 1-ULP, not bit (the corrected default IS
    # bit-identical across backends — test_dispatch_equivalence)
    np.testing.assert_allclose(quirk_jax, quirk_np, rtol=0, atol=2e-7)
    assert np.abs(quirk_jax).max() > 0.05
    assert not np.array_equal(quirk_jax, corrected), (
        "strict mode must reproduce the quirk, not the corrected reading")
