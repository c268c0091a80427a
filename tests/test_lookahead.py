"""Speculative lookahead horizon (AudioEngine lookahead mode).

The engine renders H blocks per upload+dispatch on clean blocks and
preempts the horizon whenever an event lands, so event latency stays one
block while fixed per-dispatch costs amortize H-fold. The horizon is H
stacked per-block programs built by simulating the host's per-block
advance, so horizon output is BIT-IDENTICAL to per-block output on the CPU
backend (on the GPU the two graphs agree to float32 rounding,
chip_smoke.py) — every differential below asserts
exact equality, not f32 tolerance. Event blocks rebuild the horizon in
the same dispatch when traffic is sparse (REBUILD_MIN_GAP), keeping
quiet-regime amortization in event-dense sessions.
"""

import numpy as np
import pytest

from libzl_tpu.engine.commands import ClipCommand
from libzl_tpu.engine.engine import AudioEngine
from libzl_tpu.io.wav import AudioData
from libzl_tpu.models.clip import ClipAudioSource

SR = 48000


def _tone(seconds=0.5, freq=220.0):
    t = np.arange(int(SR * seconds)) / SR
    return AudioData(
        (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None], SR
    )


def _engine(lookahead, voices=64, block=128):
    eng = AudioEngine(block_frames=block, num_voices=voices, backend="jax",
                      lookahead=lookahead)
    clip = ClipAudioSource(eng, audio=_tone())
    eng.start_transport(bpm=120)
    return eng, clip


def _run_script(lookahead, script, blocks=100):
    """Run `blocks` with script = {block_index: fn(eng, clip)}."""
    eng, clip = _engine(lookahead)
    outs, peaks = [], []
    for i in range(blocks):
        if i in script:
            script[i](eng, clip)
        res = eng.process_block()
        outs.append(np.asarray(res.outputs.master))
        peaks.append(np.asarray(res.outputs.voice_peaks))
    return np.concatenate(outs), np.stack(peaks), eng


def _play(eng, clip, note=60, channel=0, loop=True):
    cmd = ClipCommand.channel(clip.id, channel)
    cmd.midi_note = note
    cmd.start_playback = True
    cmd.looping = loop
    cmd.change_looping = loop
    eng.schedule_clip_command(cmd, 0)


def test_auto_resolution():
    eng, _ = _engine("auto")
    assert eng._lookahead == 16
    eng_np = AudioEngine(block_frames=128, num_voices=16, backend="numpy")
    assert eng_np._lookahead == 0
    # superblock bounce path: H=2 (the window caps at 2048 frames)
    eng_sb = AudioEngine(block_frames=1024, num_voices=16, backend="jax")
    assert eng_sb._lookahead == 2
    eng_huge = AudioEngine(block_frames=4096, num_voices=16, backend="jax")
    assert eng_huge._lookahead == 0
    with pytest.raises(ValueError):
        AudioEngine(block_frames=128, num_voices=16, backend="numpy",
                    lookahead=8)


def test_clean_session_matches_per_block():
    script = {0: lambda e, c: _play(e, c)}
    on, pk_on, eng = _run_script("auto", script)
    off, pk_off, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)
    assert eng._h_slices, "horizon never engaged"


def test_midhorizon_event_preempts_with_exact_timing():
    """A note landing mid-horizon must sound at exactly the same frame as
    per-block dispatch — the horizon preempts, it does not delay."""
    script = {
        0: lambda e, c: _play(e, c),
        17: lambda e, c: _play(e, c, note=67, channel=1),
        18: lambda e, c: _play(e, c, note=72, channel=2),
        45: lambda e, c: _play(e, c, note=48, channel=3),
    }
    on, pk_on, eng = _run_script("auto", script)
    off, pk_off, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)


def test_event_block_rebuilds_horizon():
    """An event landing after a long clean run rebuilds the horizon in the
    SAME block (one dispatch, H blocks delivered, H-block deadline) — the
    event-storm SLO fix. Back-to-back events must not."""
    eng, clip = _engine("auto")
    starts = []
    orig = type(eng)._start_horizon

    def spy(self):
        starts.append(self.total_blocks)
        return orig(self)

    eng._start_horizon = spy.__get__(eng)
    _play(eng, clip)
    for i in range(30):
        eng.process_block()
    # quiet: first horizon after 3 clean blocks, then on exhaustion
    assert starts and starts[0] == 3
    # event after a long clean run -> rebuild in the event block itself
    # (the command fires at the next scheduler tick, possibly next block)
    _play(eng, clip, note=67, channel=1)
    event_block = None
    for _ in range(3):
        n = eng.total_blocks
        eng.process_block()
        if eng._blocks_since_event == 0:
            event_block = n
            break
    assert event_block is not None, "scheduled event never fired"
    assert starts[-1] == event_block, "event block did not rebuild the horizon"
    assert eng._h_built_this_block, "rebuild must claim the H-block budget"
    # immediate second event (gap <= 1 tick): degrade to per-block
    _play(eng, clip, note=72, channel=2)
    for _ in range(3):
        n = eng.total_blocks
        eng.process_block()
        if eng._blocks_since_event == 0:
            assert n not in starts, "storm-gap event must not rebuild"
            break


def test_out_of_band_mutations_preempt():
    """Direct API mutations (set_bpm / set_strip / lane toggle) bypass the
    command hooks; the fingerprint must still preempt stale slices."""
    def mutate_bpm(e, c):
        e.set_bpm(151.5)

    def mutate_strip(e, c):
        e.set_strip(0, dry=0.6, pan=-0.4)

    def mutate_lane(e, c):
        e.lane_enabled[5] = False

    script = {0: lambda e, c: _play(e, c),
              20: mutate_bpm, 40: mutate_strip, 60: mutate_lane}
    on, _, _ = _run_script("auto", script)
    off, _, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)


def test_stop_transport_and_noteoff_midhorizon():
    def stop_note(e, c):
        cmd = ClipCommand.channel(c.id, 0)
        cmd.midi_note = 60
        cmd.stop_playback = True
        e.schedule_clip_command(cmd, 0)

    script = {0: lambda e, c: _play(e, c), 30: stop_note,
              50: lambda e, c: e.stop_transport()}
    on, _, _ = _run_script("auto", script)
    off, _, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)


def test_oneshot_death_midhorizon_releases_positions():
    """A one-shot voice dying inside the horizon still releases its
    positions-model entry (at catch-up) and ends at the same frame."""
    # the 0.5 s one-shot spans ~188 blocks; run past its death
    script = {0: lambda e, c: _play(e, c, loop=False)}
    on, _, eng_on = _run_script("auto", script, blocks=220)
    off, _, eng_off = _run_script(0, script, blocks=220)
    np.testing.assert_array_equal(on, off)
    assert int(eng_on.pool.active.sum()) == 0
    assert int(eng_off.pool.active.sum()) == 0


def test_no_retrace_after_first_horizon():
    """Steady sessions reuse one compiled horizon program: per-block
    inputs are values, not shapes."""
    from libzl_tpu.engine import render as render_mod

    eng, clip = _engine("auto")
    _play(eng, clip)
    for _ in range(20):
        eng.process_block()
    before = render_mod.render_horizon_onebuf._cache_size()
    _play(eng, clip, note=65, channel=4)  # event -> preempt -> new horizon
    for _ in range(40):
        eng.process_block()
    assert render_mod.render_horizon_onebuf._cache_size() == before


def test_event_storm_degrades_to_per_block():
    """With an event every block the engine must never build horizons
    (speculative renders would waste device time H-fold)."""
    eng, clip = _engine("auto")
    import libzl_tpu.engine.engine as E

    starts = []
    orig = E.AudioEngine._start_horizon

    def spy(self):
        starts.append(self.total_blocks)
        return orig(self)

    eng._start_horizon = spy.__get__(eng)
    for i in range(30):
        _play(eng, clip, note=40 + i % 20, channel=i % 10)
        eng.process_block()
    assert not starts


def test_spec_pipeline_adopts_next_horizon():
    """Quiet runs pipeline horizons: N+1 is built from N's end snapshot
    one block into emission and ADOPTED at exhaustion — _start_horizon
    must run exactly once per clean run, every later horizon arriving
    via _adopt_spec (device render overlapped with emission), and the
    speculative-build block must claim the slices-in-hand budget."""
    eng, clip = _engine("auto")
    starts, adopts, specs = [], [], []
    orig_start = type(eng)._start_horizon
    orig_adopt = type(eng)._adopt_spec
    orig_spec = type(eng)._maybe_build_spec

    eng._start_horizon = (
        lambda: (starts.append(eng.total_blocks), orig_start(eng))[1])
    eng._adopt_spec = (
        lambda: (adopts.append(eng.total_blocks), orig_adopt(eng))[1])
    eng._maybe_build_spec = (
        lambda: (specs.append(eng.total_blocks), orig_spec(eng))[1:] and None)
    _play(eng, clip)
    budgets = []
    for _ in range(60):
        eng.process_block()
        if eng._spec_built_this_block:
            budgets.append(len(eng._h_slices) - eng._h_cursor)
    H = eng._lookahead
    # first horizon after 3 clean blocks; spec built one block later
    assert starts == [3]
    assert specs and specs[0] == 4
    # adoption exactly at every exhaustion (blocks 3+H, 3+2H, ...)
    assert adopts, "speculative horizon never adopted"
    assert adopts == [3 + H * (k + 1) for k in range(len(adopts))]
    # the spec block's deadline is the H-2 slices still in hand
    assert budgets and all(b == H - 2 for b in budgets)
    # adoptions are accounted under their own kind with an H-block budget
    # (they put H blocks of audio in hand at once, like a horizon build);
    # they must NOT be charged as 1-block emits — the adoption wait is
    # the chain's upload future, not lost audio
    by_kind = eng.slo.by_kind
    assert "adopt" in by_kind and by_kind["adopt"][1] == len(adopts)
    assert by_kind["emit"][1] == eng.slo.total_blocks - len(starts) \
        - len(adopts) - len(specs) - by_kind.get("idle", [0, 0])[1] \
        - by_kind.get("per_block", [0, 0])[1]


def test_event_discards_spec_horizon():
    """An event mid-emission discards BOTH the live horizon and the
    speculative successor (built from a now-unreachable end state);
    output must still equal per-block exactly."""
    script = {0: lambda e, c: _play(e, c),
              # block 25: mid-horizon of the second pipelined horizon
              25: lambda e, c: _play(e, c, note=71, channel=5)}
    on, pk_on, eng = _run_script("auto", script)
    off, pk_off, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)


def test_pool_mirror_tracks_emission_frontier():
    """Emission syncs the pool mirror eagerly (per-slice snapshot restore),
    so positions/progress always reflect the audio actually delivered —
    mid-horizon the pool must equal a per-block engine's pool exactly."""
    eng, clip = _engine("auto")
    eng_off, clip_off = _engine(0)
    _play(eng, clip)
    _play(eng_off, clip_off)
    for _ in range(20):
        res = eng.process_block()
        eng_off.process_block()
    assert eng._h_slices and eng._h_cursor < len(eng._h_slices), \
        "expected to be mid-horizon"
    np.testing.assert_array_equal(eng.pool.pos_int, eng_off.pool.pos_int)
    np.testing.assert_array_equal(eng.pool.pos_frac, eng_off.pool.pos_frac)
    np.testing.assert_array_equal(eng.pool.env, eng_off.pool.env)
    eng.update_session(res)  # must not disturb the mirror
    np.testing.assert_array_equal(eng.pool.pos_int, eng_off.pool.pos_int)


def test_lookahead_with_bq_short_loop():
    """A 1-tick beat-quantized loop wraps ~5x inside a 16x128 horizon;
    the per-slice programs carry each block's own wrap schedule, so the
    horizon must match per-block dispatch exactly."""
    def play_bq(e, c):
        c.length_beats = 0.0
        _play(e, c)

    script = {0: play_bq}
    on, _, eng = _run_script("auto", script)
    off, _, _ = _run_script(0, script)
    np.testing.assert_array_equal(on, off)


@pytest.mark.parametrize("seed", [7, 2024])
def test_random_traffic_differential(seed):
    """Randomized differential fuzz: the SAME seeded command stream through
    a lookahead engine and a per-block engine must produce the same audio
    and voice peaks (f32 tolerance — the horizon extrapolates positions
    over a longer window). This hammers the preemption/catch-up machinery
    at arbitrary phases: notes mid-horizon, BPM jumps, transport toggles,
    strip mutations, lane freezes, stop-all."""
    def build():
        eng = AudioEngine(block_frames=128, num_voices=32, backend="jax",
                          lookahead="auto")
        clips = [ClipAudioSource(eng, audio=_tone(0.08 + 0.11 * i,
                                                  150.0 + 90 * i))
                 for i in range(4)]
        eng.start_transport(bpm=120)
        return eng, clips

    def drive(eng, clips, rng, blocks):
        outs, peaks = [], []
        for _ in range(blocks):
            roll = rng.random()
            clip = clips[int(rng.integers(0, len(clips)))]
            ch = int(rng.integers(0, 10))
            if roll < 0.10:
                cmd = ClipCommand.channel(clip.id, ch)
                cmd.midi_note = int(rng.integers(40, 80))
                cmd.start_playback = True
                cmd.looping = bool(rng.integers(0, 2))
                cmd.change_looping = cmd.looping
                eng.schedule_clip_command(cmd, int(rng.integers(0, 6)))
            elif roll < 0.14:
                cmd = ClipCommand.channel(clip.id, ch)
                cmd.midi_note = int(rng.integers(40, 80))
                cmd.stop_playback = True
                eng.schedule_clip_command(cmd, int(rng.integers(0, 4)))
            elif roll < 0.16:
                eng.set_bpm(float(rng.uniform(60, 180)))
            elif roll < 0.18:
                eng.set_strip(int(rng.integers(-1, 10)),
                              dry=float(rng.uniform(0.2, 1)),
                              pan=float(rng.uniform(-1, 1)))
            elif roll < 0.19:
                eng.lane_enabled[int(rng.integers(0, 12))] = bool(
                    rng.integers(0, 2))
            elif roll < 0.20 and eng.transport_running:
                eng.stop_transport()
            elif roll < 0.21 and not eng.transport_running:
                eng.start_transport()
            res = eng.process_block()
            outs.append(np.asarray(res.outputs.master))
            peaks.append(np.asarray(res.outputs.voice_peaks))
        return np.concatenate(outs), np.stack(peaks)

    from tests._budget import fuzz_blocks

    blocks = fuzz_blocks(quick=110, full=180)
    eng_on, clips_on = build()
    on, pk_on = drive(eng_on, clips_on, np.random.default_rng(seed), blocks)
    eng_off, clips_off = build()
    eng_off._lookahead = 0
    off, pk_off = drive(eng_off, clips_off, np.random.default_rng(seed),
                        blocks)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)
    # both engines agree on the end state (emission syncs the mirror
    # eagerly, so no reconciliation step is needed)
    np.testing.assert_array_equal(eng_on.pool.active, eng_off.pool.active)
    np.testing.assert_array_equal(eng_on.pool.pos_int, eng_off.pool.pos_int)


# --- compact dynamics encoding (ops/voice.pack_horizon_dynamics) ---------


def test_release_none_sentinel_matches_voicestate():
    """The 16-bit release-frame sentinel decodes to voicestate's _BIG; the
    two constants must stay equal or the round trip silently corrupts."""
    from libzl_tpu.engine import voicestate
    from libzl_tpu.ops import voice as voice_ops

    assert voice_ops.RELEASE_NONE == voicestate._BIG


def _sim_horizon_programs(eng, H):
    """Build H consecutive per-block programs by the host sim (the numpy
    voice machine — exactly what engine._start_horizon simulates)."""
    from libzl_tpu.ops.voice import pack_program

    pool, clock = eng.pool, eng.clock
    lane = eng.lane_enabled.copy()
    start0 = float(clock.sample_position)
    packed = []
    for h in range(H):
        prog = pool.build_program(
            block_start_sample=start0 + h * eng.block_frames,
            tick_anchor_sample=clock.anchor_sample,
            tick_anchor=clock.anchor_tick,
            samples_per_tick=clock.samples_per_tick,
            lane_enabled=lane,
        )
        packed.append(pack_program(prog))
        pool.advance(prog)
    return packed


def test_compact_dynamics_reconstruction_bit_exact():
    """Golden numpy proof of the compact horizon upload: every slice
    reconstructed from (base program + dynamics) renders bit-identically
    to the host-built per-block program it encodes — including a slice-0
    note_off (rel_rate fixes at the trigger: the one pool field advance()
    mutates mid-horizon, voicestate.advance), mid-horizon voice deaths
    (one-shots), auto-releases, and positional + beat-quantized wraps."""
    from libzl_tpu.engine import render as render_mod
    from libzl_tpu.ops import voice as voice_ops

    eng, clip = _engine("auto", voices=32)
    short = ClipAudioSource(eng, audio=_tone(0.05, 330.0))
    _play(eng, clip, note=60, channel=0)              # steady loop
    _play(eng, short, note=72, channel=1)             # short positional loop
    # one-shot on the 0.05 s clip at +1 octave: ~9 blocks to the hard stop,
    # so it auto-releases and DIES inside the 16-block horizon
    _play(eng, short, note=72, channel=2, loop=False)
    bq = ClipAudioSource(eng, audio=_tone(0.3, 110.0))
    bq.length_beats = 1.0
    _play(eng, bq, note=50, channel=3)                # beat-quantized loop
    for _ in range(5):
        eng.process_block()
    eng._discard_horizon()
    # a pending note_off on the build block (the rebuild-on-event case):
    # its linear release fixes rel_rate during slice 0's advance
    v = int(np.flatnonzero(eng.pool.active)[0])
    eng.pool.note_off(v, tail=True, frame_offset=7)

    H = 16
    B = eng.block_frames
    packed = _sim_horizon_programs(eng, H)
    dyn = voice_ops.pack_horizon_dynamics(packed[1:], eng.pool.istart)
    assert dyn is not None
    assert dyn.dtype == np.int32
    base = voice_ops.fuse_packed(*packed[0])
    recs = voice_ops.horizon_programs(np, base, dyn, H, B)

    sound = eng._sound_data_for_backend()
    if not isinstance(sound, np.ndarray):
        sound = np.asarray(sound)
    strips = voice_ops.unpack_strips(
        voice_ops.pack_strips(eng.strips)
    )
    died_any = False
    for h in range(H):
        pi, pf = packed[h]
        true_prog = voice_ops.unpack_program(pi, pf)
        died_any |= bool(
            (np.asarray(true_prog.stop_frame) < B).any())
        want = render_mod.render_block_math(
            np, sound, true_prog, strips, B)
        got = render_mod.render_block_math(
            np, sound, recs[h], strips, B)
        for name, a, b in zip(want._fields, want, got):
            np.testing.assert_array_equal(
                a, b, err_msg=f"slice {h} field {name}")
        # active rows must reconstruct every program column bit-for-bit
        act = np.asarray(true_prog.active) != 0
        rpi, rpf = voice_ops.pack_program(recs[h])
        np.testing.assert_array_equal(pi[act], rpi[act],
                                      err_msg=f"slice {h} ints")
        np.testing.assert_array_equal(pf[act].view(np.int32),
                                      rpf[act].view(np.int32),
                                      err_msg=f"slice {h} floats")
    assert died_any, "fixture never exercised a mid-horizon death"


def test_unencodable_dynamics_fall_back_to_per_block():
    """A program the compact encoding cannot carry makes
    pack_horizon_dynamics return None, and the engine transparently
    dispatches per-block with the pool state intact (audio unchanged)."""
    from libzl_tpu.ops import voice as voice_ops

    # direct: a release frame neither in-block nor "none"
    eng, clip = _engine(0, voices=8)
    _play(eng, clip)
    eng.process_block()
    packed = _sim_horizon_programs(eng, 2)
    pi, pf = packed[1]
    pi = pi.copy()
    pi[0, voice_ops.PI_RELEASE] = 0x20000  # in (0xFFFF, RELEASE_NONE)
    assert voice_ops.pack_horizon_dynamics(
        [(pi, pf)], eng.pool.istart) is None

    # direct: any 16-bit-packed frame field out of range (a block size
    # beyond 0xFFFF) must refuse the encoding, not wrap bits silently
    pi2, pf2 = packed[1]
    cols = [voice_ops.PI_SEG_START + 1, voice_ops.PI_STOP]
    if pi2.shape[1] > voice_ops.PI_BQ:  # bq columns exist at this geometry
        cols.append(voice_ops.PI_BQ)
    for col in cols:
        bad = pi2.copy()
        bad[0, col] = 0x10000
        assert voice_ops.pack_horizon_dynamics(
            [(bad, pf2)], eng.pool.istart) is None, f"col {col}"

    # engine-level: force the failure (in whichever sim implementation the
    # engine uses — the native one-call horizon or the numpy packer);
    # output must equal per-block dispatch
    from libzl_tpu.engine import hostcore as hostcore_mod

    script = {0: lambda e, c: _play(e, c)}
    off, pk_off, _ = _run_script(0, script, blocks=40)
    orig = voice_ops.pack_horizon_dynamics
    orig_native = hostcore_mod.horizon_update
    try:
        voice_ops.pack_horizon_dynamics = lambda *a, **k: None
        hostcore_mod.horizon_update = lambda *a, **k: None
        on, pk_on, eng_on = _run_script("auto", script, blocks=40)
    finally:
        voice_ops.pack_horizon_dynamics = orig
        hostcore_mod.horizon_update = orig_native
    assert not eng_on._h_slices, "horizon must not engage when unencodable"
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(pk_on, pk_off)


def test_spec_pool_sync_from_mirrors_and_stays_identity_stable():
    """sync_from must mirror EVERY pool field by content while keeping the
    destination's array identities (the native host core's pointer cache
    is keyed on them, hostcore._build_state) and must never copy the
    pointer cache itself — it holds raw addresses into the OWNING pool's
    buffers (engine._maybe_build_spec worker-side sim)."""
    from libzl_tpu.engine.voicestate import VoicePool

    rng = np.random.default_rng(7)
    src = VoicePool(16, 128, 48000.0)
    for v in range(10):
        src.note_on(
            v, clip_id=v, midi_note=int(rng.integers(40, 80)),
            midi_channel=0, lane=v % 12, base=1000 * v, length=48000,
            source_rate=48000.0, root_note=60, start_sec=0.0, stop_sec=1.0,
            gain=0.5, clip_volume=1.0, pan=0.1, attack=0.01, decay=0.05,
            sustain=0.7, release=0.2, looping=bool(v % 2),
            length_beats=2.0, start_tick=0,
        )
    src._hostcore_state_cache = ("sentinel", [], None)

    dst = VoicePool(16, 128, 48000.0)
    before_ids = {k: id(v) for k, v in dst.__dict__.items()
                  if isinstance(v, np.ndarray)}
    dst.sync_from(src)
    for k, v in src.__dict__.items():
        if k == "_hostcore_state_cache":
            continue
        got = dst.__dict__[k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got, v, err_msg=k)
            assert got is not v, f"{k} aliases the source pool"
            assert id(got) == before_ids[k], f"{k} identity rebound"
        else:
            assert got == v, k
    assert "_hostcore_state_cache" not in dst.__dict__
    assert dst._next_position_id == src._next_position_id

    # a lazily-created source scratch array appears on the destination
    prog = src.build_program(
        block_start_sample=0.0, tick_anchor_sample=0.0, tick_anchor=0,
        samples_per_tick=100.0, lane_enabled=np.ones(12, bool),
    )
    src.advance(prog)
    dst2 = VoicePool(16, 128, 48000.0)
    dst2.sync_from(src)
    np.testing.assert_array_equal(dst2._stop_frames, src._stop_frames)
    assert dst2._stop_frames is not src._stop_frames


def test_discarded_spec_build_early_exits_on_worker():
    """An event that discards the speculation while its build is still
    QUEUED on the sim worker must cancel the build (generation check) —
    orphan builds burned ~10 ms of worker time each and queued real
    builds behind them, surfacing as emit-block SLO misses in event
    storms (round-5 storm soak regression)."""
    import threading

    eng, clip = _engine("auto")
    _play(eng, clip)
    for _ in range(4):
        eng.process_block()  # horizon at block 3
    sims = []
    orig_sim = type(eng)._sim_horizon_bundle

    def spy(self, *a, **k):
        sims.append(k.get("pool") is not None or len(a) > 1)
        return orig_sim(self, *a, **k)

    eng._sim_horizon_bundle = spy.__get__(eng)

    # jam the sim worker so the chain's first step cannot start before
    # the discard
    gate = threading.Event()
    blocker = eng._spec_sim_executor().submit(gate.wait, 5.0)
    eng.process_block()  # h_cursor==2: chain launched behind the blocker
    assert eng._spec_built_this_block
    chain = eng._h_next
    assert chain is not None
    eng._mark_event()  # discard: bumps the spec generation + kills chain
    gate.set()
    blocker.result()
    # drain the sim executor: the queued step must observe the stale
    # generation and finish without simming
    eng._spec_sim_executor().submit(lambda: None).result()
    assert chain.dead and chain.entries.empty(), \
        "orphaned chain must terminate without producing entries"
    assert not sims, "orphaned build must never run the horizon sim"


def test_spec_depth_fixed_near_events():
    """Speculation depth must stay at the configured value even right
    after an event: the pump renders in bursts, and a depth-1 chain refills only at
    adoption, so exhaustion inside a burst waits the full horizon upload
    against a 1-block budget. The generation guards already make deep
    chains cheap to discard."""
    eng, clip = _engine("auto")
    _play(eng, clip)
    for _ in range(5):
        eng.process_block()
    chain = eng._h_next
    assert chain is not None
    assert eng._blocks_since_event < 4 * eng._lookahead
    assert chain._depth_now() == chain.depth == type(chain).DEFAULT_DEPTH


def test_slo_worst_records_miss_context():
    """A deadline miss snapshots its dispatch context (kind, horizon
    cursor, blocks-since-event, chain state) into stats()['slo_worst'],
    bounded at SLO_WORST_KEEP entries, worst-first."""
    eng, clip = _engine("auto")
    _play(eng, clip)
    eng.process_block()
    eng.slo.budget = 0.0  # every subsequent block misses its deadline
    for _ in range(eng.SLO_WORST_KEEP + 8):
        eng.process_block()
    worst = eng.stats()["slo_worst"]
    assert 0 < len(worst) <= eng.SLO_WORST_KEEP
    assert all(r["ms"] >= worst[-1]["ms"] for r in worst)
    rec = worst[0]
    for key in ("kind", "ms", "budget_blocks", "block", "h_cursor",
                "blocks_since_event", "chain"):
        assert key in rec
    assert rec["kind"] in ("emit", "horizon", "event_rebuild", "adopt",
                           "spec", "per_block", "idle")
