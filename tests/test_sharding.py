"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest


def test_dryrun_multichip_8():
    import jax

    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_device_info_reports_mesh_devices():
    """Under an explicit mesh the engine reports the MESH's devices (the
    device check of libzl_tpu.device), and places the sound bank and the
    strips once, replicated over every device of the mesh."""
    from libzl_tpu.engine.engine import AudioEngine
    from libzl_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(8)
    engine = AudioEngine(
        sample_rate=48000,
        block_frames=128,
        num_voices=64,
        backend="jax",
        mesh=mesh,
    )
    stats = engine.stats()
    assert stats["backend"] == "jax"
    assert stats["platform"] == "cpu" and stats["device_count"] == 8
    sound = engine._sound_data_for_backend()
    strips = engine._packed_strips_for_backend()
    for arr in (sound, strips):
        assert arr.sharding.is_fully_replicated
        assert set(arr.devices()) == set(mesh.devices.flat)
    # cached: the next block reuses the placed arrays
    assert engine._sound_data_for_backend() is sound
    assert engine._packed_strips_for_backend() is strips
def test_sharded_matches_single_device():
    import jax

    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    from libzl_tpu.parallel.sharding import make_mesh, make_sharded_render

    sound, prog, strips = ge._example_inputs(64, 128, 1 << 12)
    mesh8 = make_mesh(8)
    mesh1 = make_mesh(1)
    out8 = make_sharded_render(mesh8)(sound, prog, strips)
    out1 = make_sharded_render(mesh1)(sound, prog, strips)
    np.testing.assert_allclose(
        np.asarray(out8.master), np.asarray(out1.master), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(out8.voice_peaks), np.asarray(out1.voice_peaks), rtol=1e-5
    )


def test_entry_compiles():
    import jax

    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    master = np.asarray(out.master)
    assert master.shape == (128, 2)
    assert np.isfinite(master).all() and np.abs(master).max() > 0


def test_engine_on_mesh_matches_single_device():
    """AudioEngine(mesh=...) renders identically to the unsharded engine."""
    import jax
    import numpy as np2

    from libzl_tpu.engine.engine import AudioEngine
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource
    from libzl_tpu.parallel.sharding import make_mesh

    def run(mesh):
        # lookahead=0: this pins the sharded per-block reduction; the
        # mesh+horizon composition has its own bit-equal differential
        # (test_randomized_session_mesh_lookahead_bit_equal)
        engine = AudioEngine(
            sample_rate=48000, backend="jax", num_voices=32, mesh=mesh,
            lookahead=0,
        )
        t = np2.arange(12000) / 48000
        clip = ClipAudioSource(
            engine,
            audio=AudioData(
                (0.4 * np2.sin(2 * np2.pi * 330 * t)).astype(np2.float32)[:, None],
                48000,
            ),
        )
        engine.start_transport(bpm=120)
        for ch in range(4):
            clip.play(loop=True, midi_channel=ch)
        out = []
        for _ in range(40):
            res = engine.process_block()
            out.append(np2.asarray(res.outputs.master))
        return np2.concatenate(out, axis=0)

    sharded = run(make_mesh(8))
    single = run(None)
    np2.testing.assert_allclose(sharded, single, atol=1e-6)


def _run_random_session(mesh, blocks=30, seed=3, lookahead=0):
    """A randomized session: several clips, random notes/channels/pans,
    volumes and strip settings, live voices across lanes.

    lookahead=0 isolates the sharded reduction (per-block dispatch on both
    sides); the horizon composition is exercised by
    test_randomized_session_mesh_lookahead_bit_equal — exact since round
    4's horizon ships real per-block programs, not an extrapolation."""
    import numpy as np

    from libzl_tpu.engine.commands import ClipCommand
    from libzl_tpu.engine.engine import AudioEngine
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource

    rng = np.random.default_rng(seed)
    engine = AudioEngine(
        sample_rate=48000, backend="jax", num_voices=32, mesh=mesh,
        lookahead=lookahead,
    )
    engine.set_strip(2, dry=0.8, pan=0.3)
    engine.set_strip(5, wet1=0.4)
    clips = []
    for i in range(4):
        n = int(rng.integers(4000, 16000))
        t = np.arange(n) / 48000
        w = (0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t)).astype(np.float32)
        clips.append(
            ClipAudioSource(engine, audio=AudioData(w[:, None], 48000))
        )
        clips[-1].set_pan(float(rng.uniform(-1, 1)))
    engine.start_transport(bpm=132)
    for v in range(12):
        clip = clips[v % 4]
        cmd = ClipCommand.channel(clip.id, int(rng.integers(0, 10)))
        cmd.midi_note = int(rng.integers(48, 72))
        cmd.change_volume = True
        cmd.volume = float(rng.uniform(0.3, 1.0))
        cmd.looping = bool(v % 2)
        cmd.start_playback = True
        engine.schedule_clip_command(cmd, int(rng.integers(0, 12)))
    masters, peaks, rms = [], [], []
    for _ in range(blocks):
        res = engine.process_block()
        masters.append(np.asarray(res.outputs.master))
        peaks.append(np.asarray(res.outputs.lane_peaks))
        rms.append(np.asarray(res.outputs.lane_rms))
    return (
        np.concatenate(masters, axis=0),
        np.stack(peaks),
        np.stack(rms),
    )


def test_shardmap_render_matches_insharding_render():
    """The shard_map packed render (explicit local render + psum mixdown)
    must be bit-equal to the jit+in_shardings variant, and render the
    host's planar [2, N] bank exactly as the device's interleaved [N, 2]
    rows."""
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    from libzl_tpu.ops.voice import fuse_packed, pack_program, pack_strips
    from libzl_tpu.parallel.sharding import (
        make_mesh,
        make_shardmap_packed_render,
        make_sharded_packed_render,
    )

    sound, prog, strips = ge._example_inputs(64, 128, 1 << 12)
    pi, pf = pack_program(prog)
    fused = fuse_packed(pi, pf)
    sp = pack_strips(strips)
    mesh = make_mesh(8)
    o_map = make_shardmap_packed_render(mesh, 128)(
        np.ascontiguousarray(sound.T), fused, sp
    )
    o_jit = make_sharded_packed_render(mesh, 128)(
        np.ascontiguousarray(sound.T), pi, pf, sp
    )
    np.testing.assert_array_equal(
        np.asarray(o_map.master), np.asarray(o_jit.master)
    )
    np.testing.assert_array_equal(
        np.asarray(o_map.voice_peaks), np.asarray(o_jit.voice_peaks)
    )
    # planar bank per shard
    o_planar = make_shardmap_packed_render(mesh, 128)(sound, fused, sp)
    np.testing.assert_array_equal(
        np.asarray(o_planar.master), np.asarray(o_map.master)
    )


@pytest.mark.parametrize("n_devices", [1, 2, 8])
def test_randomized_session_sharded_equals_unsharded(n_devices):
    """Master mix and meters from a mesh-sharded engine must be
    bit-identical to the unsharded engine across mesh sizes {1,2,8}: the
    per-lane mixdown contraction (one-hot matmul + psum) is arranged so the
    reduction order over voices is mesh-invariant."""
    from libzl_tpu.parallel.sharding import make_mesh

    m_ref, p_ref, r_ref = _run_random_session(None)
    m, p, r = _run_random_session(make_mesh(n_devices))
    np.testing.assert_array_equal(m, m_ref)
    np.testing.assert_array_equal(p, p_ref)
    np.testing.assert_array_equal(r, r_ref)


def test_randomized_session_mesh_lookahead_bit_equal():
    """The lookahead horizon composes with a mesh and
    stays BIT-exact: the same randomized session through a mesh-sharded
    lookahead engine must produce identical audio and meters to the
    unsharded per-block engine (the horizon sims real per-block programs
    and the sharded mixdown's reduction order is mesh-invariant, so the
    two perf levers compose without any numeric drift)."""
    from libzl_tpu.parallel.sharding import make_mesh

    m_ref, p_ref, r_ref = _run_random_session(None)
    m, p, r = _run_random_session(make_mesh(8), lookahead="auto")
    np.testing.assert_array_equal(m, m_ref)
    np.testing.assert_array_equal(p, p_ref)
    np.testing.assert_array_equal(r, r_ref)


def test_mesh_bucket_ladder_matches_full_pool():
    """Per-shard bucket ladder (sparse session on a sharded pool): the
    prefix-bucket dispatch must produce the identical master to full-pool
    dispatch, and must actually engage (voice_peaks at the bucket size)."""
    import numpy as np

    from libzl_tpu.engine.engine import AudioEngine
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource
    from libzl_tpu.parallel.sharding import make_mesh

    def run(voice_buckets):
        # lookahead=0 pins the bucket ladder itself (half the compiled
        # graphs); ladder-under-horizon engagement on a mesh is covered
        # by dryrun_multichip + the mesh lookahead differential
        engine = AudioEngine(
            sample_rate=48000, backend="jax", num_voices=128,
            mesh=make_mesh(8), voice_buckets=voice_buckets, lookahead=0,
        )
        t = np.arange(9000) / 48000
        clip = ClipAudioSource(
            engine,
            audio=AudioData(
                (0.4 * np.sin(2 * np.pi * 260 * t)).astype(np.float32)[:, None],
                48000,
            ),
        )
        engine.start_transport(bpm=120)
        for ch in range(3):
            clip.play(loop=True, midi_channel=ch)
        out, last = [], None
        for _ in range(25):
            last = engine.process_block()
            out.append(np.asarray(last.outputs.master))
        return np.concatenate(out, axis=0), last, engine

    bucketed, last_b, eng_b = run("auto")
    full, last_f, _ = run("off")
    assert eng_b._bucket_ladder is not None
    # 3 active voices on a 128 pool over 8 shards -> 64-voice bucket
    assert np.asarray(last_b.outputs.voice_peaks).shape[0] == 64
    assert np.asarray(last_f.outputs.voice_peaks).shape[0] == 128
    np.testing.assert_allclose(bucketed, full, atol=1e-6)
    # session update path tolerates the short sharded peaks
    eng_b.update_session(last_b)
