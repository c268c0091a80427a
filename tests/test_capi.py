"""C ABI integration: build native/libzl.so and drive it via ctypes the way
the reference's test clients do (SURVEY.md §4) — in a subprocess, since the
shim owns process-global engine state."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
NATIVE = REPO / "native"

CLIENT = r"""
import ctypes, os, sys, time
import numpy as np
sys.path.insert(0, os.environ["ZL_REPO"])

# make a test clip first (pure python, before loading the shim)
from libzl_tpu.io.wav import write_wav, read_wav
sr = 48000
t = np.arange(sr) / sr
write_wav(os.environ["ZL_WAV"], (0.5*np.sin(2*np.pi*330*t)).astype(np.float32), sr)

zl = ctypes.CDLL(os.environ["ZL_SO"])
zl.ClipAudioSource_new.restype = ctypes.c_void_p
zl.ClipAudioSource_new.argtypes = [ctypes.c_char_p, ctypes.c_bool]
zl.ClipAudioSource_byID.restype = ctypes.c_void_p
zl.ClipAudioSource_getDuration.restype = ctypes.c_float
zl.ClipAudioSource_getDuration.argtypes = [ctypes.c_void_p]
zl.ClipAudioSource_getFileName.restype = ctypes.c_char_p
zl.ClipAudioSource_getFileName.argtypes = [ctypes.c_void_p]
zl.ClipAudioSource_id.argtypes = [ctypes.c_void_p]
zl.ClipAudioSource_play.argtypes = [ctypes.c_void_p, ctypes.c_bool]
zl.ClipAudioSource_stop.argtypes = [ctypes.c_void_p]
zl.ClipAudioSource_setVolume.argtypes = [ctypes.c_void_p, ctypes.c_float]
zl.ClipAudioSource_setProgressCallback.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
zl.dBFromVolume.restype = ctypes.c_float
zl.dBFromVolume.argtypes = [ctypes.c_float]
zl.JackPassthrough_getDryAmount.restype = ctypes.c_float

zl.initJuce()
clip = zl.ClipAudioSource_new(os.environ["ZL_WAV"].encode(), False)
assert clip, "clip creation failed"
cid = zl.ClipAudioSource_id(clip)
assert zl.ClipAudioSource_byID(cid) == clip
dur = zl.ClipAudioSource_getDuration(clip)
assert abs(dur - 1.0) < 1e-3, dur
name = zl.ClipAudioSource_getFileName(clip).decode()
assert name.endswith(".wav"), name

progress_hits = []
@ctypes.CFUNCTYPE(None, ctypes.c_float)
def on_progress(v):
    progress_hits.append(v)
zl.ClipAudioSource_setProgressCallback(clip, ctypes.cast(on_progress, ctypes.c_void_p))

# record the global playback while playing the clip via the C API
zl.AudioLevels_setRecordGlobalPlayback(True)
zl.AudioLevels_setGlobalPlaybackFilenamePrefix(os.environ["ZL_OUT"].encode())
zl.AudioLevels_startRecording()
assert zl.AudioLevels_isRecording()

zl.SyncTimer_startTimer(120)  # the argument is a BPM (SyncTimer.cpp:869-872)
zl.ClipAudioSource_play(clip, True)
# deterministic drive: the shim shares this interpreter, so the bridge
# runtime is reachable directly — step exact block counts instead of
# sleeping wall-clock time (LIBZL_TPU_NO_PUMP is set by the test env)
from libzl_tpu.capi import bridge
rt = bridge._rt()
assert rt._pump is None, "NO_PUMP must be in effect for the deterministic drive"
rt.step_blocks(400)
zl.ClipAudioSource_stop(clip)
rt.step_blocks(120)
zl.AudioLevels_stopRecording()
zl.SyncTimer_stopTimer()

# short wall-clock pump smoke (full pump coverage lives in
# test_pump_block_sequence_integrity)
rt.start_pump()
time.sleep(0.2)
rt.stop_pump()

# passthrough API round trip
zl.JackPassthrough_setDryAmount(3, ctypes.c_float(0.5))
assert abs(zl.JackPassthrough_getDryAmount(3) - 0.5) < 1e-6
assert abs(zl.dBFromVolume(ctypes.c_float(1.0))) < 1e-6

out = read_wav(os.environ["ZL_OUT"])
peak = float(np.abs(out.samples).max())
assert out.num_frames == 520 * 128, out.num_frames  # exact: 520 stepped blocks
assert peak > 0.05, peak
assert progress_hits, "no progress callbacks fired"
zl.shutdownJuce()
print("CAPI-OK frames=%d peak=%.3f progress_hits=%d" % (out.num_frames, peak, len(progress_hits)))
"""


@pytest.fixture(scope="module")
def libzl_so():
    so = NATIVE / "libzl.so"
    subprocess.run(["make", "-C", str(NATIVE)], check=True,
                   capture_output=True)
    assert so.exists()
    return so


def test_ctypes_client_end_to_end(libzl_so, tmp_path):
    env = dict(os.environ)
    env.update(
        ZL_REPO=str(REPO),
        ZL_SO=str(libzl_so),
        ZL_WAV=str(tmp_path / "in.wav"),
        ZL_OUT=str(tmp_path / "out.wav"),
        LIBZL_TPU_BACKEND="numpy",
        LIBZL_TPU_VOICES="32",  # numpy fallback pace on CI hosts
        LIBZL_TPU_NO_PUMP="1",  # the client drives blocks deterministically
        JAX_PLATFORMS="cpu",
        PYTHONPATH=str(REPO),
    )
    proc = subprocess.run(
        [sys.executable, "-c", CLIENT],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CAPI-OK" in proc.stdout


def test_c_host_embedding(libzl_so, tmp_path):
    """True embedding: a C binary links libzl.so, initJuce boots the
    interpreter + engine, the clip API works, clean shutdown."""
    binary = tmp_path / "embed_smoke"
    subprocess.run(
        ["gcc", "-O1", "-o", str(binary), str(NATIVE / "embed_smoke.c"),
         "-I", str(NATIVE), "-L", str(NATIVE), "-l:libzl.so",
         f"-Wl,-rpath,{NATIVE}"],
        check=True, capture_output=True,
    )
    wav = tmp_path / "embed.wav"
    t = np.arange(48000) / 48000
    from libzl_tpu.io.wav import write_wav

    write_wav(wav, (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
              48000)
    env = dict(os.environ)
    env.update(
        PYTHONPATH=str(REPO),
        LIBZL_TPU_BACKEND="numpy",
        LIBZL_TPU_VOICES="32",
        JAX_PLATFORMS="cpu",
    )
    proc = subprocess.run(
        [str(binary), str(wav)], env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "EMBED-OK" in proc.stdout


@pytest.mark.parametrize("depth", [1, 3])
def test_pump_block_sequence_integrity(tmp_path, depth):
    """The pipelined pump (consume the oldest in-flight block only after
    dispatching the newest, LIBZL_TPU_PIPELINE deep) must deliver every
    rendered block to the recorder exactly once, in order, including the
    drained final blocks. A recorded linear ramp is a contiguous prefix of
    the source iff no block was dropped/dup'd/reordered."""
    import time

    import numpy as np

    from libzl_tpu.capi import bridge
    from libzl_tpu.io.wav import read_wav, write_wav

    sr = 48000
    n = sr * 2
    ramp = (np.arange(1, n + 1, dtype=np.float32) / n * 0.5)[:, None]
    src = tmp_path / "ramp.wav"
    rec = tmp_path / "rec.wav"
    write_wav(src, ramp, sr)

    os.environ["LIBZL_TPU_BACKEND"] = "numpy"
    os.environ["LIBZL_TPU_VOICES"] = "32"
    os.environ["LIBZL_TPU_PIPELINE"] = str(depth)
    try:
        bridge.init_engine(pump=True)
        cid = bridge.clip_new(str(src))
        bridge.levels_set_record_global_playback(True)
        bridge.levels_set_global_playback_filename_prefix(str(rec))
        bridge.levels_start_recording()
        bridge.clip_play(cid, False, 0)  # one-shot at root: ratio 1.0
        # the pump is wall-paced but CI hosts render slower than realtime:
        # poll until enough blocks are through rather than sleeping a fixed
        # wall time
        engine = bridge._rt().engine
        target = engine.total_blocks + 60
        deadline = time.monotonic() + 20.0
        while engine.total_blocks < target and time.monotonic() < deadline:
            time.sleep(0.05)
        bridge.levels_stop_recording()
    finally:
        bridge.shutdown_engine()
        os.environ.pop("LIBZL_TPU_BACKEND", None)
        os.environ.pop("LIBZL_TPU_VOICES", None)
        os.environ.pop("LIBZL_TPU_PIPELINE", None)

    x = read_wav(rec).samples[:, 0]
    nz = np.flatnonzero(np.abs(x) > 0)
    assert nz.size > 1280, "too little audio recorded to judge"
    seg = x[nz[0] : nz[-1] + 1]
    # align to the source via a mid-segment sample (mono renders at 0.5x,
    # the M/S pan convention; first few ramp samples sit below the 16-bit
    # WAV resolution and record as true zeros)
    k = int(round(seg[1000] / 0.5 * n / 0.5)) - 1001
    assert 0 <= k < 64, f"head offset {k} outside quantization slack"
    expect = 0.5 * ramp[k : k + len(seg), 0]
    err = float(np.abs(seg - expect).max())
    assert err < 3.1e-5, f"block sequence broken (max dev {err})"


def test_bounce_drain_delivers_every_block_in_order(tmp_path):
    """LIBZL_TPU_BOUNCE_DRAIN=K: non-pacing sinks get K blocks per
    device->host sync (the bounce amortization, one fetch per K blocks) —
    the delivered stream must be bit-identical to per-block delivery,
    including the partial drain at stop and the per-block fallback when
    recording starts mid-run."""
    import numpy as np

    from libzl_tpu.capi.bridge import EngineRuntime
    from libzl_tpu.engine.commands import ClipCommand
    from libzl_tpu.io.sinks import AudioSink
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource

    class CaptureSink(AudioSink):
        pacing = False

        def __init__(self):
            self.blocks = []

        def write(self, block):
            self.blocks.append(np.array(block))

    sr = 48000
    n = sr
    ramp = (np.arange(1, n + 1, dtype=np.float32) / n * 0.5)[:, None]

    def run(drain, record_at=None):
        rt = EngineRuntime(sr, 128, 16, backend="numpy",
                           bounce_drain=drain)
        sink = CaptureSink()
        rt.set_sink(sink)
        clip = ClipAudioSource(rt.engine, audio=AudioData(ramp, sr))
        rt.engine.start_transport(bpm=120)
        cmd = ClipCommand.channel(clip.id, 0)
        cmd.midi_note = 60
        cmd.start_playback = True
        rt.engine.schedule_clip_command(cmd, 0)
        if record_at is None:
            rt.step_blocks(50)
        else:
            rt.step_blocks(record_at)
            rt.engine.levels.set_record_global_playback(True)
            rt.engine.levels.set_global_playback_filename_prefix(
                str(tmp_path / f"rec{drain}"))
            rt.engine.levels.start_recording()
            rt.step_blocks(50 - record_at)
            rt.engine.levels.stop_recording()
        return np.concatenate(sink.blocks, axis=0), len(sink.blocks)

    plain, n1 = run(1)
    drained, n2 = run(4)
    assert n1 == n2 == 50
    np.testing.assert_array_equal(drained, plain)
    # a partial drain tail (50 % 4 != 0) flushed at step_blocks end
    mid, n3 = run(6, record_at=21)  # recording starts mid-drain
    assert n3 == 50
    np.testing.assert_array_equal(mid, plain)


def test_bounce_drain_with_global_recording(tmp_path):
    """Global-playback recording rides the drain (fed from the batched
    master fetch): the recorded WAV must equal the per-block path's."""
    import numpy as np

    from libzl_tpu.capi.bridge import EngineRuntime
    from libzl_tpu.engine.commands import ClipCommand
    from libzl_tpu.io.sinks import NullSink
    from libzl_tpu.io.wav import AudioData, read_wav
    from libzl_tpu.models.clip import ClipAudioSource

    sr = 48000
    t = np.arange(sr // 2) / sr
    wave = (0.4 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)[:, None]

    def run(drain, tag):
        rt = EngineRuntime(sr, 128, 16, backend="numpy", bounce_drain=drain)
        rt.set_sink(NullSink())
        clip = ClipAudioSource(rt.engine, audio=AudioData(wave, sr))
        rt.engine.start_transport(bpm=120)
        cmd = ClipCommand.channel(clip.id, 0)
        cmd.midi_note = 60
        cmd.start_playback = True
        rt.engine.schedule_clip_command(cmd, 0)
        lv = rt.engine.levels
        assert not lv.only_global_recording()
        lv.set_record_global_playback(True)
        lv.set_global_playback_filename_prefix(
            str(tmp_path / f"rec_{tag}.wav"))
        rt._flush_drain()
        lv.start_recording()
        assert lv.only_global_recording()
        rt.step_blocks(40)
        rt._flush_drain()
        lv.stop_recording()
        return read_wav(str(tmp_path / f"rec_{tag}.wav")).samples

    plain = run(1, "plain")
    drained = run(5, "drained")
    assert plain.shape[0] == 40 * 128
    np.testing.assert_array_equal(drained, plain)


def test_pipelined_drain_async_jax(tmp_path):
    """On the jax backend the full-drain flush goes ASYNC: the batch's
    device->host copy starts immediately but delivery waits one drain
    window (the copy overlaps rendering). The delivered
    stream must still be bit-identical and in order, the in-flight batch
    must land on demanded flushes (record toggles, step_blocks end), and
    the one-window latency must be observable (that's the pipelining)."""
    import numpy as np

    from libzl_tpu.capi.bridge import EngineRuntime
    from libzl_tpu.engine.commands import ClipCommand
    from libzl_tpu.io.sinks import AudioSink
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource

    class CaptureSink(AudioSink):
        pacing = False

        def __init__(self):
            self.blocks = []

        def write(self, block):
            self.blocks.append(np.array(block))

    sr = 48000
    n = sr
    ramp = (np.arange(1, n + 1, dtype=np.float32) / n * 0.5)[:, None]

    def build(drain):
        rt = EngineRuntime(sr, 128, 16, backend="jax", bounce_drain=drain)
        sink = CaptureSink()
        rt.set_sink(sink)
        clip = ClipAudioSource(rt.engine, audio=AudioData(ramp, sr))
        rt.engine.start_transport(bpm=120)
        cmd = ClipCommand.channel(clip.id, 0)
        cmd.midi_note = 60
        cmd.start_playback = True
        rt.engine.schedule_clip_command(cmd, 0)
        return rt, sink

    rt1, sink1 = build(1)
    rt1.step_blocks(24)
    plain = np.concatenate(sink1.blocks, axis=0)

    rt4, sink4 = build(4)
    # step_blocks flushes at the end; drive _consume directly to observe
    # the mid-stream pipelining latency
    def pump(rt, k):
        for _ in range(k):
            with rt._lock:
                res = rt.engine.process_block()
                bno = rt.engine.total_blocks
            rt._consume(bno, res)

    pump(rt4, 8)   # two full drains: first went async, second delivers #1
    assert len(sink4.blocks) == 4, "first drain must pipeline, not deliver"
    assert rt4._pending_drain is not None
    pump(rt4, 10)  # blocks 9-16 drain; 17-18 buffered
    rt4._flush_drain()  # demanded: in-flight batch + partial tail land
    assert rt4._pending_drain is None
    assert len(sink4.blocks) == 18
    pump(rt4, 6)
    rt4._flush_drain()
    drained = np.concatenate(sink4.blocks, axis=0)
    assert len(sink4.blocks) == 24
    np.testing.assert_allclose(drained, plain, atol=1e-6)


def test_demanded_flush_races_pipelined_flush():
    """A demanded flush from an API thread (record toggles, set_sink) must
    SERIALIZE with the pump's pipelined flush — without the flush lock the
    API thread can pop the in-flight async batch and deliver it while the
    pump is still mid-delivery of the OLDER previous batch, interleaving
    sink writes out of block order. Hammer both paths concurrently and
    assert the delivered stream is exactly the per-block stream."""
    import threading

    import numpy as np

    from libzl_tpu.capi.bridge import EngineRuntime
    from libzl_tpu.engine.commands import ClipCommand
    from libzl_tpu.io.sinks import AudioSink
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource

    class CaptureSink(AudioSink):
        pacing = False

        def __init__(self):
            self.blocks = []
            self._wlock = threading.Lock()

        def write(self, block):
            # per-write atomicity only — ORDER across writes is the
            # engine's contract under test
            with self._wlock:
                self.blocks.append(np.array(block))

    sr = 48000
    n = sr
    ramp = (np.arange(1, n + 1, dtype=np.float32) / n * 0.5)[:, None]

    def build(drain):
        rt = EngineRuntime(sr, 128, 16, backend="jax", bounce_drain=drain)
        sink = CaptureSink()
        rt.set_sink(sink)
        clip = ClipAudioSource(rt.engine, audio=AudioData(ramp, sr))
        rt.engine.start_transport(bpm=120)
        cmd = ClipCommand.channel(clip.id, 0)
        cmd.midi_note = 60
        cmd.start_playback = True
        rt.engine.schedule_clip_command(cmd, 0)
        return rt, sink

    rt1, sink1 = build(1)
    rt1.step_blocks(96)
    plain = np.concatenate(sink1.blocks, axis=0)

    rt, sink = build(3)
    stop = threading.Event()

    def hammer():
        # the levels_start_recording / set_sink pattern: demanded flushes
        # at arbitrary points relative to the pump's pipelined flushes
        while not stop.is_set():
            rt._flush_drain()

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for _ in range(96):
            with rt._lock:
                res = rt.engine.process_block()
                bno = rt.engine.total_blocks
            rt._consume(bno, res)
    finally:
        stop.set()
        t.join(timeout=10)
    rt._flush_drain()
    raced = np.concatenate(sink.blocks, axis=0)
    assert len(sink.blocks) == 96
    np.testing.assert_allclose(raced, plain, atol=1e-6)


def test_drain_shape_warmup_precompiles_flush_concat():
    """_warm_drain_shapes must enumerate exactly the signatures the real
    drain windows hit: driving full pipelined flushes afterwards adds ZERO
    new compiles to the jitted concat (a mid-performance compile is
    seconds of pump stall)."""
    import numpy as np

    from libzl_tpu.capi import bridge
    from libzl_tpu.capi.bridge import EngineRuntime
    from libzl_tpu.engine.commands import ClipCommand
    from libzl_tpu.io.sinks import AudioSink
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.models.clip import ClipAudioSource

    class CaptureSink(AudioSink):
        pacing = False

        def __init__(self):
            self.blocks = []

        def write(self, block):
            self.blocks.append(np.array(block))

    sr = 48000
    ramp = (np.arange(1, sr + 1, dtype=np.float32) / sr * 0.5)[:, None]
    rt = EngineRuntime(sr, 128, 16, backend="jax", bounce_drain=4)
    sink = CaptureSink()
    rt.set_sink(sink)
    clip = ClipAudioSource(rt.engine, audio=AudioData(ramp, sr))

    rt._warm_drain_shapes()
    assert bridge._flat_concat_jit is not None
    warmed = bridge._flat_concat_jit._cache_size()
    assert warmed > 0

    def pump(n):
        for _ in range(n):
            with rt._lock:
                res = rt.engine.process_block()
                bno = rt.engine.total_blocks
            rt._consume(bno, res)

    # idle prefix FIRST: the idle shortcut's numpy zero outputs mix with
    # jax render outputs inside later drain batches — the mixed tuples
    # must not key fresh jit entries (the production pump idles before
    # the first note; observed re-compiles without the device_put
    # normalization in _concat_drain)
    pump(40)
    rt.engine.start_transport(bpm=120)
    cmd = ClipCommand.channel(clip.id, 0)
    cmd.midi_note = 60
    cmd.start_playback = True
    rt.engine.schedule_clip_command(cmd, 0)
    # full drain/cadence cycle (lcm(K=4, levels_every) windows) through
    # the REAL pipelined path, with live and idle blocks interleaved
    cycles = 4 * rt.engine._levels_every
    pump(2 * cycles)
    assert bridge._flat_concat_jit._cache_size() == warmed, (
        "pipelined flush hit a signature the warmup did not enumerate"
    )
    assert len(sink.blocks) > 0


CLIENT_FULL = r"""
import ctypes, os, sys
import numpy as np
sys.path.insert(0, os.environ["ZL_REPO"])

from libzl_tpu.io.wav import write_wav, read_wav
sr = 48000
t = np.arange(sr) / sr
write_wav(os.environ["ZL_WAV"], (0.5*np.sin(2*np.pi*330*t)).astype(np.float32), sr)

zl = ctypes.CDLL(os.environ["ZL_SO"])
CP = ctypes.c_void_p
for name, res, args in [
    ("ClipAudioSource_new", CP, [ctypes.c_char_p, ctypes.c_bool]),
    ("ClipAudioSource_byID", CP, [ctypes.c_int]),
    ("ClipAudioSource_id", ctypes.c_int, [CP]),
    ("ClipAudioSource_destroy", None, [CP]),
    ("ClipAudioSource_connectProgress", None, [CP, CP]),
    ("ClipAudioSource_playOnChannel", None, [CP, ctypes.c_bool, ctypes.c_int]),
    ("ClipAudioSource_stopOnChannel", None, [CP, ctypes.c_int]),
    ("ClipAudioSource_setStartPosition", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_setLength", None, [CP, ctypes.c_float, ctypes.c_int]),
    ("ClipAudioSource_setPan", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_setSpeedRatio", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_setPitch", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_setGain", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_setSlices", None, [CP, ctypes.c_int]),
    ("ClipAudioSource_setLoopCrossfade", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_keyZoneStart", ctypes.c_int, [CP]),
    ("ClipAudioSource_setKeyZoneStart", None, [CP, ctypes.c_int]),
    ("ClipAudioSource_keyZoneEnd", ctypes.c_int, [CP]),
    ("ClipAudioSource_setKeyZoneEnd", None, [CP, ctypes.c_int]),
    ("ClipAudioSource_rootNote", ctypes.c_int, [CP]),
    ("ClipAudioSource_setRootNote", None, [CP, ctypes.c_int]),
    ("ClipAudioSource_adsrAttack", ctypes.c_float, [CP]),
    ("ClipAudioSource_setADSRAttack", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_adsrDecay", ctypes.c_float, [CP]),
    ("ClipAudioSource_setADSRDecay", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_adsrSustain", ctypes.c_float, [CP]),
    ("ClipAudioSource_setADSRSustain", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_adsrRelease", ctypes.c_float, [CP]),
    ("ClipAudioSource_setADSRRelease", None, [CP, ctypes.c_float]),
    ("ClipAudioSource_setAudioLevelChangedCallback", None, [CP, CP]),
    ("SyncTimer_instance", CP, []),
    ("SyncTimer_getMultiplier", ctypes.c_int, []),
    ("SyncTimer_setBpm", None, [ctypes.c_uint]),
    ("SyncTimer_registerTimerCallback", None, [CP]),
    ("SyncTimer_deregisterTimerCallback", None, [CP]),
    ("SyncTimer_queueClipToStart", None, [CP]),
    ("SyncTimer_queueClipToStartOnChannel", None, [CP, ctypes.c_int]),
    ("SyncTimer_queueClipToStop", None, [CP]),
    ("SyncTimer_queueClipToStopOnChannel", None, [CP, ctypes.c_int]),
    ("stopClips", None, [ctypes.c_int, ctypes.POINTER(CP)]),
    ("AudioLevels_setShouldRecordPorts", None, [ctypes.c_bool]),
    ("AudioLevels_setRecordPortsFilenamePrefix", None, [ctypes.c_char_p]),
    ("AudioLevels_addRecordPort", None, [ctypes.c_char_p, ctypes.c_int]),
    ("AudioLevels_removeRecordPort", None, [ctypes.c_char_p, ctypes.c_int]),
    ("AudioLevels_clearRecordPorts", None, []),
    ("JackPassthrough_setPanAmount", None, [ctypes.c_int, ctypes.c_float]),
    ("JackPassthrough_getPanAmount", ctypes.c_float, [ctypes.c_int]),
    ("JackPassthrough_setWetFx1Amount", None, [ctypes.c_int, ctypes.c_float]),
    ("JackPassthrough_getWetFx1Amount", ctypes.c_float, [ctypes.c_int]),
    ("JackPassthrough_setWetFx2Amount", None, [ctypes.c_int, ctypes.c_float]),
    ("JackPassthrough_getWetFx2Amount", ctypes.c_float, [ctypes.c_int]),
    ("JackPassthrough_setMuted", None, [ctypes.c_int, ctypes.c_bool]),
    ("JackPassthrough_getMuted", ctypes.c_float, [ctypes.c_int]),
]:
    fn = getattr(zl, name)
    fn.restype = res
    fn.argtypes = args

assert zl.SyncTimer_instance() is None  # before initJuce: no runtime yet
zl.initJuce()
assert zl.SyncTimer_instance() is not None
assert zl.SyncTimer_getMultiplier() == 96
zl.registerGraphicTypes()                 # documented no-op, must not crash
zl.reloadZynthianConfiguration()

a = zl.ClipAudioSource_new(os.environ["ZL_WAV"].encode(), False)
b = zl.ClipAudioSource_new(os.environ["ZL_WAV"].encode(), False)
assert a and b

# in-process asserts: the shim shares this interpreter
from libzl_tpu.capi import bridge
from libzl_tpu.models.clip import clip_by_id
rt = bridge._rt()
engine = rt.engine
aid = zl.ClipAudioSource_id(a)
bid = zl.ClipAudioSource_id(b)
ca, cb = clip_by_id(aid), clip_by_id(bid)

# -- parameter round trips through the C marshalling layer --
zl.ClipAudioSource_setADSRAttack(a, 0.011)
zl.ClipAudioSource_setADSRDecay(a, 0.22)
zl.ClipAudioSource_setADSRSustain(a, 0.61)
zl.ClipAudioSource_setADSRRelease(a, 0.33)
for got, want in [(zl.ClipAudioSource_adsrAttack(a), 0.011),
                  (zl.ClipAudioSource_adsrDecay(a), 0.22),
                  (zl.ClipAudioSource_adsrSustain(a), 0.61),
                  (zl.ClipAudioSource_adsrRelease(a), 0.33)]:
    assert abs(got - want) < 1e-6, (got, want)
zl.ClipAudioSource_setADSRRelease(a, 0.02)  # keep voice teardown quick below
zl.ClipAudioSource_setKeyZoneStart(a, 10)
zl.ClipAudioSource_setKeyZoneEnd(a, 90)
zl.ClipAudioSource_setRootNote(a, 64)
assert zl.ClipAudioSource_keyZoneStart(a) == 10
assert zl.ClipAudioSource_keyZoneEnd(a) == 90
assert zl.ClipAudioSource_rootNote(a) == 64
zl.ClipAudioSource_setStartPosition(b, ctypes.c_float(0.1))
zl.ClipAudioSource_setLength(b, ctypes.c_float(2.0), 120)
zl.ClipAudioSource_setPan(b, ctypes.c_float(0.5))
zl.ClipAudioSource_setGain(b, ctypes.c_float(-3.0))
zl.ClipAudioSource_setSlices(b, 4)
zl.ClipAudioSource_setLoopCrossfade(b, ctypes.c_float(0.01))
zl.ClipAudioSource_setSpeedRatio(b, ctypes.c_float(1.25))
zl.ClipAudioSource_setPitch(b, ctypes.c_float(2.0))
assert abs(cb.start_position_seconds - 0.1) < 1e-6
assert abs(cb.length_beats - 2.0) < 1e-6
assert abs(cb.pan - 0.5) < 1e-6
assert abs(cb.gain_db - (-3.0)) < 1e-6
assert len(cb.slice_positions) == 4
assert abs(cb.loop_crossfade_seconds - 0.01) < 1e-6
assert abs(cb.speed_ratio - 1.25) < 1e-6
assert abs(cb.pitch_change - 2.0) < 1e-6
zl.ClipAudioSource_connectProgress(a, None)  # Qt plumbing: documented no-op

# -- passthrough strips: global (-1) and channel 3 --
for ch in (-1, 3):
    zl.JackPassthrough_setPanAmount(ch, ctypes.c_float(-0.25))
    zl.JackPassthrough_setWetFx1Amount(ch, ctypes.c_float(0.3))
    zl.JackPassthrough_setWetFx2Amount(ch, ctypes.c_float(0.7))
    assert abs(zl.JackPassthrough_getPanAmount(ch) + 0.25) < 1e-6
    assert abs(zl.JackPassthrough_getWetFx1Amount(ch) - 0.3) < 1e-6
    assert abs(zl.JackPassthrough_getWetFx2Amount(ch) - 0.7) < 1e-6
zl.JackPassthrough_setMuted(3, True)
assert zl.JackPassthrough_getMuted(3) == 1.0
zl.JackPassthrough_setMuted(3, False)
assert zl.JackPassthrough_getMuted(3) == 0.0

# -- callbacks + port recording while playing on a channel --
level_hits, timer_hits = [], []
@ctypes.CFUNCTYPE(None, ctypes.c_float)
def on_level(v):
    level_hits.append(v)
@ctypes.CFUNCTYPE(None, ctypes.c_int)
def on_tick(beat):
    timer_hits.append(beat)
zl.ClipAudioSource_setAudioLevelChangedCallback(a, ctypes.cast(on_level, CP))
zl.SyncTimer_registerTimerCallback(ctypes.cast(on_tick, CP))

zl.AudioLevels_setShouldRecordPorts(True)
zl.AudioLevels_setRecordPortsFilenamePrefix(os.environ["ZL_PORTS"].encode())
zl.AudioLevels_addRecordPort(b"lane:5", 0)   # midi channel 3 -> lane 5
zl.AudioLevels_addRecordPort(b"lane:5", 1)
zl.AudioLevels_addRecordPort(b"master", 0)
zl.AudioLevels_removeRecordPort(b"master", 0)
zl.AudioLevels_startRecording()
zl.SyncTimer_startTimer(200)
zl.ClipAudioSource_playOnChannel(a, True, 3)
rt.step_blocks(120)
zl.ClipAudioSource_stopOnChannel(a, 3)
rt.step_blocks(40)
zl.AudioLevels_stopRecording()
ports = read_wav(os.environ["ZL_PORTS"])
assert ports.samples.shape == (160 * 128, 2), ports.samples.shape
assert np.abs(ports.samples).max() > 0.05
assert level_hits, "audio-level callback never fired"
assert timer_hits and all(0 <= t < 384 for t in timer_hits), timer_hits[:5]
assert not engine.pool.active.any()
zl.AudioLevels_clearRecordPorts()
assert not engine.levels.record_ports

# -- bar-quantized queueing (SyncTimer.cpp:816-832 semantics) --
zl.SyncTimer_queueClipToStartOnChannel(b, 2)
rt.step_blocks(500)  # 384 ticks at 200 BPM = ~450 blocks
assert engine.pool.active.any(), "queued clip not playing after a bar"
zl.SyncTimer_queueClipToStopOnChannel(b, 2)
rt.step_blocks(540)
assert not engine.pool.active.any(), "queued stop did not land"
zl.SyncTimer_queueClipToStart(b)   # channel -1 variant
rt.step_blocks(500)
assert engine.pool.active.any()
zl.SyncTimer_queueClipToStop(b)
rt.step_blocks(540)
assert not engine.pool.active.any()

# -- stopClips array + deregistered timer callback goes quiet --
zl.ClipAudioSource_playOnChannel(a, True, 3)
zl.ClipAudioSource_playOnChannel(b, True, 2)
rt.step_blocks(20)
assert engine.pool.active.any()
arr = (CP * 2)(a, b)
zl.stopClips(2, arr)
rt.step_blocks(40)
assert not engine.pool.active.any(), "stopClips left voices playing"
zl.SyncTimer_setBpm(150)
assert abs(engine.bpm - 150.0) < 1e-6
zl.SyncTimer_deregisterTimerCallback(ctypes.cast(on_tick, CP))
n = len(timer_hits)
rt.step_blocks(50)
assert len(timer_hits) == n, "timer callback fired after deregistration"
zl.SyncTimer_stopTimer()

# -- env reload lands on the router --
os.environ["ZYNTHIAN_MIDI_FILTER_OUTPUT"] = "1"
zl.reloadZynthianConfiguration()
assert engine.router.filter_midi_out is True

# -- destroy invalidates the id registry --
zl.ClipAudioSource_destroy(b)
assert zl.ClipAudioSource_byID(bid) is None
assert zl.ClipAudioSource_byID(aid) is not None
zl.shutdownJuce()
print("CAPI-FULL-OK level_hits=%d timer_hits=%d" % (len(level_hits), n))
"""


def test_ctypes_full_symbol_surface(libzl_so, tmp_path):
    """Drive every public header symbol through the compiled shim (the 52
    symbols the end-to-end client doesn't touch): parameter marshalling
    round trips, callback trampolines, bar-quantized queueing, stopClips
    arrays, port recording, env reload, destroy/byID invalidation."""
    env = dict(os.environ)
    env.update(
        ZL_REPO=str(REPO),
        ZL_SO=str(libzl_so),
        ZL_WAV=str(tmp_path / "in.wav"),
        ZL_PORTS=str(tmp_path / "ports.wav"),
        LIBZL_TPU_BACKEND="numpy",
        LIBZL_TPU_VOICES="32",
        LIBZL_TPU_NO_PUMP="1",
        JAX_PLATFORMS="cpu",
        PYTHONPATH=str(REPO),
    )
    env.pop("ZYNTHIAN_MIDI_FILTER_OUTPUT", None)
    proc = subprocess.run(
        [sys.executable, "-c", CLIENT_FULL],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    assert "CAPI-FULL-OK" in proc.stdout


def test_bridge_quirk_gain_env(tmp_path):
    """LIBZL_TPU_QUIRK_GAIN=1 selects strict-reference audio at the
    embedding surface (no Python API available to a C host)."""
    import os

    from libzl_tpu.capi import bridge

    os.environ["LIBZL_TPU_BACKEND"] = "numpy"
    os.environ["LIBZL_TPU_QUIRK_GAIN"] = "1"
    try:
        bridge.init_engine(pump=False)
        assert bridge._rt().engine.quirk_gain is True
    finally:
        bridge.shutdown_engine()
        os.environ.pop("LIBZL_TPU_BACKEND", None)
        os.environ.pop("LIBZL_TPU_QUIRK_GAIN", None)
