"""Long soak on the accelerator: the C-ABI pump sustained for N minutes.

Boots the production path (native/libzl.so shim -> jax backend on the
GPU, bucket warmup, lookahead horizon, wall-paced pump with a file sink),
plays a sequenced multi-clip session live for SOAK_MINUTES, records
global playback, and reports the reliability counters the reference's
"runs a whole set live" bar implies: deadline misses (SLO), dsp load,
watchdog event accounting, pump errors, recorder output integrity.
Inputs, the sink file and the take go to `soak_out/` in the checkout.

    SOAK_MINUTES=10 python tools/soak.py
"""

import ctypes
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OUT = os.path.join(REPO, "soak_out")
MINUTES = float(os.environ.get("SOAK_MINUTES", "10"))
# seconds between clip retriggers. The default (5 s) is the realistic mix
# of clean and dirty blocks; SOAK_EVENT_SECONDS=0.1 is the event-storm
# regime where nearly every lookahead horizon is preempted — sustained
# event-block stress instead of the quiet amortized path.
EVENT_SECONDS = float(os.environ.get("SOAK_EVENT_SECONDS", "5.0"))
# SOAK_SCHEDULE_TICKS > 0 = the SEQUENCER regime: each retrigger is
# scheduled into the step ring that many ticks AHEAD (the reference's
# whole SyncTimer purpose, SyncTimer.cpp:397-401) instead of fired
# immediately; 0 = live/immediate traffic.
SCHEDULE_TICKS = int(os.environ.get("SOAK_SCHEDULE_TICKS", "0"))


def main():
    # `kill -USR1 <pid>` dumps all thread stacks to stderr: tells a stuck
    # device transfer from a lock deadlock without a debugger
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    os.environ.setdefault("LIBZL_TPU_BACKEND", "jax")
    os.environ.setdefault("LIBZL_TPU_VOICES", "1024")
    os.environ.setdefault("LIBZL_TPU_WARMUP", "1")
    os.environ.setdefault("LIBZL_TPU_PIPELINE", "2")
    os.makedirs(OUT, exist_ok=True)
    os.environ.setdefault("LIBZL_TPU_SINK",
                          "file:" + os.path.join(OUT, "sink.wav"))

    from libzl_tpu.io.wav import read_wav, write_wav

    sr = 48000
    rng = np.random.default_rng(7)
    clips_wav = []
    for i, freq in enumerate((110.0, 220.5, 331.0, 441.5)):
        t = np.arange(int(sr * (0.5 + 0.3 * i))) / sr
        w = (0.35 * np.sin(2 * np.pi * freq * t)
             + 0.1 * np.sin(2 * np.pi * 2 * freq * t)).astype(np.float32)
        p = os.path.join(OUT, f"in{i}.wav")
        write_wav(p, w, sr)
        clips_wav.append(p)

    zl = ctypes.CDLL(os.path.join(REPO, "native", "libzl.so"))
    zl.ClipAudioSource_new.restype = ctypes.c_void_p
    zl.ClipAudioSource_new.argtypes = [ctypes.c_char_p, ctypes.c_bool]
    zl.ClipAudioSource_play.argtypes = [ctypes.c_void_p, ctypes.c_bool]
    zl.ClipAudioSource_stop.argtypes = [ctypes.c_void_p]

    t0 = time.perf_counter()
    zl.initJuce()
    print(f"initJuce (warmup+fence+pump): {time.perf_counter()-t0:.1f}s",
          flush=True)

    from libzl_tpu.capi import bridge

    rt = bridge._rt()
    eng = rt.engine
    import jax

    print("backend:", jax.default_backend(), "lookahead:", eng._lookahead, "buckets:", eng._bucket_ladder,
          flush=True)

    handles = [zl.ClipAudioSource_new(p.encode(), False) for p in clips_wav]
    assert all(handles)
    zl.AudioLevels_setRecordGlobalPlayback(True)
    rec_path = os.path.join(OUT, "rec.wav")
    zl.AudioLevels_setGlobalPlaybackFilenamePrefix(rec_path.encode())
    zl.AudioLevels_startRecording()
    zl.SyncTimer_startTimer(124)
    for h in handles:
        zl.ClipAudioSource_play(h, True)

    clip_ids = sorted(eng.clips.keys())

    def retrigger():
        i = int(rng.integers(0, len(handles)))
        if SCHEDULE_TICKS > 0:
            # sequencer case: the command sits in the step ring
            # SCHEDULE_TICKS ahead of the playhead (mirrors what
            # ClipAudioSource_play builds, models/clip.py:479-496)
            from libzl_tpu.engine.commands import ClipCommand

            cmd = ClipCommand.channel(clip_ids[i], -2)
            cmd.midi_note = 60
            cmd.change_volume = True
            cmd.volume = 1.0
            cmd.stop_playback = True
            cmd.start_playback = True
            cmd.looping = True
            cmd.change_looping = True
            with rt._lock:
                eng.schedule_clip_command(cmd, SCHEDULE_TICKS)
        else:
            zl.ClipAudioSource_play(handles[i], True)

    deadline = time.monotonic() + MINUTES * 60.0
    last_report = 0.0
    while time.monotonic() < deadline:
        time.sleep(EVENT_SECONDS)
        # traffic: retrigger a random clip every EVENT_SECONDS (events
        # rebuild the lookahead horizon in-dispatch when sparse enough —
        # the realistic mix at the default; a storm at 0.1 s)
        retrigger()
        now = time.monotonic()
        if now - last_report > 30.0:
            last_report = now
            s = eng.stats()
            print(f"t={MINUTES * 60 - (deadline - now):6.0f}s "
                  f"blocks={s['blocks']} slo={s['slo_missed']}/"
                  f"{s['slo_total']} load={s['dsp_load']:.2f} "
                  f"wd={s['watchdog_mismatches']} "
                  f"err={type(rt.pump_error).__name__ if rt.pump_error else '-'}",
                  flush=True)
            print("  phases " + json.dumps(rt.phase_stats()), flush=True)

    for h in handles:
        zl.ClipAudioSource_stop(h)
    time.sleep(0.5)
    zl.AudioLevels_stopRecording()
    zl.SyncTimer_stopTimer()
    stats = eng.stats()
    phases = rt.phase_stats()
    pump_err = rt.pump_error
    realtime_blocks = stats["blocks"]
    expected = MINUTES * 60 * sr / eng.block_frames
    zl.shutdownJuce()

    rec = read_wav(rec_path)
    out = dict(
        minutes=MINUTES,
        event_seconds=EVENT_SECONDS,
        schedule_ticks=SCHEDULE_TICKS,
        voices=int(os.environ.get("LIBZL_TPU_VOICES", "1024")),
        blocks=realtime_blocks,
        blocks_expected=int(expected),
        sustained_realtime=bool(realtime_blocks >= 0.99 * expected),
        slo_missed=stats["slo_missed"],
        slo_miss_rate=round(stats["slo_missed"] / max(stats["slo_total"], 1),
                            5),
        slo_by_kind=stats.get("slo_by_kind", {}),
        slo_worst=stats.get("slo_worst", []),
        dsp_load=stats["dsp_load"],
        watchdog_mismatches=stats["watchdog_mismatches"],
        watchdog_lost=stats["watchdog_lost"],
        pump_error=repr(pump_err) if pump_err else None,
        recorded_seconds=round(rec.samples.shape[0] / sr, 1),
        recorded_peak=round(float(np.abs(rec.samples).max()), 4),
        phases=phases,
    )
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
