"""Live rig: the recommended production boot sequence, executable.

Everything the README's "Production deployment" section describes, in
order, as one script — the embedding-host recipe for a live groovebox:

1. persistent XLA compile cache (fast restarts; the engine keeps it in
   JAX_COMPILATION_CACHE_DIR, else in the checkout's .jax_cache/),
2. engine construction (bucketed dispatch is the default),
3. warmup: every voice-bucket render shape compiles BEFORE realtime, and
   the first device->host readback is paid here, never inside the pump,
4. audio sink + MIDI wiring (hardware hot-plug where ALSA exists; a
   virtual port stands in everywhere else),
5. the realtime pump, then SLO/meter reporting.

Runs anywhere (defaults to the numpy backend; pass --backend jax for a
device). The reference's equivalent is initJuce + JACK graph setup
(lib/libzl.cpp:358-410) followed by the clients' process callbacks.

    python examples/live_rig.py [--backend numpy|jax] [--seconds 3]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SR = 48000


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="numpy", choices=["numpy", "jax"])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--sink", default="null",
                    help='"alsa[:dev]", "file:<path>" or "null"')
    args = ap.parse_args()

    from libzl_tpu.capi.bridge import EngineRuntime
    from libzl_tpu.engine.commands import ClipCommand
    from libzl_tpu.io.sinks import make_sink
    from libzl_tpu.io.wav import AudioData
    from libzl_tpu.midi.devices import VirtualMidiPort
    from libzl_tpu.midi.router import Destination
    from libzl_tpu.models.clip import ClipAudioSource

    # 1+2. engine + runtime (pump not started yet); a jax engine turns on
    # the persistent compile cache itself (libzl_tpu.device)
    t0 = time.perf_counter()
    # pool size per backend: the numpy mirror renders the full pool each
    # block on one core (bucketed prefix dispatch is a jax-path feature)
    runtime = EngineRuntime(
        sample_rate=SR, block_frames=128,
        num_voices=64 if args.backend == "numpy" else 256,
        backend=args.backend, pipeline_depth=1,
    )
    engine = runtime.engine

    # 3. load the session's sounds, then the pump's start_pump() performs
    # warmup automatically (every bucket shape + the first D2H readback)
    t = np.arange(SR // 2) / SR
    kick = (np.sin(2 * np.pi * 55 * t) * np.exp(-t * 18.0)).astype(
        np.float32)[: SR // 4, None]
    keys = (0.4 * np.sin(2 * np.pi * 220 * t)
            * np.exp(-t * 3.0)).astype(np.float32)[:, None]
    clip_kick = ClipAudioSource(engine, audio=AudioData(kick, SR))
    clip_keys = ClipAudioSource(engine, audio=AudioData(keys, SR))
    clip_keys.adsr_release = 0.08

    # 4. audio out + MIDI in. Hardware MIDI hot-plugs via the scanner when
    # libasound exists (engine.router.auto_discover); a virtual port is
    # the deterministic stand-in here.
    runtime.set_sink(make_sink(args.sink, SR))
    pad = VirtualMidiPort("Live Pad")
    engine.router.registry.add_input(pad)
    engine.router.set_channel_destination(0, Destination.SAMPLER)
    engine.sampler_map.assign(0, clip_keys)

    # 5. realtime: pump paced by the wall clock (or the ALSA sink's
    # hardware rate); sequence a kick and play pad notes while running
    runtime.start_pump()
    print(f"boot (engine+warmup+pump): {time.perf_counter() - t0:.2f}s")
    engine.start_transport(bpm=120)

    end = time.monotonic() + args.seconds
    beat = 0
    while time.monotonic() < end:
        cmd = ClipCommand.channel(clip_kick.id, 1)
        cmd.midi_note = 60
        cmd.start_playback = True
        engine.schedule_clip_command(cmd, 0)
        pad.feed(bytes([0x90, 57 + (beat % 4) * 5, 100]))
        time.sleep(0.5)
        pad.feed(bytes([0x80, 57 + (beat % 4) * 5, 0]))
        beat += 1

    runtime.stop_pump()
    slo = engine.slo
    print(f"SLO: {slo.missed_blocks}/{slo.total_blocks} deadline misses, "
          f"dsp load {engine.dsp_load.load:.2f}, "
          f"playback peak {engine.levels.playback_a_hold:.1f} dBFS (hold)")
    wd = engine.watchdog
    print(f"watchdog: {wd.delivered}/{wd.scheduled} events delivered, "
          f"{wd.mismatches} mismatched blocks")
    if runtime.pump_error is not None:
        print(f"pump error: {runtime.pump_error}", file=sys.stderr)
        return 1
    if slo.total_blocks == 0:
        print("pump rendered no blocks", file=sys.stderr)
        return 1
    print("live rig OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
