"""Command-line interface: render clips through the full engine.

Usage:
    python -m libzl_tpu.cli render IN.wav OUT.wav [options]
    python -m libzl_tpu.cli info IN.wav

The `render` command is the block-engine equivalent of the reference's
test/playtest.py flow (load clip, play, listen): it plays the input clip
through the sampler voice path — looped or one-shot, pitched, stretched,
panned — and writes the master mix to a WAV.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="libzl_tpu", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a clip to a WAV")
    r.add_argument("input")
    r.add_argument("output")
    r.add_argument("--seconds", type=float, default=4.0)
    r.add_argument("--loop", action="store_true", default=False)
    r.add_argument("--note", type=int, default=60, help="MIDI note (root 60)")
    r.add_argument("--channel", type=int, default=0, help="sampler channel -2..9")
    r.add_argument("--bpm", type=float, default=120.0)
    r.add_argument("--length-beats", type=float, default=0.0,
                   help="clip length in beats (0 = natural length)")
    r.add_argument("--pitch", type=float, default=0.0, help="semitones")
    r.add_argument("--speed", type=float, default=1.0, help="speed ratio")
    r.add_argument("--gain", type=float, default=0.0, help="clip gain dB")
    r.add_argument("--start", type=float, default=0.0,
                   help="clip start position in seconds")
    r.add_argument("--crossfade", type=float, default=0.0,
                   help="loop-seam crossfade in seconds (uses audio before "
                        "--start; silently shorter if not enough material)")
    r.add_argument("--volume", type=float, default=None, help="clip volume dB")
    r.add_argument("--pan", type=float, default=0.0)
    r.add_argument("--attack", type=float, default=0.0)
    r.add_argument("--release", type=float, default=0.05)
    r.add_argument("--backend", choices=["jax", "numpy"], default="jax")
    r.add_argument("--block-frames", type=int, default=128)
    r.add_argument("--voices", type=int, default=64)
    r.add_argument("--sample-rate", type=int, default=48000)
    r.add_argument("--quiet", action="store_true")

    pl = sub.add_parser(
        "play", help="play a clip live through an audio sink (ALSA/file/null)"
    )
    pl.add_argument("input")
    pl.add_argument("--sink", default="alsa",
                    help='"alsa[:device]", "file:<path>" or "null" '
                         "(default: alsa)")
    pl.add_argument("--seconds", type=float, default=0.0,
                    help="stop after N seconds (0 = one full pass, or ctrl-c "
                         "when looping)")
    pl.add_argument("--loop", action="store_true", default=False)
    pl.add_argument("--note", type=int, default=60)
    pl.add_argument("--channel", type=int, default=0)
    pl.add_argument("--bpm", type=float, default=120.0)
    pl.add_argument("--pan", type=float, default=0.0)
    pl.add_argument("--volume", type=float, default=None, help="clip volume dB")
    pl.add_argument("--backend", choices=["jax", "numpy"], default="numpy")
    pl.add_argument("--block-frames", type=int, default=128)
    pl.add_argument("--pipeline", type=int, default=1,
                    help="pump pipeline depth (blocks in flight)")
    pl.add_argument("--quiet", action="store_true")

    st = sub.add_parser(
        "stretch",
        help="offline time-stretch / pitch-shift a WAV (the tracktion "
             "playback-render pass, without the sampler engine)",
    )
    st.add_argument("input")
    st.add_argument("output")
    st.add_argument("--speed", type=float, default=1.0,
                    help="speed ratio (2.0 = twice as fast, half duration)")
    st.add_argument("--pitch", type=float, default=0.0, help="semitones")
    st.add_argument("--gain", type=float, default=0.0, help="gain dB")
    st.add_argument("--stretch-backend", choices=["auto", "wsola", "vocoder"],
                    default="auto",
                    help="wsola = native/zl_stretch.cpp (SoundTouch-class), "
                         "vocoder = numpy phase vocoder")
    st.add_argument("--quiet", action="store_true")

    cv = sub.add_parser(
        "convert",
        help="convert between audio formats (wav/aiff/flac/ogg/mp3 in, "
             "magic-sniffed; wav/flac/ogg/mp3 out by extension)",
    )
    cv.add_argument("input")
    cv.add_argument("output")
    cv.add_argument("--quiet", action="store_true")

    i = sub.add_parser("info", help="print audio file info")
    i.add_argument("input")

    ev = sub.add_parser(
        "env", help="print backend/device/capability report (deployment "
        "debugging: which backend and device, native cores and system "
        "libraries this host resolves to)"
    )
    ev.add_argument("--backend", default="jax", choices=["jax", "numpy"])

    tr = sub.add_parser(
        "trace", help="render a clip under a jax profiler trace "
        "(TensorBoard/XProf timeline; see AudioEngine.capture_trace)"
    )
    tr.add_argument("input")
    tr.add_argument("outdir", help="profiler output directory")
    tr.add_argument("--blocks", type=int, default=50)
    tr.add_argument("--block-frames", type=int, default=128)
    tr.add_argument("--voices", type=int, default=64)
    tr.add_argument("--loop", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="loop the clip during the trace (default; "
                         "--no-loop traces a one-shot)")

    th = sub.add_parser(
        "thumbnail", help="render a waveform thumbnail to SVG"
    )
    th.add_argument("input")
    th.add_argument("output", help="output .svg path")
    th.add_argument("--width", type=int, default=512)
    th.add_argument("--height", type=int, default=128)
    th.add_argument("--buckets", type=int, default=512)
    th.add_argument("--start", type=float, default=0.0,
                    help="zoom window start, seconds")
    th.add_argument("--end", type=float, default=0.0,
                    help="zoom window end, seconds (0 = full length)")
    th.add_argument("--color", default="#ffffff")
    return p


def cmd_render(args) -> int:
    from .engine.engine import AudioEngine
    from .io.wav import read_audio, write_wav
    from .models.clip import ClipAudioSource

    engine = AudioEngine(
        sample_rate=args.sample_rate,
        block_frames=args.block_frames,
        num_voices=args.voices,
        backend=args.backend,
    )
    engine.start_transport(bpm=args.bpm)
    clip = ClipAudioSource(engine, filepath=args.input)
    if args.length_beats:
        clip.set_length(args.length_beats, int(args.bpm))
    if args.pitch:
        clip.set_pitch(args.pitch)
    if args.speed != 1.0:
        clip.set_speed_ratio(args.speed)
    if args.gain:
        clip.set_gain(args.gain)
    if args.start:
        clip.set_start_position(args.start)
    if args.crossfade:
        clip.set_loop_crossfade(args.crossfade)
    if args.volume is not None:
        clip.set_volume(args.volume)
    clip.set_pan(args.pan)
    clip.adsr_attack = args.attack
    clip.adsr_release = args.release

    from .engine.commands import ClipCommand

    cmd = ClipCommand.channel(clip.id, args.channel)
    cmd.midi_note = args.note
    cmd.change_volume = True
    cmd.volume = 1.0
    cmd.looping = args.loop
    cmd.start_playback = True
    engine.schedule_clip_command(cmd, 0)

    n_blocks = max(
        int(args.seconds * args.sample_rate) // args.block_frames, 1
    )
    blocks = []
    t0 = time.perf_counter()
    for _ in range(n_blocks):
        res = engine.process_block()
        blocks.append(res.outputs.master)
    if args.backend == "jax":
        # concatenate on device, fetch once (one device->host transfer
        # instead of one per block)
        import jax.numpy as jnp

        master = np.asarray(jnp.concatenate(blocks, axis=0))
    else:
        master = np.concatenate(blocks, axis=0)
    dt = time.perf_counter() - t0

    write_wav(args.output, master, args.sample_rate)
    if not args.quiet:
        rendered_s = n_blocks * args.block_frames / args.sample_rate
        print(
            f"rendered {rendered_s:.2f}s in {dt:.2f}s "
            f"({rendered_s / dt:.1f}x realtime, backend={args.backend}) "
            f"peak={np.abs(master).max():.4f} -> {args.output}"
        )
    return 0


def cmd_play(args) -> int:
    """Live playback: the pump + sink path (the reference is audible via
    system:playback_1/2, lib/SamplerSynth.cpp:101-102; here a Sink)."""
    from .capi.bridge import EngineRuntime
    from .io.sinks import make_sink
    from .io.wav import read_audio
    from .models.clip import ClipAudioSource

    audio = read_audio(args.input)   # decode ONCE; the clip reuses it
    sample_rate = audio.sample_rate
    runtime = EngineRuntime(
        sample_rate=sample_rate,
        block_frames=args.block_frames,
        num_voices=64,
        backend=args.backend,
        pipeline_depth=args.pipeline,
    )
    try:
        sink = make_sink(args.sink, sample_rate)
    except (RuntimeError, ValueError) as e:
        print(f"error: cannot open sink {args.sink!r}: {e}", file=sys.stderr)
        return 2
    runtime.set_sink(sink)
    engine = runtime.engine
    # no lock needed here: the pump thread doesn't exist until start_pump
    clip = ClipAudioSource(engine, audio=audio)
    clip.set_pan(args.pan)
    if args.volume is not None:
        clip.set_volume(args.volume)
    engine.start_transport(bpm=args.bpm)
    if args.note == 60:
        clip.play(loop=args.loop, midi_channel=args.channel)
    else:
        # --note: pitch-track like the render subcommand
        from .engine.commands import ClipCommand

        cmd = ClipCommand.channel(clip.id, args.channel)
        cmd.midi_note = args.note
        cmd.change_volume = True
        cmd.volume = 1.0
        cmd.looping = args.loop
        cmd.start_playback = True
        engine.schedule_clip_command(cmd, 0)
    seconds = args.seconds or (
        clip.get_duration() if not args.loop else 0.0
    )
    runtime.start_pump()
    try:
        if seconds:
            # small slack so slow hosts (rendering near realtime) finish
            # the final blocks before the stop lands
            time.sleep(seconds + 0.25)
        else:
            while True:  # looping until interrupted
                time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        runtime.run_locked(lambda: clip.stop(-3))
        time.sleep(2 * args.block_frames / sample_rate)
        runtime.stop_pump()
        runtime.set_sink(None)
    if not args.quiet:
        print(
            f"played {sink.frames_written / sample_rate:.2f}s through "
            f"{sink.name} sink (backend={args.backend})"
        )
    return 0


def cmd_stretch(args) -> int:
    """Offline render only (lib/ClipAudioSource.cpp:384-402's
    updateTempoAndPitch -> playback file, minus the engine)."""
    from .io.wav import read_audio, write_wav
    from .ops.resample import render_playback, resolve_stretch_backend

    a = read_audio(args.input)
    t0 = time.perf_counter()
    out = render_playback(
        a.samples,
        speed_ratio=args.speed,
        pitch_semitones=args.pitch,
        gain_db=args.gain,
        sample_rate=a.sample_rate,
        backend=args.stretch_backend,
    )
    dt = time.perf_counter() - t0
    write_wav(args.output, out, a.sample_rate)
    if not args.quiet:
        print(
            f"{args.input}: {a.duration_seconds:.2f}s -> "
            f"{out.shape[0] / a.sample_rate:.2f}s in {dt:.2f}s "
            f"(backend={resolve_stretch_backend(args.stretch_backend)}) "
            f"-> {args.output}"
        )
    return 0


def cmd_convert(args) -> int:
    from .io.wav import read_audio, write_wav

    a = read_audio(args.input)
    suffix = args.output.rsplit(".", 1)[-1].lower()
    if suffix == "flac":
        from .io.flac import write_flac

        write_flac(args.output, a.samples, a.sample_rate)
    elif suffix == "ogg":
        from .io.codecs import write_ogg

        write_ogg(args.output, a.samples, a.sample_rate)
    elif suffix == "mp3":
        from .io.codecs import write_mp3

        write_mp3(args.output, a.samples, a.sample_rate)
    elif suffix in ("wav", "wave"):
        write_wav(args.output, a.samples, a.sample_rate)
    else:
        print(
            f"error: unsupported output format {suffix!r} "
            f"(use .wav/.flac/.ogg/.mp3)", file=sys.stderr,
        )
        return 2
    if not args.quiet:
        import os

        print(
            f"{args.input} ({a.duration_seconds:.2f}s) -> {args.output} "
            f"({os.path.getsize(args.output)} bytes)"
        )
    return 0


def cmd_info(args) -> int:
    from .io.wav import read_audio

    a = read_audio(args.input)
    print(
        f"{args.input}: {a.num_frames} frames, {a.num_channels}ch, "
        f"{a.sample_rate} Hz, {a.duration_seconds:.3f}s, "
        f"peak {np.abs(a.samples).max():.4f}"
    )
    return 0


def cmd_env(args) -> int:
    print("libzl_tpu environment report")
    from .engine.engine import AudioEngine

    eng = AudioEngine(backend=args.backend, num_voices=64)
    dev = eng.stats()
    print(f"  backend: {dev['backend']} on {dev['platform']} "
          f"({dev['device_kind']}, {dev['device_count']} device(s))")
    print(f"  native host core: {eng.use_native_host}")
    print("  lookahead horizon: "
          + (f"{eng._lookahead} blocks (window "
             f"{eng._lookahead * eng.block_frames} frames)"
             if eng._lookahead else "off"))
    from .ops.resample import resolve_stretch_backend

    print(f"  stretch backend (auto): {resolve_stretch_backend()}")
    from .io import alsa

    print(f"  libasound (ALSA sinks/sources/midi): {alsa.available()}")
    from .io import codecs

    for name, fn in (
        ("ogg read", codecs.ogg_read_available),
        ("ogg write", codecs.ogg_write_available),
        ("mp3 read", codecs.mp3_read_available),
        ("mp3 write", codecs.mp3_write_available),
    ):
        print(f"  codec {name}: {fn()}")
    from .device import compile_cache_dir

    print(f"  compile cache: {compile_cache_dir()}")
    return 0


def cmd_trace(args) -> int:
    from .engine.engine import AudioEngine
    from .models.clip import ClipAudioSource

    eng = AudioEngine(block_frames=args.block_frames, num_voices=args.voices)
    clip = ClipAudioSource(eng, args.input)
    clip.play(loop=args.loop, midi_channel=0)
    eng.start_transport()
    # compile + settle outside the trace so the timeline shows steady state
    eng.warmup()
    for _ in range(4):
        eng.process_block()
    t0 = time.time()
    eng.capture_trace(args.blocks, args.outdir)
    dt = time.time() - t0
    print(
        f"traced {args.blocks} blocks ({args.blocks * args.block_frames} "
        f"frames) in {dt:.2f}s -> {args.outdir} (open with TensorBoard/XProf)"
    )
    return 0


def cmd_thumbnail(args) -> int:
    from .models.waveform import WaveFormItem

    item = WaveFormItem(num_buckets=args.buckets)
    item.set_source(args.input)
    end = args.end if args.end else item.length
    if end <= args.start:
        print(
            f"error: --end ({end}) must be greater than --start "
            f"({args.start})", file=sys.stderr,
        )
        return 2
    if args.start:
        item.set_start(args.start)
    if args.end:
        item.set_end(args.end)
    item.color = args.color
    svg = item.to_svg(width=args.width, height=args.height)
    with open(args.output, "w") as f:
        f.write(svg)
    print(
        f"{args.input}: {item.length:.3f}s -> {args.output} "
        f"({args.width}x{args.height}, window "
        f"{item.start:.3f}-{item.end:.3f}s)"
    )
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    try:
        if args.command == "render":
            return cmd_render(args)
        if args.command == "play":
            return cmd_play(args)
        if args.command == "stretch":
            return cmd_stretch(args)
        if args.command == "convert":
            return cmd_convert(args)
        if args.command == "info":
            return cmd_info(args)
        if args.command == "env":
            return cmd_env(args)
        if args.command == "trace":
            return cmd_trace(args)
        if args.command == "thumbnail":
            return cmd_thumbnail(args)
    except FileNotFoundError as e:
        print(f"error: no such file: {e.filename}", file=sys.stderr)
        return 2
    except Exception as e:
        import wave

        if isinstance(e, (wave.Error, EOFError, ValueError)):
            # unreadable/corrupt input or bad argument combination: the
            # CLI contract is a clean message + exit 2, not a traceback
            print(f"error: {e}", file=sys.stderr)
            return 2
        raise
    return 1


if __name__ == "__main__":
    sys.exit(main())
