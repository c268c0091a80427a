"""CLI surface: render / info / thumbnail subcommands via main(argv)."""

import xml.etree.ElementTree as ET

import numpy as np
import pytest

from libzl_tpu.cli import main
from libzl_tpu.io.wav import read_wav, write_wav

SR = 48000
SVG = "{http://www.w3.org/2000/svg}"


def make_tone(path, seconds=0.5, freq=440.0):
    t = np.arange(int(SR * seconds)) / SR
    write_wav(
        path, (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)[:, None],
        SR,
    )


def test_render_loop(tmp_path, capsys):
    src = tmp_path / "in.wav"
    out = tmp_path / "out.wav"
    make_tone(src, seconds=0.2)
    rc = main(["render", str(src), str(out), "--loop", "--seconds", "1",
               "--backend", "numpy"])
    assert rc == 0
    a = read_wav(out)
    assert a.duration_seconds > 0.9
    # still audible at the end: it looped past its 0.2 s length
    assert np.abs(a.samples[-4800:]).max() > 0.05


def test_info(tmp_path, capsys):
    src = tmp_path / "in.wav"
    make_tone(src)
    assert main(["info", str(src)]) == 0
    out = capsys.readouterr().out
    assert "48000 Hz" in out and "0.500s" in out


def test_thumbnail_svg(tmp_path):
    src = tmp_path / "in.wav"
    out = tmp_path / "thumb.svg"
    make_tone(src)
    rc = main(["thumbnail", str(src), str(out),
               "--width", "640", "--height", "160", "--color", "#3fb950"])
    assert rc == 0
    root = ET.parse(out).getroot()
    assert root.attrib["width"] == "640"
    poly = root.find(f"{SVG}polygon")
    pts = np.array([p.split(",") for p in poly.attrib["points"].split()],
                   float)
    assert (pts[:, 0] >= 0).all() and (pts[:, 0] <= 640).all()
    assert (pts[:, 1] >= 0).all() and (pts[:, 1] <= 160).all()
    # a 0.4-amplitude sine spans ~0.4 of the unnormalized vertical range
    span = pts[:, 1].max() - pts[:, 1].min()
    assert 0.3 * 160 < span < 0.5 * 160


def test_thumbnail_zoom_window(tmp_path):
    src = tmp_path / "in.wav"
    out = tmp_path / "zoom.svg"
    make_tone(src)
    assert main(["thumbnail", str(src), str(out),
                 "--start", "0.1", "--end", "0.15"]) == 0
    assert ET.parse(out).getroot().find(f"{SVG}polygon") is not None


def test_error_exits(tmp_path, capsys):
    # missing file: clean message, exit 2 (no traceback)
    assert main(["thumbnail", "/nonexistent.wav", str(tmp_path / "x.svg")]) == 2
    assert "no such file" in capsys.readouterr().err
    src = tmp_path / "in.wav"
    make_tone(src)
    # inverted zoom window
    assert main(["thumbnail", str(src), str(tmp_path / "y.svg"),
                 "--start", "0.4", "--end", "0.1"]) == 2
    assert "must be greater than" in capsys.readouterr().err
    assert main(["render", "/nonexistent.wav", str(tmp_path / "z.wav"),
                 "--backend", "numpy"]) == 2


def test_cli_bad_wav_clean_exit(tmp_path):
    """Corrupt input gets a clean message + exit 2, not a traceback."""
    import subprocess
    import sys as _sys

    bad = tmp_path / "bad.wav"
    bad.write_text("not a wav")
    proc = subprocess.run(
        [_sys.executable, "-m", "libzl_tpu.cli", "info", str(bad)],
        capture_output=True, text=True, timeout=120,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 2
    assert "error:" in proc.stderr
    assert "Traceback" not in proc.stderr


def test_stretch_subcommand(tmp_path, capsys):
    src = tmp_path / "in.wav"
    out = tmp_path / "out.wav"
    make_tone(src, seconds=1.0)
    rc = main(["stretch", str(src), str(out), "--speed", "0.5"])
    assert rc == 0
    a = read_wav(out)
    # speed 0.5 doubles the duration; pitch preserved
    assert abs(a.duration_seconds - 2.0) < 0.01
    core = np.asarray(a.samples)[SR // 4 : -SR // 4, 0]
    w = np.hanning(len(core))
    peak_hz = np.argmax(np.abs(np.fft.rfft(core * w))) * SR / len(core)
    assert abs(peak_hz - 440.0) < 5.0


def test_stretch_backend_flag(tmp_path):
    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.5)
    for backend in ("wsola", "vocoder"):
        out = tmp_path / f"out_{backend}.wav"
        rc = main(["stretch", str(src), str(out), "--speed", "2.0",
                   "--stretch-backend", backend, "--quiet"])
        assert rc == 0
        assert abs(read_wav(out).duration_seconds - 0.25) < 0.01


def test_convert_roundtrip(tmp_path):
    import pytest

    from libzl_tpu.io import flac

    if not flac.available():
        pytest.skip("native FLAC decoder unavailable")
    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.3)
    out_flac = tmp_path / "out.flac"
    rc = main(["convert", str(src), str(out_flac), "--quiet"])
    assert rc == 0
    back = tmp_path / "back.wav"
    rc = main(["convert", str(out_flac), str(back), "--quiet"])
    assert rc == 0
    a = read_wav(src)
    b = read_wav(back)
    # wav(16-bit) -> flac -> wav(16-bit) is lossless
    np.testing.assert_allclose(
        np.asarray(a.samples), np.asarray(b.samples), atol=4e-5
    )


def test_env_subcommand(capsys):
    rc = main(["env", "--backend", "numpy"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "backend: numpy on cpu" in out
    assert "native host core" in out
    assert "stretch backend" in out


def test_trace_subcommand(tmp_path, capsys):
    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.2)
    out = tmp_path / "trace"
    rc = main(["trace", str(src), str(out), "--blocks", "3",
               "--voices", "16"])
    assert rc == 0
    files = [p for p in out.rglob("*") if p.is_file()]
    assert files, "no profiler trace files written"


def test_play_file_sink(tmp_path, capsys):
    """`cli play` — the first command a user runs: pump + sink end-to-end
    (the reference is audible via system:playback_1/2,
    lib/SamplerSynth.cpp:101-102; here a FileSink)."""
    src = tmp_path / "in.wav"
    out = tmp_path / "live.wav"
    make_tone(src, seconds=0.3)
    rc = main(["play", str(src), "--sink", f"file:{out}",
               "--backend", "numpy", "--seconds", "0.3"])
    assert rc == 0
    assert "played" in capsys.readouterr().out
    a = read_wav(out)
    assert a.duration_seconds >= 0.3
    assert np.abs(np.asarray(a.samples)).max() > 0.05  # audible


def test_play_note_pitch_tracks(tmp_path):
    """--note pitch-tracks: an octave up halves the rendered duration's
    audible content (pitchRatio = 2^((note-root)/12),
    lib/SamplerSynthVoice.cpp:115-116)."""
    src = tmp_path / "in.wav"
    out = tmp_path / "note.wav"
    make_tone(src, seconds=0.4)
    rc = main(["play", str(src), "--sink", f"file:{out}", "--note", "72",
               "--backend", "numpy", "--seconds", "0.4", "--quiet"])
    assert rc == 0
    a = read_wav(out)
    s = np.abs(np.asarray(a.samples)).max(axis=1)
    sr = a.sample_rate
    # at 2x pitch the 0.4 s source is silent after ~0.2 s
    assert s[: int(0.15 * sr)].max() > 0.05
    assert s[int(0.3 * sr):].max() < 1e-4


def test_play_bad_sink_exits_2(tmp_path, capsys):
    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.1)
    rc = main(["play", str(src), "--sink", "file:"])
    assert rc == 2
    assert "cannot open sink" in capsys.readouterr().err


def test_render_all_clip_options(tmp_path):
    """Every render-time clip flag flows through (the argparse->clip
    branches: length/pitch/speed/gain/start/crossfade/volume/pan)."""
    src = tmp_path / "in.wav"
    out = tmp_path / "out.wav"
    make_tone(src, seconds=0.5)
    rc = main(["render", str(src), str(out), "--seconds", "0.5",
               "--backend", "numpy", "--length-beats", "1",
               "--pitch", "2", "--speed", "1.1", "--gain", "-3",
               "--start", "0.05", "--crossfade", "0.01",
               "--volume", "-6", "--pan", "0.5",
               "--attack", "0.01", "--release", "0.05"])
    assert rc == 0
    a = read_wav(out)
    assert np.abs(np.asarray(a.samples)).max() > 0.01
    # clip pan rides the reference's documented M/S formula
    # (lib/ClipAudioSource.h:210-222): left = 0.5*(1+pan)*m + s, so a
    # POSITIVE pan boosts the left channel — a reference quirk preserved
    s = np.asarray(a.samples)
    assert np.abs(s[:, 0]).sum() > np.abs(s[:, 1]).sum()


def test_convert_ogg_mp3_and_unsupported(tmp_path, capsys):
    """convert's output dispatch: lossy suffixes encode through the codec
    layer; an unknown suffix is a clean message + exit 2."""
    import pytest

    from libzl_tpu.io import codecs

    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.3)
    avail = {"ogg": codecs.ogg_write_available,
             "mp3": codecs.mp3_write_available}
    for suffix in ("ogg", "mp3"):
        if not avail[suffix]():
            continue
        out = tmp_path / f"out.{suffix}"
        rc = main(["convert", str(src), str(out)])
        assert rc == 0, suffix
        assert out.stat().st_size > 0
        assert "->" in capsys.readouterr().out  # non-quiet summary line

    rc = main(["convert", str(src), str(tmp_path / "out.xyz")])
    assert rc == 2
    assert "unsupported output format" in capsys.readouterr().err


def test_env_and_render_jax_backend(tmp_path, capsys):
    """The jax-backend CLI paths on the forced-CPU test mesh: env prints
    the device line; render concatenates on device and fetches once."""
    rc = main(["env", "--backend", "jax"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "backend: jax on cpu" in out and "device(s)" in out

    src = tmp_path / "in.wav"
    out_wav = tmp_path / "out.wav"
    make_tone(src, seconds=0.2)
    rc = main(["render", str(src), str(out_wav), "--seconds", "0.25",
               "--backend", "jax"])
    assert rc == 0
    a = read_wav(out_wav)
    assert np.abs(a.samples).max() > 0.05


def test_cli_value_error_in_process(tmp_path, capsys):
    """The generic handler: a ValueError from a command prints a clean
    message and exits 2 (the subprocess bad-wav test can't show up in
    in-process coverage)."""
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF....WAVEjunk")
    assert main(["info", str(bad)]) == 2
    err = capsys.readouterr().err
    assert "error:" in err and "Traceback" not in err


def test_cli_unexpected_error_propagates(tmp_path, monkeypatch):
    """Non-input errors (bugs) must NOT be swallowed into exit 2 — the
    traceback is the debugging surface."""
    import libzl_tpu.cli as cli_mod

    def boom(args):
        raise RuntimeError("engine bug")

    monkeypatch.setattr(cli_mod, "cmd_info", boom)
    src = tmp_path / "in.wav"
    make_tone(src, seconds=0.05)
    with pytest.raises(RuntimeError, match="engine bug"):
        main(["info", str(src)])


def test_play_volume_flag(tmp_path):
    src = tmp_path / "in.wav"
    loud = tmp_path / "loud.wav"
    quiet = tmp_path / "quiet.wav"
    make_tone(src, seconds=0.2)
    assert main(["play", str(src), "--sink", f"file:{loud}",
                 "--backend", "numpy", "--seconds", "0.2", "--quiet"]) == 0
    assert main(["play", str(src), "--sink", f"file:{quiet}",
                 "--backend", "numpy", "--seconds", "0.2", "--quiet",
                 "--volume", "-24"]) == 0
    pl = np.abs(np.asarray(read_wav(loud).samples)).max()
    pq = np.abs(np.asarray(read_wav(quiet).samples)).max()
    # the fader law is not linear-dB; the flag flowing through is the point
    assert 0 < pq < pl * 0.5


def test_play_loop_until_interrupt(tmp_path, monkeypatch):
    """--loop with no --seconds plays until Ctrl-C; the interrupt lands a
    clean stop + flush, exit 0."""
    import time as real_time

    import libzl_tpu.cli as cli_mod

    class _InterruptingTime:
        """time shim for the CLI module only: the first idle-loop sleep
        raises KeyboardInterrupt (once — later sleeps must behave, the
        stop/flush path sleeps too)."""

        def __init__(self):
            self.fired = False

        def __getattr__(self, name):
            return getattr(real_time, name)

        def sleep(self, seconds):
            if not self.fired:
                self.fired = True
                real_time.sleep(min(seconds, 0.3))
                raise KeyboardInterrupt
            real_time.sleep(seconds)

    src = tmp_path / "in.wav"
    out = tmp_path / "live.wav"
    make_tone(src, seconds=0.2)
    monkeypatch.setattr(cli_mod, "time", _InterruptingTime())
    rc = main(["play", str(src), "--sink", f"file:{out}",
               "--backend", "numpy", "--loop", "--quiet"])
    assert rc == 0
    assert read_wav(out).num_frames > 0


def test_env_windows_kernel_report(monkeypatch, capsys):
    """The env command reports the chosen backend and the device it renders
    on — here a GPU device faked under the jax backend — plus the compile
    cache directory (JAX_COMPILATION_CACHE_DIR when set)."""
    import libzl_tpu.engine.engine as engine_mod

    real_engine = engine_mod.AudioEngine

    class FakeGpu(real_engine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.device = {"platform": "gpu", "device_kind": "NVIDIA H100",
                           "device_count": 1}

    monkeypatch.setattr(engine_mod, "AudioEngine", FakeGpu)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/cache/here")
    assert main(["env", "--backend", "jax"]) == 0
    out = capsys.readouterr().out
    assert "backend: jax on gpu (NVIDIA H100, 1 device(s))" in out
    assert "compile cache: /cache/here" in out
