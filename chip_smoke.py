"""Bring-up smoke test: the engine's main path on the GPU, checked.

Drives the engine once through the entry points a user calls, at the
north-star size, and compares the card's audio with the repository's plain
reference — the numpy engine (backend="numpy") on the same seed:

1. device: JAX must find a GPU, else the script exits non-zero before any
   phase (and prints no result line);
2. engine: 1024 voices + 64 looped clips (bench.build_session) — 2,000
   live 128-frame blocks with the lookahead horizon on ("auto") and off
   (0), and 200 1024-frame super-blocks, every block compared with the
   numpy engine; the horizon is also compared with per-block dispatch;
3. C ABI: native/libzl.so built from the tracked sources and loaded with
   ctypes (LIBZL_TPU_BACKEND unset, so the automatic choice must land on
   jax): a looped session recorded through the pump with a file sink for
   10 s, then the deterministic path (LIBZL_TPU_NO_PUMP + step_blocks)
   compared with the same calls on the numpy engine;
4. trace: 32 steady live blocks at 1024 voices under jax.profiler — the
   render's kernels by device time, the gather fusion, the card's busy and
   idle share, and the bytes the gather needs per block;
5. stretch (ops/stretch_jax, cuFFT) against the numpy vocoder, and
   waveform thumbnails against numpy.

With --four only the voice-sharded mesh phase runs: a 4096-voice engine on
make_mesh() over every device, per-block and horizon, against the same
session on one device and against the numpy engine.

Every phase prints its measured errors beside its tolerance; a failed
phase stops the script with a non-zero exit. Long outputs (the trace and
its kernel table) go to --out (default smoke_out/). The last line of
stdout is one JSON object: {"ok": true, "device": {...}}.

    python chip_smoke.py [--four] [--out DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Device vs the numpy engine (master, lane mixes, peak meters): three times
# tighter than the golden oracle tolerance (3e-4). Not bit-exact: XLA on
# the GPU contracts a*b+c to FMA and sums the mixdown in another order
# than numpy's einsum. A TF32 mixdown (~3 significant digits) breaks it.
TOL_AUDIO = 1e-4
# Lookahead horizon vs per-block dispatch, both on the device: the same
# per-block programs through differently fused graphs, so float32 rounding
# (FMA contraction, summation order) may differ in the last bits. Checked
# relative to each field's peak magnitude; the absolute error is printed.
TOL_HORIZON = 1e-6
# Device vocoder vs numpy vocoder, relative RMS: float32 FFTs (cuFFT vs
# pocketfft) and another summation order in the overlap-add.
TOL_STRETCH_RMS = 1e-4

RENDER_FIELDS = ("master", "lane_mix", "lane_peaks", "master_peak")


class PhaseFailure(RuntimeError):
    pass


# ------------------------------------------------------------ comparisons

def max_abs_err(a, b) -> float:
    """Largest |a - b| over same-shaped arrays (float64 arithmetic)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise PhaseFailure(f"shape mismatch {a.shape} vs {b.shape}")
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise PhaseFailure("non-finite values")
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def rel_rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise PhaseFailure(f"shape mismatch {got.shape} vs {want.shape}")
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def check(name: str, err: float, tol: float, what: str = "max_abs_err"):
    ok = err <= tol
    print(f"    {name}: {what}={err:.3e} (tolerance {tol:.0e}) "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise PhaseFailure(f"{name}: {what} {err:.3e} > {tol:.0e}")
    return err


def max_rel_err(a, b) -> float:
    """max |a - b| relative to the peak magnitude of the reference b."""
    return max_abs_err(a, b) / max(float(np.max(np.abs(b))), 1e-30)


def compare_blocks(name: str, got: dict, want: dict, tol: float) -> float:
    """Compare every rendered block's master, lane mixes and peak meters."""
    worst = 0.0
    for f in RENDER_FIELDS:
        worst = max(worst, check(f"{name} {f}", max_abs_err(got[f], want[f]),
                                 tol))
    return worst


def render_blocks(engine, n: int, platform: str | None = None) -> dict:
    """Process `n` blocks and return RENDER_FIELDS stacked per block as
    numpy arrays. With `platform`, the sound bank and the last device
    master must live on that platform."""
    import jax

    outs = [engine.process_block().outputs for _ in range(n)]
    if platform is not None:
        on_dev = [o.master for o in outs if isinstance(o.master, jax.Array)]
        if not on_dev:
            raise PhaseFailure("no block was rendered on the device")
        placed = {d.platform for d in on_dev[-1].devices()}
        placed |= {d.platform for d in engine._device_sound_data.devices()}
        if placed != {platform}:
            raise PhaseFailure(f"device arrays live on {placed}, "
                               f"not {platform}")
    got = jax.device_get([[getattr(o, f) for f in RENDER_FIELDS]
                          for o in outs])
    return {f: np.stack([g[i] for g in got])
            for i, f in enumerate(RENDER_FIELDS)}


def warm(engine) -> tuple[int, float]:
    t0 = time.perf_counter()
    n = engine.warmup()
    return n, time.perf_counter() - t0


# ----------------------------------------------------------------- phases

def phase_engine(platform: str, voices: int = 1024, live_blocks: int = 2000,
                 super_blocks: int = 200) -> dict:
    import bench

    info = {}
    t0 = time.perf_counter()
    ref = render_blocks(bench.build_session(128, voices, backend="numpy"),
                        live_blocks)
    print(f"    numpy reference: {live_blocks} live blocks in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = {}
    for la in ("auto", 0):
        eng = bench.build_session(128, voices, lookahead=la)
        n, secs = warm(eng)
        print(f"    lookahead={la}: warm-up compiled {n} graphs in "
              f"{secs:.1f} s (set-up); native host core "
              f"{eng.use_native_host}", flush=True)
        t0 = time.perf_counter()
        runs[la] = render_blocks(eng, live_blocks, platform)
        print(f"    lookahead={la}: {live_blocks} blocks in "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{int(eng.pool.active.sum())} active voices", flush=True)
        info[f"warmup_graphs_lookahead_{la}"] = n
        info[f"warmup_s_lookahead_{la}"] = round(secs, 1)
        if not eng.use_native_host:
            raise PhaseFailure("native host core did not load")
        info[f"err_live_lookahead_{la}"] = compare_blocks(
            f"live lookahead={la} vs numpy", runs[la], ref, TOL_AUDIO)
    for f in RENDER_FIELDS:
        info[f"abs_err_horizon_vs_per_block_{f}"] = max_abs_err(
            runs["auto"][f], runs[0][f])
        info[f"rel_err_horizon_vs_per_block_{f}"] = check(
            f"horizon vs per-block (device) {f} (max_abs_err="
            f"{info[f'abs_err_horizon_vs_per_block_{f}']:.3e})",
            max_rel_err(runs["auto"][f], runs[0][f]), TOL_HORIZON,
            what="rel_err")

    ref = render_blocks(bench.build_session(1024, voices, backend="numpy"),
                        super_blocks)
    eng = bench.build_session(1024, voices)
    n, secs = warm(eng)
    print(f"    super-blocks: warm-up compiled {n} graphs in {secs:.1f} s",
          flush=True)
    got = render_blocks(eng, super_blocks, platform)
    info["warmup_graphs_super"] = n
    info["err_super"] = compare_blocks("super-block vs numpy", got, ref,
                                       TOL_AUDIO)
    return info


class _CaptureSink:
    """A non-pacing sink that keeps every block (the bridge sink API)."""

    name = "capture"
    pacing = False

    def __init__(self):
        self.blocks = []

    def write(self, block):
        self.blocks.append(np.array(block, np.float32))

    def close(self):
        pass


def _load_libzl():
    proc = subprocess.run(["make", "-C", str(REPO / "native"), "libzl.so",
                           f"PYTHON={sys.executable}"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise PhaseFailure("make -C native libzl.so failed:\n"
                           + proc.stdout[-2000:] + proc.stderr[-2000:])
    zl = ctypes.CDLL(str(REPO / "native" / "libzl.so"))
    vp, cp, b = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_bool
    zl.ClipAudioSource_new.restype = vp
    zl.ClipAudioSource_new.argtypes = [cp, b]
    zl.ClipAudioSource_play.argtypes = [vp, b]
    zl.ClipAudioSource_stop.argtypes = [vp]
    zl.AudioLevels_setRecordGlobalPlayback.argtypes = [b]
    zl.AudioLevels_setGlobalPlaybackFilenamePrefix.argtypes = [cp]
    zl.SyncTimer_startTimer.argtypes = [ctypes.c_int]
    return zl


def _capi_session(zl, wavs):
    handles = [zl.ClipAudioSource_new(str(p).encode(), False) for p in wavs]
    if not all(handles):
        raise PhaseFailure("ClipAudioSource_new returned NULL")
    zl.SyncTimer_startTimer(120)
    for h in handles:
        zl.ClipAudioSource_play(h, True)
    return handles


def phase_capi(platform: str, out: Path, seconds: float = 10.0,
               det_blocks: int = 1000) -> dict:
    from libzl_tpu.capi import bridge
    from libzl_tpu.io.wav import read_wav, write_wav

    info = {}
    zl = _load_libzl()
    sr = 48000
    wavs = []
    for i, freq in enumerate((110.0, 220.5, 331.0, 441.5)):
        t = np.arange(int(sr * (0.5 + 0.3 * i))) / sr
        w = (0.3 * np.sin(2 * np.pi * freq * t)
             + 0.1 * np.sin(2 * np.pi * 2 * freq * t)).astype(np.float32)
        wavs.append(out / f"capi_in{i}.wav")
        write_wav(str(wavs[-1]), w, sr)
    for var in ("LIBZL_TPU_BACKEND", "LIBZL_TPU_NO_PUMP"):
        os.environ.pop(var, None)

    # the realtime pump with a file sink, recording global playback
    sink_path = out / "capi_sink.wav"
    for p in [sink_path, *glob.glob(str(out / "capi_take*"))]:
        Path(p).unlink(missing_ok=True)
    os.environ["LIBZL_TPU_SINK"] = f"file:{sink_path}"
    t0 = time.perf_counter()
    zl.initJuce()
    boot = time.perf_counter() - t0
    try:
        rt = bridge._rt()
        eng = rt.engine
        stats = eng.stats()
        print(f"    initJuce {boot:.1f} s (warm-up {stats['warmed_graphs']} "
              f"graphs); backend {stats['backend']} on {stats['platform']} "
              f"({stats['device_kind']}); native host core "
              f"{eng.use_native_host}", flush=True)
        if stats["backend"] != "jax" or stats["platform"] != platform:
            raise PhaseFailure(f"libzl.so renders on {stats['backend']}/"
                               f"{stats['platform']}, not jax/{platform}")
        if not eng.use_native_host:
            raise PhaseFailure("native host core did not load")
        zl.AudioLevels_setRecordGlobalPlayback(True)
        zl.AudioLevels_setGlobalPlaybackFilenamePrefix(
            str(out / "capi_take").encode())
        zl.AudioLevels_startRecording()
        handles = _capi_session(zl, wavs)
        time.sleep(seconds + 0.5)
        zl.AudioLevels_stopRecording()
        for h in handles:
            zl.ClipAudioSource_stop(h)
        zl.SyncTimer_stopTimer()
        pump_error = rt.pump_error
    finally:
        zl.shutdownJuce()
        os.environ.pop("LIBZL_TPU_SINK", None)
    stats = eng.stats()
    print(f"    pump: {stats['blocks']} blocks, deadline misses "
          f"{stats['slo_missed']}/{stats['slo_total']}, by kind "
          f"[missed, total, worst overrun ms] {stats['slo_by_kind']}",
          flush=True)
    if pump_error is not None:
        raise PhaseFailure(f"pump error: {pump_error!r}")
    sink = read_wav(str(sink_path))
    takes = sorted(glob.glob(str(out / "capi_take*")))
    if not takes:
        raise PhaseFailure("no global-playback take was written")
    take = read_wav(takes[-1])
    sink_s = sink.samples.shape[0] / sr
    take_s = take.samples.shape[0] / sr
    take_peak = float(np.abs(take.samples).max())
    print(f"    file sink {sink_s:.2f} s ({sink.samples.shape[0]} frames for "
          f"{stats['blocks']} blocks); take {take_s:.2f} s, peak "
          f"{take_peak:.3f}", flush=True)
    if sink.samples.shape[0] != stats["blocks"] * eng.block_frames:
        raise PhaseFailure("file sink length != blocks rendered")
    if sink_s < seconds or not (seconds - 1.0 <= take_s <= sink_s):
        raise PhaseFailure(f"take {take_s:.2f} s / sink {sink_s:.2f} s "
                           f"for {seconds} s of playback")
    if take_peak < 0.01:
        raise PhaseFailure("the take is silent")
    info.update(capi_blocks=stats["blocks"], capi_take_s=round(take_s, 2),
                capi_slo_by_kind=stats["slo_by_kind"])

    # the deterministic path, on the automatic backend and on numpy
    os.environ["LIBZL_TPU_NO_PUMP"] = "1"
    masters = {}
    try:
        for backend in ("auto", "numpy"):
            if backend == "numpy":
                os.environ["LIBZL_TPU_BACKEND"] = "numpy"
            zl.initJuce()
            try:
                rt = bridge._rt()
                cap = _CaptureSink()
                rt.set_sink(cap)
                _capi_session(zl, wavs)
                rt.step_blocks(det_blocks)
                masters[backend] = np.stack(cap.blocks)
                masters[backend + "_engine"] = rt.engine.backend
            finally:
                zl.shutdownJuce()
    finally:
        os.environ.pop("LIBZL_TPU_NO_PUMP", None)
        os.environ.pop("LIBZL_TPU_BACKEND", None)
    if masters["auto_engine"] != "jax":
        raise PhaseFailure("the automatic backend did not choose jax")
    info["err_capi_step_blocks"] = check(
        f"C ABI step_blocks({det_blocks}) jax vs numpy master",
        max_abs_err(masters["auto"], masters["numpy"]), TOL_AUDIO)
    return info


def union_ns(intervals) -> int:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gather_fusion_names(hlo_text: str) -> set:
    """Names of the fusion instructions whose computation holds a gather."""
    comps, name, body = {}, None, []
    for line in hlo_text.splitlines():
        # computation headers start at column 0; instructions are indented
        m = re.match(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if m:
            name, body = m.group(1), []
            continue
        if line.strip() == "}":
            if name is not None:
                comps[name] = "\n".join(body)
            name = None
            continue
        if name is not None:
            body.append(line)
    with_gather = {c for c, b in comps.items() if " gather(" in b}
    names = set()
    for b in comps.values():
        for m in re.finditer(r"%?([\w.\-]+) = [^\n]*? fusion\([^\n]*"
                             r"calls=%?([\w.\-]+)", b):
            if m.group(2) in with_gather:
                names.add(m.group(1))
    return names


def reduce_trace(trace_dir: Path, window_name: str) -> dict:
    """Device kernels, busy share and per-kernel device time of a traced
    window, read from the profiler's xplane file."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(str(trace_dir / "**" / "*.xplane.pb"),
                             recursive=True))
    if not paths:
        raise PhaseFailure("the profiler wrote no xplane file")
    prof = ProfileData.from_file(paths[-1])
    window = None
    kernels, ops, layout = [], [], {}
    for plane in prof.planes:
        for line in plane.lines:
            evs = list(line.events)
            layout.setdefault(plane.name, {})[line.name] = len(evs)
            if plane.name.startswith("/host"):
                for ev in evs:
                    if ev.name == window_name:
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
            elif plane.name.startswith("/device:GPU"):
                rows = [(ev.start_ns, ev.start_ns + ev.duration_ns, ev.name)
                        for ev in evs]
                if line.name == "XLA Ops":
                    ops += rows
                elif line.name not in ("XLA Modules", "Launch Stats",
                                       "Steps", "Source code"):
                    kernels += rows
    if not kernels:
        raise PhaseFailure(f"no device kernels in the trace: {layout}")
    if window is None:
        window = (min(k[0] for k in kernels), max(k[1] for k in kernels))
    w0, w1 = window

    def clip(rows):
        return [(max(s, w0), min(e, w1), n) for s, e, n in rows
                if e > w0 and s < w1]

    print(f"    trace planes/lines (event counts): {layout}", flush=True)
    kernels, ops = clip(kernels), clip(ops)
    busy = union_ns([(s, e) for s, e, _ in kernels])
    by_kernel, by_op = {}, {}
    for s, e, n in kernels:
        by_kernel[n] = by_kernel.get(n, 0) + (e - s)
    for s, e, n in ops:
        by_op[n] = by_op.get(n, 0) + (e - s)
    return {"window_ns": w1 - w0, "busy_ns": busy, "by_kernel": by_kernel,
            "by_op": by_op, "layout": layout}


def phase_trace(platform: str, out: Path, voices: int = 1024,
                blocks: int = 32) -> dict:
    import jax

    import bench
    from libzl_tpu.engine import hostcore
    from libzl_tpu.engine import render as render_mod
    from libzl_tpu.ops.voice import fuse_packed

    eng = bench.build_session(128, voices, lookahead=0)
    warm(eng)
    for _ in range(64):
        res = eng.process_block()
    jax.block_until_ready(res.outputs.master)
    trace_dir = out / "trace"
    with jax.profiler.trace(str(trace_dir)):
        with jax.profiler.TraceAnnotation("chip_smoke_window"):
            for _ in range(blocks):
                res = eng.process_block()
            jax.block_until_ready(res.outputs.master)
    # the gather fusions of the compiled per-block render at this session's
    # dispatch shape (every voice active: the full-pool bucket)
    snap = eng.pool.save_state()
    pi, pf, _ = hostcore.voice_update(
        eng.pool, block_start_sample=float(eng.clock.sample_position),
        tick_anchor_sample=eng.clock.anchor_sample,
        tick_anchor=eng.clock.anchor_tick,
        samples_per_tick=eng.clock.samples_per_tick,
        lane_enabled=eng.lane_enabled)
    eng.pool.restore_state(snap)
    hlo = render_mod.render_block_fused.lower(
        eng._sound_data_for_backend(), fuse_packed(pi, pf),
        eng._packed_strips_for_backend(), block_frames=128,
        quirk_gain=False).compile().as_text()
    (out / "render_block_fused.hlo.txt").write_text(hlo)
    gathers = gather_fusion_names(hlo)
    red = reduce_trace(trace_dir, "chip_smoke_window")
    (out / "trace_kernels.json").write_text(json.dumps(
        {k: red[k] for k in ("window_ns", "busy_ns", "by_kernel", "by_op",
                             "layout")}, indent=1))

    # kernels carry the HLO fusion name with "." spelled "_"
    kernel_names = gathers | {g.replace(".", "_") for g in gathers}

    def is_gather(name):
        return name in kernel_names

    g_kernel = sum(v for k, v in red["by_kernel"].items() if is_gather(k))
    g_op = sum(v for k, v in red["by_op"].items() if is_gather(k))
    g_ns = g_kernel or g_op
    busy_share = red["busy_ns"] / max(red["window_ns"], 1)
    # the gather reads two taps x two channels per voice per frame (f32
    # rows of the interleaved bank) and writes the same count of f32
    V, B = voices, 128
    gather_bytes = 2 * 2 * V * B * 4
    print(f"    traced {blocks} blocks: window {red['window_ns'] / 1e6:.3f} "
          f"ms, device busy {red['busy_ns'] / 1e6:.3f} ms "
          f"({100 * busy_share:.1f}% busy, {100 * (1 - busy_share):.1f}% "
          f"idle), {red['busy_ns'] / blocks / 1e3:.1f} us device per block",
          flush=True)
    print(f"    gather fusions {sorted(gathers)}: "
          f"{g_ns / blocks / 1e3:.2f} us per block "
          f"({100 * g_ns / max(red['busy_ns'], 1):.1f}% of device busy); "
          f"the gather reads {gather_bytes / 1e6:.2f} MB per block "
          f"(2 taps x 2 ch x {V} voices x {B} frames x 4 B)", flush=True)
    top = sorted(red["by_kernel"].items(), key=lambda kv: -kv[1])[:12]
    for name, ns in top:
        print(f"      {ns / blocks / 1e3:9.2f} us/block  {name}"
              f"{'  <- gather' if is_gather(name) else ''}", flush=True)
    if not gathers:
        raise PhaseFailure("no gather fusion in the compiled render")
    return {"trace_busy_share": round(busy_share, 4),
            "trace_device_us_per_block": round(
                red["busy_ns"] / blocks / 1e3, 2),
            "trace_gather_us_per_block": round(g_ns / blocks / 1e3, 2),
            "gather_bytes_per_block": gather_bytes}


def phase_stretch_thumbnails(platform: str) -> dict:
    import jax

    from libzl_tpu.ops.resample import time_stretch
    from libzl_tpu.ops.stretch_jax import time_stretch_jax
    from libzl_tpu.ops.thumbnail import thumbnail_jit, thumbnail_math

    info = {}
    sr = 48000
    t = np.arange(sr) / sr
    x = np.stack([0.4 * np.sin(2 * np.pi * 261.6 * t),
                  0.3 * np.sin(2 * np.pi * 392.0 * t + 0.3)],
                 axis=1).astype(np.float32)
    for factor in (1.37, 0.8):
        info[f"stretch_rel_rms_{factor}"] = check(
            f"stretch x{factor} device vs numpy vocoder",
            rel_rms(time_stretch_jax(x, factor), time_stretch(x, factor)),
            TOL_STRETCH_RMS, what="rel_rms")
    rng = np.random.default_rng(5)
    clips = rng.uniform(-1, 1, (8, 2 * sr, 2)).astype(np.float32)
    mins, maxs = thumbnail_jit(jax.device_put(clips), 512)
    if {d.platform for d in mins.devices()} != {platform}:
        raise PhaseFailure("thumbnails did not run on the device")
    want = thumbnail_math(np, clips, 512)
    err = max(max_abs_err(mins, want[0]), max_abs_err(maxs, want[1]))
    info["thumbnail_err"] = check("thumbnails min/max (exact)", err, 0.0)
    return info


def phase_four(devices, platform: str, voices: int = 4096,
               blocks: int = 400) -> dict:
    """The voice-sharded engine over a mesh of `devices`, per-block and
    horizon, against one device and the numpy engine."""
    import jax

    import bench
    from libzl_tpu.parallel.sharding import make_mesh

    info = {}
    mesh = make_mesh(devices=list(devices))
    t0 = time.perf_counter()
    ref = render_blocks(bench.build_session(128, voices, backend="numpy"),
                        blocks)
    print(f"    numpy reference: {blocks} blocks at {voices} voices in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    single_eng = bench.build_session(128, voices)
    n, secs = warm(single_eng)
    print(f"    one device: warm-up compiled {n} graphs in {secs:.1f} s",
          flush=True)
    single = render_blocks(single_eng, blocks, platform)
    info["err_single_vs_numpy"] = compare_blocks(
        "one device vs numpy", single, ref, TOL_AUDIO)
    mesh_devs = set(mesh.devices.flat)
    for la in ("auto", 0):
        eng = bench.build_session(128, voices, lookahead=la, mesh=mesh)
        n, secs = warm(eng)
        print(f"    mesh of {mesh.size}, lookahead={la}: warm-up compiled "
              f"{n} graphs in {secs:.1f} s", flush=True)
        t0 = time.perf_counter()
        got = render_blocks(eng, blocks, platform)
        print(f"    mesh lookahead={la}: {blocks} blocks in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for arr in (eng._device_sound_data, eng._device_strips):
            if not (arr.sharding.is_fully_replicated
                    and set(arr.devices()) == mesh_devs):
                raise PhaseFailure("bank/strips are not replicated over "
                                   "the mesh")
        res = eng.process_block().outputs.master
        if isinstance(res, jax.Array) and set(res.devices()) != mesh_devs:
            raise PhaseFailure(f"mesh master lives on {res.devices()}")
        print(f"    mesh bank sharding {eng._device_sound_data.sharding}",
              flush=True)
        info[f"err_mesh_{la}_vs_numpy"] = compare_blocks(
            f"mesh lookahead={la} vs numpy", got, ref, TOL_AUDIO)
        info[f"err_mesh_{la}_vs_single"] = compare_blocks(
            f"mesh lookahead={la} vs one device", got, single, TOL_AUDIO)
    return info


# ------------------------------------------------------------------- main

def card_line() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return proc.stdout.strip() or proc.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the voice-sharded mesh phase")
    ap.add_argument("--out", default=str(REPO / "smoke_out"))
    args = ap.parse_args(argv)
    print(f"card: {card_line()}", flush=True)

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    print(f"jax {jax.__version__}: {len(devices)} x {platform} "
          f"({devices[0].device_kind})", flush=True)
    if platform != "gpu":
        print(f"device check: FAIL (JAX found {platform}, not gpu)",
              flush=True)
        return 2
    if args.four and len(devices) < 4:
        print(f"device check: FAIL (--four needs 4 devices, found "
              f"{len(devices)})", flush=True)
        return 2
    print("device check: PASS", flush=True)

    sys.path.insert(0, str(REPO))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.four:
        phases = [("four", lambda: phase_four(devices[:4], platform))]
    else:
        phases = [
            ("engine", lambda: phase_engine(platform)),
            ("c_abi", lambda: phase_capi(platform, out)),
            ("trace", lambda: phase_trace(platform, out)),
            ("stretch_thumbnails", lambda: phase_stretch_thumbnails(platform)),
        ]
    summary = {"card": card_line()}
    for name, fn in phases:
        print(f"phase {name}:", flush=True)
        t0 = time.perf_counter()
        try:
            summary[name] = fn()
        except Exception as exc:
            print(f"phase {name}: FAIL after {time.perf_counter() - t0:.1f} "
                  f"s: {type(exc).__name__}: {exc}", flush=True)
            import traceback

            traceback.print_exc()
            return 1
        print(f"phase {name}: PASS in {time.perf_counter() - t0:.1f} s",
              flush=True)
    stats = devices[0].memory_stats() or {}
    summary["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    print(f"peak device memory: {summary['peak_bytes_in_use']} bytes "
          f"(memory_stats peak_bytes_in_use, device 0)", flush=True)
    (out / "summary.json").write_text(json.dumps(summary, indent=1,
                                                 default=str))
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
