"""Python side of the C ABI bridge (lib/libzl.cpp equivalent).

The reference exposes an extern "C" surface (lib/libzl.h) that a ctypes/QML
client drives; every mutating call is marshalled onto the JUCE message thread
and global singletons own the engine (lib/libzl.cpp:39-42,107-116,132-135).
Here the same surface is implemented in two layers:

- native/libzl_shim.cpp: a C++ shared library exporting the exact libzl.h
  symbols, embedding CPython and forwarding each call to this module.
- this module: owns the singleton EngineRuntime (AudioEngine + a pump thread
  that renders blocks paced to the wall clock — the JACK-callback cadence
  analog) and implements each C entry point as a plain function.

Handles: clips cross the ABI as integer ids packed into the opaque pointer
(ClipAudioSource_byID registry analog). C callbacks arrive as raw function
pointers and are wrapped with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading
import time
from typing import Optional

import numpy as np

_PROGRESS_CB = ctypes.CFUNCTYPE(None, ctypes.c_float)
_LEVEL_CB = ctypes.CFUNCTYPE(None, ctypes.c_float)
_TIMER_CB = ctypes.CFUNCTYPE(None, ctypes.c_int)

_flat_concat_jit = None


def _flat_concat(parts: tuple):
    """jit(flatten+concat) over a tuple of device arrays — one dispatch
    instead of one reshape dispatch per array (jax lazily imported: the
    numpy backend never calls this)."""
    global _flat_concat_jit
    if _flat_concat_jit is None:
        import jax
        import jax.numpy as jnp

        _flat_concat_jit = jax.jit(
            lambda ps: jnp.concatenate([jnp.ravel(p) for p in ps]))
    return _flat_concat_jit(parts)


def _set_realtime_priority() -> None:
    """Elevate the CALLING thread to SCHED_FIFO (the reference's RT tick
    thread runs SCHED_FIFO max priority, lib/SyncTimer.cpp:139-142). On
    Linux, sched_setscheduler(0, ...) applies to the calling thread, so
    the pump gets RT scheduling while the speculative sim/dispatch
    workers stay SCHED_OTHER — on few-core hosts the workers' native
    horizon sims and payload packs otherwise timeslice-delay a short
    emit block past its 2.67 ms budget. Priority via LIBZL_TPU_RT_PRIORITY
    (default 10, 0 disables); EPERM (non-root, no CAP_SYS_NICE) is
    normal and silently ignored — behavior is then identical to before.
    """
    try:
        prio = int(os.environ.get("LIBZL_TPU_RT_PRIORITY", "10") or 0)
    except ValueError:
        prio = 0
    if prio <= 0 or not hasattr(os, "sched_setscheduler"):
        return
    try:
        os.sched_setscheduler(0, os.SCHED_FIFO, os.sched_param(prio))
    except (PermissionError, OSError, AttributeError):
        pass


class EngineRuntime:
    """The process-wide engine singleton + block pump thread."""

    def __init__(self, sample_rate: int = 48000, block_frames: int = 128,
                 num_voices: int = 256, backend: str = "auto",
                 pipeline_depth: int = 1,
                 bounce_drain: "int | str" = "auto",
                 lookahead: "int | str" = "auto",
                 quirk_gain: bool = False):
        from ..engine.engine import AudioEngine

        # backend "auto" resolves in the engine (libzl_tpu.device): jax on
        # an accelerator, numpy only on a host without one
        self.engine = AudioEngine(
            sample_rate=sample_rate,
            block_frames=block_frames,
            num_voices=num_voices,
            backend=backend,
            lookahead=lookahead,
            quirk_gain=quirk_gain,
        )
        # blocks in flight on the device before the host consumes the oldest
        # (each level hides one block of host->device sync behind device
        # render; costs pipeline_depth blocks of meter/recorder latency)
        self.pipeline_depth = max(int(pipeline_depth), 0)
        # schedule-ahead tracks real output latency (render + pipeline)
        self.engine.output_latency_blocks = 1 + self.pipeline_depth
        # audio output sink (io/sinks): the system:playback_1/2 analog; the
        # pump writes every consumed block's master mix here, in order
        self.sink = None
        # audio input source (io/sources): the SystemCapture tap analog;
        # the pump pulls one block per cycle into the capture meters
        self.source = None
        # bounce drain: for NON-pacing sinks (file/null bounces) accumulate
        # K blocks' master mixes device-side and fetch them in ONE
        # device->host transfer — each sync carries a fixed cost
        # regardless of size, so K blocks per sync amortizes it K-fold.
        # Global-playback recording rides the drain (its input IS the
        # fetched master); other per-block consumers (port/channel
        # recorders, capture sources, pacing sinks) fall back to per-block
        # delivery. "auto" = 32 on the jax backend (a depth tuned on the
        # earlier remote-attached target, not yet measured on the GPU; the
        # meter-cadence session fetch rides the same transfer), 1 on
        # numpy. Depth only delays non-pacing consumers: a file bounce
        # sees its audio ≤ K blocks (85 ms) late, never reordered.
        if bounce_drain == "auto":
            bounce_drain = 32 if self.engine.backend == "jax" else 1
        self.bounce_drain_blocks = max(int(bounce_drain), 1)
        self._drain_buf: list = []  # [(block_no, BlockResult)]
        # an in-flight async drain: (buf, plans, cat) whose device->host
        # copy was started with copy_to_host_async and which materializes
        # at the NEXT flush, so the drain copy overlaps rendering
        self._pending_drain = None
        # serializes whole drain flushes: a demanded flush (set_sink on an
        # API thread) must not interleave its sink writes with a pipelined
        # flush the pump is mid-delivery on — batches must land in block
        # order (test_pump_block_sequence_integrity's invariant). Ordering:
        # _flush_lock is taken BEFORE self._lock, never after.
        self._flush_lock = threading.Lock()
        # sinks/sources replaced while pumping await a safe close (set_sink)
        self._retired_io: list = []
        self._pump: Optional[threading.Thread] = None
        self._running = False
        # last per-block exception seen by the pump (see _run's guard)
        self.pump_error: Optional[BaseException] = None
        self._timer_callbacks: list = []
        from collections import deque

        self._cb_ticks = deque()  # ticks awaiting out-of-lock callback fan
        self.engine.timer_callbacks.append(self._fan_timer_callbacks)
        self._lock = threading.RLock()
        # cumulative pump phase timing (seconds) + event counts — the
        # soak/diagnostic view of where the wall clock actually goes
        # (render vs sink vs session vs drain-flush vs pacing sleep)
        self._phase_s: dict = {}
        self._phase_n: dict = {}

    def run_locked(self, fn):
        """Run `fn()` under the engine lock — the public surface for
        external callers (CLI, embedding hosts) that must mutate engine
        state while the pump runs. Keeps the lock-ordering discipline
        (_flush_lock before _lock, never after) internal to this class."""
        with self._lock:
            return fn()

    def _phase(self, name: str, dt: float) -> None:
        self._phase_s[name] = self._phase_s.get(name, 0.0) + dt
        self._phase_n[name] = self._phase_n.get(name, 0) + 1

    def phase_stats(self) -> dict:
        """Cumulative pump phase times (ms) and counts since boot."""
        out = {}
        for k in sorted(self._phase_s):
            out[k + "_ms"] = round(self._phase_s[k] * 1e3, 1)
            out[k + "_n"] = self._phase_n[k]
        return out

    # ------------------------------------------------------------- pumping

    def start_pump(self) -> None:
        if self._pump is not None:
            return
        # compile every voice-bucket render shape BEFORE going realtime: a
        # sparse session growing past a bucket boundary must never trigger
        # a multi-second XLA compile inside the pump (audible dropout).
        # The sound bank is fixed-capacity, so init-time shapes hold as
        # clips load; the persistent compile cache makes this near-free
        # after the first boot. (The initJuce-time setup-cost analog,
        # lib/libzl.cpp:358-410.)
        if self.engine.backend == "jax":
            self.engine.warmup()
            self._warm_drain_shapes()
        # realtime GIL fairness: the speculative sim/dispatch workers run
        # Python stretches (jax arg processing, numpy packing) that hold
        # the GIL for the full switch interval — at the 5 ms default a
        # 2.67 ms-budget pump block can miss its deadline just waiting
        # for the interpreter. 1 ms bounds that wait at negligible
        # context-switch cost (opt out: LIBZL_TPU_GIL_SWITCH_MS=0 keeps
        # the interpreter default).
        ms = os.environ.get("LIBZL_TPU_GIL_SWITCH_MS", "1")
        try:
            if float(ms) > 0:
                sys.setswitchinterval(float(ms) / 1e3)
        except ValueError:
            pass
        self._running = True
        self._pump = threading.Thread(target=self._run, daemon=True)
        self._pump.start()

    def _warm_drain_shapes(self) -> None:
        """Pre-compile the pipelined flush's jitted concat for the shape
        signatures the drain windows will hit, so attaching a bounce sink
        mid-performance never pays an XLA compile inside the pump
        (seconds per new signature).

        The signature set is tiny and fully determined by (drain depth K,
        meter cadence): a window's parts are its K masters followed by one
        session-array group per cadence block it contains, and every plan
        folds exactly levels_every-1 queued peak pairs (the queue drains
        at every cadence block in BOTH drain and per-block modes, so its
        length at any plan is invariant). The signature therefore depends
        only on the window's PLAN COUNT — enumerate that over every
        window-start residue, since draining can begin at any block number
        (whenever a bounce sink attaches), not just the boot phase."""
        K = self.bounce_drain_blocks
        eng = self.engine
        if K <= 1:
            return
        import jax

        z = eng._zero_outputs()
        dev = {
            name: jax.device_put(getattr(z, name))
            for name in ("master", "lane_peaks", "master_peak",
                         "lane_rms", "voice_peaks")
        }
        le = eng._levels_every
        nq = max(le - 1, 0)
        plan = ([dev["lane_peaks"], dev["master_peak"]] * nq
                + [dev["lane_peaks"], dev["master_peak"],
                   dev["lane_rms"], dev["voice_peaks"]])
        counts = {(s + K) // le - s // le for s in range(le)}
        for p in sorted(counts):
            parts = [dev["master"]] * K + plan * p
            jax.block_until_ready(_flat_concat(tuple(parts)))

    def stop_pump(self) -> None:
        self._running = False
        # local ref: the pump thread nulls self._pump on its own exit path
        # (_run's give-up tail), which can land between a check and a join
        p = self._pump
        if p is not None:
            p.join(timeout=5.0)
            self._pump = None

    def set_sink(self, sink) -> None:
        """Attach/replace the audio output sink (None detaches).

        Safe while the pump runs: the old sink is retired to the pump
        thread (its only user), which closes it at a safe point between
        blocks — closing here would race an in-flight blocking write
        (use-after-close on the ALSA handle)."""
        # blocks drained for the OLD sink must land in it before the swap
        # (a bounce file must not lose its tail to the replacement)
        self._flush_drain()
        with self._lock:
            old, self.sink = self.sink, sink
            if old is not None:
                if self._pump is not None and self._running:
                    self._retired_io.append(old)
                    old = None
        if old is not None:
            old.close()

    def set_source(self, source) -> None:
        """Attach/replace the audio capture source (None detaches); same
        retirement discipline as set_sink. Attaching a source disables the
        bounce drain (per-block capture semantics) — flush first."""
        self._flush_drain()
        with self._lock:
            old, self.source = self.source, source
            if old is not None:
                if self._pump is not None and self._running:
                    self._retired_io.append(old)
                    old = None
        if old is not None:
            old.close()

    def _close_retired_io(self) -> None:
        """Pump-side: close sinks/sources retired by set_sink/set_source
        (no block is in flight on them once the pump reaches this point)."""
        with self._lock:
            retired, self._retired_io = self._retired_io, []
        for item in retired:
            try:
                item.close()
            except Exception:
                pass

    def _consume(self, block_no: int, res) -> None:
        """Deliver one rendered block: the audio sink and recorders need
        every block; meters/positions only at the 50 ms analysis cadence
        (each sync is a round trip). The sink write happens OUTSIDE the
        engine lock: a pacing sink (ALSA PCM) blocks at the hardware rate
        and must not stall C-API calls."""
        sink = self.sink
        if self.bounce_drain_blocks > 1:
            levels = self.engine.levels
            rec_ok = (not levels.is_recording
                      or levels.only_global_recording())
            draining = (
                sink is not None and not sink.pacing
                and self.source is None
                and rec_ok
            )
            if draining:
                # under the lock: set_sink/set_source flush from API
                # threads, and a plain list swap can lose a concurrent
                # append
                with self._lock:
                    self._drain_buf.append((block_no, res))
                    full = (len(self._drain_buf)
                            >= self.bounce_drain_blocks)
                if full:
                    self._flush_drain_pipelined()
                return
            # per-block semantics resumed (recording started / sink
            # swapped): older drained blocks must land FIRST
            if self._drain_buf or self._pending_drain is not None:
                self._flush_drain()
        if sink is not None:
            t0 = time.perf_counter()
            sink.write(np.asarray(res.outputs.master))
            self._phase("sink", time.perf_counter() - t0)
        source = self.source
        capture = (
            source.read(self.engine.block_frames) if source is not None
            else None
        )
        t0 = time.perf_counter()
        with self._lock:
            engine = self.engine
            if capture is not None:
                engine.levels.ingest_capture(capture)
            if engine.levels.is_recording:
                engine.levels.feed_recorders(res.outputs)
            if block_no % engine._levels_every == 0:
                engine.update_session(res, include_recorders=False)
            else:
                # lazy device-side peak max — no sync; drained by the next
                # update_session so transients between analysis points
                # still register on the meters
                engine.accumulate_peaks(res)
        self._phase("session", time.perf_counter() - t0)

    def _plan_drain(self, buf) -> dict:
        """Walk drained blocks in order: accumulate_peaks queues skipped
        blocks' maxima so each cadence block's plan folds everything before
        it."""
        engine = self.engine
        t0 = time.perf_counter()
        plans = {}
        with self._lock:
            for i, (block_no, res) in enumerate(buf):
                if block_no % engine._levels_every == 0:
                    plans[i] = engine.session_fetch_plan(res)
                else:
                    engine.accumulate_peaks(res)
        self._phase("flush_plan", time.perf_counter() - t0)
        return plans

    def _concat_drain(self, buf, plans):
        """One flattened device buffer: the K master mixes plus every
        meter-cadence block's session arrays. The flatten+concat runs as
        ONE jitted call: eagerly, each ravel is its own op dispatch (~40
        per flush). Shape signatures recur (drain depth and cadence pattern are stable), so
        the jit cache holds a handful of entries."""
        import jax

        t0 = time.perf_counter()
        parts = [r.outputs.master for _, r in buf]
        for i in sorted(plans):
            parts.extend(plans[i][0])
        # normalize numpy leaves (the engine's idle-shortcut zero outputs)
        # to COMMITTED device arrays: a tuple mixing numpy and jax arrays
        # keys a fresh jit cache entry per mix pattern — a mid-performance
        # compile _warm_drain_shapes exists to prevent (idle blocks before
        # the first note would re-compile a warmed signature). device_put of a few 1 KB zeros per flush is noise.
        parts = [p if not isinstance(p, np.ndarray) else jax.device_put(p)
                 for p in parts]
        cat = _flat_concat(tuple(parts))
        self._phase("flush_concat", time.perf_counter() - t0)
        return cat

    def _complete_pending_drain(self) -> None:
        """Materialize and deliver the in-flight async drain, if any."""
        with self._lock:
            pending, self._pending_drain = self._pending_drain, None
        if pending is None:
            return
        buf, plans, cat = pending
        t0 = time.perf_counter()
        flat = np.asarray(cat)
        self._phase("flush_sync", time.perf_counter() - t0)
        self._deliver_drained(buf, plans, flat)

    def _flush_drain_pipelined(self) -> None:
        """Pump-path flush: start the new batch's device->host copy
        asynchronously, then deliver the PREVIOUS batch (whose copy has
        been in flight for a whole drain window). Costs one drain window
        of delivery latency — free on the non-pacing bounce sinks drains
        engage on — and overlaps the blocking sync with rendering."""
        with self._flush_lock:
            with self._lock:
                buf, self._drain_buf = self._drain_buf, []
            if not buf:
                self._complete_pending_drain()
                return
            if self.engine.backend != "jax":
                self._flush_buf_sync(buf)
                return
            plans = self._plan_drain(buf)
            cat = self._concat_drain(buf, plans)
            cat.copy_to_host_async()
            with self._lock:
                prev = self._pending_drain
                self._pending_drain = (buf, plans, cat)
            if prev is not None:
                pbuf, pplans, pcat = prev
                t0 = time.perf_counter()
                flat = np.asarray(pcat)
                self._phase("flush_sync", time.perf_counter() - t0)
                self._deliver_drained(pbuf, pplans, flat)

    def _flush_drain(self) -> None:
        """Demanded flush (sink/source swaps, record toggles, pump stop,
        step_blocks): deliver EVERYTHING — the in-flight async drain first
        (older blocks), then the current buffer synchronously with one
        device->host transfer (per-block sync cost is one transfer's fixed
        cost / drain depth)."""
        with self._flush_lock:
            self._complete_pending_drain()
            with self._lock:
                buf, self._drain_buf = self._drain_buf, []
            if buf:
                self._flush_buf_sync(buf)

    def _flush_buf_sync(self, buf) -> None:
        plans = self._plan_drain(buf)
        if self.engine.backend == "jax":
            # EAGER flatten+concat here, on purpose: demanded flushes carry
            # arbitrary partial batch lengths (whatever was buffered when
            # the sink swapped / recording toggled / the pump stopped), and
            # each new shape signature through the jitted concat is a
            # multi-second XLA compile. Eager is ~40 small dispatches + one
            # sync — compile-free at any length. The jit cache stays
            # reserved for the pipelined path's recurring steady shapes.
            import jax.numpy as jnp

            t0 = time.perf_counter()
            parts = [r.outputs.master for _, r in buf]
            for i in sorted(plans):
                parts.extend(plans[i][0])
            cat = jnp.concatenate([jnp.ravel(p) for p in parts])
            self._phase("flush_concat", time.perf_counter() - t0)
            t0 = time.perf_counter()
            flat = np.asarray(cat)
            self._phase("flush_sync", time.perf_counter() - t0)
        else:
            parts = [np.ravel(np.asarray(r.outputs.master)) for _, r in buf]
            for i in sorted(plans):
                parts.extend(np.ravel(np.asarray(a)) for a in plans[i][0])
            flat = np.concatenate(parts)
        self._deliver_drained(buf, plans, flat)

    def _deliver_drained(self, buf, plans, flat) -> None:
        engine = self.engine
        B = engine.block_frames
        t0 = time.perf_counter()
        n_master = B * 2
        big = flat[: n_master * len(buf)].reshape(len(buf) * B, 2)
        off = n_master * len(buf)
        fetched = {}
        for i in sorted(plans):
            _, unpack, total = plans[i]
            fetched[i] = unpack(flat, off)
            off += total
        sink = self.sink
        for i, (block_no, res) in enumerate(buf):
            blk = big[i * B:(i + 1) * B]
            if sink is not None:
                sink.write(blk)
            with self._lock:
                levels = engine.levels
                if levels.is_recording and levels.only_global_recording():
                    # the global recorder's input IS the fetched master —
                    # feed it from the batch, no extra sync
                    levels.feed_global_recorder(blk)
                if i in fetched:
                    engine.update_session(res, include_recorders=False,
                                          fetched=fetched[i])
        self._phase("flush_deliver", time.perf_counter() - t0)

    def step_blocks(self, n: int) -> None:
        """Deterministic pump: render and consume `n` blocks synchronously.
        Drives the exact per-block delivery path the wall-clock pump uses
        (sink, recorders, meter cadence) without any timing dependence —
        for tests and offline bounces under LIBZL_TPU_NO_PUMP."""
        if self._pump is not None:
            raise RuntimeError("step_blocks requires the pump to be stopped")
        for _ in range(int(n)):
            with self._lock:
                res = self.engine.process_block()
                block_no = self.engine.total_blocks
            self._consume(block_no, res)
            self._fire_timer_callbacks()
        self._flush_drain()

    def run_ahead_blocks(self) -> int:
        """The pump's wall-clock run-ahead margin in blocks. Must cover
        the lookahead horizon: a horizon-build / adoption block
        legitimately delivers H blocks in one call (its SLO budget is H
        periods — engine process_block accounting), so the pump keeps at
        least H+2 blocks of slack to absorb it without starving the
        sink. tests/test_bridge_api.py pins ahead >= H — the adopt-kind
        H-block budget is honest only while this holds."""
        la = getattr(self.engine, "_lookahead", 0)
        return max(4, 2 * (self.pipeline_depth + 1), la + 2)

    def _run(self) -> None:
        """Render paced to the wall clock, a few blocks ahead (the JACK
        period callback + latency analog; schedule-ahead per SURVEY.md §2)."""
        from collections import deque

        _set_realtime_priority()

        spb = self.engine.block_frames / self.engine.sample_rate
        depth = self.pipeline_depth
        ahead = self.run_ahead_blocks() * spb
        start = time.monotonic()
        rendered = 0.0
        # pipelined dispatch: keep up to `depth` blocks in flight and consume
        # the oldest only after dispatching the newest, so host->device syncs
        # overlap the device rendering ahead (jax dispatch is async). Costs
        # `depth` blocks of meter/recorder latency — the schedule-ahead trade
        # the reference already makes (lib/SyncTimer.cpp:397-411).
        inflight: deque = deque()  # (block_no, BlockResult) oldest first

        consume = self._consume
        consecutive_errors = 0
        while self._running:
            # a pacing sink (ALSA PCM) blocks in write() at the hardware
            # rate — it IS the clock, like JACK's callback cadence; only
            # pace on the wall clock without one
            sink = self.sink
            if sink is None or not sink.pacing:
                now = time.monotonic() - start
                if rendered - now > ahead:
                    t0 = time.perf_counter()
                    time.sleep(spb / 2)
                    self._phase("sleep", time.perf_counter() - t0)
                    continue
            # per-block exception guard: a bad record-port name or malformed
            # command must not silently kill audio forever (the thread looks
            # alive from outside). Record, keep pumping; give up only after
            # sustained failure.
            try:
                t0 = time.perf_counter()
                with self._lock:
                    engine = self.engine
                    res = engine.process_block()
                    inflight.append((engine.total_blocks, res))
                self._phase("render", time.perf_counter() - t0)
                while len(inflight) > depth:
                    consume(*inflight.popleft())
                self._fire_timer_callbacks()  # outside self._lock
                consecutive_errors = 0
            except Exception as e:  # noqa: BLE001 — the guard IS the point
                self.pump_error = e
                consecutive_errors += 1
                if consecutive_errors == 1:
                    import sys
                    import traceback

                    print("libzl_tpu pump: block failed (continuing):",
                          file=sys.stderr)
                    traceback.print_exc()
                if consecutive_errors >= 100:
                    print("libzl_tpu pump: 100 consecutive block failures, "
                          "stopping", file=__import__("sys").stderr)
                    break
                time.sleep(spb)
            if self._retired_io:
                self._close_retired_io()
            # hardware MIDI discovery on the reference's 300 ms connector
            # cadence: the blocking libasound enumeration runs here on the
            # pump thread with NO lock held; only the cheap diff/open/close
            # applies under the lock (render blocks never stall on it)
            router = self.engine.router
            if router.auto_discover and router.scanner.due():
                hints = router.scanner.scan_hints()
                if hints is not None:
                    with self._lock:
                        router.scanner.apply(hints)
            rendered += spb
        # drain in-flight blocks so sink/recorders keep the final audio
        while inflight:
            try:
                consume(*inflight.popleft())
            except Exception:
                pass
        try:
            self._fire_timer_callbacks()
        except Exception:
            pass
        try:
            self._flush_drain()
        except Exception:
            pass
        self._close_retired_io()
        # a give-up exit (100 consecutive failures) must not leave the
        # runtime looking alive: _running=True would make start_pump a
        # silent no-op and route retired sinks/sources to a dead drainer
        self._running = False
        self._pump = None

    def _fan_timer_callbacks(self, tick: int) -> None:
        """Engine-side hook: fires INSIDE process_block, i.e. under
        self._lock on the pump thread. C timer callbacks may re-enter the
        API — including flushing calls (punch-in recording, sink swaps)
        whose _flush_lock must never be taken after self._lock — so the
        actual client callbacks are deferred to _fire_timer_callbacks,
        which the pump/step_blocks run OUTSIDE the lock (the reference
        emits these via queued connections off its RT thread too)."""
        self._cb_ticks.append(int(tick))

    def _fire_timer_callbacks(self) -> None:
        while self._cb_ticks:
            tick = self._cb_ticks.popleft()
            for cb in list(self._timer_callbacks):
                cb(tick)


_runtime: Optional[EngineRuntime] = None


def _rt() -> EngineRuntime:
    if _runtime is None:
        raise RuntimeError("initJuce() has not been called")
    return _runtime


# ---------------------------------------------------------------- lifecycle

def init_engine(sample_rate: int = 48000, block_frames: int = 128,
                num_voices: int = 256, backend: str = "auto",
                pump: bool = True) -> None:
    """initJuce (lib/libzl.cpp:358-410): construct the engine singletons.

    Env overrides for embedding hosts (no Python API available there):
    LIBZL_TPU_BACKEND=numpy|jax, LIBZL_TPU_VOICES, LIBZL_TPU_BLOCK,
    LIBZL_TPU_RATE, LIBZL_TPU_NO_PUMP=1, LIBZL_TPU_PIPELINE=<depth>,
    LIBZL_TPU_BOUNCE_DRAIN=<K> (non-pacing sinks: one device->host sync
    per K blocks — the bounce amortization),
    LIBZL_TPU_LOOKAHEAD=<H> (speculative horizon depth; jax backend only
    — "auto" fills a 2048-frame window: min(16, 2048/block) blocks),
    LIBZL_TPU_SINK=alsa[:dev]|file:path|null,
    LIBZL_TPU_SOURCE=alsa[:dev]|file:path|null,
    LIBZL_TPU_WARMUP=1 (pre-compile every voice-bucket render shape before
    the pump starts — no mid-performance compiles; see AudioEngine.warmup),
    LIBZL_TPU_QUIRK_GAIN=1 (strict-reference audio: reproduce the
    interpolation-gain quirk of lib/SamplerSynthVoice.cpp:204-205 on every
    render — for A/B captures against a real zynthbox unit; default off =
    the corrected reading).
    """
    import os

    global _runtime
    if _runtime is None:
        backend = os.environ.get("LIBZL_TPU_BACKEND", backend)
        num_voices = int(os.environ.get("LIBZL_TPU_VOICES", num_voices))
        block_frames = int(os.environ.get("LIBZL_TPU_BLOCK", block_frames))
        sample_rate = int(os.environ.get("LIBZL_TPU_RATE", sample_rate))
        depth = int(os.environ.get("LIBZL_TPU_PIPELINE", 1))
        drain = os.environ.get("LIBZL_TPU_BOUNCE_DRAIN", "auto")
        if drain != "auto":
            drain = int(drain)
        la = os.environ.get("LIBZL_TPU_LOOKAHEAD", "auto")
        if la != "auto":
            la = int(la)
        if os.environ.get("LIBZL_TPU_NO_PUMP"):
            pump = False
        # build fully before publishing the singleton: a bad sink/source
        # spec must raise WITHOUT leaving a half-initialized, pump-less
        # engine behind (a retry would then silently no-op)
        runtime = EngineRuntime(sample_rate, block_frames, num_voices, backend,
                                pipeline_depth=depth, bounce_drain=drain,
                                lookahead=la,
                                quirk_gain=bool(
                                    os.environ.get("LIBZL_TPU_QUIRK_GAIN")))
        try:
            sink_spec = os.environ.get("LIBZL_TPU_SINK")
            if sink_spec:
                from ..io.sinks import make_sink

                runtime.set_sink(make_sink(sink_spec, sample_rate))
            source_spec = os.environ.get("LIBZL_TPU_SOURCE")
            if source_spec:
                from ..io.sources import make_source

                runtime.set_source(make_source(source_spec, sample_rate))
        except Exception:
            # a bad source spec must not leak the already-attached sink
            # (open ALSA handle / writer thread) on the unpublished runtime
            runtime.set_sink(None)
            runtime.set_source(None)
            raise
        _runtime = runtime
        if os.environ.get("LIBZL_TPU_WARMUP"):
            runtime.engine.warmup()
        if pump:
            _runtime.start_pump()


def shutdown_engine() -> None:
    """shutdownJuce (lib/libzl.cpp:412-415)."""
    global _runtime
    if _runtime is not None:
        _runtime.stop_pump()
        _runtime.set_sink(None)
        _runtime.set_source(None)
        _runtime = None
        # the clip registry is process-global: stale entries would resolve
        # old ids to clips bound to the DEAD engine after a re-init
        # (commands scheduled into a dead StepRing, engine+bank kept alive)
        from ..models import clip as clip_mod

        for c in list(clip_mod._registry.values()):
            c.pending_file = False  # cancel file watchers
        clip_mod._registry.clear()


def reload_zynthian_configuration() -> None:
    """reloadZynthianConfiguration (lib/libzl.cpp:417-419)."""
    _rt().engine.router.reload_configuration()


def db_from_volume(vol: float) -> float:
    """dBFromVolume (lib/libzl.cpp:429)."""
    from ..models.fader import fader_position_to_db

    return fader_position_to_db(vol)


def stop_clips(clip_ids: list[int]) -> None:
    """stopClips (lib/libzl.cpp:441-449)."""
    from ..models.clip import clip_by_id

    for cid in clip_ids:
        clip = clip_by_id(cid)
        if clip is not None:
            clip.stop(-3)


# ------------------------------------------------------- ClipAudioSource API

def clip_new(filepath: str, muted: bool = False) -> int:
    import os

    from ..io.wav import read_audio
    from ..models.clip import ClipAudioSource

    rt = _rt()
    # decode OUTSIDE the engine lock: a long FLAC/MP3 load must not stall
    # the pump past its schedule-ahead (the reference loads on the message
    # thread while the JACK callback keeps rendering); only the engine
    # registration needs the lock
    if not os.path.exists(filepath):
        # the reference tolerates not-yet-written sample files: a 100 ms
        # poll loads them when they land (lib/SamplerSynthSound.cpp:55-58);
        # until then the clip plays a silent placeholder
        with rt._lock:
            clip = ClipAudioSource(rt.engine, filepath=str(filepath),
                                   muted=muted, wait_for_file=True)
        return clip.id
    audio = read_audio(filepath)
    with rt._lock:
        clip = ClipAudioSource(rt.engine, audio=audio, muted=muted)
        clip.filepath = str(filepath)
    return clip.id


def clip_by_id(clip_id: int):
    from ..models.clip import clip_by_id as _by_id

    return _by_id(clip_id)


def _clip(clip_id: int):
    clip = clip_by_id(clip_id)
    if clip is None:
        raise KeyError(f"no clip with id {clip_id}")
    return clip


def clip_destroy(clip_id: int) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).destroy()


def clip_play(clip_id: int, loop: bool, midi_channel: int = -2) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).play(loop, midi_channel)


def clip_stop(clip_id: int, midi_channel: int = -2) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).stop(midi_channel)


def clip_get_duration(clip_id: int) -> float:
    return _clip(clip_id).get_duration()


def clip_get_filename(clip_id: int) -> str:
    import os

    return os.path.basename(_clip(clip_id).filepath)


def clip_set_start_position(clip_id: int, seconds: float) -> None:
    _clip(clip_id).set_start_position(seconds)


def clip_set_length(clip_id: int, beat: float, bpm: int) -> None:
    _clip(clip_id).set_length(beat, bpm)


def clip_set_pan(clip_id: int, pan: float) -> None:
    _clip(clip_id).set_pan(pan)


def clip_set_speed_ratio(clip_id: int, ratio: float) -> None:
    # DEFERRED + under the runtime lock: the re-render runs on the worker
    # and swaps at a block boundary inside process_block (the reference's
    # background needsRender/playbackFileChanged path) — a synchronous
    # STFT on the API thread would race the pump's pool mutations
    rt = _rt()
    with rt._lock:
        _clip(clip_id).set_speed_ratio(ratio, defer=True)


def clip_set_pitch(clip_id: int, semitones: float) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).set_pitch(semitones, defer=True)


def clip_set_gain(clip_id: int, db: float) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).set_gain(db, defer=True)


def clip_set_volume(clip_id: int, vol: float) -> None:
    _clip(clip_id).set_volume(vol)


def clip_set_loop_crossfade(clip_id: int, seconds: float) -> None:
    rt = _rt()
    with rt._lock:
        _clip(clip_id).set_loop_crossfade(seconds, defer=True)


def clip_set_slices(clip_id: int, count: int) -> None:
    _clip(clip_id).set_slices(count)


def clip_keyzone_start(clip_id: int) -> int:
    return _clip(clip_id).keyzone_start


def clip_set_keyzone_start(clip_id: int, v: int) -> None:
    _clip(clip_id).keyzone_start = int(v)


def clip_keyzone_end(clip_id: int) -> int:
    return _clip(clip_id).keyzone_end


def clip_set_keyzone_end(clip_id: int, v: int) -> None:
    _clip(clip_id).keyzone_end = int(v)


def clip_root_note(clip_id: int) -> int:
    return _clip(clip_id).root_note


def clip_set_root_note(clip_id: int, v: int) -> None:
    _clip(clip_id).root_note = int(v)


def clip_adsr_attack(clip_id: int) -> float:
    return _clip(clip_id).adsr_attack


def clip_set_adsr_attack(clip_id: int, v: float) -> None:
    _clip(clip_id).adsr_attack = float(v)


def clip_adsr_decay(clip_id: int) -> float:
    return _clip(clip_id).adsr_decay


def clip_set_adsr_decay(clip_id: int, v: float) -> None:
    _clip(clip_id).adsr_decay = float(v)


def clip_adsr_sustain(clip_id: int) -> float:
    return _clip(clip_id).adsr_sustain


def clip_set_adsr_sustain(clip_id: int, v: float) -> None:
    _clip(clip_id).adsr_sustain = float(v)


def clip_adsr_release(clip_id: int) -> float:
    return _clip(clip_id).adsr_release


def clip_set_adsr_release(clip_id: int, v: float) -> None:
    _clip(clip_id).adsr_release = float(v)


def clip_set_progress_callback(clip_id: int, fn_ptr: int) -> None:
    cb = _PROGRESS_CB(fn_ptr)
    _clip(clip_id).progress_callback = lambda v: cb(float(v))


def clip_set_audio_level_callback(clip_id: int, fn_ptr: int) -> None:
    cb = _LEVEL_CB(fn_ptr)
    _clip(clip_id).audio_level_callback = lambda v: cb(float(v))


# -------------------------------------------------------------- SyncTimer API

def timer_start(bpm: int) -> None:
    """SyncTimer_startTimer: despite the header's `interval` parameter
    name, the reference treats the argument as a BPM —
    SyncTimer::start(int bpm) calls setBpm(bpm) directly
    (lib/SyncTimer.cpp:869-872; libzl.cpp:313 just forwards). A
    reference-compatible client passing 120 must get 120 BPM."""
    rt = _rt()
    # under the runtime lock: transport mutations now preempt the
    # lookahead horizon (catching the pool mirror up), which must not
    # race the pump's process_block
    with rt._lock:
        rt.engine.start_transport(bpm=max(int(bpm), 1))


def timer_stop() -> None:
    rt = _rt()
    with rt._lock:
        rt.engine.stop_transport()


def timer_set_bpm(bpm: float) -> None:
    rt = _rt()
    with rt._lock:
        rt.engine.set_bpm(bpm)


def timer_get_multiplier() -> int:
    from ..constants import BEAT_SUBDIVISIONS

    return BEAT_SUBDIVISIONS


def timer_register_callback(fn_ptr: int) -> None:
    """The reference hands callbacks the tick-within-bar, wrapping at
    BeatSubdivisions*4 = 384 (lib/SyncTimer.cpp:397-409)."""
    from ..constants import TICKS_PER_BAR

    rt = _rt()
    cb = _TIMER_CB(fn_ptr)
    wrapper = lambda tick: cb(int(tick % TICKS_PER_BAR))  # noqa: E731
    wrapper._fn_ptr = fn_ptr
    rt._timer_callbacks.append(wrapper)


def timer_deregister_callback(fn_ptr: int) -> None:
    rt = _rt()
    rt._timer_callbacks = [
        cb for cb in rt._timer_callbacks
        if getattr(cb, "_fn_ptr", None) != fn_ptr
    ]


def timer_queue_clip_to_start(clip_id: int, midi_channel: int = -1) -> None:
    rt = _rt()
    with rt._lock:
        rt.engine.queue_clip_to_start(_clip(clip_id), midi_channel)


def timer_queue_clip_to_stop(clip_id: int, midi_channel: int = -1) -> None:
    rt = _rt()
    with rt._lock:
        rt.engine.queue_clip_to_stop(_clip(clip_id), midi_channel)


# ------------------------------------------------------------ AudioLevels API

def levels_is_recording() -> bool:
    return _rt().engine.levels.is_recording


def levels_set_record_global_playback(should: bool) -> None:
    _rt().engine.levels.set_record_global_playback(should)


def levels_set_global_playback_filename_prefix(prefix: str) -> None:
    _rt().engine.levels.set_global_playback_filename_prefix(prefix)


def levels_start_recording() -> None:
    rt = _rt()
    # blocks drained BEFORE the toggle belong to the pre-record stream:
    # flush them now so the recorder starts at the toggle boundary. The
    # toggle itself runs under the engine lock so it cannot interleave a
    # mid-render block; residual attribution fuzz is the blocks the pump
    # renders between flush-return and lock acquisition (<= pipeline
    # depth — the reference's Qt-thread toggle has the same +-1-cycle
    # fuzz against its JACK callbacks).
    rt._flush_drain()
    rt.run_locked(rt.engine.levels.start_recording)


def levels_stop_recording() -> None:
    rt = _rt()
    # drained blocks rendered while recording must reach the recorder
    # before it closes (same boundary discipline as start)
    rt._flush_drain()
    rt.run_locked(rt.engine.levels.stop_recording)


def levels_set_record_ports_filename_prefix(prefix: str) -> None:
    _rt().engine.levels.set_record_ports_filename_prefix(prefix)


def levels_add_record_port(port: str, channel: int) -> None:
    _rt().engine.levels.add_record_port(port, channel)


def levels_remove_record_port(port: str, channel: int) -> None:
    _rt().engine.levels.remove_record_port(port, channel)


def levels_clear_record_ports() -> None:
    _rt().engine.levels.clear_record_ports()


def levels_set_should_record_ports(should: bool) -> None:
    _rt().engine.levels.set_should_record_ports(should)


# -------------------------------------------------------- JackPassthrough API

_STRIP_KEYS = {"pan": "pan", "dry": "dry", "wet1": "wet1", "wet2": "wet2",
               "muted": "muted"}


def passthrough_set(channel: int, key: str, value: float) -> None:
    _rt().engine.set_strip(channel, **{_STRIP_KEYS[key]: value})


def passthrough_get(channel: int, key: str) -> float:
    return _rt().engine.get_strip(channel, _STRIP_KEYS[key])
