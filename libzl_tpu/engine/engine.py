"""AudioEngine: the host block runtime replacing JACK + SyncTimer.

One object owns the whole render pipeline (SURVEY.md §7 step 4):

    BlockClock (musical time)      StepRing (scheduled events)
          │                              │
          └──> process_block(): drain due ticks -> commands -> VoicePool
                    │
                    ├─ VoicePool.build_program() ───────> render (jit, GPU)
                    ├─ VoicePool.advance()  (host mirror)      │
                    └─ session updates (positions, meters) <───┘

The reference spreads this across an RT tick thread, ~30 JACK client
callbacks and a web of rings (SURVEY.md §2); here a single host thread calls
`process_block()` per 128-frame block and the device renders voices, mixdown,
strips and meters in one XLA program. Timer-command semantics follow the
process-callback switch (lib/SyncTimer.cpp:563-632); transport and stop-flush
follow SyncTimer::start/stop (:870-929).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Callable, Optional

import numpy as np

from ..constants import (
    BPM_MAXIMUM,
    BPM_MINIMUM,
    DEFAULT_BLOCK_FRAMES,
    DEFAULT_BPM,
    DEFAULT_NUM_VOICES,
    DEFAULT_SAMPLE_RATE,
    MIDI_BEAT_CLOCK_BYTE,
    NUM_SAMPLER_CHANNELS,
    channel_to_lane,
)
from ..ops import mixer as mixer_ops
from ..timebase import BlockClock, next_bar_delay
from . import render as render_mod
from .allocator import VoiceAllocator
from .commands import (
    PASSTHROUGH_SETTING_DRY,
    PASSTHROUGH_SETTING_MUTED,
    PASSTHROUGH_SETTING_PAN,
    PASSTHROUGH_SETTING_WETFX1,
    PASSTHROUGH_SETTING_WETFX2,
    ClipCommand,
    Operation,
    TimerCommand,
)
from .scheduler import StepRing, midi_clock_due
from .soundbank import SoundBank
from .voicestate import VoicePool

# lazily-created process-wide workers for speculative horizons: one
# dispatch thread (uploads/enqueues) and one sim thread (host voice sims)
# — split so consecutive horizon uploads run back-to-back while the next
# sim overlaps them (AudioEngine._spec_executor / _spec_sim_executor)
_SPEC_EXECUTOR = None
_SPEC_SIM_EXECUTOR = None


def _nice_spec_worker() -> None:
    """De-prioritize the calling spec-worker thread (Linux: setpriority
    with who=0 is per-thread). Chain sims/uploads are throughput work
    with a whole-horizon deadline; the engine thread's emit path is
    latency work with a one-block budget — on few-core hosts the
    niceness gap keeps the scheduler from timeslicing a short emit
    behind a multi-ms native horizon sim. No-op where unsupported."""
    import sys

    if not sys.platform.startswith("linux"):
        return
    try:
        os.setpriority(os.PRIO_PROCESS, 0, 10)
    except (PermissionError, OSError, AttributeError):
        pass


class _SpecChain:
    """A worker-side speculative horizon CHAIN (engine._maybe_build_spec).

    The sim thread advances a private spec pool horizon after horizon —
    no re-sync between links: horizon N+1's end state IS the pool state
    after its sim — handing each link's upload closure to the dispatch
    thread. Consecutive horizon uploads therefore run back-to-back while
    the next sim overlaps them, instead of sim+upload serializing per
    horizon. Depth-capped at `depth` un-adopted links; every step
    re-checks the owning engine's spec generation and self-terminates
    (releasing its pool) when an event discards the speculation."""

    DEFAULT_DEPTH = max(1, int(os.environ.get("LIBZL_TPU_SPEC_DEPTH", "2")
                                or 2))

    def __init__(self, eng, gen, end_snap, start, lane, anchor,
                 sound, strips, depth=None):
        self.eng = eng
        self.gen = gen
        self.end_snap = end_snap
        self.start = float(start)
        self.lane = lane
        self.anchor = anchor
        self.sound = sound
        self.strips = strips
        self.depth = self.DEFAULT_DEPTH if depth is None else depth
        self.pool = None
        self.dead = False
        self.entries: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._outstanding = 0

    def _depth_now(self) -> int:
        """Speculation depth. FIXED at `depth` (default 2, env
        LIBZL_TPU_SPEC_DEPTH; a value tuned on the earlier remote-attached
        target, not yet measured on the GPU): the pump renders in bursts
        to refill its run-ahead margin, and a depth-1 chain refills only
        at adoption, so an exhaustion inside a burst waits on a horizon
        upload against a 1-block budget. The generation guards
        (kill-before-sim and kill-before-upload) make deep chains cheap
        to discard."""
        return self.depth

    def launch(self) -> None:
        self.eng._spec_sim_executor().submit(self._step)

    def advance(self) -> None:
        """One link was adopted: refill the speculation depth."""
        with self._lock:
            self._outstanding -= 1
        self.eng._spec_sim_executor().submit(self._step)

    def kill(self) -> None:
        """Terminate regardless of generation (adoption-time mismatch):
        the next step sees `dead` and releases the pool."""
        self.dead = True
        self.eng._spec_sim_executor().submit(self._step)

    def _finish(self) -> None:
        self.dead = True
        if self.pool is not None:
            self.eng._spec_pools.append(self.pool)
            self.pool = None

    def _step(self) -> None:
        # sim-thread body; serialized by the single-thread executor
        try:
            eng = self.eng
            if self.dead:
                self._finish()
                return
            if eng._spec_gen != self.gen:
                # an event discarded this speculation while it sat in the
                # worker queue — stop before burning sim/upload time
                self._finish()
                return
            with self._lock:
                if self._outstanding >= self._depth_now():
                    return  # paused; adoption re-submits via advance()
            if self.pool is None:
                self.pool = eng._spec_pool_acquire()
                self.pool.sync_from(eng.pool)
                self.pool.restore_state(self.end_snap)
            bundle = eng._sim_horizon_bundle(
                self.start, pool=self.pool, lane=self.lane,
                anchor=self.anchor, sound=self.sound, strips=self.strips,
            )
            if bundle is None:
                # unencodable program: adoption falls back to a fresh
                # synchronous horizon
                self.entries.put(None)
                self._finish()
                return
            dispatch, snaps, died_lists = bundle
            if eng._spec_gen != self.gen:
                self._finish()
                return

            def guarded_dispatch():
                # a killed chain's queued uploads must not occupy the
                # dispatch worker: real uploads queue behind them and the
                # adoption wait surfaces as emit-block SLO misses in
                # event storms
                if self.dead or eng._spec_gen != self.gen:
                    return None
                return dispatch()

            fut = eng._spec_executor().submit(guarded_dispatch)
            self.entries.put((fut, snaps, died_lists, self.start))
            if not snaps[-1]["active"].any():
                # the whole pool dies within this link: the successor is
                # silence, which the idle shortcut delivers without a
                # dispatch — end the chain after delivering the tail
                self._finish()
                return
            self.start += len(snaps) * eng.block_frames
            with self._lock:
                self._outstanding += 1
                go = self._outstanding < self._depth_now()
            if go:
                eng._spec_sim_executor().submit(self._step)
        except Exception:
            # a failed speculative sim must never take down the audio
            # path: signal the consumer to fall back synchronously
            self.entries.put(None)
            self._finish()


@dataclasses.dataclass
class BlockResult:
    """Host-visible outputs of one processed block."""

    outputs: render_mod.RenderOutputs   # jax or numpy arrays
    midi_out: list                      # [(frame_offset, bytes), ...]
    tick_count: int


class AudioEngine:
    def __init__(
        self,
        sample_rate: int = DEFAULT_SAMPLE_RATE,
        block_frames: int = DEFAULT_BLOCK_FRAMES,
        num_voices: int = DEFAULT_NUM_VOICES,
        backend: str = "jax",
        voices_per_lane: Optional[int] = None,
        quirk_gain: bool = False,
        host_core: str = "auto",
        mesh=None,
        bank_dtype: str = "float32",
        voice_buckets: str = "auto",
        lookahead: "str | int" = "auto",
    ):
        from ..device import device_info, log, resolve_backend

        backend = resolve_backend(backend)
        self.sample_rate = sample_rate
        self.block_frames = block_frames
        self.backend = backend
        self.quirk_gain = quirk_gain
        if backend == "jax":
            # persistent XLA compilation cache: a fresh process reads
            # compiled kernels instead of recompiling every shape
            from ..device import use_compile_cache

            use_compile_cache()
        if bank_dtype not in ("float32", "int16"):
            raise ValueError(f"bank_dtype must be float32|int16: {bank_dtype}")
        self.bank_dtype = bank_dtype
        # multi-device: shard the voice axis over a jax.sharding.Mesh; the
        # per-lane mixdown contraction becomes a local matmul + psum
        # (parallel/sharding.py)
        self.mesh = mesh
        # shard_map renders, created lazily per kind (block | horizon):
        # each device renders its local voice shard, explicit psum
        # mixdown, replicated strip/meter tail. The lookahead horizon uses
        # the same slice dispatch as single-device; warmup() compiles
        # every (bucket, kind) up front.
        self._mesh_renders: dict = {}
        if mesh is not None:
            if backend == "numpy":
                raise ValueError("mesh sharding requires the jax backend")
            if num_voices % mesh.size != 0:
                raise ValueError(
                    f"num_voices ({num_voices}) must divide evenly over the "
                    f"{mesh.size}-device mesh"
                )
        # where the engine renders (platform, device kind, count): logged
        # once here and reported by stats()
        self.device = device_info(backend, mesh)
        log.info("libzl_tpu renders on %s (%s) x%d", self.device["platform"],
                 self.device["device_kind"], self.device["device_count"])
        # native host core (native/zl_hostcore.cpp): one-pass program build +
        # state advance; numpy path remains the reference implementation
        self.use_native_host = False
        if host_core in ("auto", "native"):
            from . import hostcore as _hostcore

            if _hostcore.available():
                self.use_native_host = True
            elif host_core == "native":
                raise RuntimeError("native host core requested but unavailable")

        # Speculative lookahead horizon: render H blocks in ONE
        # upload+dispatch and emit them as per-block slices, preempting the
        # horizon whenever an event lands (so note latency stays one block).
        # The horizon is H stacked per-block programs built by simulating
        # the host's own per-block advance, so a committed schedule's
        # horizon output equals per-block output, and clean blocks
        # amortize the per-dispatch upload and launch cost H-fold. Event
        # blocks rebuild the horizon in the same dispatch when traffic is
        # sparse (REBUILD_MIN_GAP), else fall back to per-block. "auto"
        # fills a 2048-frame window (16 blocks at the live geometry) — a
        # depth tuned on the earlier remote-attached target, not yet
        # measured on the GPU.
        if lookahead == "auto":
            self._lookahead = (
                max(min(16, 2048 // block_frames), 0)
                if (backend == "jax" and block_frames <= 2048) else 0
            )
            if self._lookahead == 1:
                self._lookahead = 0
        else:
            self._lookahead = max(int(lookahead), 0)
            if self._lookahead == 1:
                self._lookahead = 0  # a 1-block horizon is the plain path
            if self._lookahead and backend != "jax":
                raise ValueError("lookahead requires the jax backend")
        self._h_slices: list = []       # pending device outputs
        self._h_snaps: list = []        # pool state AFTER each slice
        self._h_died: list = []         # (clip_id, position_id) per slice
        self._h_cursor = 0
        self._h_fingerprint = None
        self._h_start0 = 0.0
        # speculative NEXT horizon: built+dispatched mid-emission from the
        # current horizon's end snapshot so device render overlaps
        # emission (see _maybe_build_spec); adopted at exhaustion
        self._h_next = None  # live _SpecChain, or None
        self._h_next_start = 0.0
        # dedicated pools for worker-side speculative sims (never the live
        # pool off the engine thread); free list, see _spec_pool_acquire
        self._spec_pools: list = []
        # generation counter for cancelling orphaned speculative builds
        # (bumped by _discard_horizon; read GIL-atomically on the worker)
        self._spec_gen = 0
        self._h_spec_tried = False
        self._spec_built_this_block = False
        self._h_built_this_block = False
        self._adopted_this_block = False
        self._clean_run = 0
        self._block_dirty = False
        # event pacing: blocks since the last event/preemption block. An
        # event block REBUILDS the horizon in the same dispatch when recent
        # traffic is sparse enough for speculation to pay (see
        # _lookahead_outputs) — constant-preemption storms degrade to the
        # per-block path instead of wasting H-fold speculative renders.
        self._blocks_since_event = 0
        self._oob_preempt = False

        self.clock = BlockClock(
            sample_rate=float(sample_rate),
            block_frames=block_frames,
            bpm=float(DEFAULT_BPM),
        )
        self.ring = StepRing()
        self.pool = VoicePool(num_voices, block_frames, float(sample_rate))
        # Bucketed prefix rendering: the allocator claims the FIRST idle
        # voice (lib/SamplerSynth.cpp:204-215), so live voices cluster at
        # low indices and a sparse session only needs a prefix of the pool
        # on the device. "auto" renders the smallest ladder bucket covering
        # the highest active index — a reference-scale session (<= 96
        # voices, lib/SamplerSynth.cpp:23) on a 1024-voice engine then pays
        # 64-voice render cost. Each bucket size compiles once (ladder is
        # geometric => at most log2(V/64)+2 compiles; the persistent
        # compile cache keeps them across processes). Inactive voices contribute
        # nothing and do not advance, so outputs are identical; the
        # voice_peaks tail is zero-padded to keep output shapes stable.
        if voice_buckets not in ("auto", "off"):
            raise ValueError("voice_buckets must be 'auto' or 'off'")
        self._bucket_ladder = None
        if (voice_buckets == "auto" and backend == "jax"
                and num_voices > 64):
            # under a mesh each bucket must split evenly over the devices,
            # so a sparse session renders a prefix of every local shard
            # instead of paying full-pool cost
            unit = 1 if mesh is None else mesh.size
            ladder = []
            s = ((64 + unit - 1) // unit) * unit
            while s < num_voices:
                ladder.append(s)
                s *= 2
            if ladder:  # at least one size below the full pool
                ladder.append(num_voices)
                self._bucket_ladder = ladder
        self.allocator = VoiceAllocator(self.pool, voices_per_lane)
        self.bank = SoundBank()
        self._bank_version_on_device = -1
        self._device_sound_data = None
        self._device_strips = None
        self._host_strips_snapshot = None

        self.strips = mixer_ops.default_strip_params(render_mod.NUM_STRIPS)
        # GlobalPlayback strip gets its wets zeroed (lib/MidiRouter.cpp:876-880)
        self.strips.wet1[0] = 0.0
        self.strips.wet2[0] = 0.0
        self.lane_enabled = np.ones(NUM_SAMPLER_CHANNELS, bool)

        self.clips: dict[int, object] = {}
        from ..midi.router import MidiRouter
        from ..midi.transport import TransportManager
        from ..models.sampler_map import SamplerNoteMapper

        self.router = MidiRouter()
        self.transport = TransportManager(self)
        self.sampler_map = SamplerNoteMapper(self)
        # When True (default), Start/StopPlayback timer commands drive the
        # engine transport directly; the reference instead emits
        # pleaseStart/StopPlayback for the UI to act on — callbacks fire
        # either way.
        self.transport_commands_control_engine = True
        from ..models.audio_levels import AudioLevels

        self.levels = AudioLevels(self)
        # 50 ms analysis cadence in blocks (lib/AudioLevels.cpp:325)
        self._levels_every = max(
            int(0.05 * sample_rate / block_frames), 1
        )
        self._last_analyze_block = -(10**9)
        # queued per-block peak arrays (see accumulate_peaks)
        self._peak_accum: list = []
        # completed deferred clip renders awaiting their block-boundary swap
        # (models/clip._render_worker appends; drained in process_block)
        # deferred clip renders completed by the worker thread; deque's
        # atomic append/popleft close the swap-vs-append race a plain list
        # drain has (an append landing on the detached list is lost)
        import collections

        self._pending_renders: "collections.deque" = collections.deque()
        self.transport_running = False
        # per-block time-weighted transport BPM (the quantized blend the
        # reference publishes to the JACK timebase, lib/SyncTimer.cpp:644-673)
        self.period_bpm = float(DEFAULT_BPM)
        # callbacks (SyncTimer signals / C callback registry,
        # lib/SyncTimer.cpp:397-401, libzl.h:74-75)
        self.timer_callbacks: list[Callable[[int], None]] = []
        self.timer_command_callbacks: list[Callable[[TimerCommand], None]] = []
        self.start_playback_callbacks: list[Callable[[], None]] = []
        self.stop_playback_callbacks: list[Callable[[], None]] = []
        self.clip_command_sent_callbacks: list[Callable[[ClipCommand], None]] = []
        self.total_blocks = 0
        # observability (utils/profiling; SURVEY.md §5 tracing/xrun analogs)
        from ..utils.profiling import (
            BlockProfiler, DspLoad, EventWatchdog, SloCounter,
        )

        period = block_frames / sample_rate
        self.profiler = BlockProfiler()
        self.slo = SloCounter(budget_seconds=period)
        # context snapshots of the worst deadline misses (top-N by
        # overrun): which block, which dispatch path, where in the horizon
        # the pump was, and how long since the last event — the per-kind
        # histogram says WHICH path misses, this says WHY (built only on a
        # miss, so it costs nothing on the hot path)
        self._slo_worst: list = []
        self.dsp_load = DspLoad(period_seconds=period)
        # per-block scheduled-vs-delivered event accounting across the MIDI
        # fabric (MidiRouterWatchdog analog, lib/MidiRouter.cpp:135-188)
        self.watchdog = EventWatchdog()

    # ------------------------------------------------------------ clip admin

    @property
    def bpm(self) -> float:
        return self.clock.bpm

    def register_clip(self, clip) -> None:
        """SamplerSynth::registerClip analog: load the clip's playback buffer
        into the device sound bank."""
        clip.slot = self.bank.load(clip.playback_audio)
        self.clips[clip.id] = clip

    def reload_clip_sound(self, clip) -> None:
        """playbackFileChanged analog (lib/SamplerSynthSound.cpp:68)."""
        # pool state is about to change: catch the mirror up / discard any
        # speculative horizon first (same discipline as command hooks)
        self._mark_event()
        clip.slot = self.bank.replace(clip.slot.slot, clip.playback_audio)
        # live voices switch to the new render at the next block, like the
        # reference's per-block buffer re-read (SamplerSynthVoice.cpp:189-191)
        self.pool.rebase_clip(clip.id, clip.slot.base, clip.slot.length)

    def unregister_clip(self, clip) -> None:
        if clip.id in self.clips:
            del self.clips[clip.id]
        if clip.slot is not None:
            self.bank.unload(clip.slot.slot)
            clip.slot = None

    # ------------------------------------------------------------ scheduling

    def schedule_clip_command(self, cmd: ClipCommand, delay: int = 0) -> None:
        self.ring.schedule_clip_command(cmd, delay)

    def schedule_timer_command(self, cmd: TimerCommand, delay: int = 0) -> None:
        self.ring.schedule_timer_command(cmd, delay)

    def schedule_midi(self, data: bytes, delay: int = 0) -> None:
        self.ring.schedule_midi(data, delay)

    def schedule_note(
        self,
        midi_note: int,
        midi_channel: int,
        set_on: bool = True,
        velocity: int = 64,
        duration: int = 0,
        delay: int = 0,
    ) -> None:
        """Schedule a MIDI note with an optional automatic off `duration`
        ticks later (SyncTimer::scheduleNote, lib/SyncTimer.cpp:1069-1087;
        the off velocity is 64 like the reference). The note flows through
        the MidiRouter — a SAMPLER-destination channel reaches clips via
        the keyzone mapper, sample-accurately."""
        status = (0x90 if set_on else 0x80) | (midi_channel & 0x0F)
        self.ring.schedule_midi(
            bytes([status, midi_note & 0x7F, velocity & 0x7F]), delay
        )
        if set_on and duration > 0:
            self.schedule_note(
                midi_note, midi_channel, False, 64, 0, delay + duration
            )

    def send_note_immediately(self, midi_note: int, midi_channel: int,
                              set_on: bool = True, velocity: int = 64) -> None:
        """SyncTimer::sendNoteImmediately (lib/SyncTimer.cpp:1096-1105)."""
        self.schedule_note(midi_note, midi_channel, set_on, velocity, 0, 0)

    def queue_clip_to_start(self, clip, midi_channel: int = -1) -> None:
        """Schedule a looped start at the next bar boundary
        (lib/SyncTimer.cpp:816-832)."""
        cmd = ClipCommand.channel(clip.id, midi_channel)
        cmd.midi_note = 60
        cmd.change_volume = True
        cmd.volume = 1.0
        # restart the loop rather than layering a second one
        # (lib/SyncTimer.cpp:825-827: stopPlayback AND startPlayback)
        cmd.stop_playback = True
        cmd.start_playback = True
        cmd.looping = True
        cmd.change_looping = True
        delay = (
            0 if not self.transport_running
            else next_bar_delay(self.clock.tick_position)
        )
        self.schedule_clip_command(cmd, delay)

    def queue_clip_to_stop(self, clip, midi_channel: int = -1) -> None:
        cmd = ClipCommand.channel(clip.id, midi_channel)
        cmd.midi_note = 60
        cmd.stop_playback = True
        delay = (
            0 if not self.transport_running
            else next_bar_delay(self.clock.tick_position)
        )
        self.schedule_clip_command(cmd, delay)

    # ------------------------------------------------------------- transport

    def start_transport(self, bpm: Optional[float] = None) -> None:
        """SyncTimer::start (lib/SyncTimer.cpp:870-879)."""
        self._mark_event()
        if bpm is not None:
            self.set_bpm(bpm)
        self.transport_running = True

    def stop_transport(self) -> None:
        """SyncTimer::stop with the ring flush (lib/SyncTimer.cpp:881-929)."""
        self._mark_event()
        self.transport_running = False
        note_offs, zeroed = self.ring.flush_for_stop()
        for cmd in zeroed:
            self.ring.schedule_clip_command(cmd, 0)
        # extend, don't overwrite: a second stop landing before the next
        # block must not discard the first flush's undelivered note-offs
        pending = getattr(self, "_pending_immediate_midi", [])
        pending.extend(ev.data for ev in note_offs)
        self._pending_immediate_midi = pending
        # musical position resets (beat/cumulativeBeat/jackPlayhead zeroing)
        self.clock.tick_position = 0
        self.clock.anchor_tick = 0
        self.clock.anchor_sample = float(self.clock.sample_position)

    def set_bpm(self, bpm: float) -> None:
        self.clock.set_bpm(float(np.clip(bpm, BPM_MINIMUM, BPM_MAXIMUM)))

    # output latency in blocks: 1 render block + the pump's pipeline depth;
    # the runtime updates this when the depth changes (the JACK latency-
    # callback analog, lib/SyncTimer.cpp:726-743)
    output_latency_blocks = 2

    def schedule_ahead_amount(self) -> int:
        """Ticks of schedule-ahead covering the engine's output latency
        (scheduleAheadAmount analog, lib/SyncTimer.cpp:711-715): the block
        pipeline depth in ticks plus one guard tick."""
        from ..timebase import schedule_ahead_ticks

        latency = (
            self.output_latency_blocks * self.block_frames / self.sample_rate
        )
        return schedule_ahead_ticks(self.bpm, latency)

    def stop_all_clips(self) -> None:
        """stopClips C API analog (lib/libzl.cpp:441-449)."""
        for clip in list(self.clips.values()):
            clip.stop(-3)

    # ---------------------------------------------------------- passthrough

    def strip_index(self, channel: int) -> int:
        """C API channel convention: -1 = GlobalPlayback, 0..9 = channels
        (lib/libzl.cpp:476-575)."""
        from ..constants import PASSTHROUGH_CHANNEL_MAX, PASSTHROUGH_CHANNEL_MIN

        if not PASSTHROUGH_CHANNEL_MIN <= channel <= PASSTHROUGH_CHANNEL_MAX:
            raise ValueError(f"passthrough channel out of range: {channel}")
        return channel + 1

    def set_strip(self, channel: int, **kwargs) -> None:
        i = self.strip_index(channel)
        for key, value in kwargs.items():
            getattr(self.strips, key)[i] = value

    def get_strip(self, channel: int, key: str) -> float:
        return float(getattr(self.strips, key)[self.strip_index(channel)])

    # -------------------------------------------------------------- commands

    def _mark_event(self) -> None:
        """An event is about to mutate engine/pool state: the speculative
        horizon (if any) is stale from this block on — discard the
        remaining slices. The pool mirror is already at the emission
        frontier (emission restores the per-slice snapshot eagerly), so
        the command applies to current state with no catch-up step."""
        self._block_dirty = True
        if self._h_slices:
            self._discard_horizon()

    def _discard_horizon(self) -> None:
        self._h_slices = []
        self._h_snaps = []
        self._h_died = []
        self._h_cursor = 0
        if self._h_next is not None:
            # explicit kill so a depth-paused chain (no step pending)
            # still runs one last step to return its pool to the free list
            self._h_next.kill()
        self._h_next = None
        self._h_spec_tried = False
        # stale-generation mark: a discarded speculative build that is
        # still queued/running on the dispatch worker early-exits at its
        # next checkpoint instead of burning ~10 ms of worker time per
        # orphan — in an event storm the orphan churn queued real builds
        # behind it and the adoption wait surfaced as emit-block SLO
        # misses (r5b storm soak: 0.855% vs round-4's 0.105%)
        self._spec_gen += 1

    def _apply_timer_command(self, cmd: TimerCommand, tick: int,
                             frame_offset: int) -> None:
        """lib/SyncTimer.cpp:563-632."""
        self._mark_event()
        for cb in self.timer_command_callbacks:
            cb(cmd)
        op = cmd.operation
        if op == Operation.START_PLAYBACK:
            for cb in self.start_playback_callbacks:
                cb()
            if self.transport_commands_control_engine:
                self.start_transport()
        elif op == Operation.STOP_PLAYBACK:
            for cb in self.stop_playback_callbacks:
                cb()
            if self.transport_commands_control_engine:
                self.stop_transport()
        elif op in (Operation.CLIP_COMMAND, Operation.START_CLIP_LOOP,
                    Operation.STOP_CLIP_LOOP):
            clip_cmd = cmd.data_parameter
            if isinstance(clip_cmd, ClipCommand):
                self._apply_clip_command(clip_cmd, tick, frame_offset)
        elif op == Operation.SAMPLER_CHANNEL_ENABLED_STATE:
            # out-of-range channels are silently ignored like the
            # reference's guarded switch (lib/SyncTimer.cpp:563-632 routes
            # to SamplerSynth::setSamplerChannelEnabled which bounds-checks)
            # — a scheduled bad command must not abort the tick walk with
            # the clock half-advanced
            from ..constants import SAMPLER_CHANNEL_MAX, SAMPLER_CHANNEL_MIN

            if SAMPLER_CHANNEL_MIN <= cmd.parameter <= SAMPLER_CHANNEL_MAX:
                lane = channel_to_lane(cmd.parameter)
                self.lane_enabled[lane] = cmd.parameter2 != 0
        elif op == Operation.SET_BPM:
            self.set_bpm(cmd.parameter)
        elif op == Operation.PASSTHROUGH_CLIENT:
            self._apply_passthrough_command(cmd)
        elif op in (Operation.REGISTER_CAS, Operation.UNREGISTER_CAS):
            clip = cmd.data_parameter
            if clip is not None:
                if op == Operation.REGISTER_CAS:
                    self.register_clip(clip)
                else:
                    self.unregister_clip(clip)
        # START_PART / STOP_PART / AUTOMATION / INVALID: observer-only,
        # like the reference's default branch

    def _apply_passthrough_command(self, cmd: TimerCommand) -> None:
        """PassthroughClientOperation value conventions
        (lib/TimerCommand.h:25): volumes 0..100, pan -100..100, muted 0/1.
        Out-of-range channels are ignored (the reference's switches
        bounds-check) — a scheduled bad command must not abort the tick
        walk with the clock half-advanced."""
        from ..constants import PASSTHROUGH_CHANNEL_MAX, PASSTHROUGH_CHANNEL_MIN

        if not PASSTHROUGH_CHANNEL_MIN <= cmd.parameter <= PASSTHROUGH_CHANNEL_MAX:
            return
        i = self.strip_index(cmd.parameter)
        setting = cmd.parameter2
        if setting == PASSTHROUGH_SETTING_DRY:
            self.strips.dry[i] = cmd.parameter3 / 100.0
        elif setting == PASSTHROUGH_SETTING_WETFX1:
            self.strips.wet1[i] = cmd.parameter3 / 100.0
        elif setting == PASSTHROUGH_SETTING_WETFX2:
            self.strips.wet2[i] = cmd.parameter3 / 100.0
        elif setting == PASSTHROUGH_SETTING_PAN:
            self.strips.pan[i] = cmd.parameter3 / 100.0
        elif setting == PASSTHROUGH_SETTING_MUTED:
            self.strips.muted[i] = 1.0 if cmd.parameter3 else 0.0

    def _apply_clip_command(self, cmd: ClipCommand, tick: int,
                            frame_offset: int) -> None:
        self._mark_event()
        clip = self.clips.get(cmd.clip_id)
        # speed/pitch/gain changes route to the clip's offline render —
        # DEFERRED to the render worker: a whole-clip STFT must not stall
        # the realtime block loop (the old buffer plays until the new one
        # lands, exactly the reference's needsRender/playbackFileChanged
        # behavior, lib/ClipAudioSource.cpp:404-413)
        if clip is not None:
            if cmd.change_pitch:
                clip.set_pitch(cmd.pitch_change, defer=True)
            if cmd.change_speed and cmd.speed_ratio > 0:
                # a scheduled bad ratio is ignored (set_speed_ratio raises
                # for direct callers; a mid-tick-walk raise would abort the
                # block with the clock half-advanced)
                clip.set_speed_ratio(cmd.speed_ratio, defer=True)
            if cmd.change_gain_db:
                clip.set_gain(cmd.gain_db, defer=True)
        self.allocator.handle(cmd, clip, tick, frame_offset)
        for cb in self.clip_command_sent_callbacks:
            cb(cmd)

    # ------------------------------------------------------------- rendering

    def _render_bucket(self, prog_i=None) -> Optional[int]:
        """Smallest ladder bucket covering the highest rendering voice, or
        None when bucketing is off. The packed program's own active column
        is authoritative — NOT pool.active, which the native host core has
        already advanced past this block's voice deaths by dispatch time
        (a dying voice still renders its final partial frames,
        lib/SamplerSynthVoice.cpp:248-257)."""
        if self._bucket_ladder is None:
            return None
        if prog_i is None:
            # diagnostic form (tests/probes): pool state between blocks
            act = np.flatnonzero(self.pool.active)
            hi = int(act[-1]) + 1 if act.size else 0
        else:
            from ..ops.voice import active_high_water

            hi = active_high_water(prog_i)
        if hi == 0:
            return self._bucket_ladder[0]
        for s in self._bucket_ladder:
            if s >= hi:
                return s
        return self.pool.num_voices

    def _mesh_render(self, kind: str):
        """Lazily built shard_map render for kind in {block, horizon}.
        Creation is cheap (closure + jit wrapper); compilation happens at
        first call — warmup() triggers every kind a session can dispatch
        so no horizon compiles mid-performance."""
        fn = self._mesh_renders.get(kind)
        if fn is None:
            from ..parallel.sharding import (
                make_shardmap_horizon_render,
                make_shardmap_packed_render,
            )

            if kind == "block":
                fn = make_shardmap_packed_render(
                    self.mesh, block_frames=self.block_frames,
                    quirk_gain=self.quirk_gain,
                )
            else:
                from ..ops.voice import fused_cols

                fn = make_shardmap_horizon_render(
                    self.mesh, block_frames=self.block_frames,
                    slices=self._lookahead, quirk_gain=self.quirk_gain,
                    base_cols=fused_cols(self.pool.n_bq_extra),
                )
            self._mesh_renders[kind] = fn
        return fn

    def _dispatch_packed(self, sound, prog_i, prog_f, strips_packed):
        from ..ops.voice import fuse_packed

        # ONE host->device buffer per block: the program pair fuses into a
        # single int32 matrix (f32 columns bit-cast), so each block pays
        # one transfer's fixed cost instead of two
        fused = fuse_packed(prog_i, prog_f)
        bucket = self._render_bucket(prog_i)
        if bucket is not None and bucket >= fused.shape[0]:
            bucket = None
        if self.mesh is not None:
            # per-shard bucket ladder: a prefix slice re-shards over the
            # mesh (contiguous row blocks), so every device renders
            # bucket/n voices; the shard_map reduction is value-semantic,
            # outputs are identical to full-pool dispatch. voice_peaks
            # comes back at the bucket length — update_session pads.
            fn = self._mesh_render("block")
            return fn(sound, fused if bucket is None else fused[:bucket],
                      strips_packed)
        if bucket is not None:
            # voice_peaks pads back to [V] INSIDE the jit (an eager host
            # concat here would add a dispatch per block)
            return render_mod.render_block_fused(
                sound, fused[:bucket], strips_packed,
                block_frames=self.block_frames, quirk_gain=self.quirk_gain,
                pad_voices_to=self.pool.num_voices,
            )
        return render_mod.render_block_fused(
            sound, fused, strips_packed,
            block_frames=self.block_frames, quirk_gain=self.quirk_gain,
        )

    # ------------------------------------------------- lookahead horizon

    def _release_died(self, died_pairs) -> None:
        """Dead voices release their playback positions
        (lib/SamplerSynthVoice.cpp:156-158)."""
        for cid, pid in died_pairs:
            clip = self.clips.get(int(cid))
            if clip is not None:
                clip.positions_model.remove_position(int(pid))

    def _fingerprint(self):
        """Out-of-band state a horizon depends on: direct API mutations
        (set_bpm, set_strip, lane toggles, bank reloads) that bypass the
        command hooks must still preempt stale slices."""
        from ..ops.voice import pack_strips

        return (
            self.clock.samples_per_tick,
            self.transport_running,
            self.bank.version,
            self.lane_enabled.tobytes(),
            pack_strips(self.strips).tobytes(),
        )

    # an event block rebuilds the horizon in the same dispatch only when
    # the run of clean blocks behind it is at least this long — a storm of
    # back-to-back events must degrade to the per-block path, never burn a
    # speculative H-block render per block (test_event_storm_degrades...)
    REBUILD_MIN_GAP = 3

    def _lookahead_outputs(self) -> Optional[render_mod.RenderOutputs]:
        """Emit the next horizon slice, or None when this block must
        dispatch per-block (event storm / horizon off / no live voices).

        Event blocks REBUILD the horizon from post-event state in one
        dispatch when recent traffic is sparse (gap >= REBUILD_MIN_GAP):
        the event block then costs the same one upload+dispatch as the
        per-block path but delivers H blocks of audio against an H-block
        deadline, so event-dense sessions keep quiet-regime amortization
        (the reference pays zero penalty for event-dense cycles —
        lib/SamplerSynth.cpp:116-148). Quiet
        sessions start a horizon after 3 consecutive clean blocks.

        Quiet runs PIPELINE horizons: one block into emission the next
        horizon is speculatively built from the current one's end
        snapshot and dispatched (_maybe_build_spec), so the device
        renders N+1 while the host emits N's slices; at exhaustion the
        pre-rendered successor is adopted (_adopt_spec) instead of paying
        a serialized build+render+transfer."""
        if self._block_dirty:
            self._clean_run = 0
            if (self._blocks_since_event >= self.REBUILD_MIN_GAP
                    and self.pool.active.any()):
                return self._start_horizon()
            return None
        if self._h_cursor < len(self._h_slices):
            if self._fingerprint() == self._h_fingerprint:
                self._clean_run += 1
                out = self._emit_slice()
                # the block AFTER the build/adopt block (post-emit cursor
                # 2) pipelines the next horizon: build+dispatch N+1 from
                # N's end snapshot while N's 14 remaining slices cover the
                # deadline (budget accounting in process_block)
                if (self._h_cursor == 2 and self._h_next is None
                        and not self._h_spec_tried):
                    self._maybe_build_spec()
                return out
            # out-of-band mutation (direct set_bpm/set_strip/lane/bank):
            # stale slices preempt; rebuild under the same pacing gate
            self._discard_horizon()
            self._clean_run = 0
            self._oob_preempt = True
            if (self._blocks_since_event >= self.REBUILD_MIN_GAP
                    and self.pool.active.any()):
                return self._start_horizon()
            return None
        self._clean_run += 1
        if self._h_next is not None:
            out = self._adopt_spec()
            if out is not None:
                return out
        if self._clean_run < 3 or not self.pool.active.any():
            return None
        return self._start_horizon()

    def _emit_slice(self) -> render_mod.RenderOutputs:
        """Deliver the next pre-rendered slice and synchronize the pool
        mirror to it eagerly (snapshot restore — a memcpy, no recompute),
        releasing the positions of voices that died in that slice."""
        h = self._h_cursor
        out = self._h_slices[h]
        self.pool.restore_state(self._h_snaps[h])
        self._release_died(self._h_died[h])
        self._h_cursor += 1
        return out

    def _sim_horizon_bundle(self, start0: float, pool=None, lane=None,
                            anchor=None, sound=None, strips=None):
        """Sim H blocks from the CURRENT pool state and dispatch ONE
        compact horizon render.

        `pool`/`lane`/`anchor`/`sound`/`strips` default to live engine
        state (the synchronous _start_horizon path); the speculative path
        passes a dedicated spec pool plus engine-thread-resolved inputs so
        the whole sim can run on the dispatch worker without touching the
        live pool (see _maybe_build_spec).

        The horizon is H per-block programs built by simulating the host's
        own per-block build+advance chain (native core or numpy mirror) —
        each slice's program is EXACTLY what per-block dispatch would have
        built, so the device output matches per-block rendering, not an
        f32-tolerance extrapolation. The upload is ONE buffer pair: slice
        0's full fused program plus a compact dynamics matrix
        (ops/voice.pack_horizon_dynamics — only the columns the
        clean-block program builder can vary), ~4.5x fewer bytes than
        stacking H full programs.

        Returns (dispatch_closure, snaps, died_lists) or None when a
        program exceeds the compact encoding; the closure (see
        _horizon_dispatch_closure) performs the upload+enqueue and returns
        the slice outputs. Leaves the pool at the horizon's END state —
        callers restore whatever frontier they need."""
        from ..ops.voice import (
            fuse_packed,
            pack_horizon_dynamics,
            pack_program,
        )

        H = self._lookahead
        B = self.block_frames
        if pool is None:
            pool = self.pool
        if lane is None:
            # persistent frozen-lane buffer: stable identity keeps the
            # native host core's pointer-struct cache warm across horizons
            # (hostcore._build_state); content is re-frozen per build
            lane = getattr(self, "_h_lane", None)
            if lane is None:
                lane = self._h_lane = np.empty_like(self.lane_enabled)
            lane[:] = self.lane_enabled
        if anchor is None:
            anchor = dict(
                tick_anchor_sample=self.clock.anchor_sample,
                tick_anchor=self.clock.anchor_tick,
                samples_per_tick=self.clock.samples_per_tick,
            )
        if self.use_native_host:
            # the WHOLE H-block sim (programs, compact dynamics, per-slice
            # snapshots and deaths) in one native call instead of H
            # per-slice ctypes sims plus numpy dynamics packing
            from . import hostcore as _hostcore

            res = _hostcore.horizon_update(
                pool, slices=H, block_start_sample=start0,
                lane_enabled=lane, **anchor,
            )
            if res is None:
                # a slice exceeded the compact encoding: caller falls back
                # to per-block dispatch after restoring its frontier
                return None
            prog_i0, prog_f0, dyn, snaps, died_lists = res
            dispatch = self._horizon_dispatch_closure(
                prog_i0, prog_f0, dyn, sound=sound, strips=strips)
            return dispatch, snaps, died_lists
        packed: list = []
        snaps: list = []
        died_lists: list = []
        for h in range(H):
            args = dict(block_start_sample=start0 + h * B, **anchor)
            prog = pool.build_program(lane_enabled=lane, **args)
            prog_i, prog_f = pack_program(prog)
            adv = pool.advance(prog)
            died = list(zip(adv["died_clips"], adv["died_positions"]))
            packed.append((prog_i, prog_f))
            snaps.append(pool.save_state())
            died_lists.append(died)
        # the sim advanced the pool H blocks; emission re-anchors it per
        # slice from the snapshots (slice 0 below), so no state is lost
        dyn = pack_horizon_dynamics(packed[1:], pool.istart)
        if dyn is None:
            # a slice exceeded the compact encoding (foreign release frame
            # / pending start past slice 0): caller falls back to
            # per-block dispatch after restoring its frontier
            return None
        prog_i0, prog_f0 = packed[0]
        dispatch = self._horizon_dispatch_closure(
            prog_i0, prog_f0, dyn, sound=sound, strips=strips)
        return dispatch, snaps, died_lists

    def _horizon_dispatch_closure(self, prog_i0, prog_f0, dyn,
                                  sound=None, strips=None):
        """Resolve everything a compact-horizon dispatch needs (device-
        resident sound/strips caches, bucket, mesh fn) and return a
        zero-argument closure that performs ONLY the jit call — upload of
        base+dyn plus enqueue, no engine state touched. The speculative
        path passes `sound`/`strips` resolved on the engine thread and
        runs the rest HERE on the dispatch worker: the bucket is a pure
        function of the simmed program, and _mesh_render's jit cache is
        GIL-atomic, so a concurrent engine-thread dispatch at worst
        duplicates a compile, never corrupts."""
        from ..ops.voice import fuse_packed

        H = self._lookahead
        B = self.block_frames
        base = fuse_packed(prog_i0, prog_f0)
        # base+dyn ship as ONE int32 buffer: one transfer's fixed cost per
        # horizon instead of two (render_horizon_onebuf)
        K = base.shape[1]
        hz = np.concatenate([base, dyn], axis=1)
        if sound is None:
            sound = self._sound_data_for_backend()
        if strips is None:
            strips = self._packed_strips_for_backend()
        # slice 0 bounds the whole horizon: no events land mid-horizon by
        # construction, so the active high-water can only shrink across
        # slices
        V = self.pool.num_voices
        bucket = self._render_bucket(prog_i0)
        if bucket is not None and bucket >= V:
            bucket = None
        hzb = hz if bucket is None else hz[:bucket]
        if self.mesh is not None:
            # per-shard bucketing, same ladder as per-block; voice_peaks
            # return at the bucket length (update_session pads)
            fn = self._mesh_render("horizon")
            return lambda: list(fn(sound, hzb, strips))
        quirk = self.quirk_gain
        pad = 0 if bucket is None else V
        return lambda: list(render_mod.render_horizon_onebuf(
            sound, hzb, strips, block_frames=B, slices=H, base_cols=K,
            quirk_gain=quirk, pad_voices_to=pad,
        ))

    def _start_horizon(self) -> Optional[render_mod.RenderOutputs]:
        """Build + dispatch an H-block horizon from the current frontier;
        emit slice 0. Returns None (pool restored, per-block dispatch
        takes the block) when a program exceeds the compact encoding."""
        snap_pre = self.pool.save_state()
        start0 = float(self.clock.sample_position)
        bundle = self._sim_horizon_bundle(start0)
        if bundle is None:
            self.pool.restore_state(snap_pre)
            return None
        dispatch, snaps, died_lists = bundle
        self._h_slices = dispatch()
        self._h_snaps = snaps
        self._h_died = died_lists
        self._h_cursor = 0
        self._h_start0 = start0
        self._h_fingerprint = self._fingerprint()
        self._h_next = None
        self._h_spec_tried = False
        self._h_built_this_block = True
        return self._emit_slice()

    def _maybe_build_spec(self) -> None:
        """Speculatively build + dispatch the NEXT horizon while this one
        still has slices in hand, from the current horizon's END snapshot
        — the device renders horizon N+1 DURING horizon N's emission run,
        so at exhaustion the next slices are already rendered and the
        steady-state quiet path pays only host-build time, never a
        serialized upload+render+transfer. Any event/OOB mutation
        discards the speculation with the horizon (_discard_horizon); an
        unencodable program simply leaves the speculation unbuilt (one
        attempt per horizon — _h_spec_tried).

        The WHOLE build runs off the engine thread as a _SpecChain: the
        sim thread advances a dedicated spec pool (the live pool is never
        touched off the engine thread) horizon after horizon, handing
        each link's upload/enqueue to the dispatch thread, so
        consecutive horizon uploads run back-to-back while the next sim
        overlaps them. The engine thread's speculative-build block pays
        only input resolution + submit, not the sim. The chain syncs the spec pool from the live pool itself: torn
        reads are safe because every advance-mutated field is overwritten
        by end_snap and any other mutation is an event, which discards
        this speculation before adoption (VoicePool.sync_from)."""
        self._h_spec_tried = True
        end_snap = self._h_snaps[-1]
        if not end_snap["active"].any():
            # whole pool dies within the current horizon: the successor is
            # silence, which the idle shortcut delivers without a dispatch
            return
        start_next = self._h_start0 + len(self._h_slices) * self.block_frames
        # inputs an event could mutate under the worker are resolved HERE
        # (cheap: version-gated caches + a lane memcpy + three floats)
        lane = getattr(self, "_spec_lane", None)
        if lane is None or lane.shape != self.lane_enabled.shape:
            lane = self._spec_lane = np.empty_like(self.lane_enabled)
        lane[:] = self.lane_enabled
        anchor = dict(
            tick_anchor_sample=self.clock.anchor_sample,
            tick_anchor=self.clock.anchor_tick,
            samples_per_tick=self.clock.samples_per_tick,
        )
        chain = _SpecChain(
            self, self._spec_gen, end_snap, start_next, lane, anchor,
            self._sound_data_for_backend(),
            self._packed_strips_for_backend(),
        )
        chain.launch()
        self._h_next = chain
        self._h_next_start = start_next
        self._spec_built_this_block = True

    def _spec_pool_acquire(self):
        """A spec pool matching the live geometry, from the free list or
        fresh (worker-side: list ops are GIL-atomic, and pools return to
        the list only after their build's sim completes — a discard storm
        that queues several builds on the single worker never shares a
        pool between an in-flight sim and a new one)."""
        from .voicestate import VoicePool

        try:
            pool = self._spec_pools.pop()
        except IndexError:
            pool = None
        live = self.pool
        if (pool is None or pool.num_voices != live.num_voices
                or pool.block_frames != live.block_frames
                or pool.output_rate != live.output_rate):
            pool = VoicePool(live.num_voices, live.block_frames,
                             live.output_rate)
        return pool

    def _adopt_spec(self) -> Optional[render_mod.RenderOutputs]:
        """Install the next speculative horizon at exhaustion and emit its
        slice 0 — valid only when nothing the speculation assumed has
        changed: the fingerprint (OOB state) still matches and the clock
        is exactly at the speculated start (events/commands discard the
        speculation before it can go stale, this is the belt). On
        success the chain is told to refill its speculation depth; any
        mismatch/failure kills the chain (it releases its pool on the
        worker) and falls back to a fresh synchronous horizon."""
        chain = self._h_next
        if (self._fingerprint() != self._h_fingerprint
                or float(self.clock.sample_position) != self._h_next_start):
            chain.kill()
            self._h_next = None
            return None
        if chain.dead and chain.entries.empty():
            # ended chain (all voices died in the last delivered link, or
            # a stale generation): nothing more is coming — fall through
            # to the idle shortcut / a fresh synchronous horizon
            self._h_next = None
            return None
        try:
            # the sim thread is at most one link behind; the timeout is a
            # belt against a wedged worker — fall back, never hang audio
            entry = chain.entries.get(timeout=60.0)
        except queue.Empty:
            chain.kill()
            self._h_next = None
            return None
        if entry is None:
            # unencodable program mid-chain: fall back to a fresh
            # synchronous horizon (which re-decides per-block)
            self._h_next = None
            return None
        fut, snaps, died_lists, start = entry
        try:
            slices = fut.result()
        except Exception:
            # a failed speculative dispatch (e.g. backend teardown in a
            # test harness) must not take down the audio path
            chain.kill()
            self._h_next = None
            return None
        if slices is None:
            # the guarded dispatch skipped (chain raced a kill): fall
            # back to a fresh synchronous horizon
            chain.kill()
            self._h_next = None
            return None
        if float(start) != self._h_next_start:
            chain.kill()
            self._h_next = None
            return None
        chain.advance()
        self._adopted_this_block = True
        self._h_slices = slices
        self._h_snaps = snaps
        self._h_died = died_lists
        self._h_cursor = 0
        self._h_start0 = float(start)
        # the chain stays installed as the speculation for the horizon
        # just adopted (its next link is already simming/uploading)
        self._h_next_start = float(start) + len(slices) * self.block_frames
        self._h_spec_tried = True
        return self._emit_slice()

    @staticmethod
    def _spec_executor():
        """Single PROCESS-WIDE dispatch worker for speculative horizon
        uploads (module-level so test harnesses creating many engines
        share one thread). jax dispatch is thread-safe; the closures it
        runs touch no engine state (see _horizon_dispatch_closure)."""
        global _SPEC_EXECUTOR
        if _SPEC_EXECUTOR is None:
            from concurrent.futures import ThreadPoolExecutor

            _SPEC_EXECUTOR = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="libzl-spec-dispatch",
                initializer=_nice_spec_worker,
            )
        return _SPEC_EXECUTOR

    @staticmethod
    def _spec_sim_executor():
        """Single PROCESS-WIDE sim worker for speculative horizon chains
        (_SpecChain._step): host voice sims run here, uploads on the
        dispatch worker, so consecutive horizon uploads pipeline while
        the next sim overlaps them. Single-threaded by design — steps of
        every chain serialize, which is what makes a chain's un-synced
        pool reuse safe."""
        global _SPEC_SIM_EXECUTOR
        if _SPEC_SIM_EXECUTOR is None:
            from concurrent.futures import ThreadPoolExecutor

            _SPEC_SIM_EXECUTOR = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="libzl-spec-sim",
                initializer=_nice_spec_worker,
            )
        return _SPEC_SIM_EXECUTOR

    def _zero_outputs(self) -> render_mod.RenderOutputs:
        if not hasattr(self, "_zero_outputs_cache"):
            B = self.block_frames
            z = np.zeros
            self._zero_outputs_cache = render_mod.RenderOutputs(
                master=z((B, 2), np.float32),
                lane_mix=z((NUM_SAMPLER_CHANNELS, B, 2), np.float32),
                strip_dry=z((render_mod.NUM_STRIPS, B, 2), np.float32),
                strip_wet1=z((render_mod.NUM_STRIPS, B, 2), np.float32),
                strip_wet2=z((render_mod.NUM_STRIPS, B, 2), np.float32),
                lane_peaks=z((NUM_SAMPLER_CHANNELS, 2), np.float32),
                lane_rms=z((NUM_SAMPLER_CHANNELS, 2), np.float32),
                master_peak=z(2, np.float32),
                voice_peaks=z(self.pool.num_voices, np.float32),
            )
        return self._zero_outputs_cache

    def _quantize_bank(self, data):
        """int16 bank (bank_dtype="int16"): halves gather bytes in device
        memory;
        exactly 16-bit-WAV precision. Applied identically on both backends
        so the numpy mirror stays bit-equal to the device."""
        if self.bank_dtype != "int16":
            return data
        return np.clip(
            np.round(data * np.float32(32767.0)), -32768, 32767
        ).astype(np.int16)

    def _sound_data_for_backend(self):
        if self.backend == "numpy":
            if self.bank_dtype == "int16":
                if self._bank_version_on_device != self.bank.version:
                    self._device_sound_data = np.ascontiguousarray(
                        self._quantize_bank(self.bank.data.T)
                    )
                    self._bank_version_on_device = self.bank.version
                return self._device_sound_data
            return self.bank.data
        if self._bank_version_on_device != self.bank.version:
            self._check_bank_capacity(self._render_devices())
            # interleaved [N, 2] rows: one row gather fetches the stereo
            # pair (ops/voice.render_voices)
            self._device_sound_data = self._put_replicated(
                np.ascontiguousarray(self._quantize_bank(self.bank.data.T))
            )
            self._bank_version_on_device = self.bank.version
        return self._device_sound_data

    def _put_replicated(self, x):
        """Upload a rarely-changing input once: to the default device, or
        replicated on every device of the mesh (a NamedSharding), so a
        mesh dispatch never re-copies it from one device."""
        import jax

        if self.mesh is None:
            return jax.device_put(x)
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.device_put(x, NamedSharding(self.mesh, PartitionSpec()))

    def _render_devices(self) -> list:
        """The devices the render runs on: the mesh's, else the default."""
        import jax

        if self.mesh is not None:
            return list(self.mesh.devices.flat)
        return jax.devices()[:1]

    def _check_bank_capacity(self, devices) -> None:
        """Sound memory is REPLICATED per device (any voice may fetch any
        sample — parallel/sharding.py), so the bank must fit every
        device's memory alongside the render working set. Fail loudly at
        upload time with actionable guidance instead of running out of
        memory mid-performance. A sharded bank (voices fetching remote
        shards) was evaluated and rejected: per-block fetch windows are
        small but latency-critical, and the reference's deployment (a
        groovebox sample pool) is far below one device's memory.
        Documented in PARITY.md."""
        itemsize = 2 if self.bank_dtype == "int16" else 4
        bank_bytes = self.bank.data.size * itemsize
        limits = []
        for d in devices:
            try:
                stats = d.memory_stats() or {}
            except Exception:
                stats = {}
            if stats.get("bytes_limit"):
                limits.append(int(stats["bytes_limit"]))
        limit = min(limits) if limits else 0
        if limit and bank_bytes > 0.6 * limit:
            raise RuntimeError(
                f"sound bank ({bank_bytes / 2**30:.2f} GiB, replicated per "
                f"device) exceeds 60% of device memory "
                f"({limit / 2**30:.2f} GiB). Use bank_dtype='int16' (half "
                f"the bytes), unload idle clips, or split the session "
                f"across engines."
            )

    def _packed_strips_for_backend(self):
        """Strips change rarely (UI gestures), so keep a device-resident copy
        and re-upload only when the packed values actually change — a
        per-block transfer would be pure overhead."""
        from ..ops.voice import pack_strips

        packed = pack_strips(self.strips)
        if self.backend == "numpy":
            return packed
        if self._host_strips_snapshot is None or not np.array_equal(
            packed, self._host_strips_snapshot
        ):
            self._device_strips = self._put_replicated(packed)
            self._host_strips_snapshot = packed
        return self._device_strips

    def capture_trace(self, n_blocks: int, outdir: str) -> None:
        """Render `n_blocks` under a jax profiler trace written to `outdir`
        (open with TensorBoard/XProf/Perfetto). The device-side analog of
        the reference's commented-out chrono probes and 0.2 ms/callback
        budget checks (lib/SyncTimer.cpp:694-699) — but capturing the real
        XLA timeline instead of host wall time. Host-side per-stage timing
        stays on utils/profiling.BlockProfiler."""
        if self.backend != "jax":
            raise RuntimeError("capture_trace requires the jax backend")
        import jax

        res = None
        with jax.profiler.trace(outdir):
            for _ in range(max(1, int(n_blocks))):
                res = self.process_block()
            jax.block_until_ready(res.outputs.master)

    def warmup(self) -> int:
        """Compile the render for every voice bucket up front so a growing
        live session never pays a mid-performance compile (the deployment
        analog of the reference paying JACK graph setup at initJuce,
        lib/libzl.cpp:358-410). Safe to call at init: the sound bank is
        fixed-capacity (soundbank.py pre-allocates), so loading clips later
        does not change the compiled shapes — only the rare bank-capacity
        growth retraces. Returns the number of graphs compiled (also kept
        as `self.warmed_graphs` and surfaced in stats()). No-op on the
        numpy backend. The C-ABI pump runs this automatically before going
        realtime; the persistent compile cache keeps the result across
        processes."""
        if self.backend != "jax":
            return 0
        # idempotent per bank shape: the env hook + the pump's automatic
        # call must not compile every bucket twice at startup
        key = (self.bank.data.shape, self.bank_dtype)
        if getattr(self, "_warmed_key", None) == key:
            return 0
        import jax

        from ..ops.voice import fuse_packed, pack_program

        prog = self.pool.build_program(
            block_start_sample=float(self.clock.sample_position),
            tick_anchor_sample=self.clock.anchor_sample,
            tick_anchor=self.clock.anchor_tick,
            samples_per_tick=self.clock.samples_per_tick,
            lane_enabled=self.lane_enabled,
        )
        prog_i, prog_f = pack_program(prog)
        sound = self._sound_data_for_backend()
        strips = self._packed_strips_for_backend()
        fused = fuse_packed(prog_i, prog_f)
        sizes = list(self._bucket_ladder or [self.pool.num_voices])
        hz = None
        if self._lookahead:
            # the horizon dispatch ships base program + compact dynamics as
            # ONE buffer (_horizon_dispatch_closure); the compile only cares
            # about dims, so an all-zero dynamics matrix does
            from ..ops.voice import horizon_dyn_cols

            D = horizon_dyn_cols(self.pool.n_bq_extra)
            hdyn = np.zeros(
                (self.pool.num_voices, 1 + (self._lookahead - 1) * D),
                np.int32,
            )
            hz = np.concatenate([fused, hdyn], axis=1)

        def warm_one(s, kind):
            # mirror _dispatch_packed's exact static signature per bucket
            # (pad_voices_to participates in the jit cache key)
            pad = self.pool.num_voices if s < self.pool.num_voices else 0
            if self.mesh is not None:
                fn = self._mesh_render(kind)
                if kind == "block":
                    out = fn(sound, fused[:s], strips)
                else:
                    out = fn(sound, hz[:s], strips)[0]
            elif kind == "block":
                out = render_mod.render_block_fused(
                    sound, fused[:s], strips,
                    block_frames=self.block_frames,
                    quirk_gain=self.quirk_gain, pad_voices_to=pad,
                )
            else:
                out = render_mod.render_horizon_onebuf(
                    sound, hz[:s], strips,
                    block_frames=self.block_frames,
                    slices=self._lookahead, base_cols=fused.shape[1],
                    quirk_gain=self.quirk_gain, pad_voices_to=pad,
                )[0]
            jax.block_until_ready(out.master)
            return out

        # the work list mirrors the dispatch policy exactly — every
        # (bucket, kind) a session can dispatch, and nothing else
        work = [(s, "block") for s in sizes]
        if self._lookahead:
            work += [(s, "horizon") for s in sizes]
        self.warmed_graphs = len(work)
        jobs = int(os.environ.get("LIBZL_TPU_WARMUP_JOBS", "4") or "1")
        if jobs > 1 and len(work) > 1 and self.mesh is None:
            # compile the (bucket, kind) graphs concurrently: XLA/PjRt
            # compilation is thread-safe and each graph compiles
            # independently, so warmup wall time approaches the slowest
            # compile instead of the sum
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(jobs, len(work))) as ex:
                out = list(ex.map(lambda w: warm_one(*w), work))[-1]
        else:
            for w in work:
                out = warm_one(*w)
        if self._lookahead:
            # pay the speculative dispatch worker's cold start (thread
            # spawn + first jit enqueue from that thread) at boot: the
            # first _maybe_build_spec otherwise lands it mid-realtime. The
            # sim worker's thread spawn is warmed the same way.
            self._spec_sim_executor().submit(lambda: None).result()
            out = self._spec_executor().submit(warm_one, *work[-1]).result()
        # one real device->host transfer at boot, so the first readback
        # inside the realtime pump finds the transfer path initialized
        np.asarray(out.master)
        self._warmed_key = key
        return len(work)

    SLO_WORST_KEEP = 16

    def _note_slo_miss(self, kind: str, busy: float, budget_blocks: int):
        """Record context for a deadline miss (top-N by overrun ms).
        Called only on a miss — off the happy path entirely."""
        chain = self._h_next
        rec = {
            "kind": kind,
            "ms": round(busy * 1e3, 2),
            "budget_blocks": budget_blocks,
            "block": self.total_blocks,
            "h_cursor": self._h_cursor,
            "blocks_since_event": self._blocks_since_event,
            "chain": (None if chain is None else
                      ("dead" if chain.dead else chain._outstanding)),
        }
        worst = self._slo_worst
        worst.append(rec)
        if len(worst) > self.SLO_WORST_KEEP:
            worst.sort(key=lambda r: r["ms"], reverse=True)
            del worst[self.SLO_WORST_KEEP:]

    def stats(self) -> dict:
        """Runtime health counters: SLO (deadline misses), DSP load, and
        the event watchdog (scheduled-vs-delivered MIDI accounting)."""
        return {
            "backend": self.backend,
            # where the render runs (libzl_tpu.device.device_info)
            **self.device,
            "blocks": self.total_blocks,
            "warmed_graphs": getattr(self, "warmed_graphs", 0),
            "slo_missed": self.slo.missed_blocks,
            "slo_total": self.slo.total_blocks,
            "slo_worst_overrun_ms": round(self.slo.worst_overrun * 1e3, 3),
            # per-dispatch-path miss attribution: kind -> [missed, total,
            # worst_overrun_ms] (emit / horizon / event_rebuild / adopt /
            # spec / per_block / idle)
            "slo_by_kind": {
                k: [v[0], v[1], round(v[2] * 1e3, 3)]
                for k, v in self.slo.by_kind.items()
            },
            # worst-miss context snapshots (top-N by overrun): WHY the
            # worst blocks missed, not just which path
            "slo_worst": sorted(self._slo_worst,
                                key=lambda r: r["ms"], reverse=True),
            "dsp_load": round(self.dsp_load.load, 4),
            "watchdog_scheduled": self.watchdog.scheduled,
            "watchdog_delivered": self.watchdog.delivered,
            "watchdog_mismatches": self.watchdog.mismatches,
            "watchdog_lost": self.watchdog.lost,
        }

    def process_block(self) -> BlockResult:
        """Render one block: drain due ticks, dispatch, advance."""
        import time as _time

        _t0 = _time.perf_counter()
        # swap in any completed deferred clip renders (the worker appends;
        # deque.popleft is atomic so no append can be lost to a list swap)
        while True:
            try:
                fn = self._pending_renders.popleft()
            except IndexError:
                break
            fn()
        midi_out: list[tuple[int, bytes]] = []
        pending = getattr(self, "_pending_immediate_midi", None)
        if pending:
            midi_out.extend((0, data) for data in pending)
            self._pending_immediate_midi = []

        # Dynamic tick walk: tick spacing re-derives after every tick's
        # commands, so a SetBpm firing mid-block changes the spacing of the
        # REMAINING ticks in the same block — exactly the reference's
        # per-step subbeat-length update (lib/SyncTimer.cpp:636-641). The
        # per-block transport BPM is the time-weighted blend of the per-tick
        # BPMs, rounded to 2 decimals (lib/SyncTimer.cpp:644,672-673), so
        # automation sweeps publish the reference's quantized step sequence.
        block_start = float(self.clock.sample_position)
        block_end = block_start + self.block_frames
        tick_count = 0
        bpm_blend = 0.0
        seg_start = block_start
        t = self.clock.tick_position
        guard = 0
        while True:
            ts = self.clock.tick_time_samples(t)
            if ts >= block_end:
                break
            guard += 1
            if guard > 8 * self.block_frames:
                raise RuntimeError("tick walk diverged (bpm below floor?)")
            offset = max(int(ts - block_start), 0)
            # the blend segment leading up to this tick runs at the BPM set
            # by the previous tick's commands
            seg_end = min(max(ts, block_start), block_end)
            bpm_blend += self.clock.bpm * (seg_end - seg_start)
            seg_start = seg_end
            # expose the firing tick so set_bpm re-anchors exactly here
            self.clock.tick_position = t
            if self.transport_running:
                # sequencer schedule-ahead hook (lib/SyncTimer.cpp:397-401)
                for cb in self.timer_callbacks:
                    cb(t)
                if midi_clock_due(t):
                    midi_out.append((offset, bytes([MIDI_BEAT_CLOCK_BYTE])))
            step = self.ring.pop_next()
            for ev in step.midi:
                midi_out.append((offset, ev.data))
            for ccmd in step.clip_commands:
                self._apply_clip_command(ccmd, t, offset)
            for tcmd in step.timer_commands:
                self._apply_timer_command(tcmd, t, offset)
            tick_count += 1
            if self.clock.tick_position != t:
                # a transport reset (stop flush) re-based the musical clock;
                # resume the walk from the new position
                t = self.clock.tick_position
            else:
                t += 1
        self.clock.tick_position = t
        bpm_blend += self.clock.bpm * (block_end - seg_start)
        self.period_bpm = (
            round(bpm_blend / self.block_frames * 100.0) / 100.0
        )

        # MIDI routing fabric: transport ticks, internal + hardware routing,
        # transport control, note->sampler mapping (all sample-offset aware)
        self.transport.emit_ticks(
            self.clock.sample_position, self.block_frames, midi_out
        )
        self.router.begin_block()
        self.router.route_internal(midi_out)
        self.router.route_hardware()
        self.transport.handle_passthrough(self.router.passthrough_out)
        self.sampler_map.handle(self.router, self.router.passthrough_out)
        self.router.flush_external()
        # event watchdog: everything that entered the fabric this block must
        # have reached a terminal (sink append or intentional swallow)
        self.watchdog.observe_block(
            self.router.in_count, self.router.accounted_count
        )

        # speculative lookahead: clean blocks emit pre-rendered horizon
        # slices (one upload+dispatch per H blocks); event blocks rebuild
        # the horizon in-dispatch when traffic is sparse enough, else fall
        # through to the per-block dispatch below
        if self._lookahead:
            self._h_built_this_block = False
            self._spec_built_this_block = False
            self._adopted_this_block = False
            self._oob_preempt = False
            out = self._lookahead_outputs()
            event_block = self._block_dirty or self._oob_preempt
            self._block_dirty = False
            self._blocks_since_event = (
                0 if event_block else self._blocks_since_event + 1
            )
            if out is not None:
                self.clock.advance_block()
                self.total_blocks += 1
                busy = _time.perf_counter() - _t0
                self.profiler.record("process_block", busy)
                # a horizon-build block delivers H blocks of audio: its
                # deadline is H periods (the pump runs that far ahead); a
                # speculative-build block's work must land before the
                # slices still in hand run out, so its deadline is that
                # many periods
                if self._h_built_this_block:
                    budget = self._lookahead
                    kind = "event_rebuild" if event_block else "horizon"
                elif self._adopted_this_block:
                    # adopting a speculative horizon puts ALL its slices
                    # in hand at once — the block delivers H blocks of
                    # audio, so like a horizon build its deadline is H
                    # periods (the wait inside is the chain's upload
                    # future, not lost audio; the pump's run-ahead margin
                    # covers >= H blocks by construction — bridge pacing)
                    budget = max(1, len(self._h_slices))
                    kind = "adopt"
                elif self._spec_built_this_block:
                    budget = max(1, len(self._h_slices) - self._h_cursor)
                    kind = "spec"
                else:
                    budget = 1
                    kind = "emit"
                if not self.slo.observe(busy, budget_blocks=budget,
                                        kind=kind):
                    self._note_slo_miss(kind, busy, budget)
                self.dsp_load.observe(busy, budget_blocks=budget)
                return BlockResult(outputs=out, midi_out=midi_out,
                                   tick_count=tick_count)

        # idle shortcut: with no live voices the render is identically zero —
        # skip the device dispatch (the reference's JACK clients always run;
        # a block engine can simply not submit work)
        if not self.pool.active.any():
            self.clock.advance_block()
            self.total_blocks += 1
            busy = _time.perf_counter() - _t0
            self.profiler.record("process_block", busy)
            if not self.slo.observe(busy, kind="idle"):
                self._note_slo_miss("idle", busy, 1)
            self.dsp_load.observe(busy)
            return BlockResult(
                outputs=self._zero_outputs(), midi_out=midi_out,
                tick_count=tick_count,
            )

        clock_args = dict(
            block_start_sample=float(self.clock.sample_position),
            tick_anchor_sample=self.clock.anchor_sample,
            tick_anchor=self.clock.anchor_tick,
            samples_per_tick=self.clock.samples_per_tick,
        )
        sound = self._sound_data_for_backend()
        from ..ops.voice import unpack_program

        if self.use_native_host:
            from . import hostcore as _hostcore

            prog_i, prog_f, died_info = _hostcore.voice_update(
                self.pool, lane_enabled=self.lane_enabled, **clock_args
            )
            if self.backend == "numpy":
                outputs = render_mod.render_block_math(
                    np, sound, unpack_program(prog_i, prog_f), self.strips,
                    self.block_frames, quirk_gain=self.quirk_gain,
                )
            else:
                outputs = self._dispatch_packed(
                    sound, prog_i, prog_f, self._packed_strips_for_backend()
                )
            died_pairs = [(cid, pid) for _, cid, pid in died_info]
        else:
            prog = self.pool.build_program(
                lane_enabled=self.lane_enabled, **clock_args
            )
            if self.backend == "numpy":
                outputs = render_mod.render_block_math(
                    np, sound, prog, self.strips, self.block_frames,
                    quirk_gain=self.quirk_gain,
                )
            else:
                from ..ops.voice import pack_program

                prog_i, prog_f = pack_program(prog)
                outputs = self._dispatch_packed(
                    sound, prog_i, prog_f, self._packed_strips_for_backend()
                )
            adv = self.pool.advance(prog)
            died_pairs = list(zip(adv["died_clips"], adv["died_positions"]))
        self._release_died(died_pairs)
        self.clock.advance_block()
        self.total_blocks += 1
        busy = _time.perf_counter() - _t0
        self.profiler.record("process_block", busy)
        if not self.slo.observe(busy, kind="per_block"):
            self._note_slo_miss("per_block", busy, 1)
        self.dsp_load.observe(busy)
        return BlockResult(outputs=outputs, midi_out=midi_out,
                           tick_count=tick_count)

    # ------------------------------------------------------- session updates

    def accumulate_peaks(self, result: BlockResult) -> None:
        """Queue one block's peak arrays for the next update_session
        WITHOUT any device work — a plain list append (even a tiny
        per-block device op costs a dispatch). The queued arrays ride the
        next session fetch raw and are
        max-folded host-side (session_fetch_plan).
        A realtime pump calls this every block so transients between
        analysis points are not lost — matching the reference, whose
        per-cycle process() snapshots every buffer for the 50 ms scan
        (lib/AudioLevels.cpp:238-257, 347-412)."""
        o = result.outputs
        self._peak_accum.append((o.lane_peaks, o.master_peak))

    def session_fetch_plan(self, result: BlockResult):
        """Lazy session arrays + an unpacker, so a caller can append them
        to its own device arrays and make ONE combined D2H (the bounce
        drain concatenates these with its K master mixes). Returns
        ``(arrays, unpack, total)`` where ``unpack(flat, off)`` slices the
        flattened transfer back into the fetch_session_arrays dict and
        ``total`` is the element count consumed.

        Drains the peak queue: the queued blocks' lane/master peaks ride
        the same transfer RAW (~26 floats per block — bytes are free, the
        round trip is the cost) and the max-fold happens host-side in
        numpy. Folding on device would issue one eager stack+max dispatch
        pair per cadence, recompiling at every new queue length; zero
        device ops is simpler. Build plans in block order."""
        o = result.outputs
        pairs = self._peak_accum
        self._peak_accum = []
        arrs = []
        for lp, mp in pairs:
            arrs += [lp, mp]
        arrs += [o.lane_peaks, o.master_peak, o.lane_rms, o.voice_peaks]
        lp_shape = np.shape(o.lane_peaks)
        mp_shape = np.shape(o.master_peak)
        rms_shape = np.shape(o.lane_rms)
        vp_shape = np.shape(o.voice_peaks)
        n_lp = int(np.prod(lp_shape))
        n_mp = int(np.prod(mp_shape))
        n_rms = int(np.prod(rms_shape))
        n_vp = int(np.prod(vp_shape))
        nq = len(pairs)

        def unpack(flat, off=0):
            lanes = mast = None
            for _ in range(nq + 1):
                lp = np.asarray(flat[off:off + n_lp]).reshape(lp_shape)
                off += n_lp
                mp = np.asarray(flat[off:off + n_mp]).reshape(mp_shape)
                off += n_mp
                lanes = lp if lanes is None else np.maximum(lanes, lp)
                mast = mp if mast is None else np.maximum(mast, mp)
            rms = np.asarray(flat[off:off + n_rms]).reshape(rms_shape)
            off += n_rms
            vp = np.asarray(flat[off:off + n_vp]).reshape(vp_shape)
            return dict(lane_peaks=lanes, master_peak=mast,
                        lane_rms=rms, voice_peaks=vp)

        total = (nq + 1) * (n_lp + n_mp) + n_rms + n_vp
        return arrs, unpack, total

    def fetch_session_arrays(self, result: BlockResult) -> dict:
        """Fetch everything update_session needs in ONE device->host
        transfer (folded peaks, RMS, voice peaks): each transfer carries a
        fixed synchronization cost, so the per-cadence cost is one sync
        regardless of array count."""
        arrs, unpack, _ = self.session_fetch_plan(result)
        if self.backend == "numpy":
            flat = np.concatenate([np.ravel(np.asarray(a)) for a in arrs])
        else:
            import jax.numpy as jnp

            flat = np.asarray(
                jnp.concatenate([jnp.ravel(a) for a in arrs]))
        return unpack(flat)

    def update_session(self, result: BlockResult,
                       include_recorders: bool = True,
                       fetched: Optional[dict] = None) -> None:
        """Feed voice peaks/progress back to the clip positions models
        (lib/SamplerSynthVoice.cpp:264-267), the AudioLevels meters and any
        active disk recorders.

        NOTE: this forces ONE device->host transfer of the block's meter
        and peak arrays (fetch_session_arrays). Meters only need the
        reference's 50 ms cadence (lib/AudioLevels.cpp:325) — callers
        driving a realtime pump should call this every `_levels_every`
        blocks (see capi/bridge), feeding recorders separately each block
        while recording and queuing skipped blocks' peaks via
        accumulate_peaks. `fetched`: a fetch_session_arrays result the
        caller already transferred (the bounce drain batches it with the
        master fetch)."""
        if fetched is None:
            fetched = self.fetch_session_arrays(result)
        self.levels.ingest_block(
            result.outputs,
            peak_override=(fetched["lane_peaks"], fetched["master_peak"]),
            rms_override=fetched["lane_rms"],
        )
        # analysis cadence by block distance (not modulo: callers invoke this
        # at different block phases — the modulo form never fired from the
        # pipelined pump, leaving meters at the -200 floor)
        if self.total_blocks - self._last_analyze_block >= self._levels_every:
            self.levels.analyze()
            self._last_analyze_block = self.total_blocks
        if include_recorders and self.levels.is_recording:
            self.levels.feed_recorders(result.outputs)
        peaks = fetched["voice_peaks"]
        if peaks.shape[0] < self.pool.num_voices:
            # mesh-bucketed dispatch returns the bucket-length sharded
            # peaks (the single-chip path pads inside the jit); inactive
            # tail voices peaked at zero by definition
            peaks = np.pad(peaks, (0, self.pool.num_voices - peaks.shape[0]))
        progress = self.pool.progress()
        act = np.flatnonzero(self.pool.active)
        if act.size:
            # group voices by clip and push one batched update per clip
            # (row-by-row set_gain_and_progress is O(voices * positions))
            clip_ids = self.pool.clip_id[act]
            order = np.argsort(clip_ids, kind="stable")
            sorted_cids = clip_ids[order]
            pids = self.pool.position_id[act][order].tolist()
            gains = (peaks[act][order] * 0.5).tolist()
            progs = progress[act][order].tolist()
            starts = np.concatenate(
                [[0], np.flatnonzero(np.diff(sorted_cids)) + 1,
                 [act.size]]
            )
            for i in range(len(starts) - 1):
                lo, hi = int(starts[i]), int(starts[i + 1])
                clip = self.clips.get(int(sorted_cids[lo]))
                if clip is None:
                    continue
                clip.positions_model.set_many(
                    pids[lo:hi], gains[lo:hi], progs[lo:hi]
                )
        for clip in self.clips.values():
            clip.positions_model.cleanup()
            clip.sync_progress()
            clip.sync_audio_level()
