"""Host-side voice state machine and per-block program builder.

The reference mutates voice state *inside* the render callback
(lib/SamplerSynthVoice.cpp:174-270: position advance, loop wraps, ADSR
transitions, auto-release, hard stops). On the device the render must be a
pure function, so all control flow moves HERE, to the host, at block granularity:

- The pool holds every per-voice quantity in numpy struct-of-arrays
  (float64/int64 for time and position bookkeeping, f32/int32 mirrors of
  exactly what the device consumes).
- `build_program()` converts the state into a `VoiceProgram` for one block:
  piecewise position segments (loop wraps precomputed in float64 — the analog
  of the reference's nextLoopUsecs arithmetic, lib/SamplerSynthVoice.cpp:179-181,
  225-247), envelope programs, release triggers and hard-stop frames.
- `advance()` moves the state past the block using THE SAME closed-form
  formulas the device kernel evaluates (int32 + f32 fractional positions), so
  host and device can never diverge: the host is authoritative and re-anchors
  the device every block.

Rules reproduced from the reference (each cited):
- pitchRatio = 2^((note-root)/12) * srcRate / outRate (SamplerSynthVoice.cpp:115)
- start position = int(startPositionSeconds * srcRate) (":121", truncated)
- beat-quantized looping when the clip length is a whole number of beats;
  wraps at musical-clock boundaries, not sample counts (":225-242")
- positional looping otherwise: wrap to slice start when position passes the
  stop position (":243-247")
- non-looping: hard stop at stop position, auto-release (exponential, see
  ops/adsr.py) starting release-time before the end (":248-257")
- ADSR death stops the voice one frame after the envelope reaches zero (":258-261")
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (
    MAX_SEGMENTS_PER_BLOCK,
    bq_extra_resets,
)
from ..ops import adsr as adsr_ops
from ..ops.voice import VoiceProgram, empty_program

_BIG = np.int32(1 << 30)


def pitch_ratio(midi_note: int, root_note: int, source_rate: float,
                output_rate: float) -> float:
    """lib/SamplerSynthVoice.cpp:115-116."""
    return (2.0 ** ((midi_note - root_note) / 12.0)) * source_rate / output_rate


@dataclasses.dataclass
class VoicePool:
    """Struct-of-arrays state for V voices."""

    num_voices: int
    block_frames: int
    output_rate: float

    def __post_init__(self):
        V = self.num_voices
        # beat-quantized reset slots past the segment horizon (0 at the
        # live geometry — see constants.bq_extra_resets)
        self.n_bq_extra = bq_extra_resets(self.block_frames, self.output_rate)
        zi = lambda dt=np.int64: np.zeros(V, dt)  # noqa: E731
        zf = lambda dt=np.float64: np.zeros(V, dt)  # noqa: E731
        self.active = np.zeros(V, bool)
        # command identity for equivalentTo matching (ClipCommand.h:33-39)
        self.clip_id = np.full(V, -1, np.int64)
        self.midi_note = zi(np.int32)
        self.midi_channel = zi(np.int32)
        self.has_slice = np.zeros(V, bool)
        self.slice_idx = np.full(V, -1, np.int32)
        # sound addressing
        self.base = zi(np.int32)
        self.length = zi(np.int32)
        self.source_rate = zf()
        # playback
        self.pos_int = zi()                    # fetch position, whole samples
        self.pos_frac = np.zeros(V, np.float32)
        self.rate_int = zi(np.int32)
        self.rate_frac = np.zeros(V, np.float32)
        self.istart = zi()                     # loop/slice start (samples, int)
        self.stop = zi()                       # stop position (samples, int)
        self.looping = np.zeros(V, bool)
        self.beat_quantized = np.zeros(V, bool)
        self.loop_len_ticks = zi()             # beat-quantized loop span
        self.next_loop_tick = zi()             # absolute tick of next wrap
        self.gain = np.zeros(V, np.float32)    # velocity/volume
        self.clip_volume = np.ones(V, np.float32)
        self.pan = np.zeros(V, np.float32)
        self.lane = zi(np.int32)
        # envelope state (see ops/adsr.py)
        self.stage = zi(np.int32)
        self.env = np.zeros(V, np.float32)
        self.a_rate = np.zeros(V, np.float32)
        self.d_rate = np.zeros(V, np.float32)
        self.sustain = np.ones(V, np.float32)
        self.rel_rate = np.zeros(V, np.float32)
        self.inv_rel = np.zeros(V, np.float32)
        self.rel_log2 = np.zeros(V, np.float32)
        self.rel_mode = zi(np.int32)
        self.release_sec = np.zeros(V, np.float32)
        # per-block pending events (frame offsets within the coming block)
        self.pending_start = np.full(V, -1, np.int64)   # -1: not starting
        self.pending_release = np.full(V, _BIG, np.int64)
        # bookkeeping for the positions model (ClipAudioSourcePositionsModel)
        self.position_id = np.full(V, -1, np.int64)
        self._next_position_id = 0

    # ------------------------------------------------------------------ events

    def idle_voices(self) -> np.ndarray:
        return np.flatnonzero(~self.active)

    def note_on(
        self,
        voice: int,
        *,
        clip_id: int,
        midi_note: int,
        midi_channel: int,
        lane: int,
        base: int,
        length: int,
        source_rate: float,
        root_note: int,
        start_sec: float,
        stop_sec: float,
        gain: float,
        clip_volume: float,
        pan: float,
        attack: float,
        decay: float,
        sustain: float,
        release: float,
        looping: bool,
        length_beats: float,
        start_tick: int,
        slice_idx: int = -1,
        has_slice: bool = False,
        frame_offset: int = 0,
    ) -> None:
        """Claim `voice` and start a note (startNote semantics,
        lib/SamplerSynthVoice.cpp:110-144)."""
        v = voice
        self.active[v] = True
        self.clip_id[v] = clip_id
        self.midi_note[v] = midi_note
        self.midi_channel[v] = midi_channel
        self.has_slice[v] = has_slice
        self.slice_idx[v] = slice_idx
        self.base[v] = base
        self.length[v] = length
        self.source_rate[v] = source_rate

        # UNBOUNDED like the reference (lib/SamplerSynthVoice.cpp:115-116:
        # no ceiling — note 36 above root plays at 8x); the gather fetch
        # serves any ratio.
        ratio = pitch_ratio(midi_note, root_note, source_rate, self.output_rate)
        self.rate_int[v] = int(ratio)
        self.rate_frac[v] = np.float32(ratio - int(ratio))
        self.istart[v] = int(start_sec * source_rate)
        self.stop[v] = int(stop_sec * source_rate)
        self.pos_int[v] = self.istart[v]
        self.pos_frac[v] = 0.0
        self.looping[v] = looping
        # "clean multiple of a number of beats" rule (SamplerSynthVoice.cpp:227)
        self.beat_quantized[v] = float(length_beats) == float(int(length_beats))
        from ..constants import BEAT_SUBDIVISIONS

        ticks = int(length_beats * BEAT_SUBDIVISIONS)
        self.loop_len_ticks[v] = max(ticks, 1)
        self.next_loop_tick[v] = start_tick + ticks

        self.gain[v] = gain
        self.clip_volume[v] = clip_volume
        self.pan[v] = pan
        self.lane[v] = lane

        rates = adsr_ops.make_rates(attack, decay, sustain, release, source_rate)
        stage, env = adsr_ops.note_on_stage(attack, decay, sustain)
        self.stage[v] = stage
        self.env[v] = env
        self.a_rate[v] = rates["a_rate"]
        self.d_rate[v] = rates["d_rate"]
        self.sustain[v] = rates["sustain"]
        self.inv_rel[v] = rates["inv_rel"]
        self.rel_log2[v] = rates["rel_log2"]
        self.rel_rate[v] = 0.0
        self.rel_mode[v] = adsr_ops.RELEASE_MODE_LINEAR
        self.release_sec[v] = release

        self.pending_start[v] = frame_offset
        self.pending_release[v] = _BIG
        self.position_id[v] = self._next_position_id
        self._next_position_id += 1

    def note_off(self, voice: int, tail: bool = True, frame_offset: int = 0) -> None:
        """stopNote semantics (lib/SamplerSynthVoice.cpp:146-169)."""
        if tail:
            self.pending_release[voice] = min(
                self.pending_release[voice], frame_offset
            )
        else:
            self.kill(voice)

    def kill(self, voice: int) -> None:
        self.active[voice] = False
        self.position_id[voice] = -1
        self.clip_id[voice] = -1
        self.stage[voice] = adsr_ops.STAGE_IDLE
        self.env[voice] = 0.0

    # fields mutated by advance()/kill() — everything a horizon simulation
    # moves; save/restore around the sim keeps the pool the authoritative
    # per-block mirror while the device renders speculative slices
    # (engine._start_horizon). note_on/_update fields are NOT here: events
    # preempt a horizon, so no command can land between save and restore.
    _ADVANCE_FIELDS = (
        "active", "clip_id", "position_id", "pos_int", "pos_frac",
        "stage", "env", "rel_rate", "rel_mode", "next_loop_tick",
        "pending_start", "pending_release",
    )

    def save_state(self) -> dict:
        """Snapshot the advance-mutated state (cheap: 12 [V] arrays)."""
        return {n: getattr(self, n).copy() for n in self._ADVANCE_FIELDS}

    def restore_state(self, snap: dict) -> None:
        """Restore a save_state snapshot IN PLACE (other code holds
        references to the pool arrays; rebinding would detach them)."""
        for n, a in snap.items():
            getattr(self, n)[:] = a

    def sync_from(self, src: "VoicePool") -> None:
        """Mirror `src`'s FULL per-voice state into this pool.

        Speculative horizon builds sim on a dedicated pool on the dispatch
        worker (engine._maybe_build_spec) so the live pool is never touched
        off the engine thread. Array contents are copied in place — stable
        identities keep the native host core's per-pool pointer cache warm
        (hostcore._build_state) — and the cache itself is never copied (it
        holds raw pointers into the OWNING pool's buffers). Scalar state
        (_next_position_id, geometry) copies by value. Safe against torn
        reads when `src` is concurrently advanced by emission restores:
        every advance-mutated field is overwritten by the caller's
        restore_state(end_snap) right after, and any mutation of the
        remaining fields is an engine event, which discards the
        speculation before it can be adopted."""
        for k, v in src.__dict__.items():
            if k == "_hostcore_state_cache":
                continue
            if isinstance(v, np.ndarray):
                mine = self.__dict__.get(k)
                if (isinstance(mine, np.ndarray) and mine.shape == v.shape
                        and mine.dtype == v.dtype):
                    mine[...] = v
                else:
                    self.__dict__[k] = v.copy()
            else:
                self.__dict__[k] = v

    def rebase_clip(self, clip_id: int, base: int, length: int) -> None:
        """Re-point live voices of `clip_id` at a swapped playback render.

        The reference's voices re-read the (reloaded) buffer and its
        geometry every block (lib/SamplerSynthVoice.cpp:189-191), so a
        re-render landing mid-note switches live playback to the new
        audio at the next block. Positions and stop frames carry over
        unchanged: they are playback-file sample offsets, and the
        playback sample rate is invariant across re-renders (a voice past
        the new end plays reference-correct silence until its positional
        wrap/stop — the documented unclamped-stop rule)."""
        m = self.active & (self.clip_id == clip_id)
        if m.any():
            self.base[m] = base
            self.length[m] = length

    # ------------------------------------------------------- program building

    def build_program(
        self,
        block_start_sample: float,
        tick_anchor_sample: float,
        tick_anchor: int,
        samples_per_tick: float,
        lane_enabled: np.ndarray | None = None,
        window_frames: int | None = None,
    ) -> VoiceProgram:
        """Produce the device program for the next block and precompute the
        wrap schedule. Vectorized over all voices.

        `lane_enabled` (bool [num_lanes]) freezes voices on disabled sampler
        channels: they neither render nor advance, like a disabled
        SamplerChannel whose process() returns early (lib/SamplerSynth.cpp:117).
        `window_frames` overrides the block size for lookahead-horizon
        builds (engine lookahead mode: one program covers H blocks; the
        caller is responsible for pool.n_bq_extra covering the window).
        """
        B = int(window_frames or self.block_frames)
        prog = empty_program(self.num_voices, B, self.n_bq_extra)
        act = self.active
        if lane_enabled is not None:
            act = act & lane_enabled[self.lane]
        if not act.any():
            self._bq_wraps = np.zeros(self.num_voices, np.int64)
            self._bq_boundary = np.zeros(self.num_voices, bool)
            self._bq_last_reset = np.full(self.num_voices, -1, np.int64)
            self._stop_frames = np.full(self.num_voices, B, np.int64)
            return prog

        V = self.num_voices
        S = MAX_SEGMENTS_PER_BLOCK
        posf = self.pos_int.astype(np.float64) + self.pos_frac.astype(np.float64)
        rate = self.rate_int.astype(np.float64) + self.rate_frac.astype(np.float64)
        rate_safe = np.where(rate > 0, rate, 1.0)
        start_f = np.where(self.pending_start >= 0, self.pending_start, 0)

        seg_start = np.full((V, S), B, np.int64)
        seg_pos_int = np.zeros((V, S), np.int64)
        seg_pos_frac = np.zeros((V, S), np.float32)
        seg_start[:, 0] = start_f
        seg_pos_int[:, 0] = self.pos_int
        seg_pos_frac[:, 0] = self.pos_frac

        # --- wrap schedule ---
        # Positional loops (SamplerSynthVoice.cpp:243-247): the post-advance
        # position comparison means the first *fetch* from the reset position
        # happens at frame n1 = ceil((stop - pos)/rate); successive wraps are
        # then exactly ceil((stop - istart)/rate) frames apart (the reset
        # lands on integer sample `istart` with zero fraction).
        n1 = np.maximum(
            np.ceil((self.stop.astype(np.float64) - posf) / rate_safe), 1
        ).astype(np.int64)
        pos_period = np.maximum(
            np.ceil((self.stop - self.istart).astype(np.float64) / rate_safe), 1
        ).astype(np.int64)
        # Beat-quantized loops (SamplerSynthVoice.cpp:225-242): the wall-clock
        # threshold fires at frame k0 = ceil(next_loop_sample - block_start)
        # but the reset affects the NEXT fetch, i.e. frame k0 + 1 — possibly
        # frame 0 of the next block (handled as a boundary reset in advance()).
        next_loop_sample = (
            tick_anchor_sample
            + (self.next_loop_tick - tick_anchor).astype(np.float64)
            * samples_per_tick
        )
        bq_diff = next_loop_sample - block_start_sample
        bq_period = np.maximum(
            self.loop_len_ticks.astype(np.float64) * samples_per_tick, 1.0
        )

        is_bq = act & self.looping & self.beat_quantized
        is_pos = act & self.looping & ~self.beat_quantized
        # exact wrap count (NOT capped at the segment horizon): the number
        # of m >= 0 with ceil(bq_diff + m*period) < B, i.e.
        # bq_diff + m*period <= B-1 — next_loop_tick bookkeeping must stay
        # right even when more wraps land in a block than segments exist
        bq_wraps = np.where(
            is_bq & (bq_diff <= B - 1),
            np.floor(((B - 1) - bq_diff) / bq_period).astype(np.int64) + 1,
            0,
        )
        istart64 = self.istart.astype(np.int64)
        # last expressed in-block bq reset frame (segments + extras), -1 if
        # none — advance() rebases the end-of-block position from it
        bq_last_reset = np.full(V, -1, np.int64)
        prev_bq_hit = is_bq.copy()  # wrap chain: extras need all prior hits
        for s in range(1, S):
            k0 = np.maximum(
                np.ceil(bq_diff + (s - 1) * bq_period), 0
            ).astype(np.int64)
            r_bq = k0 + 1
            r_pos = start_f + n1 + (s - 1) * pos_period
            r = np.where(is_bq, r_bq, r_pos)
            hit_seg = (is_bq | is_pos) & (r < B) & (r >= start_f)
            seg_start[:, s] = np.where(hit_seg, r, B)
            seg_pos_int[:, s] = np.where(hit_seg, istart64, 0)
            bq_hit = hit_seg & is_bq
            bq_last_reset = np.where(bq_hit, r, bq_last_reset)
            prev_bq_hit &= bq_hit
        # beat-quantized resets past the segment horizon (wraps S..S-1+W):
        # explicit integer reset-frame columns the kernel applies as
        # `k >= r` rebases (VoiceProgram.bq_reset) — this keeps sub-
        # (S-1)-tick bq loops exact at any block size, where the reference
        # wraps per sample without limit (lib/SamplerSynthVoice.cpp:225-242).
        # Guarded on the full prior-wrap chain: an extra only applies when
        # every earlier wrap was expressed (so its frames sit in a wrap
        # segment whose base is the loop start).
        bq_reset = np.full((V, self.n_bq_extra), B, np.int64)
        for e in range(self.n_bq_extra):
            s = S + e
            k0 = np.maximum(
                np.ceil(bq_diff + (s - 1) * bq_period), 0
            ).astype(np.int64)
            r = k0 + 1
            hit = prev_bq_hit & (r < B) & (r >= start_f)
            bq_reset[:, e] = np.where(hit, r, B)
            bq_last_reset = np.where(hit, r, bq_last_reset)
            prev_bq_hit &= hit
        # boundary wrap: the LAST counted wrap can land exactly at frame B
        # (its reset affects the next block's frame 0); only that one can,
        # since in-block resets ascend and the count caps at bq_diff +
        # (m-1)*period <= B-1
        with np.errstate(invalid="ignore"):
            r_w_last = np.where(
                bq_wraps >= 1,
                np.ceil(bq_diff + (bq_wraps - 1).astype(np.float64)
                        * bq_period) + 1,
                -1.0,
            )
        bq_boundary = is_bq & (bq_wraps >= 1) & (r_w_last == B)

        # --- stop frame (non-looping hard stop, SamplerSynthVoice.cpp:249-252)
        end_frame = start_f + np.ceil(
            (self.stop.astype(np.float64) - posf) / rate_safe
        ).astype(np.int64)
        stop_frames = np.where(act & ~self.looping, end_frame, B)
        stop_frames = np.clip(stop_frames, 0, B)

        # --- release triggers ---
        release_frames = np.where(act, self.pending_release, _BIG)
        release_is_auto = np.zeros(V, bool)
        # auto-release threshold: pos >= stop - release*srcRate, noteOff takes
        # effect the NEXT frame (SamplerSynthVoice.cpp:253-255)
        thr = self.stop.astype(np.float64) - (
            self.release_sec.astype(np.float64) * self.source_rate
        )
        k_ar = start_f + np.ceil((thr - posf) / rate_safe).astype(np.int64) + 1
        k_ar = np.maximum(k_ar, 0)
        auto = (
            act
            & ~self.looping
            & (self.stage != adsr_ops.STAGE_RELEASE)
            & (self.stage != adsr_ops.STAGE_IDLE)
            & (k_ar < np.minimum(release_frames, B))
        )
        release_is_auto |= auto
        release_frames = np.where(auto, k_ar, release_frames)

        # ADSR-death stop: a linear release in progress reaches zero at a known
        # frame; the voice renders that frame then stops (":258-261")
        in_lin_rel = act & (self.stage == adsr_ops.STAGE_RELEASE) & (
            self.rel_mode == adsr_ops.RELEASE_MODE_LINEAR
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            death = np.ceil(
                self.env.astype(np.float64)
                / np.where(self.rel_rate > 0, self.rel_rate, 1.0)
            ).astype(np.int64)
        death = np.where(in_lin_rel & (self.rel_rate > 0), death, _BIG)
        stop_frames = np.minimum(stop_frames, np.clip(start_f + death, 0, B))
        # release frames are consumed in voice-local frame space (see
        # ops/adsr.envelope_block)
        release_frames_local = np.clip(release_frames - start_f, 0, _BIG)

        # --- fill program arrays ---
        prog = prog._replace(
            active=act.astype(np.int32),
            base=self.base.astype(np.int32),
            len_minus1=np.maximum(self.length - 1, 1).astype(np.int32),
            seg_start=np.minimum(seg_start, B).astype(np.int32),
            seg_pos_int=seg_pos_int.astype(np.int32),
            seg_pos_frac=seg_pos_frac,
            rate_int=self.rate_int.astype(np.int32),
            rate_frac=self.rate_frac,
            start_frame=start_f.astype(np.int32),
            stop_frame=stop_frames.astype(np.int32),
            gain=self.gain,
            clip_volume=self.clip_volume,
            pan=self.pan,
            lane=self.lane.astype(np.int32),
            loop_period=np.where(is_pos, pos_period, 0).astype(np.int32),
            bq_reset=np.minimum(bq_reset, B).astype(np.int32),
            env=adsr_ops.AdsrProgram(
                stage0=self.stage.astype(np.int32),
                env0=self.env,
                a_rate=self.a_rate,
                d_rate=self.d_rate,
                sustain=self.sustain,
                rel_rate=self.rel_rate,
                inv_rel=self.inv_rel,
                rel_log2=self.rel_log2,
                release_frame=release_frames_local.astype(np.int32),
                rel_mode=np.where(
                    release_is_auto,
                    adsr_ops.RELEASE_MODE_EXPONENTIAL,
                    self.rel_mode,
                ).astype(np.int32),
            ),
        )
        self._bq_wraps = bq_wraps
        self._bq_boundary = bq_boundary
        self._bq_last_reset = bq_last_reset
        self._stop_frames = stop_frames
        return prog

    # ------------------------------------------------------------ state advance

    def advance(self, prog: VoiceProgram,
                window_frames: int | None = None) -> dict:
        """Advance host state past one block rendered with `prog`.

        Returns a dict of per-voice observations for the session layer
        (positions model updates, voices that died). `window_frames` must
        match the `prog` build's window (lookahead catch-up advances).
        """
        B = int(window_frames or self.block_frames)
        # voices frozen by a disabled lane were excluded from the program's
        # active mask and must not advance
        act = np.asarray(prog.active).astype(bool)
        V = self.num_voices

        # position at frame B via the device's own segment formula (unused
        # segment slots carry seg_start == B and must not be selected)
        last_seg = np.maximum(
            (np.asarray(prog.seg_start) < B).astype(np.int32).sum(axis=1) - 1, 0
        )
        idx = (np.arange(V), last_seg)
        s_start = np.asarray(prog.seg_start)[idx].astype(np.int64)
        s_int = np.asarray(prog.seg_pos_int)[idx].astype(np.int64)
        s_frac = np.asarray(prog.seg_pos_frac)[idx]
        j = np.maximum(B - s_start, 0).astype(np.int32)
        frac_full = s_frac + j.astype(np.float32) * self.rate_frac
        carry = np.floor(frac_full)
        new_pos_int = s_int + j * self.rate_int + carry.astype(np.int64)
        new_pos_frac = (frac_full - carry).astype(np.float32)
        # positional loop resets past frame B: the linear extrapolation from
        # the last segment may cross `stop` one or MORE times (a loop
        # shorter than block/(S-1) frames wraps past the segment horizon).
        # Each reset discards fractional overshoot and restarts at the
        # integer loop start (SamplerSynthVoice.cpp:241,246), so the state
        # at frame B is istart + ((j - n1) mod period) * rate exactly —
        # this generalizes the old single-wrap boundary snap (j == n1 gives
        # istart with zero fraction).
        rate64 = self.rate_int.astype(np.float64) + self.rate_frac
        rate_safe64 = np.where(rate64 > 0, rate64, 1.0)
        is_pos_v = act & self.looping & ~self.beat_quantized
        per_f = np.maximum(
            np.ceil((self.stop - self.istart).astype(np.float64)
                    / rate_safe64), 1
        ).astype(np.int64)
        n1_local = np.maximum(
            np.ceil((self.stop.astype(np.float64)
                     - (s_int.astype(np.float64) + s_frac)) / rate_safe64), 1
        ).astype(np.int64)
        crossed = is_pos_v & (j >= n1_local)
        j2 = np.where(crossed, (j - n1_local) % per_f, 0).astype(np.int64)
        frac2 = j2.astype(np.float32) * self.rate_frac
        carry2 = np.floor(frac2)
        pos2_int = self.istart + j2 * self.rate_int + carry2.astype(np.int64)
        pos2_frac = (frac2 - carry2).astype(np.float32)
        new_pos_int = np.where(crossed, pos2_int, new_pos_int)
        new_pos_frac = np.where(crossed, pos2_frac, new_pos_frac)
        # beat-quantized: rebase from the last EXPRESSED in-block reset
        # (segments or bq_reset extras — exactly what the device applied;
        # bq clips legitimately play past the loop stop between wall-clock
        # boundaries, so no positional containment applies to them). For
        # wraps within the segment horizon this reproduces the wrap-segment
        # extrapolation bit for bit (same j * rate_frac f32 arithmetic from
        # the same integer reset frame); past the horizon it replaces the
        # stale linear extrapolation with the contained position.
        last_r = self._bq_last_reset
        bq_contained = act & (last_r >= 0)
        jb = np.maximum(B - last_r, 0).astype(np.int64)
        fracb = jb.astype(np.float32) * self.rate_frac
        carryb = np.floor(fracb)
        posb_int = self.istart + jb * self.rate_int + carryb.astype(np.int64)
        posb_frac = (fracb - carryb).astype(np.float32)
        new_pos_int = np.where(bq_contained, posb_int, new_pos_int)
        new_pos_frac = np.where(bq_contained, posb_frac, new_pos_frac)
        # boundary wrap (reset lands exactly at frame B): next block's
        # frame 0 fetches the loop start
        boundary = act & self._bq_boundary
        new_pos_int = np.where(boundary, self.istart, new_pos_int)
        new_pos_frac = np.where(boundary, np.float32(0), new_pos_frac)
        self.pos_int = np.where(act, new_pos_int, self.pos_int)
        self.pos_frac = np.where(act, new_pos_frac, self.pos_frac)

        # envelope at the last rendered frame (voice-local frame space);
        # point evaluation — O(V), not O(V*B)
        start_f = np.asarray(prog.start_frame).astype(np.int64)
        n_frames = B - start_f
        env_prog_np = adsr_ops.AdsrProgram(*(np.asarray(f) for f in prog.env))
        env_last = adsr_ops.envelope_final(np, env_prog_np, n_frames)
        rf = np.asarray(prog.env.release_frame).astype(np.int64)
        released = act & (rf < n_frames)
        # new release rate fixed at trigger (linear mode)
        e_r = np.where(
            rf > 0,
            adsr_ops.ads_env_at(
                np, env_prog_np, np.maximum(rf, 1).astype(np.int32) - 1
            ),
            np.asarray(prog.env.env0),
        )
        newly_linear = released & (
            np.asarray(prog.env.rel_mode) == adsr_ops.RELEASE_MODE_LINEAR
        )
        self.rel_rate = np.where(
            newly_linear, (e_r * self.inv_rel).astype(np.float32), self.rel_rate
        )
        self.rel_mode = np.where(
            released, np.asarray(prog.env.rel_mode), self.rel_mode
        ).astype(np.int32)
        self.stage = np.where(
            act,
            np.where(
                released, adsr_ops.STAGE_RELEASE, self._ads_stage_after(n_frames)
            ),
            self.stage,
        ).astype(np.int32)
        self.env = np.where(act, env_last, self.env).astype(np.float32)

        # beat-quantized loop tick bookkeeping (nextLoopTick += lengthInTicks
        # per wrap, SamplerSynthVoice.cpp:234-235)
        self.next_loop_tick = self.next_loop_tick + self._bq_wraps * np.where(
            self.beat_quantized, self.loop_len_ticks, 0
        )

        # deaths: hard stop reached, or release completed (env==0 in release)
        dead = act & (
            (self._stop_frames < B)
            | ((self.stage == adsr_ops.STAGE_RELEASE) & (self.env <= 0))
            | (np.where(released, False, self.stage == adsr_ops.STAGE_IDLE))
        )
        died = np.flatnonzero(dead)
        died_clips = self.clip_id[died].copy()
        died_positions = self.position_id[died].copy()
        for v in died:
            self.kill(v)

        self.pending_start[:] = -1
        self.pending_release[:] = _BIG
        return {
            "died": died,
            "died_clips": died_clips,
            "died_positions": died_positions,
        }

    def _ads_stage_after(self, B) -> np.ndarray:
        """Stage after B frames ([V] array or int) with no release trigger."""
        stage = self.stage
        in_attack = stage == adsr_ops.STAGE_ATTACK
        with np.errstate(divide="ignore", invalid="ignore"):
            ka = np.where(
                in_attack & (self.a_rate > 0),
                np.ceil((np.float32(1.0) - self.env) / np.where(
                    self.a_rate > 0, self.a_rate, 1.0)),
                0,
            ).astype(np.int64)
            e_d = np.where(in_attack, np.float32(1.0), self.env)
            has_decay = (in_attack & (self.d_rate > 0)) | (
                stage == adsr_ops.STAGE_DECAY
            )
            kd = np.where(
                has_decay & (self.d_rate > 0),
                np.ceil((e_d - self.sustain) / np.where(
                    self.d_rate > 0, self.d_rate, 1.0)),
                0,
            ).astype(np.int64)
        after_attack = np.where(
            B > ka,
            np.where(has_decay & (B <= ka + kd), adsr_ops.STAGE_DECAY,
                     adsr_ops.STAGE_SUSTAIN),
            adsr_ops.STAGE_ATTACK,
        )
        out = np.where(in_attack, after_attack, stage)
        in_decay = stage == adsr_ops.STAGE_DECAY
        out = np.where(
            in_decay,
            np.where(B > kd, adsr_ops.STAGE_SUSTAIN, adsr_ops.STAGE_DECAY),
            out,
        )
        return out.astype(np.int32)

    def progress(self) -> np.ndarray:
        """Playback progress 0..1 per voice (sourceSamplePosition /
        sourceSampleLength, lib/SamplerSynthVoice.cpp:266)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            p = self.pos_int.astype(np.float64) / np.maximum(self.length, 1)
        return np.where(self.active, p, 0.0)
