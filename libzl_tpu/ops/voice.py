"""The voice render kernel: all sampler voices for one block, data-parallel.

This replaces the reference's innermost per-sample loop
(lib/SamplerSynthVoice.cpp:174-270) — the dominant cost of the engine — with a
closed-form evaluation over a [V voices, B frames] grid:

- Sample positions advance by a per-voice `pitchRatio` each frame
  (lib/SamplerSynthVoice.cpp:223); loop wraps reset the position to the slice
  start (:225-247). Because every reset target and wrap time is known at block
  start, the host precomputes per-voice *position segments*: at most
  MAX_SEGMENTS piecewise-arithmetic runs per block (segment start frame +
  start position). The kernel evaluates `pos(k) = seg_pos + (k - seg_start) *
  rate` — no sequential dependence, fully parallel over [V, B].
- Positions are int32 whole + f32 fractional parts. The fractional advance
  `j * rate_frac` spans at most one render WINDOW before the host re-anchors
  segment bases in float64, so error cannot accumulate across windows. At
  the live geometry (window = one 128-frame block) the bound vs the
  reference's double accumulator is ~1e-5 samples; lookahead horizons and
  superblocks span window_frames = H*B frames per anchor, scaling the
  in-window f32 term ~(H*B/128)-fold (still ~1e-3 samples at the maximum
  2048-frame window — pinned by the lookahead differential fuzz at
  atol=1e-5 on audio).
- Linear interpolation + ADSR + gain/volume follow the reference expression
  (lib/SamplerSynthVoice.cpp:197-216). NOTE the reference multiplies the gain
  chain into only the *second* interpolation tap (missing parentheses at
  :204-205). `quirk_gain=True` reproduces that exactly for parity testing;
  the default applies gain to both taps (the audibly correct reading).
- M/S panning per the documented algorithm (lib/ClipAudioSource.h:210-222,
  lib/SamplerSynthVoice.cpp:207-211).
- Per-voice peak is max(l+r) with 0 floor, matching :213-216.
- Mixdown: voices sum into their sampler-channel lane (additive mixing the
  JACK graph performed across clients, lib/SamplerSynth.cpp:116-148) as a
  one-hot [C, V] x [V, B*2] matmul at full f32 precision (HIGHEST: on a
  GPU a default-precision f32 product may run in TF32, ~3 significant
  digits) — one product instead of 12 RT callbacks.

Written against an array-namespace `xp` (numpy or jax.numpy) so the host-side
golden mirror and the device kernel share identical formulas.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from ..constants import MAX_SEGMENTS_PER_BLOCK, NUM_SAMPLER_CHANNELS
from . import adsr as adsr_ops


class VoiceProgram(NamedTuple):
    """Per-voice render program for one block.

    Arrays are [V] unless noted. Segment arrays are [V, S] with
    S = MAX_SEGMENTS_PER_BLOCK; unused segments carry seg_start == B (never
    selected). Segment 0 starts at `start_frame`.
    """

    active: Any          # int32 0/1: voice renders this block
    base: Any            # int32: sound base offset in the flat sample array
    len_minus1: Any      # int32: sound length - 1 ("sampleDuration")
    seg_start: Any       # int32 [V, S]: first frame of each segment
    seg_pos_int: Any     # int32 [V, S]: whole sample position at segment start
    seg_pos_frac: Any    # f32   [V, S]: fractional sample position at segment start
    rate_int: Any        # int32: whole part of pitchRatio
    rate_frac: Any       # f32: fractional part of pitchRatio
    start_frame: Any     # int32: first frame to render (sample-accurate starts)
    stop_frame: Any      # int32: first frame NOT to render (B if none)
    gain: Any            # f32: lgain == rgain (velocityToGain == identity)
    clip_volume: Any     # f32: clip volumeAbsolute
    pan: Any             # f32: clip pan in [-1, 1]
    lane: Any            # int32: sampler channel lane 0..11
    loop_period: Any     # int32: frames between positional resets; 0 = n/a.
                         #   Containment past the segment horizon: the wrap
                         #   schedule expresses at most S-1 wraps per block,
                         #   but the reference wraps per sample without
                         #   limit (lib/SamplerSynthVoice.cpp:243-247).
                         #   Positional loops repeat every loop_period
                         #   FRAMES (each reset discards the fractional
                         #   overshoot and restarts at the integer loop
                         #   start = the wrap segment's seg_pos), so frames
                         #   in a wrap segment use j mod period — exact for
                         #   any number of wraps.
    bq_reset: Any        # int32 [V, W]: beat-quantized reset frames past
                         #   the segment horizon (wraps S..S-1+W), B when
                         #   unused. Beat-quantized loops wrap on the WALL
                         #   CLOCK (lib/SamplerSynthVoice.cpp:225-242) and
                         #   legitimately play past the loop stop between
                         #   boundaries, so no modulo containment applies;
                         #   instead the host precomputes EVERY in-block
                         #   reset frame in float64 (the wrap count per
                         #   block is bounded by the BPM ceiling — see
                         #   constants.bq_extra_resets; W = 0 at the live
                         #   geometry) and the kernel applies them as
                         #   integer `k >= r` rebases — exact for any
                         #   number of wraps.
    env: adsr_ops.AdsrProgram


_INT_SCALARS = [
    "active", "base", "len_minus1", "rate_int", "start_frame", "stop_frame",
    "lane",
]
_INT_ENV = ["stage0", "release_frame", "rel_mode"]
# trailing int columns (packed AFTER the segment arrays so the native host
# core's earlier column indices stay stable — native/zl_hostcore.cpp)
_INT_TRAILER = ["loop_period"]
_F32_SCALARS = ["rate_frac", "gain", "clip_volume", "pan"]
_F32_ENV = [
    "env0", "a_rate", "d_rate", "sustain", "rel_rate", "inv_rel", "rel_log2",
]


def pack_program(prog: VoiceProgram):
    """Pack a VoiceProgram into two dense arrays: (i32 [V, Ki], f32 [V, Kf]).

    The host builds ~25 small per-voice arrays per block; shipping them to the
    device individually costs one transfer latency each. Packing makes the per-block host->device traffic
    exactly two contiguous buffers; `unpack_program` runs inside the jitted
    graph where slicing is free.
    """
    ints = [np.asarray(getattr(prog, n), np.int32)[:, None] for n in _INT_SCALARS]
    ints += [np.asarray(getattr(prog.env, n), np.int32)[:, None] for n in _INT_ENV]
    ints += [np.asarray(prog.seg_start, np.int32),
             np.asarray(prog.seg_pos_int, np.int32)]
    ints += [np.asarray(getattr(prog, n), np.int32)[:, None]
             for n in _INT_TRAILER]
    # trailing variable-width block: W beat-quantized reset columns (the
    # count is static per engine geometry; unpack infers it from the shape)
    ints += [np.asarray(prog.bq_reset, np.int32)]
    floats = [np.asarray(getattr(prog, n), np.float32)[:, None]
              for n in _F32_SCALARS]
    floats += [np.asarray(getattr(prog.env, n), np.float32)[:, None]
               for n in _F32_ENV]
    floats += [np.asarray(prog.seg_pos_frac, np.float32)]
    return np.concatenate(ints, axis=1), np.concatenate(floats, axis=1)


def fuse_packed(prog_i: np.ndarray, prog_f: np.ndarray) -> np.ndarray:
    """Fuse the packed program pair into ONE int32 matrix [V, Ki+Kf] (f32
    columns bit-cast), so each block pays one host->device transfer's
    fixed cost instead of two. `split_fused` undoes it inside the jit
    where slicing and bitcasts are free."""
    return np.concatenate([prog_i, prog_f.view(np.int32)], axis=1)


def fused_cols(n_bq_extra: int = 0) -> int:
    """Width of a fuse_packed program [V, Ki+Kf] at the given bq tail
    (the pack_program layout above) — the static split point when a
    horizon ships base+dynamics as one concatenated buffer."""
    S = MAX_SEGMENTS_PER_BLOCK
    return (len(_INT_SCALARS) + len(_INT_ENV) + 2 * S + len(_INT_TRAILER)
            + n_bq_extra + len(_F32_SCALARS) + len(_F32_ENV) + S)


def split_fused(fused):
    """Inverse of fuse_packed for traced jax values (or numpy)."""
    ki = fused.shape[1] - (len(_F32_SCALARS) + len(_F32_ENV)
                           + MAX_SEGMENTS_PER_BLOCK)
    ints = fused[:, :ki]
    fbits = fused[:, ki:]
    if isinstance(fbits, np.ndarray):
        floats = np.ascontiguousarray(fbits).view(np.float32)
    else:
        import jax

        floats = jax.lax.bitcast_convert_type(fbits, np.float32)
    return ints, floats


def active_high_water(prog_i) -> int:
    """Highest packed-program row with the active flag set, plus one
    (0 when no row is active). The program's `active` column is the
    authoritative per-block render mask: it includes voices that die
    DURING this block (they still render their final partial frames),
    unlike pool.active which the native host core has already advanced
    past the kill by dispatch time."""
    col = _INT_SCALARS.index("active")
    nz = np.flatnonzero(np.asarray(prog_i[:, col]))
    return int(nz[-1]) + 1 if nz.size else 0


def unpack_program(ints, floats) -> VoiceProgram:
    """Inverse of pack_program; works on numpy or traced jax arrays."""
    S = MAX_SEGMENTS_PER_BLOCK
    ni, ne = len(_INT_SCALARS), len(_INT_ENV)
    nf, nfe = len(_F32_SCALARS), len(_F32_ENV)
    int_cols = {n: ints[:, i] for i, n in enumerate(_INT_SCALARS)}
    env_int = {n: ints[:, ni + i] for i, n in enumerate(_INT_ENV)}
    seg_start = ints[:, ni + ne : ni + ne + S]
    seg_pos_int = ints[:, ni + ne + S : ni + ne + 2 * S]
    trailer = {n: ints[:, ni + ne + 2 * S + i]
               for i, n in enumerate(_INT_TRAILER)}
    bq_reset = ints[:, ni + ne + 2 * S + len(_INT_TRAILER):]
    f_cols = {n: floats[:, i] for i, n in enumerate(_F32_SCALARS)}
    env_f = {n: floats[:, nf + i] for i, n in enumerate(_F32_ENV)}
    seg_pos_frac = floats[:, nf + nfe : nf + nfe + S]
    env = adsr_ops.AdsrProgram(
        stage0=env_int["stage0"],
        release_frame=env_int["release_frame"],
        rel_mode=env_int["rel_mode"],
        **env_f,
    )
    return VoiceProgram(
        seg_start=seg_start,
        seg_pos_int=seg_pos_int,
        seg_pos_frac=seg_pos_frac,
        bq_reset=bq_reset,
        env=env,
        **int_cols,
        **trailer,
        **f_cols,
    )


# --- compact lookahead-horizon dynamics -------------------------------
# Packed-layout column indices (the pack_program contract above; the native
# host core emits the same layout — native/zl_hostcore.cpp).
PI_ACTIVE = _INT_SCALARS.index("active")
PI_START = _INT_SCALARS.index("start_frame")
PI_STOP = _INT_SCALARS.index("stop_frame")
PI_STAGE0 = len(_INT_SCALARS) + _INT_ENV.index("stage0")
PI_RELEASE = len(_INT_SCALARS) + _INT_ENV.index("release_frame")
PI_RELMODE = len(_INT_SCALARS) + _INT_ENV.index("rel_mode")
PI_SEG_START = len(_INT_SCALARS) + len(_INT_ENV)
PI_SEG_POS = PI_SEG_START + MAX_SEGMENTS_PER_BLOCK
PI_BQ = PI_SEG_POS + MAX_SEGMENTS_PER_BLOCK + len(_INT_TRAILER)
PF_ENV0 = len(_F32_SCALARS) + _F32_ENV.index("env0")
PF_REL_RATE = len(_F32_SCALARS) + _F32_ENV.index("rel_rate")
PF_SEG_FRAC = len(_F32_SCALARS) + len(_F32_ENV)

# "no release this block": engine/voicestate._BIG as int32 — pinned equal by
# tests/test_lookahead.py so the 16-bit sentinel below round-trips exactly
RELEASE_NONE = np.int32(1 << 30)
_RF16 = 0xFFFF  # 16-bit release-frame field; max value = the sentinel


def horizon_dyn_cols(n_bq_extra: int = 0) -> int:
    """int32 columns per horizon slice in the compact dynamics matrix."""
    S = MAX_SEGMENTS_PER_BLOCK
    return 4 + (S + 1) // 2 + 1 + (n_bq_extra + 1) // 2


def pack_horizon_dynamics(tail, istart) -> "np.ndarray | None":
    """Compact per-slice dynamics for a lookahead horizon.

    `tail` is [(prog_i, prog_f)] for slices 1..H-1 — slice 0 ships as the
    full fused base program. Across a CLEAN horizon (no events by
    construction — engine._start_horizon preempts/rebuilds on any event)
    the per-block program builder (engine/voicestate.build_program) can
    only vary: position anchors, envelope anchors (stage0 / env0 /
    release_frame / rel_mode / rel_rate — rel_rate because a slice-0
    note_off's linear release fixes its rate at the trigger,
    voicestate.advance), wrap-segment frames, the stop frame and the
    active mask (mid-horizon voice deaths). Everything else is
    command-driven, and commands preempt horizons.

    Each slice packs to horizon_dyn_cols() int32 columns instead of the
    full K=34 program: a full [V, H*K] stack is ~2.2 MB per horizon at
    V=1024, H=16; the compact matrix is ~4.5x smaller.
    Values are EXTRACTED from the host-built per-block programs, never
    recomputed, so reconstruction (unpack_horizon_slice) is bit-exact.

    Layout: col 0 = istart (loop restart sample, the one extra static the
    reconstruction needs); then per slice h>=1: pos_int, pos_frac(bits),
    env0(bits), rel_rate(bits), (S+1)//2 cols of 16-bit pairs
    [wrap_1..wrap_{S-1}, stop_frame], one flags col
    (release_frame | active<<16 | stage0<<17 | rel_mode<<20), and
    ceil(W/2) cols of 16-bit beat-quantized reset pairs.

    Returns None when a program exceeds the encoding (a release frame
    neither in-block nor "none", a pending start past slice 0, or a
    negative position anchor) — the engine then skips this horizon and
    dispatches per-block.
    """
    S = MAX_SEGMENTS_PER_BLOCK
    npack = (S + 1) // 2
    if not tail:
        return np.asarray(istart, np.int32)[:, None].copy()
    V = tail[0][0].shape[0]
    W = tail[0][0].shape[1] - PI_BQ
    D = horizon_dyn_cols(W)
    dyn = np.empty((V, 1 + len(tail) * D), np.int32)
    dyn[:, 0] = istart
    dyn_f32 = dyn.view(np.float32)  # same-itemsize alias for bit columns
    for t, (prog_i, prog_f) in enumerate(tail):
        rf = prog_i[:, PI_RELEASE]
        if ((rf >= _RF16) & (rf != RELEASE_NONE)).any():
            return None
        if (prog_i[:, PI_START] != 0).any():
            return None
        pos_int = prog_i[:, PI_SEG_POS]
        if (pos_int < 0).any():
            return None
        # every 16-bit-packed field carries an in-block frame number; a
        # block size beyond 0xFFFF (or any out-of-range value) cannot ride
        # the compact encoding — fall back to per-block dispatch instead
        # of silently wrapping bits in the lo|hi<<16 packs below
        for pk in (prog_i[:, PI_SEG_START + 1:PI_SEG_START + S],
                   prog_i[:, PI_STOP:PI_STOP + 1],
                   prog_i[:, PI_BQ:PI_BQ + W]):
            if ((pk < 0) | (pk > _RF16)).any():
                return None
        off = 1 + t * D
        dyn[:, off] = pos_int
        dyn_f32[:, off + 1] = prog_f[:, PF_SEG_FRAC]
        dyn_f32[:, off + 2] = prog_f[:, PF_ENV0]
        dyn_f32[:, off + 3] = prog_f[:, PF_REL_RATE]
        fields = [prog_i[:, PI_SEG_START + s] for s in range(1, S)]
        fields.append(prog_i[:, PI_STOP])
        for c in range(npack):
            lo = fields[2 * c]
            hi = (fields[2 * c + 1] if 2 * c + 1 < len(fields)
                  else np.int32(0))
            dyn[:, off + 4 + c] = lo | (hi << 16)
        dyn[:, off + 4 + npack] = (
            np.minimum(rf, np.int32(_RF16))
            | (prog_i[:, PI_ACTIVE] << 16)
            | (prog_i[:, PI_STAGE0] << 17)
            | (prog_i[:, PI_RELMODE] << 20)
        )
        for c in range((W + 1) // 2):
            lo = prog_i[:, PI_BQ + 2 * c]
            hi = (prog_i[:, PI_BQ + 2 * c + 1] if 2 * c + 1 < W
                  else np.int32(0))
            dyn[:, off + 5 + npack + c] = lo | (hi << 16)
    return dyn


def _bits_f32(xp, col):
    """Bit-cast an int32 column to f32 (numpy view / lax bitcast)."""
    if isinstance(col, np.ndarray):
        return np.ascontiguousarray(col).view(np.float32)
    import jax

    return jax.lax.bitcast_convert_type(col, np.float32)


def unpack_horizon_slice(xp, base: VoiceProgram, dyn, h: int,
                         block_frames: int) -> VoiceProgram:
    """Reconstruct slice h (h >= 1) of a compact lookahead horizon.

    Bit-exact vs the host-built per-block program: every dynamic column is
    the host's own value round-tripped through the packing (16-bit fields
    all carry in-block frame numbers <= block_frames <= 2048). Static
    columns come from the slice-0 base program; rows that die mid-horizon keep
    base statics with active=0 — their values stay finite and the render
    masks them, so block audio is unaffected (the full-program differential
    fuzz in tests/test_lookahead.py pins equality end to end).
    """
    S = base.seg_start.shape[1]
    W = base.bq_reset.shape[1]
    npack = (S + 1) // 2
    D = 4 + npack + 1 + (W + 1) // 2
    off = 1 + (h - 1) * D
    istart = dyn[:, 0]
    pos_int = dyn[:, off]
    pos_frac = _bits_f32(xp, dyn[:, off + 1])
    env0 = _bits_f32(xp, dyn[:, off + 2])
    rel_rate = _bits_f32(xp, dyn[:, off + 3])
    f16 = []
    for c in range(npack):
        col = dyn[:, off + 4 + c]
        f16.append(col & 0xFFFF)
        f16.append((col >> 16) & 0xFFFF)
    wraps, stop = f16[: S - 1], f16[S - 1]
    flags = dyn[:, off + 4 + npack]
    rf = flags & _RF16
    rf = xp.where(rf == _RF16, RELEASE_NONE, rf)
    zero_i = xp.zeros_like(pos_int)
    seg_start = xp.stack([zero_i] + wraps, axis=1)
    seg_pos_int = xp.stack(
        [pos_int]
        + [xp.where(w < block_frames, istart, 0) for w in wraps],
        axis=1,
    )
    zf = xp.zeros_like(pos_frac)
    seg_pos_frac = xp.stack([pos_frac] + [zf] * (S - 1), axis=1)
    if W:
        g = []
        for c in range((W + 1) // 2):
            col = dyn[:, off + 5 + npack + c]
            g.append(col & 0xFFFF)
            g.append((col >> 16) & 0xFFFF)
        bq = xp.stack(g[:W], axis=1)
    else:
        bq = base.bq_reset
    return base._replace(
        active=(flags >> 16) & 1,
        seg_start=seg_start,
        seg_pos_int=seg_pos_int,
        seg_pos_frac=seg_pos_frac,
        start_frame=zero_i,
        stop_frame=stop,
        bq_reset=bq,
        env=base.env._replace(
            stage0=(flags >> 17) & 7,
            release_frame=rf,
            rel_mode=(flags >> 20) & 3,
            env0=env0,
            rel_rate=rel_rate,
        ),
    )


def horizon_programs(xp, base_fused, dyn, slices: int,
                     block_frames: int) -> list:
    """All H per-block VoicePrograms of a compact horizon: slice 0 from the
    fused base program, slices 1..H-1 reconstructed from the dynamics."""
    pi, pf = split_fused(base_fused)
    base = unpack_program(pi, pf)
    return [base] + [
        unpack_horizon_slice(xp, base, dyn, h, block_frames)
        for h in range(1, slices)
    ]


def pack_strips(strips) -> np.ndarray:
    """StripParams -> one [5, K] f32 array (order: dry, wet1, wet2, pan, muted)."""
    return np.stack(
        [np.asarray(f, np.float32) for f in strips], axis=0
    )


def unpack_strips(packed):
    from .mixer import StripParams

    return StripParams(
        dry=packed[0], wet1=packed[1], wet2=packed[2],
        pan=packed[3], muted=packed[4],
    )


def empty_program(num_voices: int, block_frames: int,
                  n_bq_extra: int = 0) -> VoiceProgram:
    """An all-idle program (host fills in active voices per block)."""
    V, S = num_voices, MAX_SEGMENTS_PER_BLOCK
    zi = lambda *s: np.zeros(s or (V,), np.int32)  # noqa: E731
    zf = lambda *s: np.zeros(s or (V,), np.float32)  # noqa: E731
    return VoiceProgram(
        active=zi(),
        base=zi(),
        len_minus1=np.ones(V, np.int32),
        seg_start=np.full((V, S), block_frames, np.int32),
        seg_pos_int=zi(V, S),
        loop_period=zi(),
        bq_reset=np.full((V, n_bq_extra), block_frames, np.int32),
        seg_pos_frac=zf(V, S),
        rate_int=zi(),
        rate_frac=zf(),
        start_frame=zi(),
        stop_frame=np.full(V, block_frames, np.int32),
        gain=zf(),
        clip_volume=zf(),
        pan=zf(),
        lane=zi(),
        env=adsr_ops.AdsrProgram(
            stage0=zi(),
            env0=zf(),
            a_rate=zf(),
            d_rate=zf(),
            sustain=zf(),
            rel_rate=zf(),
            inv_rel=zf(),
            rel_log2=zf(),
            release_frame=np.full(V, block_frames, np.int32),
            rel_mode=zi(),
        ),
    )


def _frame_iota(xp, n: int):
    """[1, n] int32 frame indices (numpy arange | jax broadcasted_iota)."""
    if xp is np:
        return np.arange(n, dtype=np.int32)[None, :]
    import jax

    return jax.lax.broadcasted_iota(np.int32, (1, n), 1)


def positions_block(xp, prog: VoiceProgram, block_frames: int):
    """Per-frame sample positions. Returns (pos_int [V,B] i32, alpha [V,B] f32,
    seg_j [V,B] i32)."""
    f32 = np.float32
    k = _frame_iota(xp, block_frames)
    # segment index: count of segments whose start <= k, minus one
    seg_started = (prog.seg_start[:, :, None] <= k[:, None, :]).astype(np.int32)
    seg_idx = xp.maximum(seg_started.sum(axis=1) - 1, 0)  # [V, B]
    # select the segment fields with masked sums over the (tiny, static) S
    # axis — a take_along_axis here would be a second gather of 3*V*B
    # elements beside the sample fetch itself
    S = prog.seg_start.shape[1]
    s_start = prog.seg_start[:, 0:1] * (seg_idx == 0)
    s_int = prog.seg_pos_int[:, 0:1] * (seg_idx == 0)
    s_frac = prog.seg_pos_frac[:, 0:1] * (seg_idx == 0).astype(f32)
    for s in range(1, S):
        m = seg_idx == s
        s_start = s_start + prog.seg_start[:, s : s + 1] * m
        s_int = s_int + prog.seg_pos_int[:, s : s + 1] * m
        s_frac = s_frac + prog.seg_pos_frac[:, s : s + 1] * m.astype(f32)
    j = k - s_start  # frames into segment (>= 0 for frames >= start_frame)
    jc = xp.maximum(j, 0)
    # positional-loop containment past the segment horizon: wrap segments
    # start at integer loop_start with zero fraction and repeat every
    # loop_period frames, so j mod period is exact for unlimited wraps
    per = prog.loop_period[:, None]
    wrapseg = (seg_idx >= 1) & (per > 0)
    jc = xp.where(wrapseg, jc % xp.maximum(per, 1), jc)
    # beat-quantized containment past the segment horizon: the host ships
    # every remaining in-block reset frame as an integer column (float64
    # wall-clock math stays on the host — the kernel only compares ints,
    # so device placement is bit-exact vs the scalar reference). Resets
    # ascend, so later columns overwrite earlier ones. Frames at/after a
    # reset sit in the last wrap segment already (seg_pos == loop start,
    # zero fraction); only the frames-into-segment count rebases.
    for e in range(prog.bq_reset.shape[1]):
        r_e = prog.bq_reset[:, e : e + 1]            # [V, 1], == B if unused
        jc = xp.where(k >= r_e, k - r_e, jc)
    frac_full = s_frac + jc.astype(f32) * prog.rate_frac[:, None]
    carry = xp.floor(frac_full)
    pos_int = s_int + jc * prog.rate_int[:, None] + carry.astype(np.int32)
    alpha = (frac_full - carry).astype(f32)
    return pos_int, alpha, seg_idx


def render_voices(
    xp,
    sound_data,           # [2, N] planar or [N, 2] interleaved sample memory
    prog: VoiceProgram,
    block_frames: int,
    quirk_gain: bool = False,
    num_lanes: int = NUM_SAMPLER_CHANNELS,
    return_contrib: bool = False,
):
    """Render all voices for one block: two interpolation taps per frame
    gathered from the sample memory (numpy indexing / XLA gather).

    Returns (mix [C, B, 2] f32, voice_peak [V] f32[, contrib [V, B, 2]]).
    """
    f32 = np.float32
    B = block_frames
    k = _frame_iota(xp, B)

    pos_int, alpha, seg_idx = positions_block(xp, prog, B)
    env = adsr_ops.envelope_block(
        xp, prog.env, B, start_frame=prog.start_frame
    )  # [V, B], voice-local frame origin

    renders = (
        (prog.active[:, None] > 0)
        & (k >= prog.start_frame[:, None])
        & (k < prog.stop_frame[:, None])
    )
    # reference bounds rule: fetch only when sampleDuration > pos
    # (lib/SamplerSynthVoice.cpp:204); otherwise the frame contributes 0.
    valid = renders & (pos_int >= 0) & (pos_int < prog.len_minus1[:, None])

    g = (prog.gain[:, None] * env * prog.clip_volume[:, None]).astype(f32)
    inv_alpha = f32(1.0) - alpha

    # Both taps are clamped into the sound's own region; lanes where the
    # clamp changed anything are masked off by `valid` above.
    lm1 = prog.len_minus1[:, None]
    safe_pos0 = xp.clip(pos_int, 0, lm1) + prog.base[:, None]
    safe_pos1 = xp.clip(pos_int + 1, 0, lm1) + prog.base[:, None]
    planar = sound_data.shape[0] == 2
    if xp is np:
        if planar:
            t0l, t0r = sound_data[0, safe_pos0], sound_data[1, safe_pos0]
            t1l, t1r = sound_data[0, safe_pos1], sound_data[1, safe_pos1]
        else:
            tap0, tap1 = sound_data[safe_pos0], sound_data[safe_pos1]
            t0l, t0r = tap0[..., 0], tap0[..., 1]
            t1l, t1r = tap1[..., 0], tap1[..., 1]
    elif planar:
        t0l = xp.take(sound_data[0], safe_pos0, axis=0)
        t0r = xp.take(sound_data[1], safe_pos0, axis=0)
        t1l = xp.take(sound_data[0], safe_pos1, axis=0)
        t1r = xp.take(sound_data[1], safe_pos1, axis=0)
    else:
        # interleaved [N, 2]: one row gather fetches both channels
        tap0 = xp.take(sound_data, safe_pos0, axis=0)
        tap1 = xp.take(sound_data, safe_pos1, axis=0)
        t0l, t0r = tap0[..., 0], tap0[..., 1]
        t1l, t1r = tap1[..., 0], tap1[..., 1]

    if sound_data.dtype == np.int16:
        # int16 bank (engine bank_dtype="int16"): halves the gather's
        # device-memory bytes; dequant fuses into the tap consumers.
        # Exactly the precision of 16-bit source WAVs.
        dq = f32(1.0 / 32767.0)
        t0l = t0l.astype(f32) * dq
        t0r = t0r.astype(f32) * dq
        t1l = t1l.astype(f32) * dq
        t1r = t1r.astype(f32) * dq

    if quirk_gain:
        # Reference-exact expression: gain chain on the second tap only
        # (lib/SamplerSynthVoice.cpp:204-205).
        l = t0l * inv_alpha + t1l * alpha * g
        r = t0r * inv_alpha + t1r * alpha * g
    else:
        l = (t0l * inv_alpha + t1l * alpha) * g
        r = (t0r * inv_alpha + t1r * alpha) * g
    zero = f32(0.0)
    l = xp.where(valid, l, zero)
    r = xp.where(valid, r, zero)

    # M/S panning (lib/SamplerSynthVoice.cpp:207-211)
    pan = prog.pan[:, None]
    l_pan = f32(0.5) * (f32(1.0) + pan)
    r_pan = f32(0.5) * (f32(1.0) - pan)
    m_sig = f32(0.5) * (l + r)
    s_sig = l - r
    l = l_pan * m_sig + s_sig
    r = r_pan * m_sig - s_sig

    # per-voice peak: max of (l + r), floored at 0 (lib/SamplerSynthVoice.cpp:213)
    voice_peak = xp.maximum(xp.max(l + r, axis=1), zero).astype(f32)

    contrib = xp.stack([l, r], axis=-1).astype(f32)  # [V, B, 2]

    # mixdown by sampler channel lane: one-hot [C, V] matmul -> [C, B, 2]
    if xp is np:
        lanes = np.arange(num_lanes, dtype=np.int32)[:, None]
        onehot = (lanes == prog.lane[None, :]).astype(f32)
        mix = np.einsum("cv,vbt->cbt", onehot, contrib).astype(f32)
    else:
        import jax

        lanes = jax.lax.broadcasted_iota(np.int32, (num_lanes, 1), 0)
        onehot = (lanes == prog.lane[None, :]).astype(f32)
        mix = jax.lax.dot_general(
            onehot,
            contrib.reshape(contrib.shape[0], -1),
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=f32,
        ).reshape(num_lanes, B, 2)

    if return_contrib:
        return mix, voice_peak, contrib
    return mix, voice_peak
