"""ctypes binding for the native host core (native/zl_hostcore.cpp).

`voice_update(pool, ...)` replaces the numpy `build_program` + `advance`
pair with one native pass, writing the packed device-program matrices
directly. The numpy path remains the reference implementation;
tests/test_hostcore.py asserts bitwise agreement.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

# base int columns; each engine adds pool.n_bq_extra beat-quantized reset
# columns (constants.bq_extra_resets — 0 at the live geometry)
NUM_INT_COLS_BASE = 19
NUM_F32_COLS = 15

# the native core writes these matrices with a HARDCODED layout
# (zl_hostcore.cpp); desynchronizing it from ops/voice.pack_program would
# corrupt programs silently — fail at import time instead
from ..constants import MAX_SEGMENTS_PER_BLOCK as _S  # noqa: E402
from ..ops.voice import (  # noqa: E402
    _F32_ENV as _VF32E,
    _F32_SCALARS as _VF32,
    _INT_ENV as _VINTE,
    _INT_SCALARS as _VINT,
    _INT_TRAILER as _VINTT,
)

assert NUM_INT_COLS_BASE == len(_VINT) + len(_VINTE) + 2 * _S + len(_VINTT), (
    "packed int layout changed in ops/voice.py — update NUM_INT_COLS_BASE "
    "AND native/zl_hostcore.cpp together"
)
assert NUM_F32_COLS == len(_VF32) + len(_VF32E) + _S, (
    "packed f32 layout changed in ops/voice.py — update NUM_F32_COLS AND "
    "native/zl_hostcore.cpp together"
)


class _Params(ctypes.Structure):
    _fields_ = [
        ("num_voices", ctypes.c_int64),
        ("block_frames", ctypes.c_int64),
        ("block_start_sample", ctypes.c_double),
        ("tick_anchor_sample", ctypes.c_double),
        ("tick_anchor", ctypes.c_int64),
        ("samples_per_tick", ctypes.c_double),
        ("n_bq_extra", ctypes.c_int64),
    ]


_STATE_FIELDS = [
    "active", "clip_id", "pos_int", "pos_frac", "rate_int", "rate_frac",
    "istart", "stop", "looping", "beat_quantized", "loop_len_ticks",
    "next_loop_tick", "gain", "clip_volume", "pan", "lane", "stage", "env",
    "a_rate", "d_rate", "sustain", "rel_rate", "inv_rel", "rel_log2",
    "rel_mode", "release_sec", "pending_start", "pending_release",
    "position_id", "base", "length", "source_rate", "lane_enabled",
]


class _State(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _STATE_FIELDS]


# per-slice snapshot buffers for the native horizon sim — order/dtypes
# mirror VoicePool._ADVANCE_FIELDS (and native/zl_hostcore.cpp Snaps)
_SNAP_FIELDS = [
    ("active", np.bool_), ("clip_id", np.int64), ("position_id", np.int64),
    ("pos_int", np.int64), ("pos_frac", np.float32), ("stage", np.int32),
    ("env", np.float32), ("rel_rate", np.float32), ("rel_mode", np.int32),
    ("next_loop_tick", np.int64), ("pending_start", np.int64),
    ("pending_release", np.int64),
]


class _Snaps(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name, _ in _SNAP_FIELDS]


_lib: Optional[ctypes.CDLL] = None


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native core; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    from .._native import load_native

    lib = load_native("zl_hostcore", "zl_hostcore_abi_version", 6)
    if lib is None:
        return None
    lib.zl_voice_update.restype = ctypes.c_int64
    lib.zl_voice_update.argtypes = [
        ctypes.POINTER(_Params), ctypes.POINTER(_State),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.zl_horizon_update.restype = ctypes.c_int64
    lib.zl_horizon_update.argtypes = [
        ctypes.POINTER(_Params), ctypes.POINTER(_State), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(_Snaps),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _build_state(pool, lane_enabled: np.ndarray):
    """ctypes _State for (pool, lane_enabled), cached on the pool.

    The pointer marshalling (33 data_as casts) would otherwise run on
    every call of a 16-block lookahead horizon. Pool arrays are mutated IN PLACE on
    the native path (restore_state/kill/note_on write through; the numpy
    advance(), which rebinds, never runs when use_native_host is on), so
    a cached struct stays valid; an identity sweep re-marshals if any
    array was rebound (e.g. by test harnesses mixing both paths).
    lane_enabled is pointed at DIRECTLY when it is bool-contiguous (the
    engine's live array and its horizon-frozen copies both are), so
    in-place lane toggles propagate; otherwise the struct is built
    uncached around a temporary copy the caller must keep alive.

    Returns (state, keepalive)."""
    cached = getattr(pool, "_hostcore_state_cache", None)
    if cached is not None:
        state, arrays, lane_cached = cached
        if lane_cached is lane_enabled and all(
            a is getattr(pool, n) for n, a in arrays
        ):
            return state, lane_cached
    if (lane_enabled.dtype == np.bool_
            and lane_enabled.flags["C_CONTIGUOUS"]):
        lane_arr, cacheable = lane_enabled, True
    else:
        lane_arr = np.ascontiguousarray(lane_enabled, dtype=np.bool_)
        cacheable = False
    state = _State()
    arrays = []
    for name in _STATE_FIELDS[:-1]:
        a = getattr(pool, name)
        if not a.flags["C_CONTIGUOUS"]:
            raise RuntimeError(f"pool array {name} must be contiguous")
        arrays.append((name, a))
        setattr(state, name, a.ctypes.data_as(ctypes.c_void_p).value)
    setattr(
        state, "lane_enabled",
        lane_arr.ctypes.data_as(ctypes.c_void_p).value,
    )
    if cacheable:
        pool._hostcore_state_cache = (state, arrays, lane_enabled)
    return state, lane_arr


def voice_update(
    pool,
    block_start_sample: float,
    tick_anchor_sample: float,
    tick_anchor: int,
    samples_per_tick: float,
    lane_enabled: np.ndarray,
    window_frames: int | None = None,
):
    """Native build_program + advance in one pass.

    Returns (prog_i [V,19+W] i32, prog_f [V,15] f32, died_info) where
    died_info is a list of (voice, clip_id, position_id); the caller must
    finish the kill (this function already read the ids, then kills).
    """
    lib = load()
    assert lib is not None, "native host core unavailable"
    V = pool.num_voices
    prog_i = np.empty((V, NUM_INT_COLS_BASE + pool.n_bq_extra), np.int32)
    prog_f = np.empty((V, NUM_F32_COLS), np.float32)
    died = np.empty(V, np.int64)

    params = _Params(
        num_voices=V,
        block_frames=int(window_frames or pool.block_frames),
        block_start_sample=float(block_start_sample),
        tick_anchor_sample=float(tick_anchor_sample),
        tick_anchor=int(tick_anchor),
        samples_per_tick=float(samples_per_tick),
        n_bq_extra=int(pool.n_bq_extra),
    )
    state, _keepalive = _build_state(pool, lane_enabled)

    n_died = lib.zl_voice_update(
        ctypes.byref(params), ctypes.byref(state),
        prog_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        prog_f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        died.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    died_info = []
    for v in died[:n_died]:
        v = int(v)
        died_info.append((v, int(pool.clip_id[v]), int(pool.position_id[v])))
        pool.kill(v)
    return prog_i, prog_f, died_info


def horizon_update(
    pool,
    slices: int,
    block_start_sample: float,
    tick_anchor_sample: float,
    tick_anchor: int,
    samples_per_tick: float,
    lane_enabled: np.ndarray,
):
    """The whole H-block lookahead-horizon host sim in ONE native call
    (engine._sim_horizon_bundle's hot path, instead of per-slice ctypes
    calls plus numpy dynamics packing).

    Returns (prog_i0, prog_f0, dyn, snaps, died_lists) — bit-identical to
    running `voice_update` per slice + ops/voice.pack_horizon_dynamics +
    pool.save_state() per slice — or None when a tail slice exceeds the
    compact encoding (caller falls back to per-block dispatch; pool state
    is partially advanced, restore the pre-sim snapshot). `snaps[h]` is a
    restore_state()-compatible dict of views into one [H, V] buffer per
    field; `died_lists[h]` is [(clip_id, position_id)] with kills already
    applied natively (ids were read pre-kill)."""
    from ..ops.voice import horizon_dyn_cols

    lib = load()
    assert lib is not None, "native host core unavailable"
    V = pool.num_voices
    H = int(slices)
    D = horizon_dyn_cols(pool.n_bq_extra)
    prog_i = np.empty((V, NUM_INT_COLS_BASE + pool.n_bq_extra), np.int32)
    prog_f = np.empty((V, NUM_F32_COLS), np.float32)
    dyn = np.empty((V, 1 + (H - 1) * D), np.int32)
    snap_bufs = {n: np.empty((H, V), dt) for n, dt in _SNAP_FIELDS}
    died = np.empty(H * V * 3, np.int64)
    counts = np.empty(H, np.int64)

    params = _Params(
        num_voices=V,
        block_frames=int(pool.block_frames),
        block_start_sample=float(block_start_sample),
        tick_anchor_sample=float(tick_anchor_sample),
        tick_anchor=int(tick_anchor),
        samples_per_tick=float(samples_per_tick),
        n_bq_extra=int(pool.n_bq_extra),
    )
    state, _keepalive = _build_state(pool, lane_enabled)
    snaps_struct = _Snaps()
    for name, _ in _SNAP_FIELDS:
        setattr(snaps_struct, name,
                snap_bufs[name].ctypes.data_as(ctypes.c_void_p).value)

    rc = lib.zl_horizon_update(
        ctypes.byref(params), ctypes.byref(state), H,
        prog_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        prog_f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dyn.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(snaps_struct),
        died.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    snaps = [
        {n: snap_bufs[n][h] for n, _ in _SNAP_FIELDS} for h in range(H)
    ]
    died_lists = []
    for h in range(H):
        n = int(counts[h])
        tri = died[h * V * 3: h * V * 3 + n * 3].reshape(n, 3)
        died_lists.append([(int(c), int(p)) for _, c, p in tri])
    return prog_i, prog_f, dyn, snaps, died_lists
