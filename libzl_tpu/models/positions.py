"""Per-clip playback positions model (ClipAudioSourcePositionsModel equivalent).

Tracks up to POSITION_COUNT live playback positions per clip — one per active
voice — with id, gain and progress (lib/ClipAudioSourcePositionsModel.cpp:5-12).
Voices publish peak*0.5 and progress once per block
(lib/SamplerSynthVoice.cpp:264-267); `peak_gain` is the max over positions
(:160-173), `first_progress` feeds the UI progress callback (:175-185), and a
staleness reaper drops orphans after 1 s (:191-209).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..constants import POSITION_COUNT, POSITION_ORPHAN_TIMEOUT_MS


@dataclasses.dataclass
class PlaybackPosition:
    position_id: int
    gain: float = 0.0
    progress: float = 0.0
    last_updated: float = 0.0


class PositionsModel:
    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._positions: dict[int, PlaybackPosition] = {}
        self._clock = clock or time.monotonic
        self.on_peak_gain_changed: Optional[Callable[[float], None]] = None
        self.on_first_progress_changed: Optional[Callable[[float], None]] = None

    def __len__(self) -> int:
        return len(self._positions)

    def create_position(self, position_id: int) -> None:
        if len(self._positions) >= POSITION_COUNT:
            # reference silently refuses beyond POSITION_COUNT
            return
        self._positions[position_id] = PlaybackPosition(
            position_id, last_updated=self._clock()
        )

    def remove_position(self, position_id: int) -> None:
        self._positions.pop(position_id, None)

    def set_gain_and_progress(
        self, position_id: int, gain: float, progress: float
    ) -> None:
        p = self._positions.get(position_id)
        if p is None:
            return
        # one peak scan per side of the mutation, and only when someone
        # listens (the unconditional triple scan was the same per-call
        # cost class set_many exists to avoid)
        watch = self.on_peak_gain_changed is not None
        old_peak = self.peak_gain() if watch else 0.0
        p.gain = float(gain)
        p.progress = float(progress)
        p.last_updated = self._clock()
        if watch:
            new_peak = self.peak_gain()
            if new_peak != old_peak:
                self.on_peak_gain_changed(new_peak)
        if self.on_first_progress_changed is not None:
            self.on_first_progress_changed(self.first_progress())

    def set_many(self, ids, gains, progresses) -> None:
        """Batched per-block update (one clock read, one peak-change check)
        — the engine pushes every active voice's gain/progress each session
        update; doing it row-by-row was O(voices * positions) from the
        per-call peak_gain scans."""
        now = self._clock()
        positions = self._positions
        old_peak = (
            self.peak_gain() if self.on_peak_gain_changed is not None else None
        )
        for pid, g, pr in zip(ids, gains, progresses):
            p = positions.get(pid)
            if p is None:
                continue
            p.gain = g
            p.progress = pr
            p.last_updated = now
        if self.on_peak_gain_changed is not None:
            new_peak = self.peak_gain()
            if new_peak != old_peak:
                self.on_peak_gain_changed(new_peak)
        if self.on_first_progress_changed is not None:
            self.on_first_progress_changed(self.first_progress())

    def peak_gain(self) -> float:
        """Max gain over live positions (cpp:160-173)."""
        if not self._positions:
            return 0.0
        return max(p.gain for p in self._positions.values())

    def first_progress(self) -> float:
        """Progress of the first position, or -1 when none (cpp:175-185)."""
        for p in self._positions.values():
            return p.progress
        return -1.0

    def cleanup(self) -> int:
        """Reap positions not updated within the orphan timeout (cpp:191-209).
        Returns the number reaped."""
        cutoff = self._clock() - POSITION_ORPHAN_TIMEOUT_MS / 1000.0
        stale = [
            pid
            for pid, p in self._positions.items()
            if p.last_updated < cutoff
        ]
        for pid in stale:
            del self._positions[pid]
        return len(stale)
