"""Threaded WAV disk recording (the DiskWriter/ThreadedWriter equivalent).

The reference records via a juce ThreadedWriter with a 32768-sample FIFO on a
TimeSliceThread (lib/AudioLevels.cpp:35-119): the RT callback pushes blocks,
a worker thread drains to a 16-bit WAV. Here the engine's host loop pushes
rendered blocks (already on host) into a queue drained by a writer thread.
"""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..constants import RECORDER_BIT_DEPTH, RECORDER_FIFO_SAMPLES


_COMPRESSED_SUFFIXES = (".flac", ".ogg", ".mp3")


def timestamped_filename(prefix: str, suffix: str = ".wav",
                         stamp: "str | None" = None) -> str:
    """Reference naming rule: the prefix is used verbatim when it already
    ends in .wav, otherwise "-" + a timestamp is appended — QString
    "%1-%2.wav" (lib/AudioLevels.cpp:539-556). `stamp` lets one take share
    a single timestamp across all its recorders, as the reference does
    (every writer of a take gets the same %2) — re-sampling per recorder
    would split a take's files across a second boundary. Extended beyond
    the reference: a prefix ending in .flac/.ogg/.mp3 is also used
    verbatim and selects that recording format (see DiskRecorder)."""
    if prefix.endswith((".wav",) + _COMPRESSED_SUFFIXES):
        return prefix
    if stamp is None:
        stamp = recording_timestamp()
    return f"{prefix}-{stamp}{suffix}"


def recording_timestamp() -> str:
    """One take-level timestamp (share across a take's recorders)."""
    return time.strftime("%Y%m%d-%H%M") + f"{time.time() % 60:06.3f}"


class DiskRecorder:
    """One recording target: a WAV file fed from a bounded queue."""

    def __init__(self, bit_depth: int = RECORDER_BIT_DEPTH):
        self.bit_depth = bit_depth
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._file: Optional[Path] = None
        self._convert_to: Optional[Path] = None
        self._wav_path: Optional[Path] = None
        self._wave = None
        self._recording = False
        self.frames_written = 0
        self.dropped_blocks = 0
        self.failed = False

    @property
    def is_recording(self) -> bool:
        return self._recording

    @property
    def file_path(self) -> Optional[Path]:
        return self._file

    def start(self, path: str | Path, sample_rate: int,
              channels: int = 2) -> None:
        if self._recording:
            self.stop()
        elif self._thread is not None:
            # a failed writer may still be draining its old queue; unblock
            # and join it so it cannot race the new session
            if self._queue is not None:
                try:
                    self._queue.put_nowait(None)
                except queue.Full:
                    pass
            self._thread.join(timeout=10.0)
            self._thread = None
        import wave

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self._file = path
        # compressed targets (beyond the reference's WAV-only recorder):
        # stream realtime audio to a sidecar WAV, transcode when the take
        # ends (the writer thread does it post-roll; see _run)
        self._convert_to: Optional[Path] = None
        wav_path = path
        if path.suffix.lower() in _COMPRESSED_SUFFIXES:
            self._convert_to = path
            wav_path = path.parent / (path.name + ".part.wav")
        self._wave = wave.open(str(wav_path), "wb")
        self._wav_path = wav_path
        self._wave.setnchannels(channels)
        self._wave.setsampwidth(self.bit_depth // 8)
        self._wave.setframerate(int(sample_rate))
        # bound the queue like the reference FIFO: a producer running ahead
        # back-pressures (bounded, see push) rather than exhausting memory
        max_blocks = max(RECORDER_FIFO_SAMPLES // 128, 4)
        self._queue = queue.Queue(maxsize=max_blocks)
        self._recording = True
        self.frames_written = 0
        self.dropped_blocks = 0
        self.failed = False
        self._frames_at_last_full = -1
        # session token: a zombie writer that outlived its join timeout
        # must not mutate the REPLACEMENT session's shared flags
        self._session = getattr(self, "_session", 0) + 1
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # push() waits at most this long for queue space before dropping a
    # block. Bounded so a dead writer can never freeze the engine,
    # but long enough that a faster-than-realtime producer (offline
    # bounce via step_blocks, FileSink renders) simply back-pressures on a
    # healthy writer instead of silently losing audio.
    PUSH_TIMEOUT_S = 2.0

    def push(self, block: np.ndarray) -> None:
        """Append [frames, channels] float32 audio.

        Fast path is non-blocking. On a full queue, wait (bounded) ONLY if
        the writer made progress since the last full event — that's
        healthy back-pressure for faster-than-realtime producers (offline
        bounces). A wedged writer (stuck inside writeframes on a dead
        mount, queue full, zero progress) gets counted drops immediately:
        push may run under the engine lock on the pump thread, and a
        2 s wait PER BLOCK there is a de-facto permanent freeze — the
        bounded wait must bound the sequence, not just one call."""
        if not (self._recording and self._queue is not None):
            return
        block = np.asarray(block)
        try:
            self._queue.put_nowait(block)
            return
        except queue.Full:
            pass
        if self.frames_written == self._frames_at_last_full:
            self.dropped_blocks += 1
            return
        self._frames_at_last_full = self.frames_written
        try:
            self._queue.put(block, timeout=self.PUSH_TIMEOUT_S)
        except queue.Full:
            self.dropped_blocks += 1

    def stop(self) -> None:
        if not self._recording:
            return
        self._recording = False
        try:
            self._queue.put(None, timeout=2.0)  # sentinel
        except queue.Full:
            pass  # writer is wedged; the join below times out, thread is daemon
        if self._thread is not None:
            # generous: compressed targets transcode post-roll on this
            # thread (FLAC of a long take can run tens of seconds)
            self._thread.join(timeout=60.0)
        self._thread = None

    def _run(self) -> None:
        scale = float((1 << (self.bit_depth - 1)) - 1)
        width = self.bit_depth // 8
        # capture THIS session's state: after a wedge that outlives the
        # join timeout, start() installs fresh queue/wave/paths while this
        # thread still runs — reading self.* here would write session-A
        # audio into session-B's file (and close B's handle in the finally)
        q = self._queue
        wav = self._wave
        wav_path = self._wav_path
        convert_to = self._convert_to
        sess = self._session
        failed = False
        try:
            while True:
                block = q.get()
                if block is None:
                    break
                clipped = np.clip(block, -1.0, 1.0)
                if width >= 3:
                    # f32 spacing is 1.0 at magnitude 2^23: scaling in f32
                    # costs 1 LSB on ~17% of 24-bit samples (write_wav's
                    # 32-bit path documents the same rule)
                    ints = np.round(clipped.astype(np.float64) * scale)
                else:
                    ints = np.round(clipped * scale)
                if width == 2:
                    raw = ints.astype("<i2").tobytes()
                elif width == 3:
                    i32 = ints.astype(np.int32).reshape(-1)
                    b = np.empty((i32.size, 3), np.uint8)
                    b[:, 0] = i32 & 0xFF
                    b[:, 1] = (i32 >> 8) & 0xFF
                    b[:, 2] = (i32 >> 16) & 0xFF
                    raw = b.tobytes()
                else:
                    raw = ints.astype("<i4").tobytes()
                wav.writeframes(raw)
                if self._session == sess:
                    self.frames_written += block.shape[0]
        except Exception:
            # disk full / target deleted: mark failed and keep draining so
            # producers never see a permanently-full queue. Shared flags
            # belong to whichever session is CURRENT — a zombie from a
            # wedged previous session must not kill its replacement.
            failed = True
            if self._session == sess:
                self.failed = True
                self._recording = False
            while True:
                try:
                    if q.get(timeout=5.0) is None:
                        break
                except queue.Empty:
                    break
        finally:
            try:
                wav.close()
            except Exception:
                failed = True
                if self._session == sess:
                    self.failed = True
            if self._wave is wav:
                self._wave = None
            if convert_to is not None and not failed:
                self._transcode(wav_path, convert_to)

    def _transcode(self, wav_path, target) -> None:
        """Post-roll conversion of the sidecar WAV to the requested
        compressed target (FLAC lossless, OGG, MP3). Session paths are
        passed in (not read from self) so a zombie writer cannot transcode
        a newer session's files."""
        try:
            from ..io.wav import read_audio

            a = read_audio(wav_path)
            suffix = target.suffix.lower()
            if suffix == ".flac":
                from ..io.flac import write_flac

                write_flac(target, a.samples, a.sample_rate)
            elif suffix == ".ogg":
                from ..io.codecs import write_ogg

                write_ogg(target, a.samples, a.sample_rate)
            else:
                from ..io.codecs import write_mp3

                write_mp3(target, a.samples, a.sample_rate)
            wav_path.unlink(missing_ok=True)
        except Exception:
            # keep the sidecar WAV: the audio is never lost to a failed
            # or unavailable codec
            self.failed = True
