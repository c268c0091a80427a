"""Multi-device demo: a 4096-voice engine sharded over a device mesh.

Runs on every device jax finds (e.g. four GPUs of one host); with --cpu it
runs on a virtual 8-device CPU mesh instead, which exercises the identical
sharding path (the reference caps at 96 voices across 12 JACK clients on
one SBC — lib/SamplerSynth.cpp:23,254-278; here the voice axis shards over
the mesh and the only cross-device traffic is the lane-mixdown psum,
parallel/sharding.py).

    python examples/multichip_demo.py [--cpu] [out.wav]
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CPU = "--cpu" in sys.argv[1:]
if CPU:
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )

import numpy as np

import jax

if CPU:
    jax.config.update("jax_platforms", "cpu")

from libzl_tpu.engine.engine import AudioEngine
from libzl_tpu.io.wav import AudioData, write_wav
from libzl_tpu.models.clip import ClipAudioSource
from libzl_tpu.parallel.sharding import make_mesh

SR = 48000


def main(out_path="multichip_demo.wav"):
    mesh = make_mesh()
    n_dev = len(mesh.devices.flatten())
    print(f"mesh: {n_dev} devices ({mesh.devices.flatten()[0].platform})")

    # LIBZL_DEMO_VOICES / LIBZL_DEMO_SECONDS shrink the demo (the test
    # suite runs it at a smaller pool to keep the CPU-mesh wall time down;
    # the sharding path exercised is identical)
    num_voices = int(os.environ.get("LIBZL_DEMO_VOICES", "4096") or 4096)
    engine = AudioEngine(
        sample_rate=SR, block_frames=1024, num_voices=num_voices, mesh=mesh
    )
    engine.start_transport(bpm=128)

    # a spread of detuned tones across all 10 sampler channels
    rng = np.random.default_rng(7)
    clips = []
    for i in range(10):
        t = np.arange(SR // 2) / SR
        f = 110.0 * 2 ** (i / 5.0)
        wave = (0.2 * np.sin(2 * np.pi * f * t)).astype(np.float32)[:, None]
        clips.append(ClipAudioSource(engine, audio=AudioData(wave, SR)))

    # a dense looped chord cloud: 32 voices per channel at distinct pitches
    # (each (clip, channel, note) triple claims its own voice)
    from libzl_tpu.engine.commands import ClipCommand

    for i, clip in enumerate(clips):
        for v in range(32):
            cmd = ClipCommand.channel(clip.id, i)
            cmd.midi_note = 36 + v
            cmd.change_volume = True
            cmd.volume = 0.08
            cmd.looping = True
            cmd.start_playback = True
            engine.schedule_clip_command(cmd, int(rng.integers(0, 24)))
        # plus a short percussive burst through the note scheduler
        for note in (48, 52, 55, 60):
            engine.schedule_note(
                note, midi_channel=i, velocity=100,
                duration=int(rng.integers(40, 90)),
                delay=int(rng.integers(0, 48)),
            )

    seconds = float(os.environ.get("LIBZL_DEMO_SECONDS", "2.0") or 2.0)
    blocks = []
    for _ in range(int(seconds * SR) // engine.block_frames):
        res = engine.process_block()
        blocks.append(np.asarray(res.outputs.master))
    master = np.concatenate(blocks, axis=0)
    write_wav(out_path, master, SR)
    active = int(engine.pool.active.sum())
    print(
        f"rendered {master.shape[0] / SR:.1f}s with {active} live voices "
        f"sharded over {n_dev} devices, peak {np.abs(master).max():.3f} "
        f"-> {out_path}"
    )


if __name__ == "__main__":
    main(*[a for a in sys.argv[1:] if a != "--cpu"])
