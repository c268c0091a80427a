"""The one backend decision (libzl_tpu.device), the compile cache rule, and
the full-precision lane mixdown."""

import re

import jax
import numpy as np
import pytest

from libzl_tpu import device


@pytest.mark.parametrize("platform,requested,want", [
    ("gpu", "auto", "jax"),
    ("cpu", "auto", "numpy"),
    ("gpu", "numpy", "numpy"),   # the explicit override wins
    ("cpu", "jax", "jax"),
])
def test_resolve_backend(monkeypatch, platform, requested, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert device.resolve_backend(requested) == want


def test_resolve_backend_rejects_unknown():
    with pytest.raises(ValueError, match="auto\\|jax\\|numpy"):
        device.resolve_backend("cuda")


def test_bridge_auto_backend_follows_device(monkeypatch):
    """The C ABI runtime's default "auto" renders with jax when JAX's
    default backend is the GPU, and with numpy on a CPU-only host."""
    from libzl_tpu.capi.bridge import EngineRuntime

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    rt = EngineRuntime(48000, 128, 16, pipeline_depth=0, lookahead=0)
    assert rt.engine.backend == "jax"
    stats = rt.engine.stats()
    assert stats["backend"] == "jax"
    assert stats["platform"] == jax.devices()[0].platform
    assert stats["device_kind"] == jax.devices()[0].device_kind
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert EngineRuntime(48000, 128, 16).engine.backend == "numpy"


def test_device_info_numpy_backend_and_log(caplog):
    from libzl_tpu.engine.engine import AudioEngine

    info = device.device_info("numpy")
    assert info["device_count"] == 0 and info["platform"] == "cpu"
    with caplog.at_level("INFO", logger="libzl_tpu"):
        eng = AudioEngine(sample_rate=48000, num_voices=8, backend="jax")
    assert eng.stats()["device_count"] == 1  # one device without a mesh
    assert any("renders on" in r.getMessage() for r in caplog.records)


def test_compile_cache_dir_env_set_and_unset(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    fixed = device.compile_cache_dir()
    assert fixed == str(device.CACHE_DIR)
    assert fixed.endswith(".jax_cache")
    # the fixed directory sits in the checkout, next to the package
    assert (device.CACHE_DIR.parent / "libzl_tpu" / "device.py").exists()


def test_use_compile_cache_sets_only_when_unconfigured(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        # already configured (JAX read the variable, or the host set it):
        # nothing is overridden
        jax.config.update("jax_compilation_cache_dir", "/set")
        assert device.use_compile_cache() == "/set"
        assert jax.config.jax_compilation_cache_dir == "/set"
        # unconfigured: the checkout's fixed directory, never a temp name
        jax.config.update("jax_compilation_cache_dir", None)
        assert device.use_compile_cache() == str(device.CACHE_DIR)
        assert jax.config.jax_compilation_cache_dir == str(device.CACHE_DIR)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def _lowered_dot_precisions(text: str) -> list:
    """precision attributes of every dot_general in a lowered module."""
    return [line for line in text.splitlines() if "dot_general" in line]


def test_mixdown_lowers_with_highest_precision():
    """The f32 lane mixdown asks for HIGHEST precision, so a GPU never runs
    it in TF32 (~3 significant digits)."""
    import __graft_entry__ as ge
    from libzl_tpu.engine import render as render_mod
    from libzl_tpu.ops.voice import fuse_packed, pack_program, pack_strips

    sound, prog, strips = ge._example_inputs(64, 128, 1 << 12)
    fused = fuse_packed(*pack_program(prog))
    text = render_mod.render_block_fused.lower(
        np.ascontiguousarray(sound.T), fused, pack_strips(strips),
        block_frames=128).as_text()
    dots = _lowered_dot_precisions(text)
    assert dots, "no dot_general in the render"
    assert all(re.search(r"HIGHEST", d) for d in dots), dots


def test_shardmap_mixdown_lowers_with_highest_precision():
    import __graft_entry__ as ge
    from libzl_tpu.ops.voice import fuse_packed, pack_program, pack_strips
    from libzl_tpu.parallel.sharding import (
        make_mesh,
        make_shardmap_horizon_render,
        make_shardmap_packed_render,
    )

    sound, prog, strips = ge._example_inputs(64, 128, 1 << 12)
    fused = fuse_packed(*pack_program(prog))
    mesh = make_mesh(4)
    text = make_shardmap_packed_render(mesh, 128).lower(
        np.ascontiguousarray(sound.T), fused, pack_strips(strips)).as_text()
    dots = _lowered_dot_precisions(text)
    assert dots and all("HIGHEST" in d for d in dots), dots
    from libzl_tpu.ops.voice import horizon_dyn_cols

    hz = np.concatenate(
        [fused, np.zeros((64, 1 + horizon_dyn_cols()), np.int32)], axis=1)
    text = make_shardmap_horizon_render(
        mesh, 128, slices=2, base_cols=fused.shape[1]).lower(
        np.ascontiguousarray(sound.T), hz, pack_strips(strips)).as_text()
    dots = _lowered_dot_precisions(text)
    assert len(dots) >= 2 and all("HIGHEST" in d for d in dots), dots


@pytest.mark.gpu
def test_engine_on_gpu_matches_numpy(gpu_device):
    """On the card: a small live session renders on the GPU and matches
    the numpy engine within the bring-up tolerance (chip_smoke.TOL_AUDIO)."""
    import bench
    import chip_smoke

    ref = chip_smoke.render_blocks(
        bench.build_session(128, 64, backend="numpy"), 200)
    eng = bench.build_session(128, 64)
    assert eng.stats()["platform"] == "gpu"
    got = chip_smoke.render_blocks(eng, 200, platform="gpu")
    chip_smoke.compare_blocks("gpu vs numpy", got, ref, chip_smoke.TOL_AUDIO)


@pytest.mark.gpu
def test_mixdown_is_f32_accurate_on_gpu(gpu_device):
    """On the card: the lane mixdown sums the voices at f32 accuracy. A
    TF32 product keeps ~3 significant digits (relative error ~1e-3); the
    HIGHEST-precision product stays near f32 rounding."""
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from libzl_tpu.ops.voice import render_voices

    sound, prog, _ = ge._example_inputs(256, 128, 1 << 12)
    mix, _, contrib = render_voices(
        jnp, jnp.asarray(np.ascontiguousarray(sound.T)), prog, 128,
        return_contrib=True)
    assert {d.platform for d in mix.devices()} == {"gpu"}
    contrib = np.asarray(contrib, np.float64)
    onehot = (np.arange(12)[:, None] == np.asarray(prog.lane)[None, :])
    want = np.einsum("cv,vbt->cbt", onehot.astype(np.float64), contrib)
    err = np.abs(np.asarray(mix, np.float64) - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
