"""chip_smoke.py: its refusal off the GPU, its comparison helpers, and its
phases rehearsed at a tiny size on the CPU (the script itself runs only on
the card)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke as cs

REPO = Path(__file__).resolve().parents[1]


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script), "--out",
                           str(cwd / "out")], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu(tmp_path):
    proc = _run_smoke(tmp_path, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "device check: FAIL" in proc.stdout
    assert proc.stdout.splitlines()[0].startswith("card: ")


def test_refuses_outside_the_repo(tmp_path):
    """Alone in a directory (no libzl_tpu beside it) the script fails and
    prints no result line."""
    script = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", script)
    proc = _run_smoke(tmp_path, script)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_comparison_helpers():
    a = np.zeros((3, 4), np.float32)
    b = a.copy()
    b[1, 2] = 2e-4
    assert cs.max_abs_err(a, b) == pytest.approx(2e-4)
    assert cs.max_abs_err(a[:0], b[:0]) == 0.0
    with pytest.raises(cs.PhaseFailure, match="shape"):
        cs.max_abs_err(a, b[:2])
    with pytest.raises(cs.PhaseFailure, match="non-finite"):
        cs.max_abs_err(a, np.full_like(a, np.nan))
    assert cs.check("x", 1e-5, cs.TOL_AUDIO) == 1e-5
    with pytest.raises(cs.PhaseFailure, match="x"):
        cs.check("x", 2e-4, cs.TOL_AUDIO)
    want = np.ones(100)
    assert cs.rel_rms(want * (1 + 1e-5), want) == pytest.approx(1e-5)
    got = {f: np.zeros(2) for f in cs.RENDER_FIELDS}
    ref = dict(got, lane_mix=np.full(2, 5e-5))
    assert cs.compare_blocks("b", got, ref, cs.TOL_AUDIO) == 5e-5


def test_union_ns():
    assert cs.union_ns([]) == 0
    assert cs.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert cs.union_ns([(20, 30), (0, 40)]) == 40


def test_gather_fusion_names():
    hlo = (
        "%fused_computation.1 (p: f32[8,2], q: s32[4]) -> f32[4,2] {\n"
        "  ROOT %gather.3 = f32[4,2]{1,0} gather(%p, %q), offset_dims={1}\n"
        "}\n"
        "%fused_computation.2 (p: f32[4]) -> f32[4] {\n"
        "  ROOT %neg = f32[4]{0} negate(%p)\n"
        "}\n"
        "ENTRY %main (a: f32[8,2], i: s32[4]) -> f32[4,2] {\n"
        "  %loop_gather_fusion = f32[4,2]{1,0} fusion(%a, %i), kind=kLoop, "
        "calls=%fused_computation.1, metadata={op_name=\"x\"}\n"
        "  %neg_fusion = f32[4]{0} fusion(%b), kind=kLoop, "
        "calls=%fused_computation.2\n"
        "}\n"
    )
    assert cs.gather_fusion_names(hlo) == {"loop_gather_fusion"}


def test_engine_phase_rehearsal():
    """The engine phase end to end at 64 voices on the CPU: lookahead on
    and off and super-blocks against the numpy engine, plus the horizon
    against per-block dispatch."""
    info = cs.phase_engine("cpu", voices=64, live_blocks=40, super_blocks=6)
    assert info["rel_err_horizon_vs_per_block_master"] <= cs.TOL_HORIZON
    assert info["warmup_graphs_lookahead_auto"] >= 2


def test_four_phase_on_virtual_cpu_mesh():
    """The --four phase on 4 virtual CPU devices at 64 voices: the sharded
    engine (per-block and horizon) against one device and numpy, with the
    bank and strips replicated over the mesh."""
    info = cs.phase_four(jax.devices()[:4], "cpu", voices=64, blocks=24)
    assert info["err_mesh_auto_vs_single"] <= cs.TOL_AUDIO
    assert info["err_mesh_0_vs_numpy"] <= cs.TOL_AUDIO


def test_stretch_thumbnail_phase_rehearsal():
    info = cs.phase_stretch_thumbnails("cpu")
    assert info["thumbnail_err"] == 0.0


def test_render_blocks_rejects_wrong_platform():
    import bench

    eng = bench.build_session(128, 16)
    with pytest.raises(cs.PhaseFailure, match="not gpu"):
        cs.render_blocks(eng, 4, platform="gpu")
