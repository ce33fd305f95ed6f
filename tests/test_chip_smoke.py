"""chip_smoke.py: refuses a CPU backend; its phases rehearsed on the CPU.

On the card `python chip_smoke.py` runs every phase at 4096 scans × 4
targets. Here the phases run at a tiny size with the fused kernel in
the Pallas interpreter, which the apps get through a patched
RadarPredictor (the CPU backend cannot compile the Triton kernel).
"""

import functools
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _no_ok_line(stdout):
    for line in stdout.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok")


def test_refuses_cpu_backend():
    proc = _run_script(ROOT, "chip_smoke.py")
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    _no_ok_line(proc.stdout)


def test_bench_refuses_cpu_backend():
    """bench.py is a device measurement: on a CPU it prints an error
    line and exits 1 instead of timing the CPU."""
    proc = _run_script(ROOT, "bench.py")
    assert proc.returncode == 1
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "no GPU" in last["error"] and last["value"] == 0.0


def test_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path), "chip_smoke.py")
    assert proc.returncode != 0
    _no_ok_line(proc.stdout)


@pytest.mark.parametrize("where", ["grid_nodes", "jittered"])
def test_reference_drops_only_boundary_targets(where):
    """The float64 reference flags a target by its own index alone: grid
    nodes sit on cell boundaries and are all flagged; off them, the
    device's float32 cell must equal the reference's on every slot."""
    import numpy as np

    from radarml_tpu.core.arena import DEFAULT_ARENA as a

    if where == "grid_nodes":
        i, j, k = np.meshgrid(np.arange(0, 22, 3), np.arange(0, 31, 5),
                              np.arange(0, 176, 25), indexing="ij")
        xyz = np.stack(a.grid_to_cartesian_np(i.ravel(), j.ravel(),
                                              k.ravel()), -1)
        ijk, near = chip_smoke.reference_indices(xyz)
        assert near.all()
        return
    _, xyz, _ = chip_smoke.scan_batch(4, 4)
    ijk, near = chip_smoke.reference_indices(xyz)
    assert ijk.shape == (4, 4, 3) and near.shape == (4, 4)
    assert near.mean() <= 0.25
    dev = np.stack(a.clamped_matrix_indices(*np.moveaxis(xyz, -1, 0)), -1)
    np.testing.assert_array_equal(np.asarray(dev)[~near], ijk[~near])


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """Trained artifacts plus interpret-mode apps for the rehearsal."""
    from radarml_tpu.apps import predict as predict_app
    from radarml_tpu.apps import serve as serve_app
    from radarml_tpu.models.pipeline import RadarPredictor

    out = str(tmp_path_factory.mktemp("chip_smoke"))
    with pytest.MonkeyPatch.context() as mp:
        for app in (predict_app, serve_app):
            mp.setattr(app, "RadarPredictor",
                       functools.partial(RadarPredictor, interpret=True))
        paths = chip_smoke.phase_train(out, n_samples=60)
        preds, data = chip_smoke.phase_predict(
            paths, out, batch=4, targets=4, ref_scans=2, interpret=True
        )
        yield out, paths, preds, data, mp


def test_phase_predict_rehearsed(rehearsal, capsys):
    out, paths, preds, data, _ = rehearsal
    cubes, xyz, valid = data
    assert cubes.shape == (4, 22, 31, 176) and xyz.shape == (4, 4, 3)
    assert set(preds) == {"exact", "fast", "fast_i8", "fused"}
    assert preds["fused"].interpret and preds["fused"].cube_dtype == "int8"
    assert os.path.exists(os.path.join(out, "predict_fused_int8.log"))


def test_phase_kernel_rehearsed(rehearsal, capsys):
    _, _, preds, data, _ = rehearsal
    chip_smoke.phase_kernel(preds, data, calls=2, interpret=True)
    text = capsys.readouterr().out
    assert "== int64 numpy oracle exactly" in text
    assert "time fused at 4x4" in text and "time fast_i8 at 4x4" in text
    assert "memory_analysis(fused step)" in text


def test_phase_serve_rehearsed(rehearsal, capsys):
    out, paths, _, data, _ = rehearsal
    chip_smoke.phase_serve(paths, out, data, seconds=1.5, max_batch=4,
                           interpret=True)
    text = capsys.readouterr().out
    assert "scans answered" in text
    assert "decisions on 4 scans equal the live predictor's" in text
    assert os.path.exists(os.path.join(out, "serving.rmlx"))
