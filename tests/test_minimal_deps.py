"""The main path runs with JAX, numpy, scipy and optax alone.

Each app runs in a subprocess whose import system refuses flax, orbax,
grpc, protobuf, matplotlib and flatbuffers — the packages a GPU host
need not have (pyproject's optional extras).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("flax", "orbax", "grpc", "google", "matplotlib", "flatbuffers")

_PRELUDE = textwrap.dedent(f"""
    import importlib.abc, json, sys

    class _Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in {BLOCKED!r}:
                raise ImportError(f"{{name}} is not installed")

    sys.meta_path.insert(0, _Refuse())
    sys.path.insert(0, {ROOT!r})
""")


def _run(code: str, cwd) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _PRELUDE + textwrap.dedent(code)],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("mindeps")
    out = _run("""
        from radarml_tpu.apps import train
        res = train.main(["--synthetic", "45", "--datasets", "ds.pickle",
                          "--grid_epochs", "3", "--folds", "2",
                          "--svm_cm", ""])
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("flax", "matplotlib"))
        print(json.dumps({"acc": float(res["metrics"]["accuracy"]),
                          "loaded": loaded}))
    """, d)
    return d, out


def test_train_app_without_optional_packages(trained):
    d, out = trained
    assert 0.0 <= out["acc"] <= 1.0 and out["loaded"] == []
    assert (d / "train-results" / "svm_radar_classifier.pickle").exists()
    assert not (d / "train-results" / "svm_cm.png").exists()


def test_predict_app_without_optional_packages(trained):
    d, _ = trained
    out = _run("""
        from radarml_tpu.apps import predict
        res = predict.main(["--num_scans", "4", "--batch_scans", "2",
                            "--mode", "fast", "--cube_dtype", "int8",
                            "--min_proba", "0.0"])
        print(json.dumps({"n": len(res)}))
    """, d)
    assert out["n"] > 0


def test_serve_app_without_optional_packages(trained):
    d, _ = trained
    out = _run("""
        from radarml_tpu.apps import serve
        serve.main(["--export_serving", "art.rmlx", "--cube_dtype", "int8"])
        st = serve.main(["--serving_artifact", "art.rmlx", "--duration",
                         "1.5", "--max_batch", "4", "--min_proba", "0.0"])
        print(json.dumps({"processed": st["processed"]}))
    """, d)
    assert out["processed"] > 0


def test_neural_apps_name_flax_when_missing():
    """dnn/sgan fail at import with an ImportError that names flax."""
    code = """
        try:
            import radarml_tpu.apps.sgan
        except ImportError as e:
            print(json.dumps({"msg": str(e)}))
    """
    out = _run(code, ROOT)
    assert "flax" in out["msg"] and "radarml-sgan" in out["msg"]
