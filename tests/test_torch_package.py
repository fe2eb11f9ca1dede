"""Package-level rules of the PyTorch port: it imports neither JAX, the
reference package, scikit-learn nor pandas (checked in a fresh interpreter
over every module of the package, so this test process's own imports cannot
mask a leak; and on the syntax tree of ``chip_smoke.py``, whose imports sit
inside its functions), importing it builds no native library, and importing
it fixes full-f32 matmuls (TF32 off),
the Hopper form of the reference's HIGHEST-precision rule."""

import ast
import os
import pathlib
import subprocess
import sys

import torch

from qml_cutensornet_tpu_torch.utils import device as port_device

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_full_f32_matmul_flags_are_set():
    assert port_device.full_f32_is_set()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_imports_neither_jax_nor_reference(tmp_path):
    code = (
        "import importlib, pkgutil, sys\n"
        "import qml_cutensornet_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib',"
        " 'qml_cutensornet_tpu', 'sklearn', 'pandas'))\n"
        "assert not bad, bad\n"
        "names = {n for n in sys.modules if n.startswith(p.__name__)}\n"
        "for mod in ('cli.main', 'cli.classical_main', 'models.svm', 'ops.blocked_qr',"
        " 'ops.vidal', 'ops.dense', 'utils.autotune', 'cli.main_track_mem',"
        " 'cli.make_synthetic', 'parallel.mesh', 'parallel.gram', 'parallel.dryrun',"
        " 'parallel.sharded_mps', 'native', 'backends.cpu_native', 'utils.flops'):\n"
        "    assert p.__name__ + '.' + mod in names, mod\n"
        "import os\n"
        "from qml_cutensornet_tpu_torch import native\n"
        "assert native._LIB is None and not os.path.exists(os.environ['QMLTPU_NATIVE_CACHE'])\n"
        "from qml_cutensornet_tpu_torch.utils.device import full_f32_is_set\n"
        "assert full_f32_is_set()\n"
        "print('ok', len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["QMLTPU_NATIVE_CACHE"] = str(tmp_path / "native")  # importing builds nothing there
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_imports_only_the_port():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "qml_cutensornet_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "qml_cutensornet_tpu", "sklearn", "pandas"}, roots


def test_environ_sets_and_restores_knobs(monkeypatch):
    monkeypatch.setenv("QMLTPU_CHI", "64")
    monkeypatch.delenv("QMLTPU_FUSED_GATE", raising=False)
    try:
        with port_device.environ(QMLTPU_CHI="256", QMLTPU_FUSED_GATE="1"):
            assert os.environ["QMLTPU_CHI"] == "256" and os.environ["QMLTPU_FUSED_GATE"] == "1"
            raise KeyError("leaves the block by an exception")
    except KeyError:
        pass
    assert os.environ["QMLTPU_CHI"] == "64" and "QMLTPU_FUSED_GATE" not in os.environ
