"""Package-level rules of the PyTorch port: it imports neither JAX nor the
reference package (checked in a fresh interpreter, so this test process's
own JAX import cannot mask a leak), and importing it fixes full-f32
matmuls (TF32 off), the Hopper form of the reference's HIGHEST-precision
rule."""

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


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import qml_cutensornet_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib',"
        " 'qml_cutensornet_tpu'))\n"
        "assert not bad, bad\n"
        "from qml_cutensornet_tpu_torch.utils.device import full_f32_is_set\n"
        "assert full_f32_is_set()\n"
        "print('ok', len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
