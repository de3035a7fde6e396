"""The check that no JAX was loaded compares top-level names whole: the
program, lanemapping_tpu_torch, begins with the JAX package's name and
passes."""

import subprocess
import sys

from conftest import ROOT


def test_forbidden_names_are_compared_whole():
    from lanebench.core import forbidden_modules
    loaded = ["lanemapping_tpu_torch", "lanemapping_tpu_torch.models.nets",
              "jaxtyping", "jax_utils", "flaxen", "lanemapping_tpu_extra",
              "lanemapping_tpu", "lanemapping_tpu.models", "jax.numpy",
              "jaxlib", "flax.linen", "numpy"]
    assert forbidden_modules(loaded) == [
        "flax.linen", "jax.numpy", "jaxlib", "lanemapping_tpu",
        "lanemapping_tpu.models"]
    assert forbidden_modules(["lanemapping_tpu_torch"]) == []


def test_the_harness_and_the_program_load_no_jax():
    """Importing every module a run imports, the program's included,
    loads no forbidden module (in a fresh interpreter)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from lanebench import core, inputs, reference, flops, weights, "
        "precision, binning, control\n"
        "from lanebench.plain import build_model\n"
        "import lanemapping_tpu_torch.tools.stream_map, "
        "lanemapping_tpu_torch.engine.state, "
        "lanemapping_tpu_torch.data.las_tiles, "
        "lanemapping_tpu_torch.data.laserlane\n"
        "import os\n"
        "for d in ('serve', 'train'):\n"
        "    core.load_file_module(os.path.join(core.HERE, 'loops', d + "
        "'.py'), 'd_' + d)\n"
        "print(core.forbidden_modules(list(sys.modules)))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_plain_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import json\n"
            "from lanebench import reference, flops\n"
            "from lanebench.plain import build_model\n"
            "from lanebench.plain.decode import postprocess, lane_decode\n"
            "from lanebench.plain.models import head_losses\n"
            "print(sorted({m.split('.')[0] for m in sys.modules "
            "if m.startswith('lanemapping')}))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
