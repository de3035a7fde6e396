"""The KLane RowRef cell's modules load no JAX, and its plain reference
imports nothing of the program (as `test_lanebench_nojax.py` holds for
the other cells' modules)."""

import subprocess
import sys

from conftest import ROOT


def _last_line(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_the_rows_cell_and_the_program_load_no_jax():
    code = ("import sys, os; sys.path.insert(0, %r)\n"
            "from lanebench import core, rows, reference_rows, control_rows\n"
            "import lanemapping_tpu_torch.engine.runner, "
            "lanemapping_tpu_torch.models.row_head\n"
            "core.load_file_module(os.path.join(core.HERE, 'loops', "
            "'train_rows.py'), 'd_train_rows')\n"
            "for m in ('head_host_ms.train', "
            "'lane_writebacks_per_step.train'):\n"
            "    core.reader(m)\n"
            "print(core.forbidden_modules(list(sys.modules)))\n" % ROOT)
    assert _last_line(code) == "[]"


def test_the_rows_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from lanebench import rows, reference_rows\n"
            "from lanebench.plain.models import row_head\n"
            "print(sorted({m.split('.')[0] for m in sys.modules "
            "if m.startswith('lanemapping')}))\n" % ROOT)
    assert _last_line(code) == "[]"
