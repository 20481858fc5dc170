"""The port's copy of the Venn layout (``saguaro_tpu_torch.plots.venn``):
the same geometry as the reference's on subset, equal, disjoint and partial
sets, the same texts drawn, and no matplotlib import until a diagram is
drawn."""

import subprocess
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import pytest  # noqa: E402

from saguaro_tpu.plots import venn as ref  # noqa: E402
from saguaro_tpu_torch.plots import venn as port  # noqa: E402

from .torch_data import share_cpu_threads  # noqa: E402

share_cpu_threads()

SETS = [
    (set(range(100)), set(range(30))),      # subset
    (set(range(50)), set(range(50))),       # equal
    (set(range(40)), set(range(40, 90))),   # disjoint
    (set(range(60)), set(range(40, 120))),  # partial
    (set(), set()),
]


@pytest.mark.parametrize("a,b", SETS)
def test_layout_and_texts_match_reference(a, b):
    assert port.solve_venn2_layout(len(a), len(b), len(a & b)) == ref.solve_venn2_layout(
        len(a), len(b), len(a & b))
    texts = []
    for mod in (port, ref):
        fig, ax = plt.subplots()
        mod.venn2([a, b], set_labels=("All", "Bioactive"), ax=ax)
        texts.append(sorted((t.get_text(), t.get_position()) for t in ax.texts))
        plt.close(fig)
    assert texts[0] == texts[1]


def test_layout_needs_no_matplotlib():
    code = ("import sys\nfrom saguaro_tpu_torch.plots.venn import solve_venn2_layout\n"
            "solve_venn2_layout(120, 80, 25)\nsys.exit('matplotlib' in sys.modules)\n")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0
