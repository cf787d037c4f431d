"""What the harness and the reference load: no module whose whole top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``swem_tpu`` (``swem_tpu_torch`` is
another name), and the reference nothing of the port either."""

import json
import subprocess
import sys

from vosbench import harness

HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
import vosbench.run, vosbench.calibrate
from vosbench import harness
bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
for w in bench["workloads"]:
    cell = harness.load_cell(w["name"])
    harness.driver(cell)
    harness.model_config(cell)
for m in bench["per_layer"]:
    harness.reader(m["name"])
import swem_tpu_torch.engine, swem_tpu_torch.serve
import swem_tpu_torch.eval.evaluator
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import vosbench.reference.model, vosbench.reference.memory, vosbench.reference.engine
import vosbench.reference.lowp, vosbench.verdict
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, check=True, timeout=300)
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_harness_closure_holds_no_jax():
    tops = loaded(HARNESS)
    assert "swem_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_reference_imports_neither_jax_nor_the_port():
    tops = loaded(REFERENCE)
    assert not tops & (set(harness.FORBIDDEN) | {"swem_tpu_torch"})


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "swem_tpu_torch_like", sys)
    assert "swem_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
