"""Nothing the benchmark imports is JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import json
import subprocess
import sys

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tdax"}

PROBE = """
import importlib, json, pkgutil, sys
import benchmark
names = [m.name for m in pkgutil.walk_packages(benchmark.__path__, "benchmark.")
         if ".tests" not in m.name and not m.name.endswith(".tests")]
for n in names:
    importlib.import_module(n)
print(json.dumps({"modules": names, "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""

REFERENCE = """
import importlib, json, pkgutil, sys
import benchmark.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_benchmark_loads_no_jax():
    found = _run(PROBE)
    assert "benchmark.run" in found["modules"] and "benchmark.jobs.train" in found["modules"]
    assert not FORBIDDEN & set(found["top"])


def test_a_whole_run_loads_no_jax():
    code = ("import json, sys\nfrom benchmark.rehearse import rehearse\n"
            "rehearse('qwen-vl-chat.finetune-text', seed=1, units=1)\n"
            "rehearse('qwen-vl-chat-int8.capture', seed=1, units=1)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not FORBIDDEN & set(_run(code))


def test_reference_loads_nothing_of_the_program():
    top = set(_run(REFERENCE))
    assert "tdax_torch" not in top and not FORBIDDEN & top
