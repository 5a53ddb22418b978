"""What the benchmark imports: no module under portbench/ names jax, jaxlib,
flax or the JAX package gan_tpu as its top-level import, compared whole (the
port's name, gan_tpu_torch, begins with gan_tpu), and the reference imports
nothing of the program either."""

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "gan_tpu"}


def imported_top_levels(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources(root: str):
    for d, _dirs, files in os.walk(root):
        if "cache" in os.path.relpath(d, BENCH).split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: imported_top_levels(p) & FORBIDDEN for p in sources(BENCH)}
    assert not {p: b for p, b in bad.items() if b}


def test_the_whole_name_is_compared():
    """gan_tpu_torch is the program, not the JAX package."""
    assert "gan_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "gan_tpu.ops".split(".")[0] in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    bad = {p: imported_top_levels(p) & (FORBIDDEN | {"gan_tpu_torch"})
           for p in sources(os.path.join(BENCH, "reference"))}
    assert not {p: b for p, b in bad.items() if b}


def test_a_run_loads_no_jax_module():
    """What the harness and the program load in one process (the run's own
    check after the window sees the same)."""
    code = ("import sys\n"
            "from portbench import harness, cells, checks, trace, corpus, faults, counts\n"
            "import gan_tpu_torch.train.pix2pix_trainer, gan_tpu_torch.train.cyclegan_trainer\n"
            "import gan_tpu_torch.data.loader, gan_tpu_torch.data.pipeline, gan_tpu_torch.ops.build\n"
            "print(harness.forbidden_modules())\n"
            "assert not harness.forbidden_modules()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_reference_loads_without_the_program():
    code = ("import sys\n"
            "from portbench.reference import nets, steps, png\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gan_tpu_torch', 'gan_tpu', 'jax', 'jaxlib', 'flax'})\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
