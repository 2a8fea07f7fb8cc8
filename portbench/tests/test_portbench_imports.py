"""Nothing the benchmark loads is JAX or the JAX package (compared by whole
top-level module name), and the reference loads nothing of the program."""
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh process holds after
    ``code``."""
    probe = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
             f"{str(ROOT / 'src')!r}]\n{code}\n"
             "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    names = _loaded("from portbench import bench, drive, devtrace, run, "
                    "roofline, verdict, control, sweep\nimport repro_torch\n"
                    "b = bench.find()\n"
                    "[b.reader(m['name']) for m in b.spec['end_to_end'] + "
                    "b.spec['per_layer']]\nb.counts()")
    assert "repro_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded("from portbench.reference import generator, product\n"
                    "from portbench import verdict, operands")
    assert not names & (FORBIDDEN | {"repro_torch"})


def test_the_check_names_modules_by_their_whole_top_level_name():
    from portbench import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.core",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy", "flax",
                                  "torch"]) == ["flax", "jax", "repro"]
