"""Whole top-level names: the port passes, JAX and the JAX package fail;
the references import nothing of the port; the port must come from the
checkout."""

import shutil
import subprocess
import sys

import pytest

import nfftbench_helpers as h
from nfftb import guard


@pytest.mark.parametrize("name", ["torch_nfft_tpu_torch", "torch_nfft_tpu_torch.ops.binned",
                                  "torch_nfft_tpu_torchx", "jaxtyping", "nfftb.guard"])
def test_allowed(name):
    assert guard.banned_modules([name]) == []


@pytest.mark.parametrize("name", ["torch_nfft_tpu", "torch_nfft_tpu.ops.pallas", "jax",
                                  "jax.numpy", "jaxlib.xla_client", "flax"])
def test_banned(name):
    assert guard.banned_modules([name]) == [name]


def _modules_after(code: str) -> list:
    prog = (f"import sys; sys.path[:0] = [{str(h.BENCH)!r}, {str(h.ROOT)!r}]\n{code}\n"
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.split()


def test_harness_and_port_load_no_jax():
    mods = _modules_after(
        "from nfftb import cli, core, spec, guard\n"
        "guard.import_program(spec.checkout_root())\n"
        "for kind, name in [('systems', 'gram'), ('systems', 'pair'),"
        " ('references', 'gauss_sum'), ('references', 'dirichlet_pair')]:\n"
        "    spec.module(spec.BENCH_DIR, kind, name)\n"
        "import pathlib\n"
        "for p in (spec.BENCH_DIR / 'metrics').glob('*.py'):\n"
        "    spec.module(spec.BENCH_DIR, 'metrics', p.stem)")
    assert "torch_nfft_tpu_torch" in mods
    assert guard.banned_modules(mods) == []


@pytest.mark.parametrize("name", ["gauss_sum", "dirichlet_pair"])
def test_references_import_nothing_of_the_port(name):
    mods = _modules_after(f"from nfftb import spec\nspec.module(spec.BENCH_DIR, "
                          f"'references', {name!r})")
    assert not [m for m in mods if m.split(".")[0] == guard.PROGRAM]


def test_the_port_must_be_in_the_checkout(tmp_path):
    shutil.copytree(h.BENCH, tmp_path / "nfft_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(h.ROOT / "BENCHMARK.json", tmp_path)
    with pytest.raises(ImportError):
        guard.import_program(tmp_path)
