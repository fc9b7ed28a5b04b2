"""plonky_tpu_torch stands alone: importing every one of its modules loads
neither JAX nor the JAX package, and an entry point called without
device="cpu" on a machine without CUDA raises instead of running on the
CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import plonky_tpu_torch
names = [m.name for m in pkgutil.walk_packages(plonky_tpu_torch.__path__,
                                               "plonky_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "plonky_tpu"
             or m.startswith("plonky_tpu."))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 46          # every module of the package was imported
    assert bad == "[]"


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from plonky_tpu_torch.circuit import CircuitBuilder
    from plonky_tpu_torch.curves import TWEEDLEDEE
    from plonky_tpu_torch.curves import ops as cops
    from plonky_tpu_torch.fields import ops as fops
    from plonky_tpu_torch.poly import fft as pfft
    from plonky_tpu_torch.protocol import verify_proof
    spec = TWEEDLEDEE.scalar
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fops.from_ints(spec, [1, 2, 3])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cops.identity(TWEEDLEDEE, (4,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pfft.four_step_twiddles(spec, 1 << 6, 3)
    builder = CircuitBuilder(TWEEDLEDEE, security_bits=128)
    builder.assert_zero(builder.sub(builder.one_wire(), builder.one_wire()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        builder.build()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify_proof([], None, [], None, None, verify_g=True)
    # asked for the CPU, the same calls run
    assert fops.to_ints(spec, fops.from_ints(spec, [5], "cpu")).tolist() == [5]
