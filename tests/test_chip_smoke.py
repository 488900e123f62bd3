"""chip_smoke.py: what can be checked without a GPU — the device gate,
the nvidia-smi parser, the contract line and the phase selection."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_parse_smi(smoke):
    text = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
            "NVIDIA H100 80GB HBM3, 500.00 W\n")
    assert smoke.parse_smi(text) == [("NVIDIA H100 80GB HBM3", "700.00 W"),
                                     ("NVIDIA H100 80GB HBM3", "500.00 W")]
    with pytest.raises(ValueError):
        smoke.parse_smi("")


def test_contract_line(smoke):
    line = smoke.contract_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_four_card_option_runs_only_sharded_phases(smoke):
    four = [p.key for p in smoke.phases_for(4)]
    one = [p.key for p in smoke.phases_for(1)]
    assert four == ["4a", "4b", "4c"]
    assert sorted(one) == sorted(["a", "b", "c", "d", "e", "f", "g", "h",
                                  "i"])
    # float64 phases come last: they switch jax_enable_x64 on
    assert one[-3:] == ["b", "c", "i"]
