"""chip_smoke.py: refuses to run without a GPU or outside a checkout, and
its phases (rehearsed here at tiny sizes on the CPU, kernel in interpret
mode) pass their own checks against the fp64 reference."""
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except ValueError:
            continue
    return False


def test_refuses_without_gpu():
    r = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert not _printed_result(r.stdout)


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert not _printed_result(r.stdout)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SIZES", {
        "dna": (10, 200), "aa": (8, 96), "repeats": (14, 300),
        "placement": (10, 120, 2),
        "sharded": (12, 256), "sharded_repeats": (12, 320)})
    monkeypatch.setattr(chip_smoke, "ENGINE_KW", {"pallas": "interpret"})


@pytest.mark.parametrize("kind", ["dna", "aa", "repeats"])
def test_engine_phase_rehearsal(tiny, kind):
    states = 20 if kind == "aa" else 4
    rep, reference = chip_smoke.engine_phase(
        kind, states, *chip_smoke.SIZES[kind],
        conserved=kind == "repeats", repeats=kind == "repeats")
    assert chip_smoke.check(rep, reference()), rep


def test_placement_phase_rehearsal(tiny):
    rep, reference = chip_smoke.placement_phase()
    assert rep["execution_path"] == "fused"
    assert chip_smoke.check(rep, reference()), rep


def test_check_flags_a_wrong_value(tiny):
    rep, reference = chip_smoke.engine_phase("dna", 4,
                                             *chip_smoke.SIZES["dna"])
    ref = reference()
    rep["values"] = (rep["values"][0] * (1 + 1e-3),) + rep["values"][1:]
    assert not chip_smoke.check(rep, ref)


def test_sharded_phase_rehearsal(tiny):
    """The --chips 4 phase on four virtual CPU devices."""
    for rep, reference in chip_smoke.sharded_phase():
        assert chip_smoke.check(rep, reference()), rep
