"""chip_smoke.py: refuses to run without a GPU, and its phases work end to end at
``config_tiny_test`` size on the CPU (the card runs them at full 1B width)."""

import dataclasses
import json
import os
from pathlib import Path
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = Path(cs.__file__).resolve().parent


def _run(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(proc) -> bool:
    return proc.returncode != 0 and '"ok": true' not in proc.stdout


def test_refuses_without_gpu():
    proc = _run(REPO / "chip_smoke.py", REPO)
    assert _no_result(proc), proc.stdout
    assert "no GPU" in proc.stderr


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert _no_result(proc), proc.stdout


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    work = tmp_path_factory.mktemp("chip_smoke")
    old = cs.WORK
    cs.WORK = work
    yield work, cs.phase_assets(work, cs.TINY)
    cs.WORK = old


@pytest.fixture(scope="module")
def trained(assets):
    work, paths = assets
    losses, step_dir = cs.phase_train(paths, cs.TINY, work)
    return losses, step_dir


def test_assets_extend_the_base(assets):
    _work, paths = assets
    config = json.loads((paths["ext"] / "config.json").read_text())
    from ssi_jax.models.configs import config_tiny_test

    assert config["vocab_size"] == config_tiny_test.base_vocab_size_txt + config_tiny_test.n_special_txt + 16 + 2
    assert (paths["data"] / "train.jsonl").is_file()


def test_kernel_parity_phase_interpret():
    cs.phase_kernel_parity(cs.TINY, interpret=True)


def test_logits_parity_phase(assets):
    _work, paths = assets
    cs.phase_logits_parity(paths, cs.TINY)


def test_train_phase(trained):
    losses, step_dir = trained
    assert len(losses) == cs.TINY.train_steps and losses[-1] < losses[0]
    assert step_dir.is_dir()


def test_resume_phase_bitwise(assets):
    work, paths = assets
    assert cs.phase_resume(paths, cs.TINY, work)


def test_serve_phase(trained):
    cs.phase_serve(trained[1], cs.TINY)


# the four-card phases on the 8 virtual CPU devices (tests/conftest.py)
FOUR = dataclasses.replace(cs.TINY, micro_batch=4, seq_len=64, slots=4)


def test_fsdp_step_phase_on_virtual_devices():
    cs.phase_fsdp_step_vs_one_card(FOUR)


def test_tp_decode_phase_on_virtual_devices():
    cs.phase_tp_decode_vs_one_card(FOUR)


def test_fsdp_train_phase_on_virtual_devices():
    cs.phase_8b_fsdp_train("tiny_test", batch=8, seq=64, lr=1e-3)
