"""The port's example twins (``python -m repro_torch.examples.<name>``) in a
subprocess on the CPU at reduced size: ``serve_llm`` drains its requests;
``train_lm`` resumed from a checkpoint ends with the uninterrupted run's
params, and trains the recurrent configs (rwkv6-7b, zamba2-7b) too;
``pipeline_parallel`` runs its four steps, the ranks over gloo; the DSE and
deployment twins (``quickstart``, ``resnet50_dse``, ``transformer_dse``,
``multi_tenant``, ``decode_serving``) print the JAX examples' lines on the
same arguments, each pair run side by side."""
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _env():
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC), *filter(None, [os.environ.get("PYTHONPATH")])])}


def _run(module, *args):
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{module}",
                          "--device", "cpu", *args], capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _run_twins(module, *args):
    """The port's twin and the JAX package's example on the same arguments,
    side by side; returns the twin's output after checking the two agree
    line for line. The twins touch no tensor and take no ``--device``."""
    cmds = {"torch": [sys.executable, "-m", f"repro_torch.examples.{module}", *args],
            "jax": [sys.executable, str(ROOT / "examples" / f"{module}.py"), *args]}
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=_env()) for k, cmd in cmds.items()}
    outs = {}
    for k, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{k}: {err[-2000:]}"
        outs[k] = out
    assert outs["torch"].splitlines() == outs["jax"].splitlines()
    return outs["torch"]


def test_serve_llm_drains_requests():
    out = _run("serve_llm", "--requests", "5", "--slots", "2", "--new-tokens", "4")
    assert "served 5 requests, 20 tokens" in out
    assert len(re.findall(r"req \d+: prompt \[.*\] -> \[\d+, \d+, \d+, \d+\]", out)) == 3


def test_train_lm_resumes_to_the_same_params(tmp_path):
    """6 steps straight, checkpoints at 3 and 6; then the same command in a
    directory holding only the step-3 checkpoint: it prints that it resumed
    and writes a step-6 checkpoint equal to the straight run's, file for
    file and byte for byte."""
    args = ["--steps", "6", "--ckpt-every", "3", "--seq-len", "16", "--batch", "4"]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    out = _run("train_lm", *args, "--ckpt-dir", str(straight))
    assert "resumed" not in out and "loss" in out
    resumed.mkdir()
    shutil.copytree(straight / "ckpt_0000000003", resumed / "ckpt_0000000003")
    out = _run("train_lm", *args, "--ckpt-dir", str(resumed))
    assert "resumed from step 3" in out
    want, got = straight / "ckpt_0000000006", resumed / "ckpt_0000000006"
    names = sorted(p.name for p in want.iterdir())
    assert names == sorted(p.name for p in got.iterdir()) and len(names) > 2
    for name in names:
        assert (want / name).read_bytes() == (got / name).read_bytes(), name


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_train_lm_trains_recurrent_archs(tmp_path, arch):
    """``--arch`` takes the rwkv and the hybrid mamba config: the reduced
    model trains, with finite losses, and checkpoints."""
    out = _run("train_lm", "--arch", arch, "--steps", "4", "--ckpt-every", "4",
               "--seq-len", "16", "--batch", "2", "--ckpt-dir", str(tmp_path))
    assert f"training {arch}" in out
    losses = map(float, re.search(r"loss (\S+) -> (\S+)", out).groups())
    assert all(math.isfinite(x) for x in losses)
    assert (tmp_path / "ckpt_0000000004").is_dir()


def test_pipeline_parallel_runs_its_four_steps():
    """Plan, the simulator check, 4 ranks over gloo against the plain forward
    (2e-3, the JAX pipeline's own tolerance), and the strategy switch."""
    out = _run("pipeline_parallel")
    assert "plan: 4 stages x 1 layers" in out and "WAIT_REQ" in out
    assert out.count("deadlock=False") == 3 and "deadlock=True" not in out
    err = float(re.search(r"max \|delta\| vs plain forward = (\S+);", out).group(1))
    assert err <= 2e-3
    sent, simulated = map(int, re.search(r"(\d+) REQ/ACK messages sent \(the simulator's "
                                         r"(\d+)\)", out).groups())
    assert sent == simulated == 30
    assert "stages= 8 dp=  1" in out and "v5e" not in out


def test_quickstart_twin_prints_the_jax_lines():
    out = _run_twins("quickstart", "--pu1x", "2", "--pu2x", "3")
    assert "deadlock=False" in out and "first stage LD program:" in out


@pytest.mark.parametrize("sim", [False, True], ids=["no_sim", "sim"])
def test_resnet50_dse_twin_prints_the_jax_lines(sim):
    out = _run_twins("resnet50_dse", *([] if sim else ["--no-sim"]))
    assert "step 1: 35 single-batch configurations" in out
    assert ("runtime strategy switching" in out) == sim
    if sim:
        errs = [float(e) for e in re.findall(r"\( *(\S+)% off", out)]
        assert len(errs) == 2 and max(errs) < 10.0
        assert out.count("deadlock=False") == 2


def test_transformer_dse_twin_prints_the_jax_lines():
    out = _run_twins("transformer_dse", "--model", "qwen3", "--depth", "2")
    assert out.count("deadlock=False") == 2


def test_multi_tenant_twin_prints_the_jax_lines():
    out = _run_twins("multi_tenant", "--small", "--rounds", "4")
    assert "switched to two-tenant split" in out and out.count("deadlock=False") == 2


def test_decode_serving_twin_prints_the_jax_lines():
    out = _run_twins("decode_serving", "--small")
    assert "switched back to prefill" in out and "deadlock=True" not in out
