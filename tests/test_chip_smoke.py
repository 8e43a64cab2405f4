"""chip_smoke.py's phases at toy scale on the CPU, and its refusal to
report anything without a GPU.

The phases are the same functions the GPU run calls, driving the `dsm`
CLI in-process and comparing with the NumPy oracle and the frozen
reference goldens; only the scales, and the suffix sort that `dsm build`
picks on a CPU-only host, differ.
"""

import gzip
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def golden_scale1_gnu() -> tuple[str, None]:
    """Digest of the reference servers' scale-1 default-config output
    (the frozen goldens); the path count is not frozen at this scale."""
    blob = b""
    for p in "ACGT":
        with gzip.open(os.path.join(
                cs.GOLDEN, f"server-output.default.{p}.txt.gz")) as f:
            blob += f.read()
    return hashlib.sha256(blob).hexdigest(), None


@pytest.fixture
def work(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "WORK", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("phase", ["oracle", "main", "large", "four"])
def test_phase_on_cpu(work, phase):
    import jax

    if phase == "oracle":
        res = cs.phase_oracle(scale=1, expect_sa="numpy")
        assert set(res["checks"]) == {f"{c}.{o}.lines" for c in cs.CONFIGS
                                      for o in ("ascending", "gnu")}
    elif phase == "main":
        res = cs.phase_main(scale=1, want=golden_scale1_gnu(),
                            expect_sa="numpy")
        assert res["checks"]["lines"] > 0
    elif phase == "large":
        res = cs.phase_large(scale=1, expect_sa="numpy")
        assert res["checks"]["paths"] > 0
    else:
        n = len(jax.devices())
        res = cs.phase_four(n, scale=1, small_scale=1,
                            want=golden_scale1_gnu(), expect_sa="numpy")
        assert len(res["checks"]["episode_table_shards"]) == n
    assert all(t >= 0 for t in res["times_s"].values())


def test_phase_detects_wrong_output(work):
    with pytest.raises(cs.SmokeFailure, match="sha256"):
        cs.phase_main(scale=1, want=("0" * 64, None), expect_sa="numpy")


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in ("DSM_TEST_GPU", "PYTHONPATH"):
        env.pop(k, None)
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_no_result(p):
    assert p.returncode != 0
    lines = p.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except ValueError:
            return
        assert not (isinstance(last, dict) and last.get("ok"))


def test_script_fails_without_gpu():
    _assert_no_result(_run_script(os.path.join(REPO, "chip_smoke.py"), REPO))


def test_script_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _assert_no_result(_run_script(str(tmp_path / "chip_smoke.py"),
                                  str(tmp_path)))
