"""Process setup: where the compile cache lands, and the device memory
budget that capacity planning reads."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from dsm_tpu.mining import engine
from dsm_tpu.utils import jaxsetup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["env", "checkout", "installed"])
def test_cache_dir(tmp_path, monkeypatch, where):
    if where == "env":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert jaxsetup.cache_dir() == str(tmp_path)
    elif where == "checkout":
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert jaxsetup.CHECKOUT_CACHE == os.path.join(REPO, ".cache")
        assert jaxsetup.cache_dir() == os.path.join(REPO, ".cache", "jax")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".cache/" in f.read().split()
    else:
        # a copy outside a checkout (site-packages) keeps no cache
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jaxsetup, "CHECKOUT_CACHE", None)
        assert jaxsetup.cache_dir() is None


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "checkout"])
def test_setup_jax_sets_cache(tmp_path, env_dir):
    """In a fresh process, setup_jax points JAX's persistent cache at
    cache_dir() (and creates it)."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    want = os.path.join(REPO, ".cache", "jax")
    if env_dir:
        want = str(tmp_path / "jaxcache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax; from dsm_tpu.utils.jaxsetup import setup_jax; "
            "setup_jax(); print(jax.config.jax_compilation_cache_dir)")
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-500:]
    assert p.stdout.strip().splitlines()[-1] == want
    assert os.path.isdir(want)


@pytest.mark.parametrize("where", ["env", "checkout"])
def test_setup_jax_unwritable_cache(tmp_path, where):
    """A cache directory that cannot be created (its parent is a file)
    leaves the cache off; setup_jax and compiling still work."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    blocked = str(blocker / "jax")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    code = ("import jax, jax.numpy as jnp; "
            "from dsm_tpu.utils import jaxsetup; ")
    if where == "env":
        env["JAX_COMPILATION_CACHE_DIR"] = blocked
    else:
        code += f"jaxsetup.CHECKOUT_CACHE = {str(blocker)!r}; "
    code += ("jaxsetup.setup_jax(); "
             "print(int(jax.jit(lambda x: x * 2)(jnp.int32(21)))); "
             "print(jax.config.jax_compilation_cache_dir)")
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-500:]
    assert "dsm: no compilation cache" in p.stderr
    out = p.stdout.strip().splitlines()
    assert out[-2] == "42"
    if where == "checkout":
        assert out[-1] == "None"


@pytest.mark.parametrize("where", ["unwritable", "installed"])
def test_native_codec_without_cache(tmp_path, monkeypatch, where):
    """No writable checkout cache: the native codec is not built and the
    pure-Python parser takes its place."""
    from dsm_tpu.net import native, wire

    if where == "unwritable":
        blocker = tmp_path / "file"
        blocker.write_text("")
        monkeypatch.setattr(jaxsetup, "CHECKOUT_CACHE", str(blocker))
    else:
        monkeypatch.setattr(jaxsetup, "CHECKOUT_CACHE", None)
    assert native._build() is None
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    assert isinstance(native.make_parser(), wire.TrieParser)
    assert native.native_encode(np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                                np.zeros(0, np.uint64)) is None


def _fake_devices(monkeypatch, platform, stats):
    import jax

    dev = SimpleNamespace(platform=platform, device_kind="Fake Accel",
                          memory_stats=lambda: stats)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev])


@pytest.mark.parametrize("case", ["no_stats", "empty_stats", "limit", "cpu",
                                  "env"])
def test_hbm_budget(monkeypatch, case):
    monkeypatch.delenv("DSM_HBM_BYTES", raising=False)
    if case == "no_stats":
        _fake_devices(monkeypatch, "gpu", None)
        with pytest.raises(RuntimeError, match="reports no memory limit"):
            engine.hbm_budget()
    elif case == "empty_stats":
        _fake_devices(monkeypatch, "gpu", {"bytes_in_use": 5})
        with pytest.raises(RuntimeError, match="DSM_HBM_BYTES"):
            engine.hbm_budget()
    elif case == "limit":
        _fake_devices(monkeypatch, "gpu", {"bytes_limit": 1000})
        assert engine.hbm_budget() == 900
    elif case == "cpu":
        _fake_devices(monkeypatch, "cpu", None)
        assert engine.hbm_budget() == 1 << 62
    else:
        _fake_devices(monkeypatch, "gpu", None)
        monkeypatch.setenv("DSM_HBM_BYTES", "12345")
        assert engine.hbm_budget() == 12345


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        jaxsetup.require_gpu()
