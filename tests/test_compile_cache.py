"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR wins when set, else
<checkout>/.jax_cache derived from the package's own location."""

import os
import subprocess
import sys

from smarc_navigation_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_default_is_checkout_dot_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert compile_cache.CHECKOUT == REPO


def test_enable_sets_jax_config_in_fresh_process(tmp_path):
    """enable() points jax at the env var's directory and at no other."""
    code = ("import jax; from smarc_navigation_tpu import compile_cache; "
            "p = compile_cache.enable(); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path / "cc")] * 2


def test_no_hardcoded_checkout_path_in_code():
    """No program file names the checkout's absolute path (for the cache or
    anything else): every path derives from the files' own location."""
    offenders = []
    for root, _dirs, files in os.walk(REPO):
        if any(part.startswith(".") for part in root[len(REPO):].split(os.sep)):
            continue
        for f in files:
            if f.endswith((".py", ".cc", ".sh")):
                p = os.path.join(root, f)
                with open(p, encoding="utf-8", errors="replace") as fh:
                    if REPO in fh.read():
                        offenders.append(os.path.relpath(p, REPO))
    assert offenders == []
