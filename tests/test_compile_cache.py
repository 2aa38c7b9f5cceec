"""The compile-cache rule shared by every entry point: an exported
JAX_COMPILATION_CACHE_DIR wins and code sets nothing; otherwise the cache
sits at a fixed path inside the checkout."""

import os
import subprocess
import sys

import pytest

from han_jax.utils.cache import CHECKOUT, compile_cache_dir

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_variable_set_is_used_and_not_overridden():
    path, must_set = compile_cache_dir(environ={
        "JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"})
    assert (path, must_set) == ("/elsewhere/cache", False)


@pytest.mark.parametrize("name", [".jax_cache", ".jax_cache_cpu"])
def test_variable_unset_gives_fixed_checkout_path(name):
    path, must_set = compile_cache_dir(name, environ={})
    assert must_set and path == str(CHECKOUT / name)
    assert CHECKOUT == __import__("pathlib").Path(_ROOT).resolve()


@pytest.mark.parametrize("exported", [True, False])
def test_setup_applies_the_rule_in_a_fresh_process(tmp_path, exported):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if exported:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "exported")
    code = ("import jax; from han_jax.utils.cache import setup_compile_cache; "
            "print(setup_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    returned, configured = out.stdout.split()
    want = str(tmp_path / "exported") if exported else str(CHECKOUT / ".jax_cache")
    assert returned == configured == want
