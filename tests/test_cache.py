"""The persistent compilation cache lives where JAX_COMPILATION_CACHE_DIR
says, else at the fixed <checkout>/.jax_cache."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(code: str, env_extra: dict, drop=()) -> str:
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_cache_honours_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, entries land there and the
    code sets no other directory."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from naruto_tpu.utils.cache import enable_compilation_cache\n"
        "d = enable_compilation_cache()\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0 + x)(jnp.ones(7)).block_until_ready()\n"
        "print(d, jax.config.jax_compilation_cache_dir)\n")
    last = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert last.split() == [str(tmp_path), str(tmp_path)]
    assert any(tmp_path.iterdir()), "no cache entry was written"


def test_cache_default_is_checkout_dir():
    """Unset, the cache sits at the fixed in-checkout .jax_cache."""
    code = (
        "import jax\n"
        "from naruto_tpu.utils.cache import enable_compilation_cache\n"
        "d = enable_compilation_cache()\n"
        "print(d, jax.config.jax_compilation_cache_dir)\n")
    last = _run(code, {}, drop=("JAX_COMPILATION_CACHE_DIR",))
    want = str(ROOT / ".jax_cache")
    assert last.split() == [want, want]
