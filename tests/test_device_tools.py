"""Scripts that run on the card refuse the CPU; the compile cache follows
JAX_COMPILATION_CACHE_DIR; the native library builds once under a lock."""
import concurrent.futures
import ctypes
import os
import shutil
import subprocess
import sys

import pytest

from gr_ieee80211.runtime import native as NAT
from gr_ieee80211.utils import device as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_follows_environment():
    assert D.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) \
        == "/x/cache"
    assert D.compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_setup_compile_cache_sets_no_other_directory(env_dir, tmp_path):
    """With the variable set, JAX's own reading of it stands; without it
    the fixed <repo>/.jax_cache is configured."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax; from gr_ieee80211.utils import device as D; "
            "D.setup_compile_cache(); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_card_scripts_refuse_the_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_native_build_is_serialized(tmp_path):
    """Racing builders (the test workers all load the library at import)
    produce one loadable library and leave no temporary files behind."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    shutil.copy(os.path.join(REPO, "native", "phyrt.cpp"), tmp_path)
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        paths = list(ex.map(lambda _: NAT.build(str(tmp_path)), range(4)))
    assert set(paths) == {str(tmp_path / "libphyrt.so")}
    lib = ctypes.CDLL(paths[0])
    lib.phyrt_crc32.restype = ctypes.c_uint32
    lib.phyrt_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    assert lib.phyrt_crc32(b"123456789", 9) == 0xCBF43926
    assert os.listdir(tmp_path / ".build") == ["lock"]
