"""The parts of chip_smoke.py and the compile-cache path that run without a
GPU: the device check must refuse the CPU, and the cache directory must
follow JAX_COMPILATION_CACHE_DIR or fall back to the fixed in-repo path."""

import os

import jax
import pytest

import chip_smoke
from dpgo_tpu.utils import REPO_ROOT, compile_cache_dir


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu(jax)


def test_main_fails_on_cpu_without_a_result_line(capsys):
    with pytest.raises(RuntimeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize(
    "environ, expected",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/cache/elsewhere"}, "/cache/elsewhere"),
        ({}, os.path.join(REPO_ROOT, ".jax_cache")),
    ],
)
def test_compile_cache_dir(environ, expected):
    assert compile_cache_dir(environ) == expected


def test_repo_root_is_the_checkout():
    assert os.path.isfile(os.path.join(REPO_ROOT, "chip_smoke.py"))
