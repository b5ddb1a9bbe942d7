"""Device honesty (GPU required, card name and power limit reported) and
the persistent compilation cache location."""

import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from hyperres.utils import compile_cache  # noqa: E402
from hyperres.utils.device import parse_gpu_query, require_gpu  # noqa: E402


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of changing this process's
    configuration."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_compile_cache_honours_env_dir(monkeypatch, tmp_path,
                                       config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    monkeypatch.delenv("HYPERRES_COMPILE_CACHE", raising=False)
    d = compile_cache.enable_compilation_cache()
    assert d == tmp_path / "c"
    # JAX reads the variable itself: no directory is set in code
    assert "jax_compilation_cache_dir" not in config_updates
    assert config_updates["jax_persistent_cache_min_compile_time_secs"] \
        == 0.0


def test_compile_cache_defaults_to_checkout(monkeypatch, config_updates,
                                            repo_root):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("HYPERRES_COMPILE_CACHE", raising=False)
    d = compile_cache.enable_compilation_cache()
    assert d == repo_root / ".jaxcache"
    assert config_updates["jax_compilation_cache_dir"] == str(d)
    assert d.is_dir()


def test_compile_cache_can_be_disabled(monkeypatch, config_updates):
    monkeypatch.setenv("HYPERRES_COMPILE_CACHE", "0")
    assert compile_cache.enable_compilation_cache() is None
    assert config_updates == {}


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu(jax.devices())


def test_chip_smoke_refuses_cpu(capsys):
    """Off a GPU the smoke test exits non-zero before any phase and
    prints no result line."""
    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out
    assert "no GPU" in err


def test_bench_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()


@pytest.mark.parametrize("text, want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", 700.0)]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
     [("NVIDIA H100 80GB HBM3", 500.0), ("NVIDIA H100 80GB HBM3", 700.0)]),
    ("NVIDIA H100 PCIe, [N/A]\n", [("NVIDIA H100 PCIe", None)]),
])
def test_parse_gpu_query(text, want):
    assert parse_gpu_query(text) == want


def test_parse_gpu_query_rejects_garbage():
    with pytest.raises(ValueError):
        parse_gpu_query("no comma here")


@pytest.mark.parametrize("acc, ok", [
    ((0.7, 0.95, 48.3, 33.2, 0.006), True),
    ((0.7, 0.95, 44.0, 33.2, 0.006), False),    # pipeline PSNR
    ((0.7, 0.95, 48.3, 33.2, 0.02), False),     # SAM
    ((0.7, 0.95, 48.3, 20.0, 0.006), False),    # method PSNR
    ((0.2, 0.95, 48.3, 33.2, 0.006), False),    # finite fraction
])
def test_bench_accuracy_gates(acc, ok):
    assert bench.gates_pass(acc, bench.accuracy_gates()) is ok
