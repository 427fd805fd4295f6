"""Run-time plumbing: compile-cache placement, the CLI's backend pin, the
native library build, and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

from libssa_tpu.util import jaxcache, nativebuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_calls(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    import jax

    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setattr(jaxcache, "_done", False)
    monkeypatch.delenv("LIBSSA_NO_COMPILE_CACHE", raising=False)
    return calls


def test_cache_dir_is_fixed_inside_checkout():
    assert jaxcache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert jaxcache.cache_dir() == jaxcache.cache_dir()


def test_cache_env_var_wins(monkeypatch, cache_calls, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it; code sets no dir."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jaxcache.enable_compilation_cache()
    assert "jax_compilation_cache_dir" not in cache_calls
    assert jaxcache._done


def test_cache_defaults_to_checkout_path(monkeypatch, cache_calls, tmp_path):
    import jax

    target = str(tmp_path / "cache")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jaxcache, "cache_dir", lambda: target)
    jaxcache.enable_compilation_cache()
    assert cache_calls["jax_compilation_cache_dir"] == target
    assert os.path.isdir(target)


def test_cache_skipped_on_cpu(monkeypatch, cache_calls):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxcache.enable_compilation_cache()
    assert cache_calls == {}


def test_cache_not_marked_done_before_backend_probe(monkeypatch, cache_calls):
    """A failing backend probe leaves the cache unconfigured, to retry."""
    import jax

    def boom():
        raise RuntimeError("no backend yet")

    monkeypatch.setattr(jax, "default_backend", boom)
    with pytest.raises(RuntimeError):
        jaxcache.enable_compilation_cache()
    assert not jaxcache._done


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_cli_platform_pin(monkeypatch, capsys, platform):
    """--platform {auto,cpu,gpu} pins jax_platforms before any work."""
    import jax

    from libssa_tpu.cli import main

    seen = {}
    real_update = jax.config.update

    def update(key, value):
        if key == "jax_platforms":
            seen[key] = value
        else:
            real_update(key, value)

    monkeypatch.setattr(jax.config, "update", update)
    rc = main(["pair", "--query", "MKVL", "--subject", "MKVL",
               "--platform", platform])
    assert rc == 0 and seen == {"jax_platforms": platform}
    capsys.readouterr()


def test_cli_platform_rejects_unknown(capsys):
    from libssa_tpu.cli import main

    with pytest.raises(SystemExit):
        main(["pair", "--query", "MK", "--subject", "MK", "--platform", "rocm"])
    capsys.readouterr()


@pytest.fixture
def native_src(tmp_path, monkeypatch):
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    monkeypatch.delenv("LIBSSA_NO_NATIVE_BUILD", raising=False)
    monkeypatch.setattr(nativebuild, "_source_dir", lambda: str(tmp_path))
    return tmp_path


def test_native_build_stamps_host(native_src):
    """A library is fresh only with this host's stamp beside it: a copy
    carried over from another host is rebuilt."""
    (native_src / "x.cpp").write_text('extern "C" int f() { return 1; }\n')
    out = nativebuild.ensure_built("libx.so", "x.cpp")
    assert out == str(native_src / "libx.so")
    stamp = native_src / "libx.so.stamp"
    assert stamp.read_text() == nativebuild._host_stamp(
        os.environ.get("CXX", "g++")
    )
    built = os.path.getmtime(out)
    assert nativebuild.ensure_built("libx.so", "x.cpp") == out
    assert os.path.getmtime(out) == built  # fresh: not rebuilt
    stamp.write_text("another-host x86_64 g++ -O3 -march=native")
    assert nativebuild.ensure_built("libx.so", "x.cpp") == out
    assert stamp.read_text() == nativebuild._host_stamp(
        os.environ.get("CXX", "g++")
    )


def test_native_build_failure_leaves_no_temp(native_src):
    (native_src / "bad.cpp").write_text("this is not C++\n")
    assert nativebuild.ensure_built("libbad.so", "bad.cpp") is None
    assert not [p for p in os.listdir(native_src) if ".tmp." in p]
    assert not (native_src / "libbad.so").exists()


def test_native_flags_are_portable():
    assert not any("march" in f for f in nativebuild._CXXFLAGS)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu_host():
    """Without a GPU the smoke exits nonzero and never prints the ok line."""
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py it fails too."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
