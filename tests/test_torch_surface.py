"""The last two pieces of the JAX package's surface in the port.

  - `--fleet-stack MS` in the port's CLI parses to the JAX CLI's
    `fleet_stack_window_ms`, and `server --help` lists it.
  - `jax-compilation-cache-dir` names the directory the port's compiled
    libraries build into and load from (ops/_build.py `use_build_dir`):
    an app built with it builds the native runtime there (g++, here on the
    CPU) and the CUDA kernels' libraries go there too (a stand-in nvcc that
    only writes its output file); a directory that cannot be created or
    written raises a RuntimeError naming the key (never an OSError, which
    the fault classifier counts as a device fault); without the key the
    libraries stay in spark_scheduler_tpu_torch/_build/.
  - `UNSUPPORTED_KEYS` is empty: a JAX install YAML that sets the key
    boots on the port.
"""

from __future__ import annotations

import importlib

import pytest

JAX = "spark_scheduler_tpu"
PORT = "spark_scheduler_tpu_torch"


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def test_cli_fleet_stack_parses_like_jax(monkeypatch):
    captured = {}

    class Built(Exception):
        pass

    def capture(pkg):
        def build(backend, config, **kw):
            captured[pkg] = config
            raise Built

        return build

    for pkg in (JAX, PORT):
        monkeypatch.setattr(mod(pkg, "server.app"), "build_scheduler_app",
                            capture(pkg))
        with pytest.raises(Built):
            mod(pkg, "__main__").main(
                ["server", "--port", "0", "--fleet-stack", "5"]
            )
    assert captured[PORT].fleet_stack_window_ms == 5.0
    assert captured[JAX].fleet_stack_window_ms == 5.0


def test_server_help_lists_fleet_stack(capsys):
    with pytest.raises(SystemExit) as done:
        mod(PORT, "__main__").main(["server", "--help"])
    assert done.value.code == 0
    assert "--fleet-stack" in capsys.readouterr().out


@pytest.fixture
def build_dirs(monkeypatch):
    """Restore both copies of the build directory, and the loaded native
    runtime, after the test."""
    native, build = mod(PORT, "native"), mod(PORT, "ops._build")
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(native, "_lib", None)
    return native, build


def _app(config):
    from spark_scheduler_tpu_torch.server.app import build_scheduler_app
    from spark_scheduler_tpu_torch.store.backend import InMemoryBackend

    return build_scheduler_app(InMemoryBackend(), config, device="cpu")


def test_app_builds_the_native_runtime_into_the_cache_dir(tmp_path, build_dirs):
    from spark_scheduler_tpu_torch.server.config import InstallConfig

    native, build = build_dirs
    cache = tmp_path / "cache" / "port"
    config = InstallConfig.from_dict({"jax-compilation-cache-dir": str(cache)})
    app = _app(config)
    try:
        assert app.solver.uses_native_arena
        assert build.BUILD_DIR == native.BUILD_DIR == cache.resolve()
        assert native.library_path().parent == cache.resolve()
        assert [p.name for p in cache.glob("*.so")] == [native.library_path().name]
        assert not list(cache.glob("*.tmp"))
    finally:
        app.stop()


def test_cuda_kernels_build_into_the_cache_dir(tmp_path, build_dirs, monkeypatch):
    _native, build = build_dirs
    monkeypatch.setattr(build, "_loaded", {})
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then : > "$2"; fi; '
        "shift; done\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    cache = build.use_build_dir(tmp_path / "kernels")
    assert set(build.build_all(("probe", "window_kernel"))) == {
        "probe", "window_kernel",
    }
    assert sorted(p.name for p in cache.glob("*.so")) == sorted(
        build.library_path(n).name for n in ("probe", "window_kernel")
    )
    assert build.library_path("probe").parent == cache


@pytest.mark.parametrize("where", ["under-a-file", "is-a-file"])
def test_unwritable_cache_dir_raises_naming_the_key(tmp_path, build_dirs, where):
    from spark_scheduler_tpu_torch.faults.errors import classify_slot_failure
    from spark_scheduler_tpu_torch.server.config import InstallConfig

    native, build = build_dirs
    before = build.BUILD_DIR
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    path = blocker / "cache" if where == "under-a-file" else blocker
    config = InstallConfig(jax_compilation_cache_dir=str(path))
    with pytest.raises(RuntimeError, match="jax-compilation-cache-dir") as err:
        _app(config)
    assert not isinstance(err.value, OSError)
    assert not classify_slot_failure(err.value)
    assert build.BUILD_DIR == native.BUILD_DIR == before


def test_default_build_dir_is_the_package_build_dir(build_dirs):
    from spark_scheduler_tpu_torch.server.config import InstallConfig

    native, build = build_dirs
    app = _app(InstallConfig())
    try:
        assert build.BUILD_DIR == native.BUILD_DIR == build.DEFAULT_BUILD_DIR
        assert build.DEFAULT_BUILD_DIR == (
            build.Path(build.__file__).resolve().parent.parent / "_build"
        )
    finally:
        app.stop()


def test_every_jax_install_key_is_served(tmp_path, build_dirs):
    """A JAX install YAML that sets `jax-compilation-cache-dir` beside
    other keys boots on the port; nothing is refused."""
    from spark_scheduler_tpu_torch.server.app import (
        UNSUPPORTED_KEYS,
        unsupported_keys,
    )
    from spark_scheduler_tpu_torch.server.config import InstallConfig

    assert UNSUPPORTED_KEYS == {}
    raw = {"jax-compilation-cache-dir": str(tmp_path / "jax-cache"),
           "solver": {"scale-tier": True, "prune-top-k": 4},
           "fleet": {"stack-window-ms": 2.0}}
    config = InstallConfig.from_dict(raw)
    assert unsupported_keys(config) == []
    assert config.fleet_stack_window_ms == 2.0
    app = _app(config)
    try:
        assert app.solver.uses_native_arena
    finally:
        app.stop()
