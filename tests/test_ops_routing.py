"""The host-versus-device decision, the compile-cache placement and the
device-derived matcher memory budgets."""

import os

import jax
import pytest

from pbwt_tpu import ops
from pbwt_tpu.ops import match_jax


@pytest.fixture
def cache_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "enable_compile_cache", lambda: calls.append(1))
    monkeypatch.delenv("PBWT_TPU_DEVICE", raising=False)
    return calls


@pytest.mark.parametrize("backend,exact,want", [
    ("gpu", True, True), ("gpu", False, False), ("cpu", True, False)])
def test_backend_decides(monkeypatch, cache_calls, backend, exact, want):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert ops.device_requested(exact) is want
    assert len(cache_calls) == int(want)


def test_cpu_pinned_process_answers_host(monkeypatch, cache_calls):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    # answered from the environment alone: the backend is never asked
    monkeypatch.setattr(jax, "default_backend", lambda: pytest.fail("asked"))
    assert ops.device_requested() is False
    assert not cache_calls


@pytest.mark.parametrize("value,exact,want", [
    ("1", True, True), ("1", False, True), ("0", True, False),
    ("", True, False)])
def test_env_forces(monkeypatch, cache_calls, value, exact, want):
    monkeypatch.setenv("PBWT_TPU_DEVICE", value)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert ops.device_requested(exact) is want
    assert len(cache_calls) == int(want)


def test_compile_cache_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    ops.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == prev   # JAX's own


def test_compile_cache_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        ops.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_trajectory_budget_from_bytes_limit():
    # an 80 GB card at JAX's default 75% memory fraction
    traj, snap = match_jax.memory_budgets(60 * 10 ** 9)
    Mp, Ns = 1 << 20, 2048
    assert 11 * Mp * (Ns + 1) <= traj               # 1M x 2048 is resident
    assert 11 * Mp * (8 * Ns + 1) > traj            # 1M x 16k is not
    assert 4 * Mp * 32 <= snap <= 4 << 31           # >= one group, int32-safe
    assert match_jax.memory_budgets(1 << 40)[1] == 4 << 31
    assert match_jax.device_bytes_limit() > 0
