"""Device engine: grouped XLA scans for construction, matching, imputation,
painting and the copy-model likelihood."""

import os as _os

_REPO_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))), ".jax_cache")


def device_requested(exact: bool = True) -> bool:
    """Should algorithms route through the device engine?

    The one host-versus-device decision: every routing site asks here.
    ``PBWT_TPU_DEVICE`` decides when set: ``0`` (or empty) keeps the host C
    engine, any other value forces the device engine on whatever backend
    JAX has, the CPU included.
    Unset, the device engine is the default on a GPU backend.

    Paths whose device outputs are only f32-close rather than byte-identical
    to the host (painting's printed matrices, the copy-model likelihood) pass
    ``exact=False``: they stay on the host unless ``PBWT_TPU_DEVICE`` asks
    for the device, keeping the reference bit-parity contract by default.
    """
    v = _os.environ.get("PBWT_TPU_DEVICE")
    if v is not None:
        want = v not in ("", "0")
    elif not exact:
        return False
    # a process pinned to the host backend can answer without importing
    # jax at all — the import alone costs ~1 s, which would dominate
    # host-only CLI pipelines that merely ASKED whether a device is present
    elif _os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        return False
    else:
        import jax

        want = jax.default_backend() == "gpu"
    if want:
        enable_compile_cache()
    return want


def enable_compile_cache() -> None:
    """Point JAX's persistent compilation cache at ``.jax_cache`` at the repo
    root (a fixed path, so later processes hit it).  Sets nothing when
    ``JAX_COMPILATION_CACHE_DIR`` is set: JAX already uses that."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", _REPO_CACHE_DIR)
