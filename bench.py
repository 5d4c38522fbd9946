"""Benchmark: PBWT construction, divergence-carrying construction and
standing-panel matchDynamic on one GPU.

Runs in one process and prints one JSON line per stage; every line names
the device as JAX reports it (platform, device_kind, count) and the card
with its power limit as nvidia-smi reports them.  Without a GPU backend it
exits non-zero before measuring anything.

Stages:
  build     grouped construction (no divergence) at M_build x N_build,
            hap-sites/s over the device scan
  build_ad  the divergence-carrying construction chain the matcher runs
            (64 groups of 32 sites), hap-sites/s
  match     DeviceMatcher q/s against a standing M_match x 2048 panel at
            Q in {256, 1024, 4096}, or at Q_match alone

Usage: python bench.py [M_build] [N_build] [M_match] [Q_match]
"""

import json
import subprocess
import sys
import time

import numpy as np

T_START = time.perf_counter()


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def trace(msg):
    """Stage breadcrumb on stderr, so the JSON lines stay clean."""
    print(f"bench[{time.perf_counter() - T_START:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def build_words(M, N, Mp, seed=0):
    """Packed group words for a tiled random panel, built without ever
    materialising the (N, Mp) column matrix.  Pad haplotypes are all-ones
    columns == all-ones words."""
    from pbwt_tpu.ops import build as dbuild

    rng = np.random.RandomState(seed)
    # per-site allele frequencies for realistic run-length structure;
    # haplotypes tile a 16k-wide random block (the partition's work is
    # data-independent, so tiling doesn't change the measurement)
    freqs = rng.beta(0.2, 0.8, size=N).astype(np.float32)
    TILE = min(M, 1 << 14)
    X_tile = (rng.random_sample((N, TILE)).astype(np.float32)
              < freqs[:, None]).astype(np.uint8)
    W_tile = dbuild.pack_group_words(X_tile)        # (Ng, TILE) int32
    Ng = W_tile.shape[0]
    W = np.full((Ng, Mp), -1, dtype=np.int32)       # pad haps: all-ones
    for t0 in range(0, M, TILE):
        t1 = min(t0 + TILE, M)
        W[:, t0:t1] = W_tile[:, :t1 - t0]
    return W


def _time_build(W, a0, with_divergence, reps=3):
    import jax

    from pbwt_tpu.ops import build as dbuild

    def run():
        return jax.block_until_ready(dbuild.build_scan_grouped(
            W, a0, with_divergence=with_divergence))

    run()                                   # warm-up / compile
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return (time.perf_counter() - t0) / reps


def bench_build(M, N):
    import jax.numpy as jnp

    from pbwt_tpu.ops import build as dbuild

    Mp = dbuild.pad_to(M)
    W = jnp.asarray(build_words(M, N, Mp))
    a0 = jnp.arange(Mp, dtype=jnp.int32)
    trace(f"panel words uploaded ({W.nbytes >> 20} MB)")
    dt = _time_build(W, a0, with_divergence=False)
    trace(f"build measured ({dt:.3f} s/rep)")
    out = {"metric": "build_hap_sites_per_s", "value": M * N / dt,
           "unit": "hap-sites/s", "M": M, "N": N, "seconds": dt}
    groups = min(64, W.shape[0])
    dt_ad = _time_build(W[:groups], a0, with_divergence=True)
    trace(f"build_ad measured ({dt_ad:.3f} s/rep)")
    out_ad = {"metric": "build_ad_hap_sites_per_s",
              "value": M * groups * 32 / dt_ad, "unit": "hap-sites/s",
              "M": M, "N": groups * 32, "seconds": dt_ad}
    return out, out_ad


def bench_match_dynamic(M, N, Qs):
    """Standing-panel matchDynamic q/s at each Q (best of two warm calls;
    each Q compiles its own query scan first)."""
    from pbwt_tpu.ops import match_jax
    from pbwt_tpu.synth import match_data

    Xp, Xq = match_data(M, N, max(Qs))
    trace("match data built")
    matcher = match_jax.DeviceMatcher(Xp)
    trace(f"matcher panel up (trajectory resident: "
          f"{matcher.traj is not None})")
    for Q in Qs:
        matcher.match(Xq[:Q])             # warm-up / compile
        dt = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            rows = matcher.match(Xq[:Q])
            dt = min(dt, time.perf_counter() - t0)
        trace(f"match Q={Q} measured ({dt:.3f} s best-of-2)")
        yield {"metric": "match_queries_per_s", "value": Q / dt,
               "unit": "queries/s", "M": M, "N": N, "Q": Q,
               "rows": len(rows), "seconds": dt}


def main():
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"bench: JAX backend is {jax.default_backend()!r}, not a "
                 f"GPU; nothing measured")
    from pbwt_tpu.ops import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    where = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())},
             "card": card_info()}
    M = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 16
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 14
    Mm = int(sys.argv[3]) if len(sys.argv) > 3 else 100_000
    Qs = (int(sys.argv[4]),) if len(sys.argv) > 4 else (256, 1024, 4096)
    for res in bench_build(M, N):
        print(json.dumps({**res, **where}), flush=True)
    for res in bench_match_dynamic(Mm, 2048, Qs):
        print(json.dumps({**res, **where}), flush=True)


if __name__ == "__main__":
    main()
