"""Secondary benchmark: query-vs-panel set-maximal matching throughput.

Measures the matchDynamic-equivalent device path (SURVEY.md section 6's
"queries/s for matchDynamic at 100k haplotypes" metric) end-to-end and
device-scan-only. Prints one JSON line per measurement.

Usage: python bench_match.py [M] [N] [Q]
"""

import json
import sys
import time

import numpy as np


def main():
    M = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    N = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    Q = int(sys.argv[3]) if len(sys.argv) > 3 else 256

    from pbwt_tpu.synth import match_data

    Xp, Xq = match_data(M, N, Q)

    from pbwt_tpu.ops import match_jax

    matcher = match_jax.DeviceMatcher(Xp)             # panel upload once
    rows = matcher.match(Xq)                          # warm-up / compile
    t0 = time.perf_counter()
    rows = matcher.match(Xq)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "match_queries_per_s",
        "value": round(Q / dt, 2), "unit": "queries/s",
        "M": M, "N": N, "Q": Q, "rows": len(rows),
        "seconds": round(dt, 3),
    }))
    t0 = time.perf_counter()
    rows = match_jax.match_queries_device(Xp, Xq)     # incl. panel setup
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "match_queries_per_s_cold_panel",
        "value": round(Q / dt, 2), "unit": "queries/s",
        "M": M, "N": N, "Q": Q, "rows": len(rows),
        "seconds": round(dt, 3),
    }))


if __name__ == "__main__":
    main()
