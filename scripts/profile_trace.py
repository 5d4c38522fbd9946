"""Capture a jax.profiler device trace of steady-state DeviceMatcher calls
and print the top XLA ops by total device time (parsed from the perfetto
trace.json.gz the profiler writes - no tensorboard needed).

Usage: python scripts/profile_trace.py [Q] [M] [N]
"""

import glob
import gzip
import json
import os
import sys
import tempfile
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    from pbwt_tpu.ops import match_jax
    from pbwt_tpu.synth import match_data

    Q = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    M = int(sys.argv[2]) if len(sys.argv) > 2 else 100_000
    N = int(sys.argv[3]) if len(sys.argv) > 3 else 2048

    Xp, Xq = match_data(M, N, Q)
    matcher = match_jax.DeviceMatcher(Xp)
    xq = Xq[:Q]
    rows = matcher.match(xq)                       # compile + warm
    print(f"warm ok: {len(rows)} rows", flush=True)

    tdir = tempfile.mkdtemp(prefix="pbwt_trace_")
    jax.profiler.start_trace(tdir)
    for _ in range(3):
        rows = matcher.match(xq)
    jax.profiler.stop_trace()

    files = glob.glob(f"{tdir}/**/*.trace.json.gz", recursive=True)
    if not files:
        print("no trace.json.gz found under", tdir)
        print(glob.glob(f"{tdir}/**/*", recursive=True)[:20])
        return
    with gzip.open(files[0], "rt") as fh:
        tr = json.load(fh)
    ev = tr.get("traceEvents", [])
    # keep complete events on the device tracks ("/device:GPU:0", ...)
    pid_names = {e["pid"]: e["args"].get("name", "")
                 for e in ev if e.get("ph") == "M"
                 and e.get("name") == "process_name" and "args" in e}
    tot = defaultdict(float)
    cnt = defaultdict(int)
    total = 0.0
    for e in ev:
        if e.get("ph") != "X":
            continue
        pname = pid_names.get(e.get("pid"), "")
        if "/device:" not in pname:
            continue
        name = e.get("name", "?")
        dur = float(e.get("dur", 0.0))
        tot[name] += dur
        cnt[name] += 1
        total += dur
    print(f"\ntrack processes seen: {sorted(set(pid_names.values()))[:10]}")
    print(f"total device-track op time: {total/1e6:.3f} s over 3 calls\n")
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:30]
    for name, dur in top:
        print(f"{dur/1e6:9.4f} s  x{cnt[name]:7d}  {name[:100]}")


if __name__ == "__main__":
    main()
